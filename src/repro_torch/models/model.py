"""Top-level model API: build -> specs/init -> loss / prefill / decode_step.

The port of the JAX package's ``models/model.py``, for every family it
serves: dense and vision GQA, MoE, MLA, Mamba-2 SSD, RG-LRU hybrids and the
encoder-decoder. ``build_model(cfg, tp)`` resolves the same TP-divisibility
padding: query heads pad up to a multiple of the model-axis size; KV heads
smaller than the axis stay unsharded (replicated); Mamba-2's inner dim
pads so SSD heads split evenly; the vocab pads to a multiple of ``tp``.
A model of any ``tp`` runs unsharded when no rules are given, as the
reference's does (the padded model is the reference of every sharded run
at that ``tp``).

Sharded serving (``repro_torch.sharding``): ``init``, ``set_params`` and
``convert.params_from_numpy`` given ``rules`` keep only this rank's block
of each leaf (``Rules.param_pspec``; the whole tree is the same function
of the seed on every mesh), and ``prefill`` / ``decode_step`` /
``forward`` run under ``sharding_ctx(rules, rules.mesh, d_model)``
(``serve.make_serve_fns(model, rules=...)``): they take this rank's batch
rows (the rules' batch axes) and return this rank's block of the
vocabulary (``logits_btv``) and caches laid out by
``serve.serve_step.cache_shardings``. Every family runs on any mesh:
the GQA ones (dense, vision, MoE), MLA, the SSD, the RG-LRU hybrid and
the encoder-decoder, whose frames (each rank's batch rows, every frame)
go through the encoder in the residual's layout and whose cross K/V are
held as ``cache_shardings`` lays them out (``models/encdec.py``). An
RG-LRU width that "model" does not divide is refused (the reference
does not pad it).

Training under rules (``train.make_train_step(model, opt, rules)``):
:meth:`Model.loss` runs under a context on this rank's blocks of the
float32 masters (:meth:`Model.master_params` given ``rules``) and its
batch rows, for every family: under the TP rules (tensor parallelism
over "model", MoE's experts over "model", the residual split by
sequence, the "embed" dimension over "data") and under ``no_tp`` (ZeRO
over both axes, the batch over "model" too; the model built at
``tp=1``, as the reference's ``build_model(cfg, tp=1 if no_tp else
TP)``). The loss is vocab-parallel and its mean runs over the global
batch, and the MoE load-balancing loss is taken from each microbatch's
global routing, so every rank returns the same value. The SSD, the
RG-LRU and the encoder-decoder train through the same mixers as they
serve: a train step reads no cache, so the SSD's and the cross
attention's cache layouts never apply (``models/ssm.py``,
``models/encdec.py``).

Parameters live in the module (``Model.params``, the JAX package's nested
layout) on the model's device. The reference keeps float32 parameters and
casts each to the compute dtype at use; casting gives the same values
every time, so the port stores every weight in the compute dtype once,
when it is loaded (phi3-medium-14b: 29.3 GB in bf16, 58.6 GB in float32).
The leaves the reference reads uncast in float32 stay float32
(``FLOAT32_KEYS``): the norms' scales and biases (``rmsnorm`` casts its
scale to float32), the MoE router (its logits are float32), the SSD
decay ``a_log`` and ``dt_bias``, and the RG-LRU's ``lam``; stored in bf16
they would round before use, and routing would pick other experts.

Training keeps the reference's float32 masters instead: ``Model.loss``
takes a tree from :meth:`Model.master_params` (float32 leaves with
``requires_grad``), and the forward casts each weight at use, so a bf16
forward over float32 masters is the reference's computation. Only the
serving entry points run under ``torch.inference_mode``.

The encoder-decoder (``family == "audio"``) prefills from ``tokens`` and
``frames`` (B, encoder_len, d_model): the encoder runs once, each decoder
layer's cross K/V is projected from its output, and the decode steps
carry them in the cache (``{"self": ..., "cross": (ck, cv)}``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (TensorStruct, apply_norm, embed_specs,
                                       embed_tokens, init_tree, logits_out,
                                       norm_specs, tree_leaves, tree_map,
                                       tree_paths)
from repro_torch.runtime import spmd
from repro_torch.sharding import ctx as shard
from repro_torch.sharding.rules import local_shape, local_slices

#: Keys of the tree whose leaves stay float32 (see the module docstring):
#: the norms (layers', MLA's q/kv, the SSD's gated norm, the encoder-
#: decoder's), the router, and the SSD's and RG-LRU's decay parameters.
FLOAT32_KEYS = ("norm1", "norm2", "final_norm", "norm_x", "enc_norm",
                "q_norm", "kv_norm", "norm", "router", "a_log", "dt_bias",
                "lam")


def _pad_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


class ParamTree(nn.Module):
    """A nested dict / list of tensors as a module tree, so ``Model``'s
    parameters show in ``named_parameters`` and ``state_dict`` (names like
    ``params.stack.groups.0.mixer.wq``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, list):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v) for v in value))
            else:
                self.register_parameter(key, value)


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, raw_cfg: ArchConfig, heads: int,
                 kv_heads: int, kv_sharded: bool, tp: int,
                 compute_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg                  # possibly padded for TP
        self.raw_cfg = raw_cfg          # the assigned config
        self.heads = heads
        self.kv_heads = kv_heads
        self.kv_sharded = kv_sharded
        self.tp = tp
        self.compute_dtype = compute_dtype
        self.device = device
        self.tree: Optional[dict] = None    # nested dict of the Parameters
        self.params: Optional[ParamTree] = None
        self.param_rules = None             # the rules the tree is laid out by
        self._cache_len = 0                 # global length of sharded caches
        self._loss_rules = None             # the rules Model.loss last checked

    # ---------------------------------------------------------- specs/init

    def param_specs(self) -> dict:
        cfg = self.cfg
        specs: dict[str, Any] = {"embed": embed_specs(cfg)}
        if cfg.family == "audio":
            specs["encdec"] = encdec_lib.encdec_specs(cfg, self.heads,
                                                      self.kv_heads)
        else:
            specs["stack"] = tf.stack_specs(cfg, self.heads, self.kv_heads)
        specs["final_norm"] = norm_specs(cfg)
        return specs

    def count_params(self, params=None) -> int:
        tree = params if params is not None else self.param_specs()
        return sum(math.prod(x.shape) for x in tree_leaves(tree))

    def param_dtype(self, path: tuple) -> torch.dtype:
        """The stored dtype of the leaf at ``path``: float32 under a key of
        ``FLOAT32_KEYS``, else the compute dtype."""
        return torch.float32 if any(k in FLOAT32_KEYS for k in path) \
            else self.compute_dtype

    def check_rules(self, rules) -> None:
        """Raise unless this model can be laid out by ``rules``:
        ``NotImplementedError`` for an SSD cache layout the layer does
        not read (``ssm.cache_layout``; serving rules only: a train step
        builds no cache); ``ValueError`` for a "model" axis other than
        ``tp`` (under ``no_tp``: a model not built at ``tp=1``), KV
        sharding other than the model's, an RG-LRU width its tensor-
        parallel axis does not divide, or an "embed" dimension its axes
        do not divide."""
        mesh = rules.mesh
        cfg = self.cfg
        msz = int(mesh.shape.get("model", 1))
        if rules.no_tp:
            if self.tp != 1:
                raise ValueError(
                    f"the model is padded for tp={self.tp}; the no_tp rules "
                    "use the 'model' axis as data parallelism and take the "
                    "model built at tp=1, as the reference does")
        elif msz != self.tp:
            raise ValueError(f"the model is padded for tp={self.tp}, the "
                             f"mesh's model axis has {msz} devices")
        kinds = cfg.layer_kinds()
        if self.tp > 1 and "rec" in kinds and cfg.rglru_width % self.tp:
            raise ValueError(
                f"{cfg.name}: the RG-LRU width {cfg.rglru_width} does not "
                f"divide over tp={self.tp}; the reference's build_model pads "
                "the heads, the KV heads, the SSD's inner dimension and the "
                "vocabulary but not this width, so it has no layout of such "
                "a model to hold a sharded one to")
        if self.tp > 1 and "ssm" in kinds and rules.mode != "train":
            ssm_lib.cache_layout(cfg, self.tp)
        if self.tp > 1 and rules.kv_sharded != self.kv_sharded:
            raise ValueError(f"rules.kv_sharded={rules.kv_sharded}, the "
                             f"model's KV heads ({self.kv_heads}) are "
                             f"{'' if self.kv_sharded else 'not '}split "
                             f"over tp={self.tp}")
        for path, spec in zip(tree_paths(self.param_specs()),
                              tree_leaves(self.param_specs())):
            pspec = rules.param_pspec(spec)
            for dim, n in enumerate(spec.shape):
                other = [a for a in pspec.axes_of(dim)
                         if a != "model" or rules.no_tp]
                if other and n % mesh.axis_size(tuple(other)):
                    raise ValueError(
                        f"{'/'.join(map(str, path))}: dim {dim} ({n}) does "
                        f"not divide over {other}")

    def _slices_of(self, rules):
        """(path, spec) -> this rank's block of the leaf under ``rules``."""
        def slices(_, spec):
            return local_slices(rules.param_pspec(spec), spec.shape,
                                rules.mesh)
        return slices

    def set_params(self, tree: dict, rules=None) -> "Model":
        """Hold ``tree`` (the JAX layout; tensors of any dtype and device,
        at the specs' shapes) as this model's parameters, each moved to the
        model's device and stored in :meth:`param_dtype`; with ``rules``
        only this rank's block of each leaf (:meth:`check_rules`)."""
        specs = self.param_specs()
        paths, got = tree_paths(specs), tree_paths(tree)
        if got != paths:
            raise ValueError(f"parameter tree paths differ from the specs': "
                             f"{sorted(set(got) ^ set(paths))[:4]}")

        def whole(path, t):
            spec = _at(specs, path)
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{tuple(t.shape)}, spec {spec.shape}")
            return t

        tree = tree_map(whole, tree)
        if rules is not None:
            self.check_rules(rules)
            slices_of = self._slices_of(rules)
            return self._set_local_params(tree_map(
                lambda path, t: t[slices_of(path, _at(specs, path))], tree),
                rules)
        return self._hold(tree, None)

    def _set_local_params(self, tree: dict, rules) -> "Model":
        """Hold ``tree``, already this rank's blocks under ``rules``."""
        self.check_rules(rules)
        slices_of = self._slices_of(rules)
        specs = self.param_specs()

        def block(path, t):
            want = tuple(sl.stop - sl.start
                         for sl in slices_of(path, _at(specs, path)))
            if tuple(t.shape) != want:
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{tuple(t.shape)}, this rank's block "
                                 f"{want}")
            return t

        return self._hold(tree_map(block, tree), rules)

    def _hold(self, tree: dict, rules) -> "Model":
        self.tree = tree_map(lambda path, t: nn.Parameter(
            t.to(self.device, self.param_dtype(path)), requires_grad=False),
            tree)
        self.params = ParamTree(self.tree)
        self.param_rules = rules
        return self

    def init(self, generator: Optional[torch.Generator] = None,
             rules=None) -> "Model":
        """Draw every parameter by its spec's init kind from ``generator``
        (a ``torch.Generator`` on the model's device; default: seeded 0),
        leaf by leaf in the JAX tree's order, each cast to its stored dtype
        as it is drawn. With ``rules``, each leaf is drawn whole all the
        same (a stacked leaf one layer at a time) and only this rank's
        block is kept, so every mesh holds blocks of the same tree."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if rules is None:
            return self.set_params(init_tree(
                generator, self.param_specs(), self.device,
                lambda path, _: self.param_dtype(path)))
        self.check_rules(rules)
        return self._set_local_params(init_tree(
            generator, self.param_specs(), self.device,
            lambda path, _: self.param_dtype(path), self._slices_of(rules)),
            rules)

    def _layout(self):
        """(rules, mesh) of the sharding context the call runs in, checked
        against the parameters' layout; None outside a context."""
        rules, mesh = shard.current_rules(), shard.current_mesh()
        if rules is None or mesh is None:
            if self.param_rules is not None:
                raise ValueError("the model holds this rank's blocks of its "
                                 "parameters: run it under sharding_ctx "
                                 "(serve.make_serve_fns(model, rules=...))")
            return None
        held = self.param_rules
        if held is None:
            raise ValueError("a sharded run needs the parameters laid out by "
                             "the rules: init(..., rules=) or set_params("
                             "..., rules=)")
        if mesh is not held.mesh or rules.mesh is not held.mesh or \
                rules.kv_sharded != held.kv_sharded or \
                rules.no_tp != held.no_tp:
            raise ValueError("the sharding context's rules lay the "
                             "parameters out otherwise than they are held")
        return rules, mesh

    def _global_batch(self, b: int) -> int:
        bax = shard.batch_axes()
        return b * shard.current_mesh().axis_size(bax) if bax else b

    def _params(self) -> dict:
        if self.tree is None:
            raise RuntimeError("the model has no parameters: call init() "
                               "or convert.params_from_numpy() first")
        return self.tree

    def master_params(self, tree: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None,
                      rules=None) -> dict:
        """Float32 training parameters in the JAX layout, each a leaf on
        the model's device with ``requires_grad``: ``tree`` (numpy arrays
        or tensors, e.g. ``convert.numpy_params``) copied, or else drawn
        by :meth:`init`'s rule from ``generator``. With ``rules``, this
        rank's block of each leaf (``Rules.param_pspec``): ``tree`` whole
        and sliced before it is copied (or already this rank's blocks, as
        ``train.checkpoint.load_checkpoint`` restores them), or each leaf
        drawn whole and sliced, so every mesh holds blocks of the same
        tree. The reference trains float32 masters and casts each to the
        compute dtype at use, as every layer function here does
        (``.to(x.dtype)``); the serving copy (:meth:`set_params`) is not
        touched."""
        specs = self.param_specs()
        slices_of = None
        if rules is not None:
            self.check_rules(rules)
            slices_of = self._slices_of(rules)
        drawn = tree is None
        if drawn:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            tree = init_tree(generator, specs, self.device,
                             lambda path, _: torch.float32, slices_of)
        if tree_paths(tree) != tree_paths(specs):
            raise ValueError("parameter tree paths differ from the specs'")

        def leaf(path, t):
            t = t.detach() if torch.is_tensor(t) else torch.as_tensor(t)
            spec = _at(specs, path)
            if drawn:
                return t.requires_grad_(True)
            block = slices_of(path, spec) if slices_of is not None else None
            if tuple(t.shape) == spec.shape:
                t = t if block is None else t[block]
            elif block is None or tuple(t.shape) != tuple(
                    sl.stop - sl.start for sl in block):
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{tuple(t.shape)}, spec {spec.shape}")
            return t.to(self.device, torch.float32, copy=True) \
                .requires_grad_(True)

        return tree_map(leaf, tree)

    def check_blocks(self, params: dict, rules) -> None:
        """Raise ``ValueError`` unless every leaf of ``params`` is this
        rank's block of its spec under ``rules`` (a stacked leaf may be
        held as ``transformer.Layers``, one tensor per layer)."""
        specs = self.param_specs()
        slices_of = self._slices_of(rules)
        for path, leaf in zip(tree_paths(params), tree_leaves(params)):
            want = tuple(sl.stop - sl.start for sl in
                         slices_of(path, _at(specs, path)))
            if tuple(leaf.shape) != want:
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{tuple(leaf.shape)}, this rank's block "
                                 f"under the rules {want}")

    # ---------------------------------------------------------- forward

    def _embed(self, batch, params):
        """The residual stream's input, in the residual's layout: under a
        sharding context each rank's vocab-parallel part (the image
        embeddings on model rank 0 only) summed over "model"."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], batch["tokens"],
                         self.compute_dtype)
        if cfg.num_patches and "image_embeds" in batch:
            img = batch["image_embeds"].to(self.device, self.compute_dtype)
            npatch = img.shape[1]
            if shard.model_axis()[1]:
                img = torch.zeros_like(img)
            x = torch.cat([img, x[:, npatch:]], dim=1)
        x = shard.reduce_seq(x)
        b, s = batch["tokens"].shape
        if shard.active():
            shard.constrain(x, "act_btd", (self._global_batch(b),
                                           shard.padded_len(s), cfg.d_model))
        return x

    def _positions(self, n: int):
        return torch.arange(n, dtype=torch.int32, device=self.device)

    def _encode(self, batch, params):
        cfg = self.cfg
        if "frames" not in batch:
            raise ValueError(f"{cfg.name}: the encoder-decoder needs "
                             "batch['frames'] (B, encoder_len, d_model)")
        enc = encdec_lib.run_encoder(
            cfg, params["encdec"],
            batch["frames"].to(self.device, self.compute_dtype),
            self.heads, self.kv_heads)
        return encdec_lib.project_cross_kv(cfg, params["encdec"], enc,
                                           self.heads, self.kv_heads)

    @torch.inference_mode()
    def encode(self, batch):
        """The encoder-decoder's encoder over ``batch["frames"]``, then each
        decoder layer's cross K/V: (ck, cv), each (L, B, encoder_len, KV,
        head_dim)."""
        return self._encode(batch, self._params())

    def _stack(self, params, x, positions, caches, cross_kv=None,
               train: bool = False, cache_len: int = 0):
        """The decoder stack (the encoder-decoder's with ``cross_kv``);
        returns (x, caches, aux), aux the MoE load-balancing loss (0.0
        without MoE)."""
        if self.cfg.family == "audio":
            x, caches = encdec_lib.run_decoder(
                self.cfg, params["encdec"], x, positions, caches, cross_kv,
                self.heads, self.kv_heads, train=train, cache_len=cache_len)
            return x, caches, 0.0
        return tf.apply_stack(self.cfg, params["stack"], x, positions,
                              caches, self.heads, self.kv_heads, train=train,
                              cache_len=cache_len)

    @torch.inference_mode()
    def forward(self, batch) -> torch.Tensor:
        """Teacher-forced logits at every position, (B, S, V), with no
        cache (the pass the training loss takes); under a sharding context
        this rank's rows and block of the vocabulary."""
        params = self._params()
        self._layout()
        s = batch["tokens"].shape[1]
        x = self._embed(batch, params)
        cross = self._encode(batch, params) \
            if self.cfg.family == "audio" else None
        x, _, _ = self._stack(params, x, self._positions(s), None, cross)
        x = apply_norm(self.cfg, params["final_norm"],
                       shard.gather_seq(x, s))
        return logits_out(self.cfg, params["embed"], x)

    def loss(self, batch, params: Optional[dict] = None) -> torch.Tensor:
        """Next-token cross entropy plus 0.01 x the MoE load-balancing
        loss, differentiable (no inference mode): the reference's
        ``Model.loss``. ``batch``: tokens and labels (B, S) on the model's
        device (with frames for the encoder-decoder, image_embeds where
        the config has patches); ``params``: the float32 master tree
        (:meth:`master_params`), default the serving copy. The encoder
        runs inside the differentiated function, the stack with
        ``train=True`` (remat per ``REPRO_REMAT``); the logsumexp and the
        label logit are float32.

        Under a sharding context (train rules, checked by
        :meth:`check_rules` once per rules object): ``batch`` is this
        rank's rows (the encoder-decoder's frames too), ``params`` this
        rank's blocks (checked each call). Each
        rank's logits are its block of the vocabulary (``logits_btv``), so
        the logsumexp takes its max and its sum over "model" and the
        label's logit from the rank that holds it; the mean runs over the
        global batch's tokens (each rank's mean, weighted by its share of
        the rows, summed over the batch axes), and each MoE layer's
        load-balancing loss over the microbatch's global routing
        (``models/moe.py``). Every rank returns the same value; its
        gradient on this rank is this rank's part (``train_step`` sums the
        parts)."""
        params = self._params() if params is None else params
        if shard.active():
            rules = shard.current_rules()
            if rules is not self._loss_rules:
                if rules.mode != "train":
                    raise ValueError(f"Model.loss under sharding rules "
                                     f"takes train rules, not {rules.mode}")
                self.check_rules(rules)
                self._loss_rules = rules
            self.check_blocks(params, rules)
        b, s = batch["tokens"].shape
        x = self._embed(batch, params)
        cross = self._encode(batch, params) \
            if self.cfg.family == "audio" else None
        x, _, aux = self._stack(params, x, self._positions(s), None, cross,
                                train=True)
        x = shard.gather_seq(apply_norm(self.cfg, params["final_norm"], x), s)
        logits = logits_out(self.cfg, params["embed"], x).float()
        labels = batch["labels"].long()
        mesh = shard.current_mesh()
        tp, t = shard.model_axis()
        if tp == 1:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, labels[..., None])[..., 0]
        else:
            m = mesh.all_reduce(logits.detach().amax(dim=-1), "model", "max")
            lse = torch.log(mesh.reduce_from(
                torch.exp(logits - m[..., None]).sum(dim=-1), "model")) + m
            lo, n = t * logits.shape[-1], logits.shape[-1]
            local = (labels >= lo) & (labels < lo + n)
            picked = logits.gather(-1, torch.where(local, labels - lo, 0)[
                ..., None])[..., 0]
            tgt = mesh.reduce_from(torch.where(local, picked, 0.0), "model")
        ce = (lse - tgt).mean()
        bax = shard.batch_axes()
        if bax:
            ce = mesh.reduce_from(ce * (b / self._global_batch(b)), bax)
        return ce + 0.01 * aux

    # ---------------------------------------------------------- serving

    def cache_structs(self, batch: int, max_len: int) -> dict:
        if self.cfg.family == "audio":
            return encdec_lib.encdec_cache_structs(
                self.cfg, batch, max_len, self.compute_dtype, self.kv_heads)
        return tf.cache_structs(self.cfg, batch, max_len, self.compute_dtype,
                                self.kv_heads)

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zero caches for ``batch`` sequences of ``max_len`` positions;
        under a sharding context this rank's blocks of them
        (``serve_step.cache_shardings``; ``batch`` is the global batch)."""
        structs = self.cache_structs(batch, max_len)
        if self._layout() is None:
            return self._zeros(structs)
        self._cache_len = max_len
        return self._zeros(self._local_cache_structs(structs, batch))

    def _local_cache_structs(self, structs, batch: int):
        from repro_torch.serve.serve_step import cache_shardings
        rules, mesh = shard.current_rules(), shard.current_mesh()
        bax = rules.batch_axes
        if bax and batch % mesh.axis_size(bax):
            raise ValueError(f"batch {batch} does not divide over the batch "
                             f"axes {bax}")
        specs = cache_shardings(rules, structs)
        leaves = iter(tree_leaves(specs))
        return tree_map(lambda _, st: TensorStruct(
            local_shape(next(leaves), st.shape, mesh), st.dtype), structs)

    def _check_caches(self, caches, batch: int) -> None:
        """Raise ``ValueError`` unless ``caches`` are this rank's blocks,
        as ``cache_shardings`` lays them out, of the caches of ``batch``
        sequences and the global length the last ``init_cache`` /
        ``prefill`` recorded."""
        from repro_torch.serve.serve_step import cache_shardings
        structs = self.cache_structs(batch, self._cache_len)
        specs = tree_leaves(cache_shardings(shard.current_rules(), structs))
        paths, got = tree_paths(structs), tree_leaves(caches)
        if len(got) != len(specs):
            raise ValueError("the caches are not the tree init_cache / "
                             "prefill made")
        for path, st, spec, c in zip(paths, tree_leaves(structs), specs,
                                     got):
            shard.constrain_spec(c, spec, st.shape,
                                 "cache " + "/".join(map(str, path)))

    def _zeros(self, structs):
        return tree_map(
            lambda _, s: torch.zeros(s.shape, dtype=s.dtype,
                                     device=self.device), structs)

    @torch.inference_mode()
    def prefill(self, batch, max_len: int = 0):
        """Process the prompt; returns (last-position logits (B, 1, V),
        caches of ``max_len`` positions filled with the prompt's K/V or
        the recurrent states; the encoder-decoder's carry its cross K/V).
        Under a sharding context: this rank's batch rows in, its rows and
        block of the vocabulary out, its blocks of the caches."""
        params = self._params()
        layout = self._layout()
        b, s = batch["tokens"].shape
        max_len = max_len or s
        x = self._embed(batch, params)
        gb = self._global_batch(b) if layout else b
        if self.cfg.family == "audio":
            cross = self._encode(batch, params)
            structs = self.cache_structs(gb, max_len)
            if layout:
                self._cache_len = max_len
                structs = self._local_cache_structs(structs, gb)
            selfc = self._zeros(structs["self"])
            x, _, _ = self._stack(params, x, self._positions(s), selfc,
                                  cross, cache_len=max_len)
            caches = {"self": selfc, "cross": cross}
        else:
            x, caches, _ = self._stack(params, x, self._positions(s),
                                       self.init_cache(gb, max_len),
                                       cache_len=max_len)
        if layout:
            self._check_caches(caches, gb)
        x = apply_norm(self.cfg, params["final_norm"],
                       shard.gather_seq(x, s)[:, -1:])
        logits = logits_out(self.cfg, params["embed"], x)
        return shard.constrain(logits, "logits_btv",
                               (gb, 1, self.cfg.vocab_size)), caches

    @torch.inference_mode()
    def decode_step(self, tokens, caches, pos: int):
        """One token step. tokens: (B, 1); pos: the current length. The
        caches are written in place and returned. Under a sharding
        context: this rank's rows and caches (those ``prefill`` or
        ``init_cache`` made) in, its rows and block of the vocabulary
        out."""
        params = self._params()
        layout = self._layout()
        b = tokens.shape[0]
        if layout is not None:
            self._check_caches(caches, self._global_batch(b))
        x = self._embed({"tokens": tokens}, params)
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=self.device)
        if self.cfg.family == "audio":
            x, _, _ = self._stack(params, x, positions, caches["self"],
                                  caches["cross"], cache_len=self._cache_len)
        else:
            x, caches, _ = self._stack(params, x, positions, caches,
                                       cache_len=self._cache_len)
        x = apply_norm(self.cfg, params["final_norm"], shard.gather_seq(x, 1))
        logits = logits_out(self.cfg, params["embed"], x)
        if layout is not None:
            shard.constrain(logits, "logits_btv",
                            (self._global_batch(b), 1, self.cfg.vocab_size))
        return logits, caches


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def build_model(cfg: ArchConfig, tp: int = 1,
                compute_dtype: torch.dtype = torch.bfloat16,
                device=None) -> Model:
    """The model of ``cfg`` padded for ``tp``, without parameters (call
    ``init`` or ``convert.params_from_numpy``). Runs on the card unless
    ``device="cpu"``."""
    device = spmd.resolve_device(device)
    raw = cfg
    heads = cfg.num_heads
    kv = cfg.num_kv_heads
    changes: dict[str, Any] = {}
    if heads and heads % tp:
        heads = _pad_up(heads, tp)
        changes["num_heads"] = heads
    if kv > tp and kv % tp:
        kv = _pad_up(kv, tp)
    if kv and heads % kv:
        # padded Q heads must stay an integer multiple of KV heads: pad kv
        # up to the nearest divisor of the padded head count.
        kv = next(k for k in range(kv, heads + 1) if heads % k == 0)
    if kv != cfg.num_kv_heads:
        changes["num_kv_heads"] = kv
    kv_sharded = kv > 0 and kv % tp == 0
    if cfg.ssm_state:
        di = cfg.ssm_d_inner or cfg.ssm_expand * cfg.d_model
        nh = di // cfg.ssm_headdim
        if nh % tp:
            di = _pad_up(nh, tp) * cfg.ssm_headdim
            changes["ssm_d_inner"] = di
    if cfg.vocab_size % tp:
        changes["vocab_size"] = _pad_up(cfg.vocab_size, tp)
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    return Model(cfg=cfg, raw_cfg=raw, heads=heads, kv_heads=max(kv, 1),
                 kv_sharded=kv_sharded, tp=tp, compute_dtype=compute_dtype,
                 device=device)
