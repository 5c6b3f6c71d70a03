"""Top-level model API: build -> specs/init -> loss / prefill / decode_step.

The port of the JAX package's ``models/model.py``, for every family it
serves: dense and vision GQA, MoE, MLA, Mamba-2 SSD, RG-LRU hybrids and the
encoder-decoder. ``build_model(cfg, tp)`` resolves the same TP-divisibility
padding: query heads pad up to a multiple of the model-axis size; KV heads
smaller than the axis stay unsharded (replicated); Mamba-2's inner dim
pads so SSD heads split evenly; the vocab pads to a multiple of ``tp``.
Only ``tp == 1`` holds parameters here: sharding is ROADMAP item 15d.

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
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (TensorStruct, apply_norm, embed_specs,
                                       embed_tokens, init_tree, logits_out,
                                       norm_specs, tree_leaves, tree_map,
                                       tree_paths)
from repro_torch.runtime import spmd

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

    def _require_single_device(self) -> None:
        if self.tp != 1:
            raise NotImplementedError(
                f"tp={self.tp}: tensor-parallel sharding is not ported yet "
                "(ROADMAP item 15d); build with tp=1")

    def set_params(self, tree: dict) -> "Model":
        """Hold ``tree`` (the JAX layout; tensors of any dtype and device)
        as this model's parameters, each moved to the model's device and
        stored in :meth:`param_dtype`. Shapes must match the specs."""
        self._require_single_device()
        specs = self.param_specs()
        paths, got = tree_paths(specs), tree_paths(tree)
        if got != paths:
            raise ValueError(f"parameter tree paths differ from the specs': "
                             f"{sorted(set(got) ^ set(paths))[:4]}")

        def place(path, t):
            spec = _at(specs, path)
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{tuple(t.shape)}, spec {spec.shape}")
            return nn.Parameter(t.to(self.device, self.param_dtype(path)),
                                requires_grad=False)

        self.tree = tree_map(place, tree)
        self.params = ParamTree(self.tree)
        return self

    def init(self, generator: Optional[torch.Generator] = None) -> "Model":
        """Draw every parameter by its spec's init kind from ``generator``
        (a ``torch.Generator`` on the model's device; default: seeded 0),
        leaf by leaf in the JAX tree's order, each cast to its stored dtype
        as it is drawn."""
        self._require_single_device()
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.set_params(init_tree(generator, self.param_specs(), self.device,
                                  lambda path, _: self.param_dtype(path)))
        return self

    def _params(self) -> dict:
        if self.tree is None:
            raise RuntimeError("the model has no parameters: call init() "
                               "or convert.params_from_numpy() first")
        return self.tree

    def master_params(self, tree: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None) -> dict:
        """Float32 training parameters in the JAX layout, each a leaf on
        the model's device with ``requires_grad``: ``tree`` (numpy arrays
        or tensors, e.g. ``convert.numpy_params``) copied, or else drawn
        by :meth:`init`'s rule from ``generator``. The reference trains
        float32 masters and casts each to the compute dtype at use, as
        every layer function here does (``.to(x.dtype)``); the serving
        copy (:meth:`set_params`) is not touched."""
        self._require_single_device()
        specs = self.param_specs()
        if tree is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            tree = init_tree(generator, specs, self.device,
                             lambda path, _: torch.float32)
        if tree_paths(tree) != tree_paths(specs):
            raise ValueError("parameter tree paths differ from the specs'")

        def leaf(path, t):
            t = t.detach() if torch.is_tensor(t) else torch.as_tensor(t)
            if tuple(t.shape) != _at(specs, path).shape:
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{tuple(t.shape)}, spec "
                                 f"{_at(specs, path).shape}")
            return t.to(self.device, torch.float32, copy=True) \
                .requires_grad_(True)

        return tree_map(leaf, tree)

    # ---------------------------------------------------------- forward

    def _embed(self, batch, params):
        cfg = self.cfg
        x = embed_tokens(params["embed"], batch["tokens"],
                         self.compute_dtype)
        if cfg.num_patches and "image_embeds" in batch:
            img = batch["image_embeds"].to(self.device, self.compute_dtype)
            npatch = img.shape[1]
            x = torch.cat([img, x[:, npatch:]], dim=1)
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
               train: bool = False):
        """The decoder stack (the encoder-decoder's with ``cross_kv``);
        returns (x, caches, aux), aux the MoE load-balancing loss (0.0
        without MoE)."""
        if self.cfg.family == "audio":
            x, caches = encdec_lib.run_decoder(
                self.cfg, params["encdec"], x, positions, caches, cross_kv,
                self.heads, self.kv_heads, train=train)
            return x, caches, 0.0
        return tf.apply_stack(self.cfg, params["stack"], x, positions,
                              caches, self.heads, self.kv_heads, train=train)

    @torch.inference_mode()
    def forward(self, batch) -> torch.Tensor:
        """Teacher-forced logits at every position, (B, S, V), with no
        cache (the pass the training loss takes)."""
        params = self._params()
        x = self._embed(batch, params)
        cross = self._encode(batch, params) \
            if self.cfg.family == "audio" else None
        x, _, _ = self._stack(params, x, self._positions(x.shape[1]), None,
                              cross)
        x = apply_norm(self.cfg, params["final_norm"], x)
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
        label logit are float32."""
        params = self._params() if params is None else params
        x = self._embed(batch, params)
        cross = self._encode(batch, params) \
            if self.cfg.family == "audio" else None
        x, _, aux = self._stack(params, x, self._positions(x.shape[1]),
                                None, cross, train=True)
        x = apply_norm(self.cfg, params["final_norm"], x)
        logits = logits_out(self.cfg, params["embed"], x).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        return (lse - tgt).mean() + 0.01 * aux

    # ---------------------------------------------------------- serving

    def cache_structs(self, batch: int, max_len: int) -> dict:
        if self.cfg.family == "audio":
            return encdec_lib.encdec_cache_structs(
                self.cfg, batch, max_len, self.compute_dtype, self.kv_heads)
        return tf.cache_structs(self.cfg, batch, max_len, self.compute_dtype,
                                self.kv_heads)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return self._zeros(self.cache_structs(batch, max_len))

    def _zeros(self, structs):
        return tree_map(
            lambda _, s: torch.zeros(s.shape, dtype=s.dtype,
                                     device=self.device), structs)

    @torch.inference_mode()
    def prefill(self, batch, max_len: int = 0):
        """Process the prompt; returns (last-position logits (B, 1, V),
        caches of ``max_len`` positions filled with the prompt's K/V or
        the recurrent states; the encoder-decoder's carry its cross K/V)."""
        params = self._params()
        b, s = batch["tokens"].shape
        max_len = max_len or s
        x = self._embed(batch, params)
        if self.cfg.family == "audio":
            cross = self._encode(batch, params)
            selfc = self._zeros(self.cache_structs(b, max_len)["self"])
            x, _, _ = self._stack(params, x, self._positions(s), selfc,
                                  cross)
            caches = {"self": selfc, "cross": cross}
        else:
            x, caches, _ = self._stack(params, x, self._positions(s),
                                       self.init_cache(b, max_len))
        x = apply_norm(self.cfg, params["final_norm"], x[:, -1:])
        return logits_out(self.cfg, params["embed"], x), caches

    @torch.inference_mode()
    def decode_step(self, tokens, caches, pos: int):
        """One token step. tokens: (B, 1); pos: the current length. The
        caches are written in place and returned."""
        params = self._params()
        x = embed_tokens(params["embed"], tokens, self.compute_dtype)
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=self.device)
        if self.cfg.family == "audio":
            x, _, _ = self._stack(params, x, positions, caches["self"],
                                  caches["cross"])
        else:
            x, caches, _ = self._stack(params, x, positions, caches)
        x = apply_norm(self.cfg, params["final_norm"], x)
        return logits_out(self.cfg, params["embed"], x), caches


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
