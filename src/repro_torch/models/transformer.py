"""Decoder stack assembly: layer pattern -> stacked parameter groups.

The port of the JAX package's ``models/transformer.py``. Layers are grouped
by the arch's ``layer_pattern`` period p: ``groups[pos]`` holds the
``L // p`` layers of pattern position ``pos`` stacked on a leading axis,
``rem`` the ``L % p`` remainder, unstacked; caches have the same layout.
The reference scans the groups with ``lax.scan``; here a Python loop walks
the stack, each layer reading views of its slice of the stacked params and
caches (so cache writes land in the stacked buffers, in place).

Every layer = pre-norm mixer (GQA or MLA attention, RG-LRU or SSD) +
pre-norm MLP (dense or MoE), residual around each. The stack returns the
MoE layers' summed load-balancing loss beside its output, as the
reference does (``Model.loss`` adds it). Training recomputes each group
body (one pattern period, the reference's scan step) in the backward pass
under ``torch.utils.checkpoint``, per ``REPRO_REMAT`` (see
:func:`remat_policy`).

Under a sharding context each layer runs on this rank's blocks and its
residual follows the rules' ``act_btd``: split by sequence over "model"
in prefill (all-gathered before the mixer and the MLP, their row-parallel
partial outputs reduce-scattered back; a sequence that "model" does not
divide is padded at the end, and the mixer sees only the real positions),
replicated over "model" in a decode step (the partial outputs
all-reduced). The MoE layer reduces its own output (``models/moe.py``).

Training under rules runs the same layers: every gather and reduce-
scatter lies inside the group body, so remat re-issues them when the
backward pass recomputes the body (in the same order on every rank: the
graph is the same on each) and no gathered weight is kept from one
layer to the next; the collectives' adjoints (``runtime/mesh.py``) carry
the gradients back.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (TensorStruct, apply_mlp, apply_norm,
                                       mlp_specs, norm_specs, tree_map)
from repro_torch.sharding import ctx as shard

ATTN_KINDS = ("global", "local", "chunked", "bidir")


def mixer_specs(cfg, kind: str, heads: int, kv_heads: int) -> dict:
    if kind in ATTN_KINDS:
        if cfg.attention == "mla":
            return attn.mla_specs(cfg, heads)
        return attn.gqa_specs(cfg, heads, kv_heads)
    if kind == "rec":
        return rglru_lib.rglru_specs(cfg)
    if kind == "ssm":
        return ssm_lib.ssm_specs(cfg)
    raise ValueError(f"unknown layer kind {kind}")


def layer_specs(cfg, kind: str, heads: int, kv_heads: int) -> dict:
    specs = {
        "norm1": norm_specs(cfg),
        "mixer": mixer_specs(cfg, kind, heads, kv_heads),
    }
    if cfg.moe:
        specs["norm2"] = norm_specs(cfg)
        specs["mlp"] = moe_lib.moe_specs(cfg)
    elif cfg.d_ff:
        specs["norm2"] = norm_specs(cfg)
        specs["mlp"] = mlp_specs(cfg)
    # d_ff == 0 (mamba2): mixer-only block, no MLP sublayer
    return specs


def apply_layer(cfg, p, kind: str, x, positions, cache, heads: int,
                kv_heads: int, cache_len: int = 0):
    """One layer; returns (x, cache, aux), aux the MoE load-balancing
    loss (0.0 without MoE). ``x`` is in the residual's layout (the whole
    sequence outside a sharding context); ``positions`` holds the real
    positions; ``cache_len`` is the caches' global length (sharded runs)."""
    s = positions.shape[0]
    h = shard.gather_seq(apply_norm(cfg, p["norm1"], x), s)
    if kind in ATTN_KINDS:
        if cfg.attention == "mla":
            h, new_cache = attn.mla_attention(cfg, p["mixer"], h, kind,
                                              positions, cache, heads,
                                              cache_len)
        else:
            h, new_cache = attn.gqa_attention(cfg, p["mixer"], h, kind,
                                              positions, cache, heads,
                                              kv_heads, cache_len)
    elif kind == "rec":
        h, new_cache = rglru_lib.apply_rglru(cfg, p["mixer"], h, cache)
    else:
        h, new_cache = ssm_lib.apply_ssm(cfg, p["mixer"], h, cache)
    x = x + shard.reduce_seq(h)
    aux = 0.0                       # the load-balancing loss, MoE only
    if "mlp" in p:
        h = shard.gather_seq(apply_norm(cfg, p["norm2"], x), s)
        if cfg.moe:
            h, aux = moe_lib.apply_moe(cfg, p["mlp"], h)
        else:
            h = shard.reduce_seq(apply_mlp(cfg, p["mlp"], h))
        x = x + h
    return x, new_cache, aux


def _stack(specs, n: int):
    return tree_map(lambda _, s: dataclasses.replace(
        s, shape=(n,) + s.shape, axes=("layers",) + s.axes), specs)


def stack_specs(cfg, heads: int, kv_heads: int) -> dict:
    kinds = cfg.layer_kinds()
    p = len(cfg.layer_pattern)
    n_full, rem = divmod(cfg.num_layers, p)
    out: dict[str, Any] = {"groups": [], "rem": []}
    if n_full:
        for pos in range(p):
            out["groups"].append(
                _stack(layer_specs(cfg, cfg.layer_pattern[pos], heads,
                                   kv_heads), n_full))
    for i in range(rem):
        out["rem"].append(layer_specs(cfg, kinds[n_full * p + i], heads,
                                      kv_heads))
    return out


def mixer_cache_struct(cfg, kind: str, batch: int, max_len: int, dtype,
                       kv_heads: int):
    if kind in ATTN_KINDS:
        if cfg.attention == "mla":
            return attn.mla_cache_struct(cfg, batch, max_len, dtype)
        return attn.gqa_cache_struct(
            cfg, batch, attn.layer_cache_len(cfg, kind, max_len), kv_heads,
            dtype)
    if kind == "rec":
        return rglru_lib.rglru_cache_struct(cfg, batch, dtype)
    return ssm_lib.ssm_cache_struct(cfg, batch, dtype)


def cache_structs(cfg, batch: int, max_len: int, dtype, kv_heads: int) -> dict:
    """TensorStruct tree mirroring stack_specs' group/rem layout."""
    p = len(cfg.layer_pattern)
    n_full, rem = divmod(cfg.num_layers, p)
    kinds = cfg.layer_kinds()
    out: dict[str, Any] = {"groups": [], "rem": []}
    if n_full:
        for pos in range(p):
            one = mixer_cache_struct(cfg, cfg.layer_pattern[pos], batch,
                                     max_len, dtype, kv_heads)
            out["groups"].append(tree_map(
                lambda _, s: TensorStruct((n_full,) + s.shape, s.dtype),
                one))
    for i in range(rem):
        out["rem"].append(mixer_cache_struct(cfg, kinds[n_full * p + i],
                                             batch, max_len, dtype, kv_heads))
    return out


class Layers:
    """A stacked leaf held as one tensor per layer (``layers[j]`` is layer
    ``j``), which the stack reads as it reads the stacked tensor: the
    train step makes each layer's block its own autograd leaf, so one
    layer's gradient is added into the stacked gradient as soon as it is
    made, and no stacked-size gradient exists but the sum."""

    def __init__(self, layers: list):
        self.layers = layers

    def __getitem__(self, j: int):
        return self.layers[j]

    @property
    def shape(self) -> tuple:
        return (len(self.layers),) + tuple(self.layers[0].shape)


def _slice(tree, j: int):
    return tree_map(lambda _, t: t[j], tree)


#: Weight products: a matrix times a 2-D weight (``x @ w`` folds the
#: leading axes into one ``mm``). The attention einsums are ``bmm``.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy() -> str:
    """``REPRO_REMAT`` as the reference reads it: "nothing" (the default:
    save nothing, recompute the whole group body), "none" (no remat) or
    "dots" (save the weight products' outputs, recompute the rest)."""
    return os.environ.get("REPRO_REMAT", "nothing")


def with_remat(fn, policy: str = "nothing"):
    """``fn`` recomputed in the backward pass by ``policy``
    (:func:`remat_policy`'s values). The recomputation runs in the
    sharding context of the call (the backward pass of CUDA tensors runs
    on autograd's device thread, which does not see the caller's
    thread-local context)."""
    if policy == "none":
        return fn
    kwargs = {}
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def call(*args):
        rules, mesh = shard.current_rules(), shard.current_mesh()
        embed = shard.current_embed_dim()

        def body(*a):
            with shard.sharding_ctx(rules, mesh, embed):
                return fn(*a)
        return ckpt.checkpoint(body, *args, use_reentrant=False, **kwargs)
    return call


def apply_stack(cfg, params, x, positions, caches, heads: int,
                kv_heads: int, train: bool = False, cache_len: int = 0):
    """Run the full layer stack. caches: None or cache_structs-shaped
    tensors, updated in place and returned. Returns (x, caches, aux): aux
    the MoE layers' summed load-balancing loss, a float32 scalar (0.0, a
    Python float, without MoE). Under ``train`` each full group (the
    ``p`` layers of one pattern period) is recomputed in the backward pass
    per :func:`remat_policy`; the ``rem`` layers are not, as in the
    reference."""
    p = len(cfg.layer_pattern)
    n_full = cfg.num_layers // p
    aux = 0.0

    def group_body(xc, aux, group_params, group_caches):
        for pos in range(p):
            xc, _, a = apply_layer(
                cfg, group_params[pos], cfg.layer_pattern[pos], xc,
                positions, None if group_caches is None
                else group_caches[pos], heads, kv_heads, cache_len)
            aux = aux + a
        return xc, aux

    body = with_remat(group_body, remat_policy()) if train else group_body
    for j in range(n_full):
        x, aux = body(x, aux, [_slice(g, j) for g in params["groups"]],
                      None if caches is None
                      else [_slice(c, j) for c in caches["groups"]])
    kinds = cfg.layer_kinds()
    for i, lp in enumerate(params["rem"]):
        x, _, a = apply_layer(cfg, lp, kinds[n_full * p + i], x, positions,
                              None if caches is None else caches["rem"][i],
                              heads, kv_heads, cache_len)
        aux = aux + a
    return x, caches, aux
