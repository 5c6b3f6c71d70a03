"""Serving steps: prefill / decode over a model's KV caches.

The port of the JAX package's ``serve/serve_step.py``. The reference jits
the pair and donates the cache to ``decode`` so it updates in place; here
the model writes its caches in place itself, so the steps are plain
closures. Given ``rules`` (``repro_torch.sharding.Rules``), both run
inside ``sharding_ctx(rules, rules.mesh, d_model)``: the model's
parameters must be laid out by rules of the same mesh
(``Model.init(..., rules=)``), each step takes this rank's batch rows and
returns its block of the logits and the caches :func:`cache_shardings`
lays out. As in the reference, one
rules object (one mode) serves both steps: make a prefill pair and a
decode pair from rules of each mode.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.layers import TensorStruct
from repro_torch.models.model import Model
from repro_torch.sharding.ctx import sharding_ctx
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.sharding.rules import channel_split_dim, kv_cache_split


def make_serve_fns(model: Model, rules=None, max_len: int = 0):
    """(prefill(batch), decode(tokens, caches, pos)) of ``model``, its
    caches ``max_len`` positions long (0: the prompt's length); under
    ``rules`` each runs inside its sharding context."""
    def prefill(batch):
        if rules is None:
            return model.prefill(batch, max_len=max_len)
        with sharding_ctx(rules, rules.mesh, model.cfg.d_model):
            return model.prefill(batch, max_len=max_len)

    def decode(tokens, caches, pos):
        if rules is None:
            return model.decode_step(tokens, caches, pos)
        with sharding_ctx(rules, rules.mesh, model.cfg.d_model):
            return model.decode_step(tokens, caches, pos)

    return prefill, decode


def prefill_input_structs(model: Model, batch: int, seq_len: int) -> dict:
    cfg = model.cfg
    s: dict[str, Any] = {"tokens": TensorStruct((batch, seq_len),
                                                torch.int32)}
    if cfg.family == "audio":
        s["frames"] = TensorStruct((batch, cfg.encoder_len, cfg.d_model),
                                   model.compute_dtype)
    if cfg.num_patches:
        s["image_embeds"] = TensorStruct(
            (batch, cfg.num_patches, cfg.d_model), model.compute_dtype)
    return s


def cache_shardings(rules, cache_struct) -> Any:
    """Structural cache layouts (mirror the models' cache_structs): a
    ``PartitionSpec`` per leaf.

    KV caches: batch -> the batch axes; KV heads -> "model" when they
    divide, else the *sequence* dim -> "model" (the partial attention of
    each rank's positions combined across "model"). MLA's compressed
    caches always split by sequence. Recurrent / conv states split their
    widest trailing (channel) dim over "model" where it divides (the TP
    layout of the producing layer)."""
    b = rules.batch_axes or None
    tp = int(rules.mesh.shape.get("model", 1))

    def mixer(tree, stacked: bool):
        off = 1 if stacked else 0
        lead = [None] * off

        def kv(leaf):  # (L?, B, S, K, hd)
            s = leaf.shape
            parts = lead + [b, None, None, None]
            split = kv_cache_split(rules, s[off + 2], s[off + 1], tp)
            if split is not None:
                parts[off + (2 if split == "heads" else 1)] = "model"
            return P(*parts)

        def seqshard(leaf):  # (L?, B, S, R): MLA compressed
            s = leaf.shape
            parts = lead + [b, None, None]
            if rules.seq_shard_cache and s[off + 1] % tp == 0:
                parts[off + 1] = "model"
            return P(*parts)

        def chan_last(leaf):  # conv / recurrent states: channels last
            s = leaf.shape
            parts = lead + [b] + [None] * (len(s) - off - 1)
            wide = channel_split_dim(s[off + 1:], tp)
            if wide is not None:
                parts[off + 1 + wide] = "model"
            return P(*parts)

        keys = set(tree.keys())
        if keys == {"k", "v"}:
            return {k: kv(v) for k, v in tree.items()}
        if keys == {"ckv", "k_rope"}:
            return {k: seqshard(v) for k, v in tree.items()}
        return {k: chan_last(v) for k, v in tree.items()}

    if set(cache_struct.keys()) == {"self", "cross"}:  # enc-dec
        return {"self": mixer(cache_struct["self"], stacked=True),
                "cross": tuple(
                    mixer({"k": c, "v": c}, stacked=True)["k"]
                    for c in cache_struct["cross"])}
    return {"groups": [mixer(t, stacked=True)
                       for t in cache_struct["groups"]],
            "rem": [mixer(t, stacked=False)
                    for t in cache_struct["rem"]]}

