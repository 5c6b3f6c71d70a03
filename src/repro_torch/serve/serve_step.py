"""Serving steps: prefill / decode over a model's KV caches.

The port of the JAX package's ``serve/serve_step.py``. The reference jits
the pair and donates the cache to ``decode`` so it updates in place; here
the model writes its caches in place itself, so the steps are plain
closures. ``cache_shardings`` is JAX sharding and waits for ROADMAP item
15d.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.layers import TensorStruct
from repro_torch.models.model import Model


def make_serve_fns(model: Model, max_len: int = 0):
    """(prefill(batch), decode(tokens, caches, pos)) of ``model``, its
    caches ``max_len`` positions long (0: the prompt's length)."""
    def prefill(batch):
        return model.prefill(batch, max_len=max_len)

    def decode(tokens, caches, pos):
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
