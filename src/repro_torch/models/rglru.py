"""RG-LRU recurrent block (RecurrentGemma / Griffin "Hawk" block).

    r_t = σ(W_a x_t + b_a)            recurrence gate
    i_t = σ(W_x x_t + b_x)            input gate
    a_t = exp(c·softplus(Λ)·(-r_t))   per-channel decay in (0,1), c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The port of the JAX package's ``models/rglru.py``: in-proj -> causal conv
-> RG-LRU, gated by a GeLU branch. Each step of the recurrence is computed
in float32; the state ``h`` is kept in the compute dtype between decode
steps, as the reference keeps it.

A prefill evaluates ``h_t = a_t h_{t-1} + b_t`` (``h0`` folded into
``b_0``) with a log-depth Hillis–Steele scan in plain torch: ceil(log2 S)
steps (9 at 512 tokens) of three elementwise ops over (B, S, W), where a
loop over time would issue S steps of a few small launches each and leave
the card waiting on the host. Its tree differs from ``associative_scan``'s,
so float32 sums agree to rounding, not bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, TensorStruct, causal_conv1d

C_FACTOR = 8.0


def rglru_specs(cfg) -> dict:
    d, w = cfg.d_model, cfg.rglru_width
    return {
        "in_x": ParamSpec((d, w), ("embed", "inner")),
        "in_gate": ParamSpec((d, w), ("embed", "inner")),
        "conv_w": ParamSpec((cfg.rglru_conv, w), (None, "inner")),
        "conv_b": ParamSpec((w,), ("inner",), "zeros"),
        "wa": ParamSpec((w, w), ("inner", None)),
        "ba": ParamSpec((w,), (None,), "zeros"),
        "wx": ParamSpec((w, w), ("inner", None)),
        "bx": ParamSpec((w,), (None,), "zeros"),
        "lam": ParamSpec((w,), (None,), "normal"),
        "out": ParamSpec((w, d), ("inner", "embed")),
    }


def _lru_gates(p, x):
    """x: (B, S, W) -> (a float32, b in x's dtype) with
    h_t = a_t h_{t-1} + b_t."""
    r = torch.sigmoid(x @ p["wa"].to(x.dtype) + p["ba"].to(x.dtype))
    i = torch.sigmoid(x @ p["wx"].to(x.dtype) + p["bx"].to(x.dtype))
    log_a = -C_FACTOR * F.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult.to(x.dtype) * (i * x)
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0 (Hillis–Steele:
    the pair (a, b) at t absorbs the pair at t - d for d = 1, 2, 4, ...)."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def apply_rglru(cfg, p, x, cache=None):
    """x: (B, S, D); cache: None | dict(conv, h), written in place.
    Returns (y, cache)."""
    gate = F.gelu(x @ p["in_gate"].to(x.dtype), approximate="tanh")
    xs = x @ p["in_x"].to(x.dtype)
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = causal_conv1d(xs, p["conv_w"], conv_state)
    xs = xs + p["conv_b"].to(x.dtype)

    a, b = _lru_gates(p, xs)
    h0 = cache["h"] if cache is not None else None
    if cache is not None and x.shape[1] == 1:
        h_last = a[:, 0] * h0.float() + b[:, 0].float()
        h = h_last[:, None]
    else:
        bf = b.float()
        if h0 is not None:
            bf[:, 0] += a[:, 0] * h0.float()
        h = linear_scan(a, bf)
        h_last = h[:, -1]
    y = (h.to(x.dtype) * gate) @ p["out"].to(x.dtype)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_last)
    return y, cache


def rglru_cache_struct(cfg, batch: int, dtype):
    w = cfg.rglru_width
    return dict(conv=TensorStruct((batch, cfg.rglru_conv - 1, w), dtype),
                h=TensorStruct((batch, w), dtype))
