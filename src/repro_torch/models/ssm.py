"""Mamba-2 SSD (state-space duality) mixer block.

The port of the JAX package's ``models/ssm.py``. A prefill (or the
teacher-forced pass) runs the chunked SSD algorithm: attention-like math
within chunks plus a linear recurrence across chunk states. A decode step
is the recurrence with O(1) state:
    h_t = exp(A·dt_t)·h_{t-1} + dt_t·B_t ⊗ x_t,   y_t = C_t·h_t + D·x_t
The cache is (conv tails, recurrent state), written in place.

Precision as the reference's: ``dt`` and ``a`` are float32 from the
projections and cast to the compute dtype before the chunked scan; the
within-chunk decay is masked before ``exp``. The reference's two
four-operand einsums are written as explicit pairwise products (torch
contracts an einsum left to right unless ``opt_einsum`` is installed,
which would materialise a (B, nc, Q, Q, H, P) intermediate): the
elementwise factors first, then one batched matrix product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _pad_seq
from repro_torch.models.layers import (ParamSpec, TensorStruct,
                                       causal_conv1d, rmsnorm)


def ssm_dims(cfg):
    """(d_inner, num_heads); d_inner may be padded for TP divisibility."""
    d_inner = cfg.ssm_d_inner or cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_headdim
    return d_inner, heads


def ssm_specs(cfg) -> dict:
    d = cfg.d_model
    di, nh = ssm_dims(cfg)
    n = cfg.ssm_state
    k = cfg.ssm_conv
    return {
        "wz": ParamSpec((d, di), ("embed", "inner")),
        "wx": ParamSpec((d, di), ("embed", "inner")),
        "wb": ParamSpec((d, n), ("embed", None)),
        "wc": ParamSpec((d, n), ("embed", None)),
        "wdt": ParamSpec((d, nh), ("embed", "heads")),
        "conv_x": ParamSpec((k, di), (None, "inner")),
        "conv_xb": ParamSpec((di,), ("inner",), "zeros"),
        "conv_b": ParamSpec((k, n), (None, None)),
        "conv_bb": ParamSpec((n,), (None,), "zeros"),
        "conv_c": ParamSpec((k, n), (None, None)),
        "conv_cb": ParamSpec((n,), (None,), "zeros"),
        "a_log": ParamSpec((nh,), ("heads",), "zeros"),
        "dt_bias": ParamSpec((nh,), ("heads",), "zeros"),
        "d_skip": ParamSpec((nh,), ("heads",), "ones"),
        "norm": ParamSpec((di,), ("inner",), "zeros"),
        "out_proj": ParamSpec((di, d), ("inner", "embed")),
    }


def _ssd_chunked(x, dt, a, b_in, c_in, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H); a: (H,) negative decay rates;
    b_in/c_in: (B, S, N). Returns (y (B,S,H,P), h_final (B,H,P,N)).
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    nc = -(-s // chunk)
    if nc * chunk != s:
        x, dt, b_in, c_in = (_pad_seq(t, nc * chunk)
                             for t in (x, dt, b_in, c_in))
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_in.reshape(bsz, nc, chunk, n)
    cc = c_in.reshape(bsz, nc, chunk, n)

    da = dtc * a                                # (B, nc, Q, H), negative
    cum = torch.cumsum(da, dim=2)               # within-chunk decay
    total = cum[:, :, -1]                       # (B, nc, H)

    # intra-chunk (causal, attention-like)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,T,H)
    qi = torch.arange(chunk, device=x.device)
    mask = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    # mask BEFORE exp: the upper triangle of li is positive and would
    # overflow exp.
    decay = torch.exp(torch.where(mask, li, -1e9))
    sc = cc @ bc.transpose(-1, -2)                        # (B,nc,Q,T)
    # y_diag[q,h,p] = sum_t sc[q,t] decay[q,t,h] dt[t,h] x[t,h,p]
    w = sc[..., None] * decay * dtc[:, :, None, :, :]     # (B,nc,Q,T,H)
    y_diag = (w.permute(0, 1, 4, 2, 3)                    # (B,nc,H,Q,T)
              @ xc.permute(0, 1, 3, 2, 4))                # (B,nc,H,T,P)
    y_diag = y_diag.permute(0, 1, 3, 2, 4)                # (B,nc,Q,H,P)

    # chunk states: S_c = sum_t exp(total - cum_t) * dt_t * B_t x_t^T
    state_decay = torch.exp(total[:, :, None, :] - cum)  # (B,nc,Q,H)
    u = (state_decay * dtc)[..., None] * xc               # (B,nc,T,H,P)
    states = (u.flatten(3).transpose(-1, -2) @ bc).unflatten(
        2, (h, p))                                        # (B,nc,H,P,N)

    # inter-chunk recurrence over chunk states
    h_prev = (x.new_zeros((bsz, h, p, n)) if h0 is None
              else h0.to(x.dtype))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * torch.exp(total[:, c])[:, :, None, None] + \
            states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (B,nc,H,P,N)

    # inter-chunk contribution: y += C_q exp(cum_q) h_prev
    y_off = (cc @ h_prevs.flatten(2, 3).transpose(-1, -2)).unflatten(
        -1, (h, p))                                       # (B,nc,Q,H,P)
    y_off = y_off * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)
    return y[:, :s], h_prev


def apply_ssm(cfg, p, x, cache=None):
    """x: (B, S, D). cache: None | dict(conv_x, conv_b, conv_c, h), written
    in place. Returns (y (B, S, D), cache)."""
    bsz, s, d = x.shape
    di, nh = ssm_dims(cfg)
    hp = cfg.ssm_headdim

    z = x @ p["wz"].to(x.dtype)
    xs = x @ p["wx"].to(x.dtype)
    b_in = x @ p["wb"].to(x.dtype)
    c_in = x @ p["wc"].to(x.dtype)
    dt_raw = x @ p["wdt"].to(x.dtype)

    cs = cache or {}
    xs, ncx = causal_conv1d(xs, p["conv_x"], cs.get("conv_x"))
    xs = F.silu(xs + p["conv_xb"].to(x.dtype))
    b_in, ncb = causal_conv1d(b_in, p["conv_b"], cs.get("conv_b"))
    b_in = F.silu(b_in + p["conv_bb"].to(x.dtype))
    c_in, ncc = causal_conv1d(c_in, p["conv_c"], cs.get("conv_c"))
    c_in = F.silu(c_in + p["conv_cb"].to(x.dtype))

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())   # (B,S,H)
    a = -torch.exp(p["a_log"].float())                       # (H,) negative

    xh = xs.reshape(bsz, s, nh, hp)
    h0 = cache["h"] if cache is not None else None
    if cache is not None and s == 1:
        da = torch.exp(dt[:, 0] * a[None])                   # (B,H)
        dbx = (dt[:, 0].to(x.dtype)[:, :, None, None]
               * b_in[:, 0][:, None, None, :]) * xh[:, 0][..., None]
        h_last = h0 * da[:, :, None, None].to(x.dtype) + dbx
        y = (h_last @ c_in[:, 0][:, None, :, None])[..., 0][:, None]
    else:
        y, h_last = _ssd_chunked(xh, dt.to(x.dtype), a.to(x.dtype), b_in,
                                 c_in, cfg.ssm_chunk, h0)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = rmsnorm(y * F.silu(z), p["norm"])
    out = y @ p["out_proj"].to(x.dtype)
    if cache is not None:
        cache["conv_x"].copy_(ncx)
        cache["conv_b"].copy_(ncb)
        cache["conv_c"].copy_(ncc)
        cache["h"].copy_(h_last)
    return out, cache


def ssm_cache_struct(cfg, batch: int, dtype):
    di, nh = ssm_dims(cfg)
    n = cfg.ssm_state
    k1 = cfg.ssm_conv - 1
    return dict(
        conv_x=TensorStruct((batch, k1, di), dtype),
        conv_b=TensorStruct((batch, k1, n), dtype),
        conv_c=TensorStruct((batch, k1, n), dtype),
        h=TensorStruct((batch, nh, cfg.ssm_headdim, cfg.ssm_state), dtype))
