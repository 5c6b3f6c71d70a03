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

Under a sharding context the layer runs by heads: each rank holds its
heads' block of ``wz``, ``wx``, ``wdt``, the x conv, ``a_log``,
``dt_bias``, ``d_skip`` and the gated norm's scale, and its rows of
``out_proj`` (a partial sum, which the caller reduces); ``wb``, ``wc``
and the B and C convs are replicated, so B and C are computed whole,
and each rank reads them for its own heads only. The gated norm's mean
runs over the whole (padded) inner dimension: its sum of squares is
summed over "model". The caches are held as
``serve_step.cache_shardings`` lays them out, which is not always by
heads: the state ``h`` (H, P, N) splits its widest dimension, so by the
state N at mamba2-130m's full width (128 > 64 > 24), by heads where H is
widest, or whole where that dimension does not divide; ``conv_b`` and
``conv_c`` split by N where it divides (:func:`cache_layout`). A conv
split by N runs on this rank's N block (its cache keeps that block's
last inputs) and B and C are gathered over "model" where the heads need
them whole. A decode step into a state split by N, or held whole,
gathers the step's x, dt and decay of every head over "model" (a few
KB) and updates every head's state over the N it holds (elementwise,
so as the heads layout would); C·h is summed over those N and
reduce-scattered by heads (or, held whole, sliced). A prefill runs the
chunked scan by heads: its initial state is brought to the heads layout
(a reduce-scatter of the zero-padded N blocks) and its final state
back to the cache's (an all-gather by heads, then this rank's slice).

Training under rules reads no cache, so none of the cache's layouts
applies and the branches that serve them (a conv split by N, a decode
step over every head's state, :func:`_state_to_heads` and
:func:`_state_from_heads`) are never taken: the layer runs by heads from
a zero state. Its backward pass: the gated norm's sum of squares is
summed over "model" forward and its gradient summed over "model" too
(``copy_to(reduce_from(.))``), since every rank's block of the norm's
output reads the whole sum; the replicated leaves of the B/C path are
each rank's part of the gradient (``partial_grad``: each rank's heads
read B and C), summed by the train step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _pad_seq
from repro_torch.models.layers import (ParamSpec, TensorStruct,
                                       causal_conv1d, rmsnorm)
from repro_torch.sharding import ctx as shard
from repro_torch.sharding.rules import channel_split_dim

SSM_AXES = {"wz": ("embed", "inner"), "wx": ("embed", "inner"),
            "wb": ("embed", None), "wc": ("embed", None),
            "wdt": ("embed", "heads"), "out_proj": ("inner", "embed")}


def ssm_dims(cfg):
    """(d_inner, num_heads); d_inner may be padded for TP divisibility."""
    d_inner = cfg.ssm_d_inner or cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_headdim
    return d_inner, heads


def cache_layout(cfg, tp: int) -> dict:
    """How ``serve_step.cache_shardings`` splits the caches over a "model"
    axis of ``tp`` > 1 ranks: ``h`` by "heads", by the "state" N or
    "whole", ``conv_b`` / ``conv_c`` ("bc") by the "state" or "whole".
    Raises ``NotImplementedError`` for a layout the layer does not read:
    ``h`` split by its head dimension P (P the widest), a B/C conv split
    by its taps, or ``conv_x`` not split by its channels."""
    di, nh = ssm_dims(cfg)
    n, k1 = cfg.ssm_state, cfg.ssm_conv - 1
    h = {0: "heads", 2: "state", None: "whole"}.get(
        channel_split_dim((nh, cfg.ssm_headdim, n), tp))
    bc = {1: "state", None: "whole"}.get(channel_split_dim((k1, n), tp))
    if h is None:
        raise NotImplementedError(
            f"{cfg.name}: the SSD state (heads {nh}, head dim "
            f"{cfg.ssm_headdim}, state {n}) splits by its head dimension "
            f"over tp={tp}; only a split by heads, by the state, or none "
            "is read")
    if bc is None or channel_split_dim((k1, di), tp) != 1:
        raise NotImplementedError(
            f"{cfg.name}: the SSD conv caches ({k1} taps, state {n}, inner "
            f"{di}) do not split by channels over tp={tp}")
    return {"h": h, "bc": bc}


def ssm_specs(cfg) -> dict:
    d = cfg.d_model
    di, nh = ssm_dims(cfg)
    n = cfg.ssm_state
    k = cfg.ssm_conv
    return {
        "wz": ParamSpec((d, di), ("embed", "inner")),
        "wx": ParamSpec((d, di), ("embed", "inner")),
        "wb": ParamSpec((d, n), ("embed", None), partial_grad=True),
        "wc": ParamSpec((d, n), ("embed", None), partial_grad=True),
        "wdt": ParamSpec((d, nh), ("embed", "heads")),
        "conv_x": ParamSpec((k, di), (None, "inner")),
        "conv_xb": ParamSpec((di,), ("inner",), "zeros"),
        "conv_b": ParamSpec((k, n), (None, None), partial_grad=True),
        "conv_bb": ParamSpec((n,), (None,), "zeros", partial_grad=True),
        "conv_c": ParamSpec((k, n), (None, None), partial_grad=True),
        "conv_cb": ParamSpec((n,), (None,), "zeros", partial_grad=True),
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


def _gated_norm(y, z, scale, width: int, eps: float = 1e-6):
    """rmsnorm(y * silu(z), scale) over a dimension split over "model":
    the sum of squares summed over "model" and divided by the whole
    ``width``. Under autograd its gradient is summed over "model" too
    (Megatron's "g" then "f"): each rank normalises its own block by the
    whole sum, so each holds only its block's part of the sum's
    gradient."""
    g = y * F.silu(z)
    xf = g.float()
    mesh = shard.current_mesh()
    ss = mesh.copy_to(mesh.reduce_from(
        xf.square().sum(dim=-1, keepdim=True), "model"), "model")
    out = xf * torch.rsqrt(ss / width + eps)
    return (out * (1.0 + scale.float())).to(g.dtype)


def _state_to_heads(h, layout: str, nh: int):
    """A cache state in ``layout`` -> this rank's heads, every N."""
    if layout == "heads":
        return h
    if layout == "whole":
        return shard.model_block(h, 1)
    n_all = h.shape[-1] * shard.model_axis()[0]
    full = h.new_zeros(h.shape[:1] + (nh,) + h.shape[2:3] + (n_all,))
    shard.model_block(full, 3).copy_(h)
    return shard.current_mesh().reduce_scatter(full, "model", 1)


def _state_from_heads(h, layout: str):
    """This rank's heads' state -> the cache's ``layout``."""
    if layout == "heads":
        return h
    h = shard.current_mesh().all_gather(h, "model", 1)
    return h if layout == "whole" else shard.model_block(h, 3)


def apply_ssm(cfg, p, x, cache=None):
    """x: (B, S, D). cache: None | dict(conv_x, conv_b, conv_c, h), written
    in place. Returns (y (B, S, D), cache); under a sharding context ``y``
    is this rank's partial sum and the cache its blocks (see the
    module). Without a cache (training, the teacher-forced pass) the
    cache's layout is not read."""
    bsz, s, d = x.shape
    di, nh = ssm_dims(cfg)
    hp = cfg.ssm_headdim
    p = shard.gathered(p, SSM_AXES)
    tp, _ = shard.model_axis()
    mesh = shard.current_mesh()
    layout = cache_layout(cfg, tp) if tp > 1 and cache is not None \
        else None
    dil, nhl = p["wx"].shape[1], p["wdt"].shape[1]
    decode = cache is not None and s == 1
    # a decode step over the state of every head (split by N or whole)
    all_heads = decode and layout is not None and layout["h"] != "heads"

    z = x @ p["wz"].to(x.dtype)
    xs = x @ p["wx"].to(x.dtype)
    b_in = x @ p["wb"].to(x.dtype)
    c_in = x @ p["wc"].to(x.dtype)
    dt_raw = x @ p["wdt"].to(x.dtype)

    cs = cache or {}
    xs, ncx = causal_conv1d(xs, p["conv_x"], cs.get("conv_x"))
    xs = F.silu(xs + p["conv_xb"].to(x.dtype))
    bc_split = cache is not None and layout is not None and \
        layout["bc"] == "state"
    # the conv of this rank's N block where its cache holds that block
    part = shard.model_block if bc_split else (lambda t, _: t)
    b_in, ncb = causal_conv1d(part(b_in, 2), part(p["conv_b"], 1),
                              cs.get("conv_b"))
    b_in = F.silu(b_in + part(p["conv_bb"], 0).to(x.dtype))
    c_in, ncc = causal_conv1d(part(c_in, 2), part(p["conv_c"], 1),
                              cs.get("conv_c"))
    c_in = F.silu(c_in + part(p["conv_cb"], 0).to(x.dtype))
    state_split = all_heads and layout["h"] == "state"
    if bc_split and not state_split:        # the heads read every N
        bc = mesh.all_gather(torch.cat([b_in, c_in], dim=-1), "model", 2)
        bc = bc.unflatten(-1, (tp, 2, -1))
        b_in, c_in = bc[..., 0, :].flatten(-2), bc[..., 1, :].flatten(-2)
    elif state_split and not bc_split:      # the state reads its N block
        b_in, c_in = shard.model_block(b_in, 2), shard.model_block(c_in, 2)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())   # (B,S,H)
    a = -torch.exp(p["a_log"].float())                       # (H,) negative

    xh = xs.reshape(bsz, s, nhl, hp)
    h0 = cache["h"] if cache is not None else None
    if all_heads:
        # every head's x, dt and decay of this step, in one gather
        da = torch.exp(dt[:, 0] * a[None])                   # (B,Hl)
        g = mesh.all_gather(torch.cat([xs[:, 0].float(), dt[:, 0], da],
                                      dim=-1), "model", 1)
        g = g.unflatten(1, (tp, -1))
        x_all = g[..., :dil].reshape(bsz, nh, hp).to(x.dtype)
        dt_all = g[..., dil:dil + nhl].reshape(bsz, nh)
        da_all = g[..., dil + nhl:].reshape(bsz, nh)
        dbx = (dt_all.to(x.dtype)[:, :, None, None]
               * b_in[:, 0][:, None, None, :]) * x_all[..., None]
        h_last = h0 * da_all[:, :, None, None].to(x.dtype) + dbx
        y_all = (h_last @ c_in[:, 0][:, None, :, None])[..., 0]
        y = (mesh.reduce_scatter(y_all, "model", 1) if state_split
             else shard.model_block(y_all, 1))[:, None]
    elif decode:
        da = torch.exp(dt[:, 0] * a[None])                   # (B,H)
        dbx = (dt[:, 0].to(x.dtype)[:, :, None, None]
               * b_in[:, 0][:, None, None, :]) * xh[:, 0][..., None]
        h_last = h0 * da[:, :, None, None].to(x.dtype) + dbx
        y = (h_last @ c_in[:, 0][:, None, :, None])[..., 0][:, None]
    else:
        if layout is not None and h0 is not None:
            h0 = _state_to_heads(h0, layout["h"], nh)
        y, h_last = _ssd_chunked(xh, dt.to(x.dtype), a.to(x.dtype), b_in,
                                 c_in, cfg.ssm_chunk, h0)
        if layout is not None and cache is not None:
            h_last = _state_from_heads(h_last, layout["h"])
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, dil)
    if tp == 1:
        y = rmsnorm(y * F.silu(z), p["norm"])
    else:
        y = _gated_norm(y, z, p["norm"], di)
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
