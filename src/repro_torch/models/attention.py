"""Attention: GQA and MLA, with sliding-window and chunked masks and KV
caches.

The port of the JAX package's ``models/attention.py``. Variants:
  * gqa      grouped-query attention, optional QKV bias, RoPE.
  * mla      multi-head latent attention (MiniCPM3): the cache holds the
             compressed ``ckv`` and the head-shared ``k_rope``; a decode
             step is absorbed (q projected into the latent space, scores
             taken against the compressed cache, which never re-expands).
Layer kinds:
  * global   full causal attention.
  * local    sliding-window mask; a decode cache longer than the window is
             an O(window) ring buffer.
  * chunked  chunk-local causal mask.

Plain torch operations that mirror the reference's numerics: the scores
accumulate in float32 and are scaled after the product, masked scores are
``NEG_INF`` (not -inf), the softmax runs in float32 and is cast to the
values' dtype before the PV product. ``F.scaled_dot_product_attention``
is not used: its softmax runs in another precision and order. Past
``s * t > 4096**2`` (or when forced) the scores are taken blockwise with
an online softmax, as the reference scans them.

Caches are updated in place: prefill writes the prompt's K and V at offset
0, a decode step writes position ``pos``; nothing is concatenated or
cloned per token.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import (ParamSpec, TensorStruct, apply_rope,
                                       rmsnorm, rope_freqs)

BLOCK_Q = 1024
BLOCK_KV = 1024
NEG_INF = -1e30
_UNWRITTEN = 2 ** 30        # the position of a ring slot not yet written


# ---------------------------------------------------------------- specs

def gqa_specs(cfg, heads: int, kv_heads: int) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, heads, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, kv_heads, hd), ("embed", "kv", None)),
        "wv": ParamSpec((d, kv_heads, hd), ("embed", "kv", None)),
        "wo": ParamSpec((heads, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((heads, hd), ("heads", None), "zeros")
        specs["bk"] = ParamSpec((kv_heads, hd), ("kv", None), "zeros")
        specs["bv"] = ParamSpec((kv_heads, hd), ("kv", None), "zeros")
    return specs


def mla_specs(cfg, heads: int) -> dict:
    d = cfg.d_model
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wdq": ParamSpec((d, qr), ("embed", None)),
        "q_norm": ParamSpec((qr,), (None,), "zeros"),
        "wuq": ParamSpec((qr, heads, nope + rope_d), (None, "heads", None)),
        "wdkv": ParamSpec((d, kvr), ("embed", None)),
        "kv_norm": ParamSpec((kvr,), (None,), "zeros"),
        "wkr": ParamSpec((d, rope_d), ("embed", None)),
        "wuk": ParamSpec((kvr, heads, nope), (None, "heads", None)),
        "wuv": ParamSpec((kvr, heads, vd), (None, "heads", None)),
        "wo": ParamSpec((heads, vd, d), ("heads", None, "embed")),
    }


# ---------------------------------------------------------------- masks

def _mask_value(kind: str, q_pos, k_pos, window: int, chunk: int):
    """True where attention is allowed."""
    ok = k_pos <= q_pos
    if kind == "local" and window:
        ok = ok & (k_pos > q_pos - window)
    if kind == "chunked" and chunk:
        ok = ok & ((k_pos // chunk) == (q_pos // chunk))
    return ok


# ---------------------------------------------------------------- core sdpa

def _scores(q, k):
    """(B, S, K, G, Dh) x (B, T, K, Dh) -> (B, K, G, S, T) in float32 (the
    reference's ``preferred_element_type``: a bf16 product is exact in
    float32, so casting first accumulates the same terms)."""
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())


def _sdpa_full(q, k, v, kind, window, chunk, q_positions, k_positions):
    """Materialized-scores attention for short sequences.

    q: (B, S, K, G, Dh); k/v: (B, T, K, Dh). Returns (B, S, K, G, Dh)."""
    scale = q.shape[-1] ** -0.5
    scores = _scores(q, k) * scale
    ok = _mask_value(kind, q_positions[:, None], k_positions[None, :],
                     window, chunk)
    scores = torch.where(ok, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)


def _pad_seq(x, n: int, value=0):
    """``x`` padded along axis 1 (or axis 0 if 1-D) to length ``n``."""
    axis = 1 if x.dim() > 1 else 0
    extra = n - x.shape[axis]
    if not extra:
        return x
    shape = list(x.shape)
    shape[axis] = extra
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def _sdpa_blockwise(q, k, v, kind, window, chunk, q_positions, k_positions):
    """Online-softmax attention over KV blocks, one Q block at a time.

    dh (q/k) and dv (v) may differ."""
    b, s, kh, g, dh = q.shape
    t = k.shape[1]
    dv = v.shape[-1]
    scale = dh ** -0.5
    nq = -(-s // BLOCK_Q)
    nk = -(-t // BLOCK_KV)
    qp = _pad_seq(q, nq * BLOCK_Q)
    kp = _pad_seq(k, nk * BLOCK_KV)
    vp = _pad_seq(v, nk * BLOCK_KV)
    qpos = _pad_seq(q_positions, nq * BLOCK_Q, -(10 ** 9))
    kpos = _pad_seq(k_positions, nk * BLOCK_KV, _UNWRITTEN)

    outs = []
    for i in range(nq):
        qi = qp[:, i * BLOCK_Q:(i + 1) * BLOCK_Q]
        qpos_i = qpos[i * BLOCK_Q:(i + 1) * BLOCK_Q]
        m = torch.full((b, kh, g, BLOCK_Q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kh, g, BLOCK_Q), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, kh, g, BLOCK_Q, dv), dtype=v.dtype,
                          device=q.device)
        for j in range(nk):
            kj = kp[:, j * BLOCK_KV:(j + 1) * BLOCK_KV]
            vj = vp[:, j * BLOCK_KV:(j + 1) * BLOCK_KV]
            kpos_j = kpos[j * BLOCK_KV:(j + 1) * BLOCK_KV]
            sc = _scores(qi, kj) * scale
            ok = _mask_value(kind, qpos_i[:, None], kpos_j[None, :],
                             window, chunk)
            sc = torch.where(ok, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgst,btkd->bkgsd", p.to(vj.dtype), vj)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (b, BLOCK_Q, kh, g, dv)
    return torch.cat(outs, dim=1)[:, :s]


def sdpa(q, k, v, kind, window, chunk, q_positions, k_positions,
         force_blockwise: Optional[bool] = None):
    s, t = q.shape[1], k.shape[1]
    blockwise = (s * t > 4096 * 4096) if force_blockwise is None \
        else force_blockwise
    fn = _sdpa_blockwise if blockwise else _sdpa_full
    return fn(q, k, v, kind, window, chunk, q_positions, k_positions)


# ---------------------------------------------------------------- gqa module

def _project(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).unflatten(-1, (h, hd))


def gqa_attention(cfg, p, x, kind: str, positions, cache=None,
                  heads: int = 0, kv_heads: int = 0):
    """x: (B, S, D); positions: (S,) int32. cache: None (no cache, the
    teacher-forced pass) or dict(k, v) of (B, T, K, Dh), which prefill
    fills and a decode step (S == 1) writes at ``positions[0]``, both in
    place. Returns (out, cache)."""
    b, s, d = x.shape
    hd = cfg.head_dim
    g = heads // kv_heads

    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    ring = (cache is not None and kind == "local" and cfg.local_window
            and cache["k"].shape[1] == cfg.local_window)
    if cache is None:                       # no cache
        kk, vv = k, v
        k_positions = positions
    elif s == 1 and ring:                   # decode into the ring buffer
        w = cfg.local_window
        pos = positions[0]
        slot = (pos % w).long()[None]
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        kk, vv = cache["k"], cache["v"]
        # slot i holds position = i (mod w) in (pos-w, pos]; unwritten
        # slots decode to negative positions: push them past the causal
        # mask.
        iota = torch.arange(w, dtype=torch.int32, device=x.device)
        p_i = pos - ((pos - iota) % w)
        k_positions = torch.where(p_i >= 0, p_i, _UNWRITTEN).to(torch.int32)
    elif s == 1:                            # decode step at positions[0]
        t = cache["k"].shape[1]
        # dynamic_update_slice clamps the start so the write fits
        at = positions[:1].clamp(0, t - 1).long()
        cache["k"].index_copy_(1, at, k)
        cache["v"].index_copy_(1, at, v)
        kk, vv = cache["k"], cache["v"]
        k_positions = torch.arange(t, dtype=torch.int32, device=x.device)
    elif ring:                              # prefill the ring: last w tokens
        w = cfg.local_window
        tail = min(s, w)
        start = s - tail
        ppos = start + torch.arange(tail, dtype=torch.int64, device=x.device)
        cache["k"][:, ppos % w] = k[:, start:]
        cache["v"][:, ppos % w] = v[:, start:]
        kk, vv = k, v
        k_positions = positions
    else:                                   # prefill: fill cache, attend local
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        kk, vv = k, v
        k_positions = positions

    qg = q.reshape(b, s, kv_heads, g, hd)
    out = sdpa(qg, kk, vv, kind, cfg.local_window, cfg.chunk_size,
               positions, k_positions)
    y = out.reshape(b, s, heads * hd) @ p["wo"].to(x.dtype).reshape(
        heads * hd, d)
    return y, cache


# ---------------------------------------------------------------- mla module

def mla_attention(cfg, p, x, kind: str, positions, cache=None,
                  heads: int = 0):
    """MiniCPM3-style MLA. x: (B, S, D); cache: None or dict(ckv, k_rope)
    of (B, T, kv_lora_rank) / (B, T, qk_rope_dim), which a prefill writes
    from slot 0 and a decode step at ``positions[0]``, in place. A prefill
    expands K and V from the latent and attends through :func:`sdpa`; a
    decode step attends in the latent space over every slot at or before
    its position (no window, no chunk). Scores are float32 in both."""
    b, s, d = x.shape
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    cq = rmsnorm(x @ p["wdq"].to(x.dtype), p["q_norm"])
    q = _project(cq, p["wuq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_freqs(rope_d, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)

    ckv = rmsnorm(x @ p["wdkv"].to(x.dtype), p["kv_norm"])
    k_rope = apply_rope((x @ p["wkr"].to(x.dtype))[:, :, None, :],
                        cos, sin)[:, :, 0]  # (B, S, rope_d), head-shared

    decode = cache is not None and s == 1
    if decode:
        t = cache["ckv"].shape[1]
        # dynamic_update_slice clamps the start so the write fits
        at = positions[:1].clamp(0, t - 1).long()
        cache["ckv"].index_copy_(1, at, ckv)
        cache["k_rope"].index_copy_(1, at, k_rope)
        ckv_all, kr_all = cache["ckv"], cache["k_rope"]
        k_positions = torch.arange(t, dtype=torch.int32, device=x.device)
    else:
        if cache is not None:
            cache["ckv"][:, :s] = ckv
            cache["k_rope"][:, :s] = k_rope
        ckv_all, kr_all = ckv, k_rope
        k_positions = positions

    scale = (nope + rope_d) ** -0.5
    wuk, wuv = p["wuk"].to(x.dtype), p["wuv"].to(x.dtype)
    if decode:
        # Absorbed decode: project q into latent space; never expand the
        # cache.
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, wuk)
        sc = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv_all.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             kr_all.float())) * scale
        ok = k_positions[None, :] <= positions[:, None]
        sc = torch.where(ok, sc, NEG_INF)
        w = torch.softmax(sc, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhst,btr->bshr", w, ckv_all)
        out = torch.einsum("bshr,rhk->bshk", ctx, wuv)
    else:
        kvr = ckv_all.shape[-1]
        k_nope = (ckv_all @ wuk.reshape(kvr, heads * nope)).unflatten(
            -1, (heads, nope))
        vfull = (ckv_all @ wuv.reshape(kvr, heads * vd)).unflatten(
            -1, (heads, vd))
        k_full = torch.cat(
            [k_nope, kr_all[:, :, None, :].expand(-1, -1, heads, rope_d)],
            dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        qg = q_full.reshape(b, s, heads, 1, nope + rope_d)
        out = sdpa(qg, k_full, vfull, kind, cfg.local_window, cfg.chunk_size,
                   positions, k_positions)
        out = out.reshape(b, s, heads, vd)
    y = out.reshape(b, s, heads * vd) @ p["wo"].to(x.dtype).reshape(
        heads * vd, d)
    return y, cache


def gqa_cache_struct(cfg, batch: int, max_len: int, kv_heads: int, dtype):
    shape = (batch, max_len, kv_heads, cfg.head_dim)
    return dict(k=TensorStruct(shape, dtype), v=TensorStruct(shape, dtype))


def mla_cache_struct(cfg, batch: int, max_len: int, dtype):
    return dict(ckv=TensorStruct((batch, max_len, cfg.kv_lora_rank), dtype),
                k_rope=TensorStruct((batch, max_len, cfg.qk_rope_dim), dtype))
