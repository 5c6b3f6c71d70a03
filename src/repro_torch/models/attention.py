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
from repro_torch.sharding import ctx as shard
from repro_torch.sharding.rules import kv_cache_split

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
    # the latent projections and norms are held whole on "model", and each
    # rank's heads give part of their gradient
    return {
        "wdq": ParamSpec((d, qr), ("embed", None), partial_grad=True),
        "q_norm": ParamSpec((qr,), (None,), "zeros", partial_grad=True),
        "wuq": ParamSpec((qr, heads, nope + rope_d), (None, "heads", None)),
        "wdkv": ParamSpec((d, kvr), ("embed", None), partial_grad=True),
        "kv_norm": ParamSpec((kvr,), (None,), "zeros", partial_grad=True),
        "wkr": ParamSpec((d, rope_d), ("embed", None), partial_grad=True),
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


GQA_AXES = {"wq": ("embed", "heads", None), "wk": ("embed", "kv", None),
            "wv": ("embed", "kv", None), "wo": ("heads", None, "embed"),
            "bq": ("heads", None), "bk": ("kv", None), "bv": ("kv", None)}


def layer_cache_len(cfg, kind: str, max_len: int) -> int:
    """The length of a layer's cache for ``max_len`` positions: a local
    layer's ring of ``local_window`` slots when ``max_len`` is longer,
    else ``max_len``. Local layers keep an O(window) ring buffer; chunked
    layers stay full-length (their sibling global layers need the full
    cache anyway)."""
    if kind == "local" and cfg.local_window and max_len > cfg.local_window:
        return cfg.local_window
    return max_len


def gqa_attention(cfg, p, x, kind: str, positions, cache=None,
                  heads: int = 0, kv_heads: int = 0, cache_len: int = 0):
    """x: (B, S, D); positions: (S,) int32. cache: None (no cache, the
    teacher-forced pass) or dict(k, v) of (B, T, K, Dh), which prefill
    fills and a decode step (S == 1) writes at ``positions[0]``, both in
    place. Returns (out, cache).

    Under a sharding context: ``x`` is the whole sequence of this rank's
    batch rows; Q runs on this rank's heads, K and V on its KV heads when
    they are sharded, else on all of them (each local q head ``h`` reading
    KV head ``h // g``); ``wo`` is row-parallel, so ``out`` is this rank's
    partial sum. The cache is this rank's block per
    ``serve_step.cache_shardings`` for ``cache_len`` positions: by heads,
    whole, or by sequence when the KV heads cannot be split. A decode step
    into a sequence-split cache writes its position on the rank that owns
    it, each rank attends all heads over its own positions, and the parts
    are combined over "model" (global max, then the softmax's sum, then
    the weighted values)."""
    b, s, d = x.shape
    hd = cfg.head_dim
    g = heads // kv_heads
    p = shard.gathered(p, GQA_AXES)
    tp, t = shard.model_axis()

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
    hl, kl = q.shape[2], k.shape[2]
    # the KV head of each local q head: the local KV heads in groups of g
    # (KV sharded with the q heads, or one rank), else an index into all
    sel = None if kl * g == hl else \
        (t * hl + torch.arange(hl, device=x.device)) // g

    seq_split = False
    if cache is None:
        glen = 0
    elif shard.active() and tp > 1:
        if not cache_len:
            raise ValueError("a sharded cache needs its global length")
        glen = layer_cache_len(cfg, kind, cache_len)
        seq_split = kv_cache_split(shard.current_rules(), kv_heads, glen,
                                   tp) == "seq"
    else:
        glen = cache["k"].shape[1]
    ring = bool(cache is not None and kind == "local" and cfg.local_window
                and glen == cfg.local_window)
    lo = t * (glen // tp) if seq_split else 0
    if cache is None:                       # no cache
        kk, vv = k, v
        k_positions = positions
    elif seq_split and s == 1:              # decode into this rank's block
        out = _decode_seq_split(cfg, kind, q, k, v, cache, positions, ring,
                                glen, lo, tp, t, kv_heads, g)
        y = out.reshape(b, s, hl * hd) @ p["wo"].to(x.dtype).reshape(
            hl * hd, d)
        return y, cache
    elif seq_split:                         # prefill: write owned positions
        w = glen if ring else 0
        start = s - min(s, w) if ring else 0
        ppos = torch.arange(start, s, dtype=torch.int64, device=x.device)
        slot = ppos % w if ring else ppos
        owned = (slot >= lo) & (slot < lo + cache["k"].shape[1])
        cache["k"][:, slot[owned] - lo] = k[:, start:][:, owned]
        cache["v"][:, slot[owned] - lo] = v[:, start:][:, owned]
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
        t_len = cache["k"].shape[1]
        # dynamic_update_slice clamps the start so the write fits
        at = positions[:1].clamp(0, t_len - 1).long()
        cache["k"].index_copy_(1, at, k)
        cache["v"].index_copy_(1, at, v)
        kk, vv = cache["k"], cache["v"]
        k_positions = torch.arange(t_len, dtype=torch.int32, device=x.device)
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

    if sel is None:
        qg = q.reshape(b, s, kl, hl // kl, hd)
    else:
        qg = q.reshape(b, s, hl, 1, hd)
        kk, vv = kk[:, :, sel], vv[:, :, sel]
    out = sdpa(qg, kk, vv, kind, cfg.local_window, cfg.chunk_size,
               positions, k_positions)
    y = out.reshape(b, s, hl * hd) @ p["wo"].to(x.dtype).reshape(
        hl * hd, d)
    return y, cache


def _decode_seq_split(cfg, kind, q, k, v, cache, positions, ring: bool,
                      glen: int, lo: int, tp: int, t: int, kv_heads: int,
                      g: int):
    """One decode step's attention over a cache split by sequence over
    "model" (this rank holds positions or ring slots [lo, lo + T/tp)):
    the step's K and V written on the rank that owns its slot, every head's
    scores over this rank's slots, then the softmax and the weighted values
    combined over "model". Returns this rank's heads' output (B, 1, Hl,
    Dh)."""
    mesh = shard.current_mesh()
    b, _, hl, hd = q.shape
    n = cache["k"].shape[1]
    pos = positions[0]
    slot = pos % glen if ring else pos.clamp(0, glen - 1)
    at = (slot - lo).long()
    owned = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1)[None]
    for name, new in (("k", k), ("v", v)):
        old = cache[name].index_select(1, at)
        cache[name].index_copy_(1, at, torch.where(owned, new, old))
    iota = lo + torch.arange(n, dtype=torch.int32, device=q.device)
    if ring:
        p_i = pos - ((pos - iota) % glen)
        k_positions = torch.where(p_i >= 0, p_i, _UNWRITTEN).to(torch.int32)
    else:
        k_positions = iota
    qa = mesh.all_gather(q, "model", 2).reshape(b, 1, kv_heads, g, hd)
    scores = _scores(qa, cache["k"]) * hd ** -0.5
    ok = _mask_value(kind, positions[:, None], k_positions[None, :],
                     cfg.local_window, cfg.chunk_size)
    scores = torch.where(ok, scores, NEG_INF)
    o = shard.combine_seq_split(scores, cache["v"], "bkgst,btkd->bskgd",
                                v.dtype)
    return o.reshape(b, 1, tp * hl, hd)[:, :, t * hl:(t + 1) * hl]


# ---------------------------------------------------------------- mla module

MLA_AXES = {"wdq": ("embed", None), "wuq": (None, "heads", None),
            "wdkv": ("embed", None), "wkr": ("embed", None),
            "wuk": (None, "heads", None), "wuv": (None, "heads", None),
            "wo": ("heads", None, "embed")}


def mla_attention(cfg, p, x, kind: str, positions, cache=None,
                  heads: int = 0, cache_len: int = 0):
    """MiniCPM3-style MLA. x: (B, S, D); cache: None or dict(ckv, k_rope)
    of (B, T, kv_lora_rank) / (B, T, qk_rope_dim), which a prefill writes
    from slot 0 and a decode step at ``positions[0]``, in place. A prefill
    expands K and V from the latent and attends through :func:`sdpa`; a
    decode step attends in the latent space over every slot at or before
    its position (no window, no chunk). Scores are float32 in both.

    Under a sharding context: the heads are this rank's (``wuq``, ``wuk``,
    ``wuv`` and the row-parallel ``wo``: ``out`` is a partial sum); the
    latent ``ckv`` and ``k_rope`` are computed whole on every rank. The
    cache (``cache_len`` positions) is split by sequence over "model"
    when "model" divides its length (``serve_step.cache_shardings``),
    else held whole. Split, a prefill writes the positions this rank
    owns and a decode step writes its position on the rank that owns it;
    the step's ``q_abs`` and ``q_rope`` are gathered over "model", each
    rank scores every head over its own positions, and the latent context
    is combined over "model" (:func:`shard.combine_seq_split`).

    Training takes the prefill path with no cache under autograd, under
    the TP rules (this rank's heads; the latent's gradient is partial on
    each rank, the leaves of ``partial_grad`` in :func:`mla_specs`) and
    under ``no_tp`` (every head). It
    reaches no collective but the weights' gathers."""
    b, s, d = x.shape
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p = shard.gathered(p, MLA_AXES)
    tp, t = shard.model_axis()

    cq = rmsnorm(x @ p["wdq"].to(x.dtype), p["q_norm"])
    q = _project(cq, p["wuq"])
    hl = q.shape[2]
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_freqs(rope_d, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)

    ckv = rmsnorm(x @ p["wdkv"].to(x.dtype), p["kv_norm"])
    k_rope = apply_rope((x @ p["wkr"].to(x.dtype))[:, :, None, :],
                        cos, sin)[:, :, 0]  # (B, S, rope_d), head-shared

    seq_split = False
    if cache is not None and shard.active() and tp > 1:
        if not cache_len:
            raise ValueError("a sharded cache needs its global length")
        seq_split = shard.current_rules().seq_shard_cache and \
            cache_len % tp == 0
    n = cache["ckv"].shape[1] if cache is not None else 0
    glen = cache_len if seq_split else n
    lo = t * n if seq_split else 0

    decode = cache is not None and s == 1
    if decode:
        # dynamic_update_slice clamps the start so the write fits; a split
        # cache is written on the rank that owns the slot
        at = (positions[:1].clamp(0, glen - 1) - lo).long()
        owned = (at >= 0) & (at < n)
        at = at.clamp(0, n - 1)
        for name, new in (("ckv", ckv), ("k_rope", k_rope)):
            if seq_split:
                new = torch.where(owned, new, cache[name].index_select(1, at))
            cache[name].index_copy_(1, at, new)
        ckv_all, kr_all = cache["ckv"], cache["k_rope"]
        k_positions = lo + torch.arange(n, dtype=torch.int32,
                                        device=x.device)
    else:
        if seq_split:                   # this rank's positions only
            hi = min(s, lo + n)
            if hi > lo:
                cache["ckv"][:, :hi - lo] = ckv[:, lo:hi]
                cache["k_rope"][:, :hi - lo] = k_rope[:, lo:hi]
        elif cache is not None:
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
        if seq_split:
            qa = shard.current_mesh().all_gather(
                torch.cat([q_abs, q_rope], dim=-1), "model", 2)
            q_abs, q_rope = qa[..., :-rope_d], qa[..., -rope_d:]
        sc = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv_all.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             kr_all.float())) * scale
        ok = k_positions[None, :] <= positions[:, None]
        sc = torch.where(ok, sc, NEG_INF)
        if seq_split:
            ctx = shard.combine_seq_split(sc, ckv_all, "bhst,btr->bshr",
                                          x.dtype)[:, :, t * hl:(t + 1) * hl]
        else:
            w = torch.softmax(sc, dim=-1).to(x.dtype)
            ctx = torch.einsum("bhst,btr->bshr", w, ckv_all)
        out = torch.einsum("bshr,rhk->bshk", ctx, wuv)
    else:
        kvr = ckv_all.shape[-1]
        k_nope = (ckv_all @ wuk.reshape(kvr, hl * nope)).unflatten(
            -1, (hl, nope))
        vfull = (ckv_all @ wuv.reshape(kvr, hl * vd)).unflatten(
            -1, (hl, vd))
        k_full = torch.cat(
            [k_nope, kr_all[:, :, None, :].expand(-1, -1, hl, rope_d)],
            dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        qg = q_full.reshape(b, s, hl, 1, nope + rope_d)
        out = sdpa(qg, k_full, vfull, kind, cfg.local_window, cfg.chunk_size,
                   positions, k_positions)
        out = out.reshape(b, s, hl, vd)
    y = out.reshape(b, s, hl * vd) @ p["wo"].to(x.dtype).reshape(
        hl * vd, d)
    return y, cache


def gqa_cache_struct(cfg, batch: int, max_len: int, kv_heads: int, dtype):
    shape = (batch, max_len, kv_heads, cfg.head_dim)
    return dict(k=TensorStruct(shape, dtype), v=TensorStruct(shape, dtype))


def mla_cache_struct(cfg, batch: int, max_len: int, dtype):
    return dict(ckv=TensorStruct((batch, max_len, cfg.kv_lora_rank), dtype),
                k_rope=TensorStruct((batch, max_len, cfg.qk_rope_dim), dtype))
