"""Encoder-decoder backbone (Whisper-medium): an encoder over precomputed
frame embeddings (the conv frontend is a stub, as in the reference) and a
causal decoder with per-layer cross-attention.

The port of the JAX package's ``models/encdec.py``. The encoder's layers
are kind ``bidir``, which the reference's mask treats as causal; the port
keeps that. Cross-attention has no RoPE and no mask. Decode caches: the
decoder's self-attention K/V (written in place) and the per-layer cross
K/V, projected once from the encoder's output at prefill and carried.

Under a sharding context the encoder's and the decoder's residuals take
the rules' ``act_btd`` layout, as ``transformer.apply_layer``'s do: the
frames are split by sequence in a prefill (padded to a multiple of
"model"), each sublayer's input is gathered whole and its row-parallel
output reduced back. The encoder's output is gathered whole before the
cross K/V are projected, and each rank keeps its block of the cross
cache in the layout ``serve_step.cache_shardings`` gives it
(:func:`cross_layout`): its KV heads, its encoder positions (when the KV
heads do not divide "model"; the cross-attention then combines the
ranks' positions as a sequence-split decode does), or all of it.

Training under rules reads no cache: the cross K/V take the reference's
training layout (``act_bskd``: this rank's KV heads, or every head where
they do not divide "model"), never the encoder positions, so the
combine over "model", which has no adjoint, is never reached. The
encoder's output is gathered whole by the gather whose adjoint sums
over "model" (``shard.gather_seq``: every rank's cross K/V projection
reads all of it for its own heads). As in the reference only the
decoder's layers are recomputed in the backward pass; the encoder's are
not.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamSpec, TensorStruct, apply_mlp,
                                       apply_norm, mlp_specs, norm_specs,
                                       tree_map)
from repro_torch.models.transformer import _slice, _stack, with_remat
from repro_torch.sharding import ctx as shard
from repro_torch.sharding.rules import kv_cache_split

CROSS_AXES = {k: attn.GQA_AXES[k] for k in ("wq", "wk", "wv", "wo")}


def cross_specs(cfg, heads: int, kv_heads: int) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": ParamSpec((d, heads, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, kv_heads, hd), ("embed", "kv", None)),
        "wv": ParamSpec((d, kv_heads, hd), ("embed", "kv", None)),
        "wo": ParamSpec((heads, hd, d), ("heads", None, "embed")),
    }


def enc_layer_specs(cfg, heads, kv_heads) -> dict:
    return {
        "norm1": norm_specs(cfg),
        "attn": attn.gqa_specs(cfg, heads, kv_heads),
        "norm2": norm_specs(cfg),
        "mlp": mlp_specs(cfg),
    }


def dec_layer_specs(cfg, heads, kv_heads) -> dict:
    return {
        "norm1": norm_specs(cfg),
        "self_attn": attn.gqa_specs(cfg, heads, kv_heads),
        "norm_x": norm_specs(cfg),
        "cross": cross_specs(cfg, heads, kv_heads),
        "norm2": norm_specs(cfg),
        "mlp": mlp_specs(cfg),
    }


def encdec_specs(cfg, heads: int, kv_heads: int) -> dict:
    return {
        "encoder": _stack(enc_layer_specs(cfg, heads, kv_heads),
                          cfg.encoder_layers),
        "enc_norm": norm_specs(cfg),
        "decoder": _stack(dec_layer_specs(cfg, heads, kv_heads),
                          cfg.num_layers),
    }


def cross_layout(cfg, kv_heads: int) -> str:
    """How this rank holds the cross K/V: "heads" (its KV heads), "seq"
    (its encoder positions), "whole", or "one" outside a context or on
    one rank. Serving follows ``serve_step.cache_shardings``' rule for a
    KV cache; the train rules follow the reference's ``act_bskd`` (by
    heads where the rules shard them, else whole)."""
    tp, _ = shard.model_axis()
    if tp == 1:
        return "one"
    rules = shard.current_rules()
    if rules.mode == "train":
        return "heads" if rules.kv_sharded else "whole"
    return kv_cache_split(rules, kv_heads, cfg.encoder_len, tp) or "whole"


def _cross_attend(cfg, p, x, ck, cv, heads, kv_heads):
    """Cross-attention of ``x`` over the encoder's K/V; under a sharding
    context this rank's heads (its partial sum through ``wo``) over
    ``ck`` / ``cv`` in :func:`cross_layout`'s layout."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    g = heads // kv_heads
    p = shard.gathered(p, CROSS_AXES)
    tp, t = shard.model_axis()
    q = attn._project(x, p["wq"])
    hl = q.shape[2]
    if cross_layout(cfg, kv_heads) == "seq":
        # every head over this rank's encoder positions, then combined
        qa = shard.current_mesh().all_gather(q, "model", 2).reshape(
            b, s, kv_heads, g, hd)
        sc = attn._scores(qa, ck) * hd ** -0.5
        out = shard.combine_seq_split(sc, cv, "bkgst,btkd->bskgd", x.dtype)
        out = out.reshape(b, s, heads, hd)[:, :, t * hl:(t + 1) * hl]
    else:
        kl = ck.shape[2]
        if kl * g == hl:                    # this rank's KV heads, or all
            qg = q.reshape(b, s, kl, g, hd)
        else:                               # all KV heads: each q head's
            sel = (t * hl + torch.arange(hl, device=x.device)) // g
            ck, cv = ck[:, :, sel], cv[:, :, sel]
            qg = q.reshape(b, s, hl, 1, hd)
        sc = attn._scores(qg, ck) * hd ** -0.5
        w = torch.softmax(sc, dim=-1).to(x.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", w, cv)
    out = out.reshape(b, s, hl * hd)
    return out @ p["wo"].to(x.dtype).reshape(hl * hd, -1)


def run_encoder(cfg, params, frames, heads, kv_heads):
    """frames: (B, T_enc, D) precomputed embeddings (frontend stub), whole
    on every rank. Returns the encoder's output (B, T_enc, D), whole."""
    n = frames.shape[1]
    x = shard.split_seq(frames)
    positions = torch.arange(n, dtype=torch.int32, device=x.device)
    for j in range(cfg.encoder_layers):
        lp = _slice(params["encoder"], j)
        h = shard.gather_seq(apply_norm(cfg, lp["norm1"], x), n)
        h, _ = attn.gqa_attention(cfg, lp["attn"], h, "bidir", positions,
                                  None, heads, kv_heads)
        x = x + shard.reduce_seq(h)
        h = shard.gather_seq(apply_norm(cfg, lp["norm2"], x), n)
        x = x + shard.reduce_seq(apply_mlp(cfg, lp["mlp"], h))
    return shard.gather_seq(apply_norm(cfg, params["enc_norm"], x), n)


def project_cross_kv(cfg, params, enc_out, heads, kv_heads):
    """Per-decoder-layer cross K/V, stacked: (L, B, T_enc, KV, hd) each;
    under a sharding context this rank's block (:func:`cross_layout`)."""
    if cross_layout(cfg, kv_heads) == "seq":
        enc_out = shard.model_block(enc_out, 1)
    ck, cv = [], []
    for j in range(cfg.num_layers):
        cross = shard.gathered(_slice(params["decoder"], j)["cross"],
                               CROSS_AXES)
        ck.append(attn._project(enc_out, cross["wk"]))
        cv.append(attn._project(enc_out, cross["wv"]))
    return torch.stack(ck), torch.stack(cv)


def run_decoder(cfg, params, x, positions, self_caches, cross_kv, heads,
                kv_heads, train: bool = False, cache_len: int = 0):
    """x: (B, S, D) token embeddings, in the residual's layout.
    self_caches: None or the stacked self-attention caches (written in
    place; ``cache_len`` their global length, for sharded runs); cross_kv:
    stacked (ck, cv). With ``train`` each layer's body is recomputed in
    the backward pass (the reference's nothing-saveable remat, whatever
    ``REPRO_REMAT`` says). Returns (x, self_caches)."""
    ck, cv = cross_kv
    s = positions.shape[0]

    def body(x, lp, ck_j, cv_j, cache):
        h = shard.gather_seq(apply_norm(cfg, lp["norm1"], x), s)
        h, _ = attn.gqa_attention(cfg, lp["self_attn"], h, "global",
                                  positions, cache, heads, kv_heads,
                                  cache_len)
        x = x + shard.reduce_seq(h)
        h = shard.gather_seq(apply_norm(cfg, lp["norm_x"], x), s)
        x = x + shard.reduce_seq(_cross_attend(cfg, lp["cross"], h, ck_j,
                                               cv_j, heads, kv_heads))
        h = shard.gather_seq(apply_norm(cfg, lp["norm2"], x), s)
        return x + shard.reduce_seq(apply_mlp(cfg, lp["mlp"], h))

    fn = with_remat(body) if train else body
    for j in range(cfg.num_layers):
        x = fn(x, _slice(params["decoder"], j), ck[j], cv[j],
               None if self_caches is None else _slice(self_caches, j))
    return x, self_caches


def encdec_cache_structs(cfg, batch: int, max_len: int, dtype,
                         kv_heads: int) -> dict:
    n = cfg.num_layers
    self_c = tree_map(lambda _, s: TensorStruct((n,) + s.shape, s.dtype),
                      attn.gqa_cache_struct(cfg, batch, max_len, kv_heads,
                                            dtype))
    cross_shape = (n, batch, cfg.encoder_len, kv_heads, cfg.head_dim)
    return {"self": self_c,
            "cross": (TensorStruct(cross_shape, dtype),
                      TensorStruct(cross_shape, dtype))}
