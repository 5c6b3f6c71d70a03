"""Encoder-decoder backbone (Whisper-medium): an encoder over precomputed
frame embeddings (the conv frontend is a stub, as in the reference) and a
causal decoder with per-layer cross-attention.

The port of the JAX package's ``models/encdec.py``. The encoder's layers
are kind ``bidir``, which the reference's mask treats as causal; the port
keeps that. Cross-attention has no RoPE and no mask. Decode caches: the
decoder's self-attention K/V (written in place) and the per-layer cross
K/V, projected once from the encoder's output at prefill and carried.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamSpec, TensorStruct, apply_mlp,
                                       apply_norm, mlp_specs, norm_specs,
                                       tree_map)
from repro_torch.models.transformer import _slice, _stack, with_remat


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


def _cross_attend(cfg, p, x, ck, cv, heads, kv_heads):
    b, s, _ = x.shape
    hd = cfg.head_dim
    g = heads // kv_heads
    qg = attn._project(x, p["wq"]).reshape(b, s, kv_heads, g, hd)
    sc = attn._scores(qg, ck) * hd ** -0.5
    w = torch.softmax(sc, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, cv).reshape(b, s, heads * hd)
    return out @ p["wo"].to(x.dtype).reshape(heads * hd, -1)


def run_encoder(cfg, params, frames, heads, kv_heads):
    """frames: (B, T_enc, D) precomputed embeddings (frontend stub)."""
    x = frames
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for j in range(cfg.encoder_layers):
        lp = _slice(params["encoder"], j)
        h = apply_norm(cfg, lp["norm1"], x)
        h, _ = attn.gqa_attention(cfg, lp["attn"], h, "bidir", positions,
                                  None, heads, kv_heads)
        x = x + h
        h = apply_norm(cfg, lp["norm2"], x)
        x = x + apply_mlp(cfg, lp["mlp"], h)
    return apply_norm(cfg, params["enc_norm"], x)


def project_cross_kv(cfg, params, enc_out, heads, kv_heads):
    """Per-decoder-layer cross K/V, stacked: (L, B, T_enc, KV, hd) each."""
    ck, cv = [], []
    for j in range(cfg.num_layers):
        cross = _slice(params["decoder"], j)["cross"]
        ck.append(attn._project(enc_out, cross["wk"]))
        cv.append(attn._project(enc_out, cross["wv"]))
    return torch.stack(ck), torch.stack(cv)


def run_decoder(cfg, params, x, positions, self_caches, cross_kv, heads,
                kv_heads, train: bool = False):
    """x: (B, S, D) token embeddings. self_caches: None or the stacked
    self-attention caches (written in place); cross_kv: stacked (ck, cv).
    With ``train`` each layer's body is recomputed in the backward pass
    (the reference's nothing-saveable remat, whatever ``REPRO_REMAT``
    says). Returns (x, self_caches)."""
    ck, cv = cross_kv

    def body(x, lp, ck_j, cv_j, cache):
        h = apply_norm(cfg, lp["norm1"], x)
        h, _ = attn.gqa_attention(cfg, lp["self_attn"], h, "global",
                                  positions, cache, heads, kv_heads)
        x = x + h
        h = apply_norm(cfg, lp["norm_x"], x)
        x = x + _cross_attend(cfg, lp["cross"], h, ck_j, cv_j, heads,
                              kv_heads)
        h = apply_norm(cfg, lp["norm2"], x)
        return x + apply_mlp(cfg, lp["mlp"], h)

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
