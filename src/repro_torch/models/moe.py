"""Mixture-of-Experts layer: top-k routing, capacity-bounded dispatch.

The port of the JAX package's ``models/moe.py``, with its semantics: each
token's top-k choices get a position in their expert from an occurrence
rank taken in flat (b, s, k) order with a stable sort; an assignment past
the expert's capacity is dropped (it contributes exact zeros). A prefill
(s > 1) dispatches per batch row into (B, E, C, D) buffers with a per-row
capacity ``ceil8(max(int(cf * s * k / E), 1))``; a decode step (s == 1)
dispatches the batch's tokens flat into (E, C, D) with the capacity of
``b * s`` tokens. The router's logits and softmax are float32, from the
compute-dtype activations and the float32 router. The Switch-style
load-balancing loss is returned beside the output, as the reference does.

Experts are chosen by a stable descending sort of the probabilities, not
``torch.topk``: on a tie ``jax.lax.top_k`` takes the lower expert id first,
and ``torch.topk`` does not promise an order among equal values.

The reference's ``_grouped_manual`` (expert parallelism in a shard_map
over the mesh's model axis) needs a mesh; it waits for the sharding slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec


def moe_specs(cfg) -> dict:
    d = cfg.d_model
    e = cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    specs = {
        "router": ParamSpec((d, e), ("embed", None), "small"),
        "wi": ParamSpec((e, d, f), ("experts", "embed", "moe_mlp")),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "moe_mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "moe_mlp", "embed")),
    }
    if cfg.shared_expert_d_ff:
        fs = cfg.shared_expert_d_ff
        specs.update({
            "shared_wi": ParamSpec((d, fs), ("embed", "mlp")),
            "shared_wg": ParamSpec((d, fs), ("embed", "mlp")),
            "shared_wo": ParamSpec((fs, d), ("mlp", "embed")),
        })
    return specs


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: the reference's
    ``max(int(cf * tokens * k / E), 1)`` rounded up to a multiple of 8."""
    cap = max(int(cfg.capacity_factor * tokens * cfg.top_k
                  / cfg.num_experts), 1)
    return -(-cap // 8) * 8


def _position_in_expert(expert_ids):
    """Occurrence rank of each assignment within its expert, along the
    last axis in flat order (each leading index on its own)."""
    n = expert_ids.shape[-1]
    idx = torch.sort(expert_ids, dim=-1, stable=True).indices
    se = expert_ids.gather(-1, idx)
    pos = torch.arange(n, dtype=torch.int64, device=expert_ids.device)
    pos = pos.expand_as(se)
    is_start = torch.ones_like(se, dtype=torch.bool)
    is_start[..., 1:] = se[..., 1:] != se[..., :-1]
    start = torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    return torch.empty_like(pos).scatter_(-1, idx, pos - start)


def route(cfg, p, x):
    """(probs (B, S, E) float32, gate values (B, S, k) float32 normalised
    over k, expert ids (B, S, k) int64) of ``x`` (B, S, D)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[..., :cfg.top_k], ids[..., :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_ids


def _experts(p, buf):
    """The experts' SwiGLU on their buffers: (..., E, C, D) -> same."""
    wi, wg, wo = (p[k].to(buf.dtype) for k in ("wi", "wg", "wo"))
    h = torch.einsum("...ecd,edf->...ecf", buf, wi)
    h = F.silu(h) * torch.einsum("...ecd,edf->...ecf", buf, wg)
    return torch.einsum("...ecf,efd->...ecd", h, wo)


def _grouped_auto(cfg, p, x, gate_vals, ids_r, pos_r, keep, cap: int):
    """Per-row dispatch: x (B, S, D); ids_r / pos_r / keep (B, S*k)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    pos_safe = torch.where(keep, pos_r, 0)
    src = torch.repeat_interleave(x, k, dim=1)                # (B, S*k, D)
    src = torch.where(keep[..., None], src, 0)
    slot = ids_r * cap + pos_safe                             # (B, S*k)
    buf = x.new_zeros((b, e * cap, d))
    buf.scatter_add_(1, slot[..., None].expand(-1, -1, d), src)
    out_buf = _experts(p, buf.view(b, e, cap, d)).reshape(b, e * cap, d)
    gathered = out_buf.gather(1, slot[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered, 0)
    weighted = gathered * gate_vals.reshape(b, s * k, 1).to(x.dtype)
    return weighted.reshape(b, s, k, d).sum(dim=2)


def _flat(cfg, p, x, gate_vals, flat_ids, pos_in_e, keep, cap: int):
    """Flat-token dispatch of a decode step: x (T, D); flat_ids (T*k,)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    pos_safe = torch.where(keep, pos_in_e, 0)
    src = torch.repeat_interleave(x, k, dim=0)
    src = torch.where(keep[:, None], src, 0)
    slot = flat_ids * cap + pos_safe
    buf = x.new_zeros((e * cap, d))
    buf.index_add_(0, slot, src)
    out_buf = _experts(p, buf.view(e, cap, d)).reshape(e * cap, d)
    gathered = torch.where(keep[:, None], out_buf[slot], 0)
    weighted = gathered * gate_vals.reshape(-1, 1).to(x.dtype)
    return weighted.reshape(t, k, d).sum(dim=1)


def dropped_assignments(cfg, p, x) -> int:
    """How many of the top-k assignments of ``x`` (B, S, D) apply_moe
    drops for want of capacity."""
    b, s, _ = x.shape
    _, _, ids = route(cfg, p, x)
    if s > 1:
        pos, cap = _position_in_expert(ids.reshape(b, -1)), capacity(cfg, s)
    else:
        pos, cap = _position_in_expert(ids.reshape(-1)), capacity(cfg, b)
    return int((pos >= cap).sum())


def apply_moe(cfg, p, x):
    """x: (B, S, D) -> (out (B, S, D), aux_loss float32 scalar)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    probs, gate_vals, expert_ids = route(cfg, p, x)
    t = b * s
    if s > 1:
        cap = capacity(cfg, s)
        ids_r = expert_ids.reshape(b, s * k)                 # per-row ids
        pos_r = _position_in_expert(ids_r)
        keep = pos_r < cap
        y = _grouped_auto(cfg, p, x, gate_vals, ids_r, pos_r, keep, cap)
    else:
        cap = capacity(cfg, t)
        flat_ids = expert_ids.reshape(-1)                    # (T*k,)
        pos_in_e = _position_in_expert(flat_ids)
        keep = pos_in_e < cap
        y = _flat(cfg, p, x.reshape(t, d), gate_vals, flat_ids, pos_in_e,
                  keep, cap)
    y = y.reshape(b, s, d)

    if cfg.shared_expert_d_ff:
        hs = F.silu(x @ p["shared_wi"].to(x.dtype)) * (
            x @ p["shared_wg"].to(x.dtype))
        y = y + hs @ p["shared_wo"].to(x.dtype)

    # Switch-style load-balancing aux loss.
    me = probs.reshape(t, e).mean(dim=0)                     # (E,)
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, expert_ids.reshape(-1), torch.ones(t * k, device=x.device)) / (
        t * k)
    aux = e * torch.sum(me * ce)
    return y, aux
