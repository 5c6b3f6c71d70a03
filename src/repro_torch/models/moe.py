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

Under a sharding context (``repro_torch.sharding``) the layer runs expert
parallel over "model", each rank holding a block of the experts
(``block_range``: ceil(E / tp) each, the last ranks short or empty when
"model" does not divide E) and of the shared expert's hidden columns. Its
input is the whole sequence of the rank's batch rows (the layer gathers
it), and its output is in the residual's layout:

  prefill  the reference's ``_grouped_manual``: routing replicated over
           "model", the per-row capacity from the whole sequence,
           positions from the global flat (b, s, k) order; each rank
           scatters only its experts' assignments (the others go to a
           trash column ``cap``), runs its experts, and takes the
           gate-weighted sum over k before a float32 reduce-scatter over
           the sequence. The reference takes ``_grouped_auto`` where
           "model" divides neither E nor s; both compute the same values,
           and so does this path for any E and s.
  decode   the flat (E, C, D) path (``moe_ecd``): the step's tokens are
           gathered over the batch axes so the capacity and positions are
           the global batch's, each rank runs its experts on their whole
           capacity (the C dimension is not split over "data": each data
           rank computes it), keeps its batch rows, and the float32
           all-reduce over "model" sums the experts' parts.

The shared expert is column- then row-parallel (its partial sum reduced
in the activations' dtype), and the load-balancing loss is taken from the
global routing. In a prefill under grad mode (training) each rank sums
the probabilities and the assignment counts of the positions it owns
(its ``model_block`` of the sequence), and the two (E,) sums are reduced
over the batch axes and "model" (``reduce_from``), so every rank's loss is
the global one and the probabilities' gradient is counted once over
"model". Without grad (serving) every "model" rank sums the whole routed
sequence, and the sums are reduced over the batch axes alone.

Training (``Model.loss`` under train rules) runs the prefill path under
autograd. Each rank's combine covers only its own experts' gates and its
load-balancing sums only its own positions, so the router's gradient is
partial on each "model" rank; the train step sums it over "model"
(its ParamSpec's ``partial_grad``, read by
``train_step.grad_reduce_axes``). A rank
with no experts returns zeros that stay in its input's graph, so it joins
the adjoint of every reduction the other ranks join. Under ``no_tp`` the
experts are whole on every rank (ZeRO'd over ("data", "model")) and the
sums are reduced over the batch axes, which include "model".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec
from repro_torch.sharding import ctx as shard
from repro_torch.sharding.rules import block_range

MOE_AXES = {"router": ("embed", None),
            "wi": ("experts", "embed", "moe_mlp"),
            "wg": ("experts", "embed", "moe_mlp"),
            "wo": ("experts", "moe_mlp", "embed"),
            "shared_wi": ("embed", "mlp"), "shared_wg": ("embed", "mlp"),
            "shared_wo": ("mlp", "embed")}


def moe_specs(cfg) -> dict:
    d = cfg.d_model
    e = cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    specs = {
        # held whole on "model"; each rank's experts' gates and positions'
        # load-balancing sums give part of its gradient
        "router": ParamSpec((d, e), ("embed", None), "small",
                            partial_grad=True),
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
    drops for want of capacity; under a sharding context, of this rank's
    batch rows in a prefill, of the step's whole batch in a decode step
    (gathered as apply_moe gathers it)."""
    p = shard.gathered(p, MOE_AXES)
    if x.shape[1] == 1 and shard.batch_axes():
        x = shard.current_mesh().all_gather(x, shard.batch_axes(), 0)
    b, s, _ = x.shape
    _, _, ids = route(cfg, p, x)
    if s > 1:
        pos, cap = _position_in_expert(ids.reshape(b, -1)), capacity(cfg, s)
    else:
        pos, cap = _position_in_expert(ids.reshape(-1)), capacity(cfg, b)
    return int((pos >= cap).sum())


def apply_moe(cfg, p, x):
    """x: (B, S, D) -> (out (B, S, D), aux_loss float32 scalar). Under a
    sharding context, expert parallel (see the module); ``out`` is then in
    the residual's layout."""
    if shard.active():
        return _apply_moe_sharded(cfg, p, x)
    b, s, d = x.shape
    k = cfg.top_k
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

    return y, _load_balance(cfg, _routing_sums(probs, expert_ids), t)


def _routing_sums(probs, expert_ids):
    """(2, E) float32: the sum of ``probs`` (..., E) over its positions and
    the count of ``expert_ids`` (..., k) per expert."""
    e = probs.shape[-1]
    ids = expert_ids.reshape(-1)
    return torch.stack([probs.reshape(-1, e).sum(0), torch.zeros(
        e, device=probs.device).index_add_(
            0, ids, torch.ones(ids.shape[0], device=probs.device))])


def _load_balance(cfg, sums, tokens: int):
    """The Switch-style load-balancing loss of ``tokens`` tokens from their
    :func:`_routing_sums`: E x sum(mean probability x share of the
    assignments), as the reference takes it over the flat (t, E)."""
    me, ce = sums[0] / tokens, sums[1] / (tokens * cfg.top_k)
    return cfg.num_experts * torch.sum(me * ce)


def _grouped_local(cfg, p, x, gate_vals, ids_r, pos_r, keep, cap: int,
                   e0: int, e1: int):
    """Per-row dispatch to this rank's experts [e0, e1) (``p``'s expert
    leaves hold just them): x (B, S, D); ids_r / pos_r / keep (B, S*k).
    Returns this rank's part of the gate-weighted sum over k."""
    b, s, d = x.shape
    k, el = cfg.top_k, e1 - e0
    if el == 0:
        # zeros in x's graph (a sum over no channels), so that the
        # reduction of this part is an autograd node here too and this
        # rank joins its adjoint collective in the backward pass
        return x.new_zeros((b, s, d)) + x[..., :0].sum(-1, keepdim=True)
    ok = keep & (ids_r >= e0) & (ids_r < e1)
    ids_l = torch.where(ok, ids_r - e0, 0)
    pos_l = torch.where(ok, pos_r, cap)                       # trash column
    src = torch.repeat_interleave(x, k, dim=1)
    src = torch.where(ok[..., None], src, 0)
    buf = x.new_zeros((b, el * (cap + 1), d))
    buf.scatter_add_(1, (ids_l * (cap + 1) + pos_l)[..., None].expand(
        -1, -1, d), src)
    buf = buf.view(b, el, cap + 1, d)[:, :, :cap].contiguous()
    out_buf = _experts(p, buf).reshape(b, el * cap, d)
    slot = ids_l * cap + pos_l.clamp(max=cap - 1)
    gathered = out_buf.gather(1, slot[..., None].expand(-1, -1, d))
    gathered = torch.where(ok[..., None], gathered, 0)
    weighted = gathered * gate_vals.reshape(b, s * k, 1).to(x.dtype)
    return weighted.reshape(b, s, k, d).sum(dim=2)


def _flat_local(cfg, p, x, gate_vals, flat_ids, pos_in_e, keep, cap: int,
                e0: int, e1: int):
    """Flat-token dispatch of a decode step to this rank's experts [e0,
    e1): x (T, D); flat_ids (T*k,). Returns this rank's part (T, D)."""
    t, d = x.shape
    k, el = cfg.top_k, e1 - e0
    if el == 0:
        return x.new_zeros((t, d))
    ok = keep & (flat_ids >= e0) & (flat_ids < e1)
    ids_l = torch.where(ok, flat_ids - e0, 0)
    pos_l = torch.where(ok, pos_in_e, cap)                    # trash column
    src = torch.repeat_interleave(x, k, dim=0)
    src = torch.where(ok[:, None], src, 0)
    buf = x.new_zeros((el * (cap + 1), d))
    buf.index_add_(0, ids_l * (cap + 1) + pos_l, src)
    buf = buf.view(el, cap + 1, d)[:, :cap].contiguous()
    out_buf = _experts(p, buf).reshape(el * cap, d)
    gathered = torch.where(ok[:, None],
                           out_buf[ids_l * cap + pos_l.clamp(max=cap - 1)], 0)
    weighted = gathered * gate_vals.reshape(-1, 1).to(x.dtype)
    return weighted.reshape(t, k, d).sum(dim=1)


def _apply_moe_sharded(cfg, p, x):
    """apply_moe under a sharding context (see the module)."""
    mesh = shard.current_mesh()
    bax = shard.batch_axes()
    p = shard.gathered(p, MOE_AXES)
    tp, ti = shard.model_axis()
    e0, e1 = block_range(cfg.num_experts, tp, ti)
    b, s, d = x.shape
    if s > 1:
        probs, gate_vals, expert_ids = route(cfg, p, x)
        cap = capacity(cfg, s)
        ids_r = expert_ids.reshape(b, s * cfg.top_k)
        pos_r = _position_in_expert(ids_r)
        y = _grouped_local(cfg, p, x, gate_vals, ids_r, pos_r, pos_r < cap,
                           cap, e0, e1)
        y = shard.reduce_seq(y.float()).to(x.dtype)
        if torch.is_grad_enabled():
            # training: each rank sums its own positions, so the sums over
            # the batch axes and "model" count every token once, and so
            # does their gradient
            sums = _routing_sums(shard.model_block(probs, 1),
                                 shard.model_block(expert_ids, 1))
            axes = set(bax or ()) | ({"model"} if tp > 1 else set())
        else:
            # serving: every "model" rank routed the whole sequence alike
            sums, axes = _routing_sums(probs, expert_ids), set(bax or ())
        sums = mesh.reduce_from(sums, tuple(
            a for a in mesh.axis_names if a in axes))
        tokens = b * s * (mesh.axis_size(bax) if bax else 1)
    else:
        xg = mesh.all_gather(x, bax, 0) if bax else x
        probs, gate_vals, expert_ids = route(cfg, p, xg)
        tokens = xg.shape[0] * s
        cap = capacity(cfg, tokens)
        flat_ids = expert_ids.reshape(-1)
        pos_in_e = _position_in_expert(flat_ids)
        y = _flat_local(cfg, p, xg.reshape(tokens, d), gate_vals, flat_ids,
                        pos_in_e, pos_in_e < cap, cap, e0, e1)
        r0 = mesh.axis_index(bax) * b if bax else 0
        y = y[r0:r0 + b].reshape(b, s, d)
        y = shard.reduce_seq(y.float()).to(x.dtype)
        sums = _routing_sums(probs, expert_ids)
    if cfg.shared_expert_d_ff:
        hs = F.silu(x @ p["shared_wi"].to(x.dtype)) * (
            x @ p["shared_wg"].to(x.dtype))
        y = y + shard.reduce_seq(hs @ p["shared_wo"].to(x.dtype))
    # Switch-style load-balancing aux loss, from the global routing (taken
    # last: remat's recompute stops at its last saved tensor, and so runs
    # through every collective above on every rank)
    return y, _load_balance(cfg, sums, tokens)
