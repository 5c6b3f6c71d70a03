"""Parallel Barabási–Albert (PBA) generator: two-phase preferential
attachment, with P = lp * D logical processors over a topology of D
devices (the host topology: all P on one device).

The JAX package's ``core/pba.py`` in torch, bit-identical to it for the
same config, faction table and pair capacity:

  phase 1 (local):  per-processor Pólya urn over *processor ids*, seeded
                    with the processor's faction members, resolved to
                    each chain's root in place (the resolve kernel), then
                    counted per target processor (the histogram kernel).
  exchange 1:       the (P, P) counts transpose.
  phase 2 (local):  per-processor Pólya urn over local endpoint slots (the
                    pool), granted to requesters in request order (the
                    gather kernel).
  exchange 2:       single-shot (P, C) buffers, or R >= 1 streamed rounds
                    of (P, C_r) buffers.
  substitution:     each local edge's processor tag is replaced by the
                    next endpoint received from that processor, by
                    occurrence rank (the gather kernel).

Where the JAX package vmaps a per-rank body, this module draws the random
words one rank at a time (``blocking.map_logical``: a whole (P, n) draw
would hold several (P, n) int64 temporaries) and runs everything after
the draws, the kernels included, on the whole (lp, n) batch at once.

Over D > 1 devices each device is one process of a ``torch.distributed``
group and runs its lp rows (:func:`generate_pba_sharded`;
:func:`generate_pba` with lp = 1); the two exchanges are the blocked
transposes of ``runtime/blocking.py``, and the drop count is summed over
the group, so every rank returns the same stats and its own rows of the
host path's (P, E) edge arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.factions import FactionTable, validate_table
from repro_torch.core.graph import EdgeList, GenStats
from repro_torch.kernels import ops
from repro_torch.runtime import blocking, spmd, streaming
from repro_torch.runtime import topology as topology_lib
from repro_torch.runtime.topology import Topology

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class PBAConfig:
    """PBA generation parameters (the JAX package's PBAConfig).

    vertices_per_proc: local vertex count V (global = V * P).
    edges_per_vertex: the BA ``k``, edges attached per new vertex.
    interfaction_prob: probability that a phase-1 slot picks a uniformly
      random processor instead of copying an earlier slot.
    pair_capacity: static per-(sender, receiver) endpoint budget C. None ->
      derived from faction sizes and device memory.
    exchange_rounds: None -> single fixed-capacity exchange 2 (pairs
      needing more than C endpoints overflow into counted drops). R >= 1 ->
      streamed exchange in rounds of C_r = ceil(C / R) per pair, repeated
      until every pair's residual is zero.
    total_capacity_factor: phase-2 urn budget as a multiple of E_local.
    seed: global RNG seed.
    """

    vertices_per_proc: int
    edges_per_vertex: int
    interfaction_prob: float = 0.05
    pair_capacity: Optional[int] = None
    exchange_rounds: Optional[int] = None
    total_capacity_factor: int = 2
    seed: int = 0

    @property
    def edges_per_proc(self) -> int:
        return self.vertices_per_proc * self.edges_per_vertex


# Fraction of device memory the live exchange buffer may claim (1/16), and
# the per-round floor on the pair capacity.
_EXCHANGE_MEM_DIVISOR = 16
_MIN_ROUND_CAPACITY = 16


def default_pair_capacity(edges_per_proc: int, min_s: int,
                          num_procs: int = 0,
                          exchange_rounds: Optional[int] = None,
                          memory_bytes: Optional[int] = None,
                          device=None) -> int:
    """Static per-pair capacity heuristic (the JAX package's rule).

    A generous multiple of E/s, clipped to E_local; with ``num_procs``
    given, clamped so each logical processor's (P, C_r) int32 round buffer
    fits 1/16 of the device memory (``memory_bytes``, else probed from
    ``device``), with C_r >= 16 on streamed runs. The probed memory makes
    the default device-dependent, and the capacity is part of the graph's
    identity: runs compared across devices pin ``pair_capacity``.
    """
    c = 8 * edges_per_proc // max(min_s, 1)
    c = int(min(max(c, 64), edges_per_proc))
    if num_procs:
        mem = (memory_bytes if memory_bytes is not None
               else spmd.device_memory_bytes(device))
        budget = max(mem // _EXCHANGE_MEM_DIVISOR, 1)
        rounds = max(exchange_rounds or 1, 1)
        cap = (budget // (4 * num_procs)) * rounds
        if exchange_rounds is not None:
            cap = max(cap, _MIN_ROUND_CAPACITY * rounds)
        c = int(max(min(c, cap), 1))
    return c


def resolve_pointers(ptr: torch.Tensor, terminal: torch.Tensor,
                     max_rounds: int = 64) -> torch.Tensor:
    """Resolve every slot of ``ptr`` (m,) or (rows, m) to the root of its
    chain, in place (``ops.resolve_roots``: one kernel launch per urn).

    The JAX package's ``resolve_pointers`` runs ``ptr <- ptr[ptr]`` until
    every entry lands on a terminal slot (at most ``max_rounds`` rounds)
    and returns the pass's fixpoint: non-terminal slots point strictly
    down (``uniform_slots`` draws U[0, j)) and terminal slots point at
    themselves, so the fixpoint holds each chain's root. A self-pointing
    slot that is not terminal (slot 0 of a phase-1 urn with no faction
    seeds) makes the reference run all its rounds and still ends at that
    fixpoint. Neither ``terminal`` nor the round count is needed here;
    ``max_rounds`` below ``m.bit_length()`` could stop the reference short
    of the fixpoint, and raises.
    """
    del terminal
    if max_rounds < ptr.shape[-1].bit_length():
        raise ValueError(f"max_rounds={max_rounds} may stop short of the "
                         f"fixpoint of {ptr.shape[-1]} slots")
    return ops.resolve_roots(ptr)


def occurrence_rank(a: torch.Tensor) -> torch.Tensor:
    """occ[..., j] = #{j' < j : a[..., j'] == a[..., j]} along the last
    axis: the rank of each entry within its equal-value group."""
    n = a.shape[-1]
    sa, idx = torch.sort(a, dim=-1, stable=True)
    pos = torch.arange(n, dtype=_I32, device=a.device).expand_as(a)
    is_start = torch.ones_like(a, dtype=torch.bool)
    is_start[..., 1:] = sa[..., 1:] != sa[..., :-1]
    group_start = torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    return torch.empty_like(a).scatter_(-1, idx, pos - group_start)


def _phase1_urn(rank: int, faction_row: torch.Tensor, s: torch.Tensor,
                cfg: PBAConfig, num_procs: int):
    """One processor's phase-1 urn: (ptr, terminal, base) rows of E."""
    e_local = cfg.edges_per_proc
    dev = faction_row.device
    max_s = faction_row.shape[0]
    j = torch.arange(e_local, dtype=_I32, device=dev)

    urn_key = rng_lib.device_key(cfg.seed, rng_lib.STREAM_PBA_URN, rank)
    r = rng_lib.uniform_slots(urn_key, e_local, j.clamp(min=1))  # U[0, j)

    coin_key = rng_lib.device_key(
        cfg.seed, rng_lib.STREAM_PBA_INTERFACTION_COIN, rank)
    inter = rng_lib.coin(coin_key, e_local, cfg.interfaction_prob,
                         dev) & (j >= s)
    proc_key = rng_lib.device_key(
        cfg.seed, rng_lib.STREAM_PBA_INTERFACTION_PROC, rank)
    rand_proc = rng_lib.uniform_ints(proc_key, e_local, num_procs, dev)

    seeded = j < s
    terminal = seeded | inter
    base = torch.where(
        seeded, faction_row[j.clamp(max=max_s - 1).long()],
        torch.where(inter, rand_proc, -1))
    return torch.where(terminal, j, r), terminal, base


def _phase1(ranks: torch.Tensor, procs_blk: torch.Tensor,
            s_blk: torch.Tensor, cfg: PBAConfig, num_procs: int):
    """The local processor-tag lists A (lp, E) and per-target counts
    (lp, P) of the block's processors."""
    ptr, terminal, base = blocking.map_logical(
        lambda r, fr, ss: _phase1_urn(r, fr, ss, cfg, num_procs),
        ranks, procs_blk, s_blk)
    ptr = resolve_pointers(ptr, terminal)
    del terminal
    a = torch.gather(base, -1, ptr.long())
    return a, ops.histogram(a, num_procs)


def _phase2_pool_urn(rank: int, cfg: PBAConfig, t_cap: int,
                     device) -> torch.Tensor:
    """One processor's unresolved phase-2 urn pointers (E + t_cap,)."""
    e_local = cfg.edges_per_proc
    jj = torch.arange(e_local + t_cap, dtype=_I32, device=device)
    key = rng_lib.device_key(cfg.seed, rng_lib.STREAM_PBA_PHASE2_URN, rank)
    r = rng_lib.uniform_slots(key, e_local + t_cap, jj.clamp(min=1))
    return torch.where(jj < e_local, jj, r)


def _phase2_pool(ranks: torch.Tensor, cfg: PBAConfig,
                 t_cap: Optional[int] = None) -> torch.Tensor:
    """Resolve the block's phase-2 urns once: slot -> *global* vertex id.

    Returns (lp, E + t_cap) int32. A pool depends only on (seed, rank,
    t_cap), not on the demand, so the single-shot and streamed grant paths
    draw identical endpoints for the same slot at the same budget. The
    first E slots are the k out-edges of each local vertex (a uniform slot
    is a degree-proportional vertex); later slots copy a uniformly chosen
    earlier slot.
    """
    e_local = cfg.edges_per_proc
    if t_cap is None:
        t_cap = cfg.total_capacity_factor * e_local
    ptr = blocking.map_logical(
        lambda r: _phase2_pool_urn(r, cfg, t_cap, ranks.device), ranks)
    terminal = torch.arange(e_local + t_cap, device=ranks.device) < e_local
    ptr = resolve_pointers(ptr, terminal)
    local_vertex = torch.div(ptr, cfg.edges_per_vertex,
                             rounding_mode="floor")
    return ranks[:, None] * cfg.vertices_per_proc + local_vertex


def _phase2(pool: torch.Tensor, recv_counts: torch.Tensor, cfg: PBAConfig,
            pair_capacity: int):
    """One provider's single-shot grant: per-pair demand clipped to
    ``pair_capacity``. Returns out_buf (P, C) of global vertex ids, -1 in
    unused slots, and the number granted."""
    e_local = cfg.edges_per_proc
    t_cap = cfg.total_capacity_factor * e_local
    cc = recv_counts.clamp(max=pair_capacity)
    offsets = torch.cumsum(cc, 0, dtype=_I32) - cc  # exclusive prefix
    c_idx = torch.arange(pair_capacity, dtype=_I32, device=pool.device)
    flat_idx = offsets[:, None] + c_idx[None, :]
    valid = (c_idx[None, :] < cc[:, None]) & (flat_idx < t_cap)
    vals = pool[(e_local + flat_idx.clamp(0, t_cap - 1)).long()]
    out_buf = torch.where(valid, vals, -1)
    return out_buf, valid.sum(dtype=_I32)


def grant_indices(recv_counts: torch.Tensor, r: int, round_cap: int,
                  e_local: int, t_cap: int):
    """The pool slots that round ``r`` of the streamed grant reads, and
    which of them are granted: (idx, valid), both (..., P, C_r).

    Pair p's run starts at ``e_local + offsets[p] + r * C_r``, with
    ``offsets`` the exclusive prefix of the *unclipped* demand, so a pair's
    endpoints occupy one contiguous pool run across rounds; slots past the
    urn budget ``t_cap`` clamp to its last slot and are not granted.
    """
    offsets = torch.cumsum(recv_counts, -1, dtype=_I32) - recv_counts
    window = streaming.round_window(recv_counts, r, round_cap)
    c_idx = torch.arange(round_cap, dtype=_I32, device=recv_counts.device)
    flat_idx = offsets[..., None] + r * round_cap + c_idx
    valid = (c_idx < window[..., None]) & (flat_idx < t_cap)
    return e_local + flat_idx.clamp(0, t_cap - 1), valid


def receive_indices(a: torch.Tensor, occ: torch.Tensor, r: int,
                    round_cap: int):
    """The band of round ``r`` and where each edge finds its endpoint in
    the received (P * C_r) buffer: (band, idx), both shaped like ``a``.

    Edge j, tagged with provider a[j] and request rank occ[j], reads slot
    ``a[j] * C_r + occ[j] - r * C_r``; off the band the slot clamps into
    the provider's segment and the value read is discarded.
    """
    band = (occ >= r * round_cap) & (occ < (r + 1) * round_cap)
    idx = a * round_cap + (occ - r * round_cap).clamp(0, round_cap - 1)
    return band, idx


def _grant_round(pool: torch.Tensor, recv_counts: torch.Tensor, r: int,
                 round_cap: int, e_local: int, t_cap: int) -> torch.Tensor:
    """Round ``r`` of the streamed grant: ranks [r*C_r, (r+1)*C_r) per pair.

    ``pool`` (m,) with ``recv_counts`` (P,) for one provider, or (lp, m)
    with (lp, P) for a block; returns (..., P, C_r), read at
    :func:`grant_indices`. Slots past the urn budget ``t_cap`` emit -1.
    """
    idx, valid = grant_indices(recv_counts, r, round_cap, e_local, t_cap)
    if pool.ndim == 1:
        vals = ops.gather(pool, idx)
    else:
        vals = ops.gather(pool, idx.reshape(pool.shape[0], -1)) \
            .reshape(idx.shape)
    return torch.where(valid, vals, -1)


def pba_logical_block(ranks: torch.Tensor, procs_blk: torch.Tensor,
                      s_blk: torch.Tensor, cfg: PBAConfig, num_procs: int,
                      pair_capacity: int, topo: Topology):
    """Run a device's block of lp logical PBA processors.

    ranks: (lp,) int32 global logical ids; procs_blk: (lp, max_s) faction
    rows; s_blk: (lp,) faction sizes. Returns (u (lp, E), v (lp, E),
    dropped over all procs of every device, granted (lp,), rounds run).
    Host path: ``Topology.host()`` with lp == P.
    """
    a, counts = _phase1(ranks, procs_blk, s_blk, cfg, num_procs)
    recv_counts = blocking.transpose_counts(counts, topo)
    lp = a.shape[0]
    occ = occurrence_rank(a)

    if cfg.exchange_rounds is None:
        # Single fixed-capacity exchange: per-pair overflow (occ >= C) is
        # dropped and counted.
        pool = _phase2_pool(ranks, cfg)
        out_buf, granted = blocking.map_logical(
            lambda r, p, rc: _phase2(p, rc, cfg, pair_capacity),
            ranks, pool, recv_counts)                      # (lp, P, C)
        del pool
        in_buf = blocking.transpose_payload(out_buf, topo)
        v = ops.gather(in_buf.reshape(lp, num_procs * pair_capacity),
                       a * pair_capacity + occ.clamp(max=pair_capacity - 1))
        v = torch.where(occ < pair_capacity, v, -1)
        rounds = 1
    else:
        v, granted, rounds = _streamed_exchange2(
            a, occ, counts, recv_counts, ranks, cfg, pair_capacity,
            num_procs, topo)

    j = torch.arange(cfg.edges_per_proc, dtype=_I32, device=a.device)
    u = (ranks[:, None] * cfg.vertices_per_proc
         + torch.div(j, cfg.edges_per_vertex, rounding_mode="floor")[None])
    u = torch.where(v >= 0, u, -1)
    dropped = int(blocking.all_reduce_sum((v < 0).sum(), topo))
    return u, v, dropped, granted, rounds


def _streamed_exchange2(a, occ, counts, recv_counts, ranks, cfg: PBAConfig,
                        pair_capacity: int, num_procs: int, topo: Topology):
    """Exchange 2 as a multi-round stream (``runtime/streaming.py``).

    Round r serves request ranks [r*C_r, (r+1)*C_r) of every pair; the
    requester writes the received band into its edge list by occurrence
    rank. Rounds repeat until the all-reduced grantable residual is zero,
    so no edge is dropped for pair capacity; only urn-budget exhaustion
    (t_cap) can still emit -1.
    """
    lp = a.shape[0]
    e_local = cfg.edges_per_proc
    t_cap = cfg.total_capacity_factor * e_local
    c_r = streaming.round_capacity(pair_capacity, cfg.exchange_rounds)
    max_rounds = streaming.rounds_needed(e_local, c_r)
    pool = _phase2_pool(ranks, cfg)

    # Terminate on what the urn can actually grant, not raw demand.
    offsets = torch.cumsum(recv_counts, 1, dtype=_I32) - recv_counts
    grantable = torch.minimum(recv_counts, t_cap - offsets).clamp(min=0)

    def emit(r):
        return _grant_round(pool, recv_counts, r, c_r, e_local, t_cap)

    def consume(r, recv, v):
        band, idx = receive_indices(a, occ, r, c_r)
        vals = ops.gather(recv.reshape(lp, num_procs * c_r), idx)
        return torch.where(band, vals, v)

    v0 = torch.full((lp, e_local), -1, dtype=_I32, device=a.device)
    v, rounds = streaming.run_exchange(
        grantable, c_r, max_rounds, emit, consume, v0, topo)

    # Provider-side grants: pair q was served min(demand, rounds*C_r)
    # ranks, of which those within the urn budget yielded endpoints.
    served = recv_counts.clamp(max=rounds * c_r)
    granted = torch.minimum(served, t_cap - offsets).clamp(min=0) \
        .sum(1, dtype=_I32)
    return v, granted, rounds


def pba_stream_setup_block(ranks: torch.Tensor, procs_blk: torch.Tensor,
                           s_blk: torch.Tensor, cfg: PBAConfig,
                           num_procs: int, topo: Topology):
    """A device's block of the device stream's setup: phase 1 and
    exchange 1, run once per generation.

    Returns (a (lp, E) processor tags, occ (lp, E) request ranks,
    recv_counts (lp, P) provider-side demand), which stay resident on the
    device across rounds (:func:`pba_stream_round_block`).
    """
    a, counts = _phase1(ranks, procs_blk, s_blk, cfg, num_procs)
    recv_counts = blocking.transpose_counts(counts, topo)
    return a, occurrence_rank(a), recv_counts


def pba_stream_round_block(r: int, a: torch.Tensor, occ: torch.Tensor,
                           recv_counts: torch.Tensor, pool: torch.Tensor,
                           ranks: torch.Tensor, cfg: PBAConfig,
                           num_procs: int, round_cap: int, urn_budget: int,
                           block_cap: int, topo: Topology):
    """Round ``r`` of the device stream's exchange 2.

    The round contract of :func:`_streamed_exchange2`, unrolled so a host
    driver can interleave rounds with write-back: grant request ranks
    [r*C_r, (r+1)*C_r) of every pair from the resident pool (the gather
    kernel), route the (lp, P, C_r) buffer through the blocked transpose,
    look the band up in it (the gather kernel), count the band per
    provider (the histogram kernel) and move the band to the front of
    each row (the band-compaction kernel). Returns (u, v) of shape
    (lp, block_cap), -1 marking padding (and, in ``v``, urn-exhausted
    grants), and counts (lp, P): this round's per-provider band sizes,
    which the host checks against the compacted block.
    """
    u, v, band = round_compact_inputs(r, a, occ, recv_counts, pool, ranks,
                                      cfg, num_procs, round_cap, urn_budget,
                                      topo)
    counts = round_census(a, band, num_procs)
    u, v = ops.band_compact(u, v, band, block_cap)
    return u, v, counts


def round_census(a: torch.Tensor, band: torch.Tensor,
                 num_procs: int) -> torch.Tensor:
    """A round's census: per row of the (lp, E) tags ``a``, how many of
    the edges in ``band`` name each provider, (lp, P) (the histogram
    kernel, counting only where ``band`` is set)."""
    return ops.histogram(a, num_procs, mask=band)


def round_compact_inputs(r: int, a: torch.Tensor, occ: torch.Tensor,
                         recv_counts: torch.Tensor, pool: torch.Tensor,
                         ranks: torch.Tensor, cfg: PBAConfig, num_procs: int,
                         round_cap: int, urn_budget: int, topo: Topology):
    """What round ``r`` of the device stream hands to the band compaction:
    (u, v, band), each (lp, E), -1 in ``u`` and ``v`` off the band.

    Grants request ranks [r*C_r, (r+1)*C_r) of every pair from the
    resident pool (the gather kernel), routes the (lp, P, C_r) buffer
    through the blocked transpose and looks the band up in it (the gather
    kernel); ``u`` is each edge's own endpoint.
    """
    lp = a.shape[0]
    e_local = cfg.edges_per_proc
    out = _grant_round(pool, recv_counts, r, round_cap, e_local, urn_budget)
    recv = blocking.transpose_payload(out, topo)
    del out
    band, idx = receive_indices(a, occ, r, round_cap)
    vals = ops.gather(recv.reshape(lp, num_procs * round_cap), idx)
    del recv, idx
    v = torch.where(band, vals, -1)
    del vals
    j = torch.arange(e_local, dtype=_I32, device=a.device)
    u = (ranks[:, None] * cfg.vertices_per_proc
         + torch.div(j, cfg.edges_per_vertex, rounding_mode="floor")[None])
    return torch.where(band, u, -1), v, band


def stream_block_capacity(edges_per_proc: int, num_procs: int,
                          round_cap: int) -> int:
    """Static per-proc bound on a round's band size: each (requester,
    provider) pair contributes at most C_r request ranks per round, and a
    processor never has more than E edges in total."""
    return min(edges_per_proc, num_procs * round_cap)


def _derived_pair_capacity(cfg: PBAConfig, table: FactionTable,
                           device) -> int:
    """The capacity every generator path uses for (cfg, table) on
    ``device``."""
    return cfg.pair_capacity or default_pair_capacity(
        cfg.edges_per_proc, int(table.s.min()), num_procs=table.num_procs,
        exchange_rounds=cfg.exchange_rounds, device=device)


def pba_shard_body(rank: int, faction_row: torch.Tensor, s: int,
                   cfg: PBAConfig, num_procs: int, pair_capacity: int,
                   topo: Topology):
    """One device's program with one logical proc (rank ``rank``, its
    (max_s,) faction row and size ``s``): the lp = 1 case of
    :func:`pba_logical_block`. Returns (u (E,), v (E,), dropped over all
    procs, granted, rounds run)."""
    ranks = torch.tensor([rank], dtype=_I32, device=faction_row.device)
    s_blk = torch.tensor([s], dtype=faction_row.dtype,
                         device=faction_row.device)
    u, v, dropped, granted, rounds = pba_logical_block(
        ranks, faction_row[None], s_blk, cfg, num_procs, pair_capacity,
        topo)
    return u[0], v[0], dropped, granted[0], rounds


def _check_vertex_space(cfg: PBAConfig, num_procs: int) -> int:
    num_vertices = num_procs * cfg.vertices_per_proc
    if num_vertices > 2**31 - 1:
        raise ValueError(
            f"P * vertices_per_proc = {num_vertices} exceeds the int32 "
            "vertex-id space")
    return num_vertices


def _block_inputs(table: FactionTable, lp: int, topo: Topology, device):
    """This device's (ranks (lp,), faction rows (lp, max_s), sizes (lp,))."""
    d = blocking.device_index(topo)
    rows = slice(d * lp, (d + 1) * lp)
    return (blocking.logical_ranks(lp, topo, device),
            torch.from_numpy(table.procs[rows]).to(device),
            torch.from_numpy(table.s[rows]).to(device))


def _stats(cfg: PBAConfig, num_procs: int, dropped: int, rounds: int,
           pair_capacity: int) -> GenStats:
    n = num_procs * cfg.vertices_per_proc
    requested = num_procs * cfg.edges_per_proc
    return GenStats(requested_edges=requested,
                    emitted_edges=requested - dropped,
                    dropped_edges=dropped, num_vertices=n,
                    exchange_rounds=rounds, pair_capacity=pair_capacity,
                    fallback_counts=ops.fallback_counts())


def generate_pba(cfg: PBAConfig, table: FactionTable,
                 topology: Optional[Topology] = None, *,
                 device=None) -> tuple[EdgeList, GenStats]:
    """PBA with one logical processor per device: P == D, each device one
    process of the ``torch.distributed`` group (``topology`` None: flat
    over P devices). Returns this rank's (1, E) row of the host path's
    edges and the global stats. ``device`` as in
    :func:`generate_pba_host`, defaulting to this rank's card."""
    validate_table(table)
    device = spmd.resolve_device(device)
    num_procs = table.num_procs
    topo = topology_lib.resolve(topology, default_devices=num_procs,
                                device=device)
    if topo.num_devices != num_procs:
        raise ValueError(
            f"generate_pba runs 1 proc per device: table has {num_procs} "
            f"procs but topology {topo.label} has {topo.num_devices} "
            "devices; use generate_pba_sharded for P = lp * D")
    n = _check_vertex_space(cfg, num_procs)
    pair_capacity = _derived_pair_capacity(cfg, table, device)
    ranks, procs, s = _block_inputs(table, 1, topo, device)
    u, v, dropped, _, rounds = pba_shard_body(
        int(ranks[0]), procs[0], int(s[0]), cfg, num_procs, pair_capacity,
        topo)
    return (EdgeList(src=u[None], dst=v[None], num_vertices=n),
            _stats(cfg, num_procs, dropped, rounds, pair_capacity))


def generate_pba_sharded(cfg: PBAConfig, table: FactionTable,
                         topology: Optional[Topology] = None, *,
                         device=None) -> tuple[EdgeList, GenStats]:
    """P = lp * D logical processors over a topology of D devices, one
    process per device of the ``torch.distributed`` group (``topology``
    None: flat over the world size). Each rank runs its lp rows; the
    exchanges are one all-to-all each on a flat topology, two on
    ``Topology.pods(r, c)``. Returns this rank's (lp, E) rows of
    :func:`generate_pba_host`'s edges, bit for bit, and the global stats.
    """
    validate_table(table)
    device = spmd.resolve_device(device)
    num_procs = table.num_procs
    topo = topology_lib.resolve(topology, device=device)
    lp = topo.lp(num_procs)
    n = _check_vertex_space(cfg, num_procs)
    pair_capacity = _derived_pair_capacity(cfg, table, device)
    ranks, procs, s = _block_inputs(table, lp, topo, device)
    u, v, dropped, _, rounds = pba_logical_block(
        ranks, procs, s, cfg, num_procs, pair_capacity, topo)
    return (EdgeList(src=u, dst=v, num_vertices=n),
            _stats(cfg, num_procs, dropped, rounds, pair_capacity))


def generate_pba_host(cfg: PBAConfig, table: FactionTable,
                      topology: Optional[Topology] = None, *,
                      device=None) -> tuple[EdgeList, GenStats]:
    """Run the P-logical-processor PBA program on one device.

    ``device`` defaults to the current CUDA device and raises when there is
    none; ``device="cpu"`` runs the plain PyTorch path. The exchanges are
    transposes of the (P, P, ...) block. Bit-identical to the JAX
    package's ``generate_pba_host`` for the same (cfg, table) and pair
    capacity. ``topology``, if given, must be ``Topology.host()``.
    """
    validate_table(table)
    if topology is not None and not topology.is_host:
        raise ValueError(
            f"generate_pba_host runs the host topology, got {topology.label}")
    device = spmd.resolve_device(device)
    num_procs = table.num_procs
    n = _check_vertex_space(cfg, num_procs)
    pair_capacity = _derived_pair_capacity(cfg, table, device)
    topo = Topology.host()
    ranks, procs, s = _block_inputs(table, num_procs, topo, device)
    u, v, dropped, _, rounds = pba_logical_block(
        ranks, procs, s, cfg, num_procs, pair_capacity, topo)
    return (EdgeList(src=u, dst=v, num_vertices=n),
            _stats(cfg, num_procs, dropped, rounds, pair_capacity))


def serial_ba_reference(num_vertices: int, k: int, seed: int = 0, *,
                        device=None) -> EdgeList:
    """Classic serial BA via the uniform-edge-endpoint urn (oracle for tests).

    Pure numpy, sequential, and bit-equal to the JAX package's: the ground
    truth the parallel algorithm approximates in the P=1 limit. Returns
    int32 tensors on ``device`` (the current CUDA device unless
    ``device="cpu"``).
    """
    device = spmd.resolve_device(device)
    rng = np.random.default_rng(seed)
    e = num_vertices * k
    src = np.empty(e, np.int64)
    dst = np.empty(e, np.int64)
    # endpoint slot pool: 2 slots per edge
    pool = np.empty(2 * e, np.int64)
    n_slots = 0
    for v_new in range(num_vertices):
        for j in range(k):
            i = v_new * k + j
            src[i] = v_new
            tgt = 0 if n_slots == 0 else pool[rng.integers(0, n_slots)]
            dst[i] = tgt
            pool[n_slots] = v_new
            pool[n_slots + 1] = tgt
            n_slots += 2
    return EdgeList(src=torch.from_numpy(src.astype(np.int32)).to(device),
                    dst=torch.from_numpy(dst.astype(np.int32)).to(device),
                    num_vertices=num_vertices)
