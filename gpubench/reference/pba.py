"""Plain reference of the parallel Barabási–Albert (PBA) graph.

The graph of Yoo & Henderson's two-phase generator as the configuration
states it, worked out again from the spec and the seed in plain PyTorch
and numpy, one processor row at a time. It shares no code with the
program: no kernel, no exchange, no round. Edge (i, j) of processor i is

  u = i * V + j // k
  v = pool_p[E + offset_p[i] + occ[i, j]]       with p = a[i, j]

where ``a[i]`` is processor i's phase-1 urn over processor ids resolved
to each chain's root, ``occ[i, j]`` the rank of edge j among processor
i's edges that name p, ``offset_p[i]`` the edges that processors before
i ask of p, and ``pool_p`` provider p's phase-2 urn over its own endpoint
slots. However many rounds the program's exchange takes, it hands edge
(i, j) that slot. A slot past the urn budget (``auto_capacity``: the
largest demand rounded up to a power of two, so never) emits nothing.

``edge_blocks`` makes every pool whole. ``row_blocks`` makes the edges of
a few rows alone, for a graph too large to make whole: phase 1 of every
processor for the demand, then each edge's pool slot followed down its
chain, one threefry word a step.

``control=True`` compares the interfaction coin's probability in
bfloat16 instead of float32: the next precision below the one the
configuration states.
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import rng

_I32 = torch.int32


def make_factions(num_procs: int, num_factions: int, min_size: int,
                  max_size: int, seed: int):
    """(rows (P, max_s) int32 padded with -1, sizes (P,)): each
    processor's urn seeds, the members of every faction it belongs to.
    Factions are drawn with numpy's ``default_rng(seed)``; a processor in
    none joins one at random."""
    gen = np.random.default_rng(seed)
    factions = []
    for _ in range(num_factions):
        size = int(gen.integers(min_size, max_size + 1))
        factions.append(np.sort(gen.choice(num_procs, size=size,
                                           replace=False)))
    member_of = [[] for _ in range(num_procs)]
    for fi, members in enumerate(factions):
        for m in members:
            member_of[int(m)].append(fi)
    for p in range(num_procs):
        if not member_of[p]:
            fi = int(gen.integers(0, len(factions)))
            factions[fi] = np.sort(np.append(factions[fi], p))
            member_of[p].append(fi)
    rows = [np.concatenate([factions[fi] for fi in member_of[p]])
            for p in range(num_procs)]
    sizes = np.array([len(r) for r in rows], np.int64)
    table = np.full((num_procs, int(sizes.max())), -1, np.int32)
    for p, row in enumerate(rows):
        table[p, :len(row)] = row
    return table, sizes


def chain_roots(ptr: torch.Tensor) -> torch.Tensor:
    """Each slot's chain followed to its root (a slot that points at
    itself), by pointer jumping; int64."""
    ptr = ptr.long()
    while True:
        nxt = ptr[ptr]
        if torch.equal(nxt, ptr):
            return ptr
        ptr = nxt


def occurrence_rank(a: torch.Tensor) -> torch.Tensor:
    """occ[j] = #{j' < j : a[j'] == a[j]} for a 1-D ``a``."""
    n = a.numel()
    sa, idx = torch.sort(a, stable=True)
    pos = torch.arange(n, dtype=torch.int64, device=a.device)
    start = torch.ones(n, dtype=torch.bool, device=a.device)
    start[1:] = sa[1:] != sa[:-1]
    first = torch.cummax(torch.where(start, pos, 0), dim=0).values
    occ = torch.empty(n, dtype=torch.int64, device=a.device)
    occ[idx] = pos - first
    return occ


def phase1_tags(cfg: dict, i: int, row: torch.Tensor, s: int,
                control: bool = False) -> torch.Tensor:
    """Processor i's phase-1 urn: the provider each of its E edges asks."""
    p, e = cfg["procs"], cfg["vertices_per_proc"] * cfg["edges_per_vertex"]
    dev = row.device
    j = torch.arange(e, dtype=_I32, device=dev)
    r = rng.uniform_slots(
        rng.device_key(cfg["seed"], rng.STREAM_PBA_URN, i), j.clamp(min=1))
    inter = rng.coin(
        rng.device_key(cfg["seed"], rng.STREAM_PBA_INTERFACTION_COIN, i),
        e, cfg["interfaction_prob"], dev,
        torch.bfloat16 if control else torch.float32) & (j >= s)
    rand_proc = rng.uniform_ints(
        rng.device_key(cfg["seed"], rng.STREAM_PBA_INTERFACTION_PROC, i),
        e, p, dev)
    seeded = j < s
    base = torch.where(seeded, row[j.clamp(max=row.numel() - 1).long()],
                       torch.where(inter, rand_proc, -1))
    ptr = torch.where(seeded | inter, j, r)
    return base[chain_roots(ptr)]


def provider_pool(cfg: dict, q: int, length: int, device) -> torch.Tensor:
    """Provider q's first ``length`` phase-2 urn slots as global vertex
    ids: slot j < E is local vertex j // k, a later slot copies a uniform
    earlier one."""
    e, k = cfg["vertices_per_proc"] * cfg["edges_per_vertex"], \
        cfg["edges_per_vertex"]
    jj = torch.arange(length, dtype=_I32, device=device)
    r = rng.uniform_slots(
        rng.device_key(cfg["seed"], rng.STREAM_PBA_PHASE2_URN, q),
        jj.clamp(min=1))
    root = chain_roots(torch.where(jj < e, jj, r))
    return (q * cfg["vertices_per_proc"] + root // k).to(_I32)


def requested_edges(cfg: dict) -> int:
    return cfg["procs"] * cfg["vertices_per_proc"] * cfg["edges_per_vertex"]


def edge_blocks(cfg: dict, device, control: bool = False):
    """The graph's (u, v) int32 edges, one processor's row at a time."""
    p, v_per = cfg["procs"], cfg["vertices_per_proc"]
    k = cfg["edges_per_vertex"]
    e = v_per * k
    table, sizes = make_factions(p, **cfg["factions"])
    rows = torch.from_numpy(table).to(device)
    a = torch.empty((p, e), dtype=_I32, device=device)
    occ = torch.empty((p, e), dtype=_I32, device=device)
    counts = torch.empty((p, p), dtype=torch.int64, device=device)
    for i in range(p):
        a[i] = phase1_tags(cfg, i, rows[i], int(sizes[i]), control)
        counts[i] = torch.bincount(a[i], minlength=p)
        occ[i] = occurrence_rank(a[i])
    del rows
    recv = counts.T.contiguous()               # (provider, requester)
    offsets = torch.cumsum(recv, 1) - recv
    demand = recv.sum(1)
    if cfg.get("auto_capacity", True):
        budget = 1 << max(int(demand.max()) - 1, 0).bit_length()
    else:
        budget = cfg["total_capacity_factor"] * e
    used = demand.clamp(max=budget)
    start = torch.cumsum(e + used, 0) - (e + used)
    pools = torch.empty(int((e + used).sum()), dtype=_I32, device=device)
    for q in range(p):
        n = e + int(used[q])
        pools[int(start[q]): int(start[q]) + n] = provider_pool(cfg, q, n,
                                                                device)
    j = torch.arange(e, dtype=torch.int64, device=device)
    for i in range(p):
        prov = a[i].long()
        slot = offsets[prov, i] + occ[i]
        ok = slot < budget
        v = pools[start[prov] + e + torch.where(ok, slot, 0)]
        u = (i * v_per + j // k).to(_I32)
        yield u[ok], v[ok]


def pool_vertices_at(cfg: dict, prov: torch.Tensor,
                     slot: torch.Tensor) -> torch.Tensor:
    """Pool slot ``slot`` of provider ``prov`` (int64, elementwise) as a
    global vertex id: slot s >= E copies slot ``bits(s) % s`` of the same
    pool, until a slot below E, local vertex s // k."""
    e = cfg["vertices_per_proc"] * cfg["edges_per_vertex"]
    stream = rng.threefry2x32((0, int(cfg["seed"])), 0,
                              rng.STREAM_PBA_PHASE2_URN)
    k0, k1 = rng.threefry2x32(stream, 0, prov)
    s = slot.clone()
    live = torch.nonzero(s >= e).reshape(-1)
    while live.numel():
        at = s[live]
        x0, x1 = rng.threefry2x32((k0[live], k1[live]), at >> 32,
                                  at & rng.MASK32)
        r = (x0 ^ x1) % at
        s[live] = r
        live = live[r >= e]
    return (prov * cfg["vertices_per_proc"]
            + s // cfg["edges_per_vertex"]).to(_I32)


def row_of(cfg: dict, u: torch.Tensor) -> torch.Tensor:
    """The processor row that owns source vertex ``u``."""
    return u // cfg["vertices_per_proc"]


def row_blocks(cfg: dict, rows, device, control: bool = False):
    """The (u, v) int32 edges of processor rows ``rows``, row by row."""
    p, v_per = cfg["procs"], cfg["vertices_per_proc"]
    k = cfg["edges_per_vertex"]
    e = v_per * k
    rows = sorted(int(r) for r in rows)
    table, sizes = make_factions(p, **cfg["factions"])
    seeds = torch.from_numpy(table).to(device)
    counts = torch.empty((p, p), dtype=torch.int64, device=device)
    tags = {}
    for i in range(p):
        a = phase1_tags(cfg, i, seeds[i], int(sizes[i]), control)
        counts[i] = torch.bincount(a, minlength=p)
        if i in rows:
            tags[i] = a
    recv = counts.T
    offsets = torch.cumsum(recv, 1) - recv
    demand = recv.sum(1)
    if cfg.get("auto_capacity", True):
        budget = 1 << max(int(demand.max()) - 1, 0).bit_length()
    else:
        budget = cfg["total_capacity_factor"] * e
    j = torch.arange(e, dtype=torch.int64, device=device)
    for i in rows:
        prov = tags[i].long()
        slot = offsets[prov, i] + occurrence_rank(tags[i])
        ok = slot < budget
        v = pool_vertices_at(cfg, prov[ok], e + slot[ok])
        yield (i * v_per + j // k)[ok].to(_I32), v
