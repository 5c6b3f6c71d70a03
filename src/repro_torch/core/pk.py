"""Parallel Kronecker (PK) generator — closed-form meta-edge expansion.

The JAX package's ``core/pk.py`` in torch, bit-identical to it for the
same seed graph and config. Edge t of the L-th Kronecker power G^{⊗L} of
a seed graph (e0 edges over n0 vertices) follows from the base-e0 digits
of t:

    t = sum_i d_i * e0^(L-1-i),   d_i ∈ [0, e0)
    U(t) = sum_i u0[d_i] * n0^(L-1-i),   V(t) likewise,

so any contiguous index range ``[t0, t1)`` is expanded with zero
communication. The range start is digit-decomposed on the host in exact
Python ints; the device decomposes only the local offset (< 2^31) and
carry-adds (the ``pk_expand`` kernel). Vertex ids fit int32 (n0^L <=
2^31 - 1, checked).

Randomization (the paper's "temporarily modify the seed graph"): with
probability ``noise`` per (edge, level) the digit is redrawn uniformly,
counter-based; optional deletion sampling emits -1 slots. The paper's
second randomization, XOR with a sparse Erdős–Rényi graph, is
:func:`xor_randomize` (numpy on the host).

:func:`generate_pk` spreads the index range over the devices of a
topology, one contiguous chunk per device (one process per device of a
``torch.distributed`` group), with no collective but the emitted-edge
count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import EdgeList, GenStats
from repro_torch.core.spec import SeedGraph
from repro_torch.kernels import ops
from repro_torch.runtime import blocking, spmd
from repro_torch.runtime import topology as topology_lib
from repro_torch.runtime.topology import Topology

__all__ = ["SeedGraph", "PKConfig", "star_clique_seed", "dense_power_seed",
           "pk_sizes", "decompose_base", "expand_chunk", "generate_pk_host",
           "generate_pk", "xor_randomize", "dense_kronecker_power"]


def star_clique_seed(num_vertices: int = 5) -> SeedGraph:
    """A seed in the spirit of the paper's Fig. 2: hub 0 + self-loops.

    Row/col 0 dense plus the diagonal — gives communities-within-communities
    blocks under Kronecker powering.
    """
    u, v = [], []
    for i in range(num_vertices):
        u.append(0), v.append(i)
        if i:
            u.append(i), v.append(i)
    return SeedGraph(np.array(u, np.int32), np.array(v, np.int32), num_vertices)


def dense_power_seed(num_vertices: int, avg_degree: int, seed: int = 0) -> SeedGraph:
    """Random seed with e0 = n0*avg_degree edges (paper's large-degree seed)."""
    rng = np.random.default_rng(seed)
    e0 = num_vertices * avg_degree
    return SeedGraph(rng.integers(0, num_vertices, e0).astype(np.int32),
                     rng.integers(0, num_vertices, e0).astype(np.int32),
                     num_vertices)


@dataclasses.dataclass(frozen=True)
class PKConfig:
    """levels: Kronecker power L. noise: per-(edge, level) digit-redraw prob.
    delete_prob: per-edge deletion prob (static-shape -1 slots).
    seed: RNG seed for the randomization streams.

    Class and field names equal the JAX package's: ``spec_digest`` hashes
    them."""

    levels: int
    noise: float = 0.0
    delete_prob: float = 0.0
    seed: int = 0


def pk_sizes(seed: SeedGraph, cfg: PKConfig) -> tuple[int, int]:
    """(num_vertices, num_edges) of the expanded graph, exact python ints."""
    return seed.num_vertices ** cfg.levels, seed.num_edges ** cfg.levels


def _check_int32(seed: SeedGraph, cfg: PKConfig, chunk: int) -> None:
    n, _ = pk_sizes(seed, cfg)
    if n > 2**31 - 1:
        raise ValueError(f"n0^L = {n} exceeds int32 vertex-id space")
    if chunk > 2**31 - 1:
        raise ValueError(f"per-device chunk {chunk} exceeds int32")


def decompose_base(t0: int, base: int, levels: int) -> np.ndarray:
    """Host-side exact digit decomposition of a python int (MSB first)."""
    digits = np.zeros(levels, np.int32)
    for i in range(levels - 1, -1, -1):
        digits[i] = t0 % base
        t0 //= base
    if t0:
        raise ValueError("t0 out of range for levels")
    return digits


def seed_tables(seed: SeedGraph, device) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """The seed's (e0,) int32 endpoint tables on ``device``."""
    return (torch.from_numpy(np.ascontiguousarray(seed.u, np.int32))
            .to(device),
            torch.from_numpy(np.ascontiguousarray(seed.v, np.int32))
            .to(device))


def expand_chunk(t_local: torch.Tensor, base_digits, seed_u: torch.Tensor,
                 seed_v: torch.Tensor, n0: int, e0: int, levels: int,
                 cfg: PKConfig, rank: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Expansion of (m,) int32 local edge indices ``t_local`` of the range
    whose start has the (L,) MSB-first digits ``base_digits``, with the
    config's noise and deletion drawn under RNG rank ``rank``: the
    ``pk_expand`` kernel on the card, its plain version on the CPU.
    Returns (u, v) int32 global endpoint ids (-1 where deleted)."""
    return ops.pk_expand(t_local, base_digits, seed_u, seed_v, n0, e0,
                         levels, cfg.noise, cfg.delete_prob, cfg.seed,
                         rank=rank)


def generate_pk_host(seed: SeedGraph, cfg: PKConfig, *, device=None
                     ) -> tuple[EdgeList, GenStats]:
    """Single-device PK expansion of the full index range.

    ``device`` defaults to the current CUDA device and raises when there
    is none; ``device="cpu"`` runs the plain path."""
    SeedGraph.validate(seed)
    n, e = pk_sizes(seed, cfg)
    _check_int32(seed, cfg, e)
    device = spmd.resolve_device(device)
    su, sv = seed_tables(seed, device)
    t = torch.arange(e, dtype=torch.int32, device=device)
    u, v = expand_chunk(t, np.zeros(cfg.levels, np.int32), su, sv,
                        seed.num_vertices, seed.num_edges, cfg.levels, cfg,
                        rank=0)
    del t
    edges = EdgeList(src=u, dst=v, num_vertices=n)
    emitted = int((u >= 0).sum())
    return edges, GenStats(requested_edges=e, emitted_edges=emitted,
                           dropped_edges=e - emitted, num_vertices=n,
                           fallback_counts=ops.fallback_counts())


def generate_pk(seed: SeedGraph, cfg: PKConfig,
                topology: Optional[Topology] = None, *, device=None
                ) -> tuple[EdgeList, GenStats]:
    """PK over a topology of D devices (``topology`` None: flat over the
    process group's world size): device d expands the contiguous chunk
    [d*chunk, (d+1)*chunk), chunk = ceil(e / D), with RNG rank d, its
    range start digit-decomposed on the host; indices past e are -1.
    Returns this rank's (chunk,) share of the JAX package's
    ``generate_pk`` arrays and the global stats. Zero communication but
    the emitted count."""
    SeedGraph.validate(seed)
    device = spmd.resolve_device(device)
    topo = topology_lib.resolve(topology, device=device)
    num_procs = topo.num_devices
    n, e = pk_sizes(seed, cfg)
    chunk = -(-e // num_procs)
    _check_int32(seed, cfg, chunk)
    rank = blocking.device_index(topo)
    base = decompose_base(min(rank * chunk, e), seed.num_edges, cfg.levels)
    su, sv = seed_tables(seed, device)
    t = torch.arange(chunk, dtype=torch.int32, device=device)
    u, v = expand_chunk(t, base, su, sv, seed.num_vertices, seed.num_edges,
                        cfg.levels, cfg, rank=rank)
    del t
    if chunk * num_procs > e:
        u, v = blocking.mask_tail((u, v), rank, chunk, e)
    emitted = int(blocking.all_reduce_sum((u >= 0).sum(), topo))
    return (EdgeList(src=u, dst=v, num_vertices=n),
            GenStats(requested_edges=e, emitted_edges=emitted,
                     dropped_edges=e - emitted, num_vertices=n,
                     fallback_counts=ops.fallback_counts()))


def _xor_apply(src: np.ndarray, dst: np.ndarray, er_u: np.ndarray,
               er_v: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact multiset XOR of an edge list with sampled flip edges.

    XOR is an involution, so multiplicity matters on both sides:
      * a flip edge sampled an even number of times cancels pairwise —
        net no-op; odd multiplicity acts exactly once;
      * an acting flip that matches an existing edge removes *one* copy of
        it (an original with multiplicity > 1 keeps the rest);
      * an acting flip with no match is appended.
    O(E log E) via sorted matching.
    """
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    er_key = er_u.astype(np.int64) * n + er_v.astype(np.int64)
    flip_key, flip_mult = np.unique(er_key, return_counts=True)
    flip_key = flip_key[flip_mult % 2 == 1]  # even multiplicities cancel

    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    pos = np.searchsorted(sorted_key, flip_key)
    present = (pos < len(key)) & (sorted_key[np.minimum(pos, max(len(key) - 1, 0))]
                                  == flip_key) if len(key) else np.zeros(len(flip_key), bool)
    # flip_key entries are unique, so each present flip deletes one distinct
    # original occurrence (its first in sort order).
    keep_mask = np.ones(len(key), bool)
    keep_mask[order[pos[present]]] = False
    add_key = flip_key[~present]
    add_u = (add_key // n).astype(np.int32)
    add_v = (add_key % n).astype(np.int32)
    new_src = np.concatenate([src[keep_mask], add_u]).astype(np.int32)
    new_dst = np.concatenate([dst[keep_mask], add_v]).astype(np.int32)
    return new_src, new_dst


def xor_randomize(edges: EdgeList, flip_fraction: float = 0.01,
                  seed: int = 0) -> EdgeList:
    """The paper's second PK randomization: XOR the adjacency with a sparse
    Erdős–Rényi graph — edges present in both vanish, ER-only edges appear.

    |E|·flip_fraction ER edges are sampled (numpy, ``seed``) and XORed
    with exact multiset semantics (see :func:`_xor_apply`) on the host;
    the result lies on the input's device.
    """
    src, dst = edges.to_numpy()
    n = edges.num_vertices
    rng = np.random.default_rng(seed)
    m = max(int(len(src) * flip_fraction), 1)
    er_u = rng.integers(0, n, m).astype(np.int64)
    er_v = rng.integers(0, n, m).astype(np.int64)
    new_src, new_dst = _xor_apply(src, dst, er_u, er_v, n)
    dev = edges.src.device
    return EdgeList(src=torch.from_numpy(new_src).to(dev),
                    dst=torch.from_numpy(new_dst).to(dev), num_vertices=n)


def dense_kronecker_power(seed: SeedGraph, levels: int) -> np.ndarray:
    """Oracle: dense adjacency of the L-th Kronecker power (tiny graphs only)."""
    a0 = np.zeros((seed.num_vertices, seed.num_vertices), np.int32)
    a0[seed.u, seed.v] += 1
    a = a0.copy()
    for _ in range(levels - 1):
        a = np.kron(a, a0)
    return a
