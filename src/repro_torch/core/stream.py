"""Out-of-core streaming: edge blocks from the generator to a sink.

The JAX package's ``core/stream.py`` (the PBA streams and ``PKStream``)
in torch; the communication-free stream is ``core/cfree.py``'s
``CFreeStream``. Each PBA
stream serves deterministic, independently regenerable blocks: block
``r`` is exactly the set of edges whose request rank falls in round r's
window ``[r*C_r, (r+1)*C_r)``. Two drivers give bit-identical blocks, so
a manifest started by either resumes under the other (and under the JAX
package's streams of the same spec):

  * :class:`PBAStream`, host-driven: phase 1 and one processor's urn pool
    at a time run on the device; the host resolves every edge once in
    numpy and buckets the edges by round.
  * :class:`PBAShardedStream`, device-resident on a device topology
    (``Topology.flat(d)`` or ``pods(r, c)``, one process per device of a
    ``torch.distributed`` group when d > 1): phase 1, the request ranks,
    the demand and the urn pools stay on the devices, every round's
    grant, transpose, band lookup, census and compaction run there, and
    only the round's kept edges leave. A rank's blocks are its own rows'
    edges: the one-device stream's edges whose ``u`` falls in its
    vertex range, in the same order.

:class:`PKStream` expands one slab of the Kronecker index range per
block on the device. It and ``CFreeStream`` keep their blocks on the
device for the memory sink (:func:`drain_on_device`).

:func:`stream_to_shards` drives a stream into ``storage.ShardWriter``; a
preempted run restarts by regenerating only the blocks the manifest says
are missing. The device stream is driven double-buffered through
:func:`repro_torch.runtime.streaming.drive_rounds`. Over a process group
rank 0 gathers each block from every rank, in rank order, and writes it;
the shard set equals the one-device run's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import pba, pk
from repro_torch.core import storage
from repro_torch.core.factions import FactionTable, validate_table
from repro_torch.core.graph import GenStats
from repro_torch.core.pba import PBAConfig
from repro_torch.core.pk import PKConfig
from repro_torch.core.spec import SeedGraph, spec_digest
from repro_torch.kernels import ops
from repro_torch.runtime import blocking, spmd, streaming
from repro_torch.runtime import topology as topology_lib
from repro_torch.runtime.topology import Topology


@dataclasses.dataclass
class EdgeBlock:
    """One streamed block: compacted host-side edges of block ``index``."""

    index: int
    src: np.ndarray
    dst: np.ndarray


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def stream_urn_budget(cfg: PBAConfig, max_demand: int,
                      auto_capacity: bool) -> int:
    """The uniform phase-2 urn budget every stream pool is drawn at.

    The budget bounds which slots are granted and which emit -1, so it is
    part of the graph's identity: both drivers of one spec derive the same
    value. auto mode covers the largest per-provider demand (no edge is
    dropped for urn exhaustion), rounded to a power of two so the graph is
    stable under small demand changes; parity mode is the static device
    budget, which reproduces ``generate_pba_host``.
    """
    if auto_capacity:
        return _next_pow2(max(max_demand, 1))
    return cfg.total_capacity_factor * cfg.edges_per_proc


def _warn_skewed_budget(cfg: PBAConfig, urn_budget: int,
                        mean_demand: float, resident_procs: int) -> None:
    """Warn when the uniform auto budget is dominated by a demand skew:
    every resident pool is drawn at the largest provider's demand."""
    if urn_budget > 8 * max(mean_demand, 1):
        warnings.warn(
            f"auto_capacity urn budget {urn_budget} is "
            f"{urn_budget / max(mean_demand, 1):.0f}x the mean provider "
            f"demand: the faction layout is heavily skewed, and every "
            f"resident pool ({resident_procs} per device/host) is drawn "
            f"at the max-demand budget (~4*{urn_budget}B each). For "
            "large skewed runs pin pair_capacity/total_capacity_factor "
            "(auto_capacity=False) to bound pool memory.",
            RuntimeWarning, stacklevel=3)


def _pba_stream_meta(cfg: PBAConfig, table: FactionTable,
                     auto_capacity: bool, num_procs: int, round_cap: int,
                     urn_budget: int) -> dict:
    """Everything the streamed graph depends on, as the JAX package
    records it: resume validation compares this dict. Topology-free, since
    both drivers emit identical blocks."""
    digest = hashlib.sha256(
        table.procs.tobytes() + table.s.tobytes()
    ).hexdigest()[:16]
    return {"generator": "pba", "seed": cfg.seed,
            "procs": num_procs,
            "vertices_per_proc": cfg.vertices_per_proc,
            "edges_per_vertex": cfg.edges_per_vertex,
            "interfaction_prob": cfg.interfaction_prob,
            "total_capacity_factor": cfg.total_capacity_factor,
            "auto_capacity": auto_capacity,
            "table_digest": digest,
            "round_capacity": round_cap,
            "urn_budget": urn_budget,
            "spec_digest": spec_digest(cfg, table, auto_capacity)}


def _narrow_keys(keys: np.ndarray, num_keys: int) -> np.ndarray:
    """``keys`` in [0, num_keys) in the narrowest unsigned type: a stable
    argsort then gives the same order by radix sort."""
    for dt in (np.uint8, np.uint16):
        if num_keys <= np.iinfo(dt).max + 1:
            return keys.astype(dt)
    return keys


class PBAStream:
    """Host-driven streaming PBA.

    The device runs phase 1 and one processor's urn pool at a time (each
    trimmed to that processor's own demand after the draw); the host keeps
    O(edges) state and serves block ``r`` as a slice of edges bucketed by
    round once. auto_capacity=True draws every pool at the uniform
    :func:`stream_urn_budget` (no urn-exhaustion drops for any faction
    layout); auto_capacity=False draws at ``total_capacity_factor * E``,
    and the blocks concatenate to ``generate_pba_host``'s edge multiset.

    ``device`` defaults to the current CUDA device and raises when there
    is none; ``device="cpu"`` runs the plain PyTorch path.
    """

    def __init__(self, cfg: PBAConfig, table: FactionTable,
                 auto_capacity: bool = True, *, device=None):
        validate_table(table)
        device = spmd.resolve_device(device)
        self.device = device
        self.cfg = cfg
        self.table = table
        self._auto_capacity = auto_capacity
        num_procs = self.num_procs = table.num_procs
        self.num_vertices = pba._check_vertex_space(cfg, num_procs)
        self.requested_edges = num_procs * cfg.edges_per_proc
        self.pair_capacity = pba._derived_pair_capacity(cfg, table, device)
        self.round_cap = streaming.round_capacity(
            self.pair_capacity, cfg.exchange_rounds or 1)
        e_local = cfg.edges_per_proc

        ranks = torch.arange(num_procs, dtype=torch.int32, device=device)
        a, counts = pba._phase1(ranks, torch.from_numpy(table.procs).to(
            device), torch.from_numpy(table.s).to(device), cfg, num_procs)
        occ = pba.occurrence_rank(a)
        prov = a.cpu().numpy()
        occ_h = occ.cpu().numpy()
        counts_h = counts.cpu().numpy()        # (requester, provider)
        del a, occ, counts
        self.num_blocks = streaming.rounds_needed(
            max(int(counts_h.max()), 1), self.round_cap)

        demand = counts_h.sum(axis=0, dtype=np.int64)  # per provider
        self.urn_budget = stream_urn_budget(cfg, int(demand.max()),
                                            auto_capacity)
        if auto_capacity:
            _warn_skewed_budget(cfg, self.urn_budget, float(demand.mean()),
                                1)

        # One processor's pool at a time, drawn at the uniform budget and
        # trimmed to its own demand, written into one flat host array.
        used = np.minimum(demand, self.urn_budget)
        row_len = e_local + used
        row_start = np.concatenate([[0], np.cumsum(row_len[:-1])]) \
            .astype(np.int64)
        pool_flat = np.empty(int(row_len.sum()), np.int32)
        for p in range(num_procs):
            row = pba._phase2_pool(ranks[p:p + 1], cfg, self.urn_budget)[0]
            pool_flat[row_start[p]: row_start[p] + row_len[p]] = \
                row[: row_len[p]].cpu().numpy()
            del row

        # Resolve every edge's endpoint once: the edge (i, j) with tag
        # a[i, j] = p and occurrence rank occ[i, j] was granted provider
        # p's pool slot offsets[p, i] + occ[i, j] (offsets from the
        # unclipped demand, the addressing of _grant_round).
        recv = counts_h.T.astype(np.int64)     # (provider, requester)
        offsets = np.cumsum(recv, axis=1) - recv
        slot = offsets[prov, np.arange(num_procs)[:, None]] + occ_h
        in_budget = slot < self.urn_budget
        idx = row_start[prov] + e_local + np.where(in_budget, slot, 0)
        del slot, prov
        v = np.where(in_budget, pool_flat[idx], -1).astype(np.int32)
        del idx, in_budget, pool_flat
        u = (np.arange(num_procs, dtype=np.int32)[:, None]
             * np.int32(cfg.vertices_per_proc)
             + (np.arange(e_local, dtype=np.int32)
                // cfg.edges_per_vertex)[None, :])

        # Bucket edges by round once, so block(i) is a slice.
        block_id = _narrow_keys((occ_h // self.round_cap).ravel(),
                                self.num_blocks)
        del occ_h
        order = np.argsort(block_id, kind="stable")
        self._bounds = np.concatenate(
            [[0], np.cumsum(np.bincount(block_id,
                                        minlength=self.num_blocks))])
        del block_id
        self._u_sorted = u.ravel()[order]
        del u
        self._v_sorted = v.ravel()[order]

    @property
    def exchange_rounds(self) -> int:
        return self.num_blocks

    def meta(self) -> dict:
        return _pba_stream_meta(self.cfg, self.table, self._auto_capacity,
                                self.num_procs, self.round_cap,
                                self.urn_budget)

    def block(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Edges resolved in round ``i``: request ranks [i*C_r, (i+1)*C_r)."""
        if not 0 <= i < self.num_blocks:
            raise ValueError(f"block {i} out of range [0, {self.num_blocks})")
        lo, hi = self._bounds[i], self._bounds[i + 1]
        u, v = self._u_sorted[lo:hi], self._v_sorted[lo:hi]
        keep = v >= 0
        return u[keep], v[keep]

    def iter_blocks(self) -> Iterator[EdgeBlock]:
        for i in range(self.num_blocks):
            src, dst = self.block(i)
            yield EdgeBlock(i, src, dst)


class PBAShardedStream:
    """Device-resident streaming PBA over a device topology, P = lp * D.

    The round contract of :class:`PBAStream`, executed on the devices:
    each device's phase 1 tags and request ranks (lp, E), transposed
    demand (lp, P) and urn pools stay resident across rounds, and each
    round (``core/pba.py::pba_stream_round_block``, its grant buffer
    through the topology's blocked transpose) returns a compacted
    (lp, min(E, P*C_r)) block. Blocks are bit-identical to
    :class:`PBAStream` for the same (cfg, table, auto_capacity), so
    manifests written by either driver resume under the other.

    ``topology`` defaults to ``Topology.flat`` over the process group's
    world size (1 with no group); a topology of D > 1 devices runs one
    process per device of the group, and the round count and urn budget
    come from the demand of all P procs, reduced over the group, so every
    rank runs the same rounds. The host topology belongs to
    :class:`PBAStream`. ``dispatch_block(i)`` enqueues round i and
    returns at once; ``gather_block(handle)`` waits for that round alone,
    checks it, and copies the kept edges to the host. On the card the
    check and the copy run on a side stream after the round's event, so a
    round dispatched later keeps the main stream busy meanwhile.
    ``gather_block_on_device`` leaves the edges on the device.
    """

    def __init__(self, cfg: PBAConfig, table: FactionTable,
                 topology: Optional[Topology] = None,
                 auto_capacity: bool = True, *, device=None):
        validate_table(table)
        device = spmd.resolve_device(device)
        if topology is not None and topology.is_host:
            raise ValueError(
                "PBAShardedStream runs a device topology; the host "
                "topology's stream is PBAStream")
        topo = topology_lib.resolve(topology, device=device)
        self.device = device
        self.topology = topo
        self.cfg = cfg
        self.table = table
        self._auto_capacity = auto_capacity
        num_procs = self.num_procs = table.num_procs
        self.num_vertices = pba._check_vertex_space(cfg, num_procs)
        self.requested_edges = num_procs * cfg.edges_per_proc
        self.pair_capacity = pba._derived_pair_capacity(cfg, table, device)
        self.round_cap = streaming.round_capacity(
            self.pair_capacity, cfg.exchange_rounds or 1)
        self.lp = topo.lp(num_procs)

        self._ranks, procs, s = pba._block_inputs(table, self.lp, topo,
                                                  device)
        self._a, self._occ, self._recv = pba.pba_stream_setup_block(
            self._ranks, procs, s, cfg, num_procs, topo)
        del procs, s
        # The round count and the urn budget are the whole graph's: the
        # largest pair count and provider demand over every rank, and the
        # demand's sum over all P providers for the mean.
        demand = self._recv.sum(1, dtype=torch.int64)  # per provider
        big_pair, big_demand = blocking.all_reduce_max(
            torch.stack([self._recv.max().long(), demand.max()]),
            topo).tolist()
        total_demand = int(blocking.all_reduce_sum(demand.sum(), topo))
        del demand
        self.num_blocks = streaming.rounds_needed(max(big_pair, 1),
                                                  self.round_cap)
        self.urn_budget = stream_urn_budget(cfg, big_demand, auto_capacity)
        if auto_capacity:
            _warn_skewed_budget(cfg, self.urn_budget,
                                total_demand / num_procs, self.lp)
        self.block_cap = pba.stream_block_capacity(
            cfg.edges_per_proc, num_procs, self.round_cap)
        self._pool = pba._phase2_pool(self._ranks, cfg, self.urn_budget)
        self._side = torch.cuda.Stream(device) if device.type == "cuda" \
            else None

    @property
    def exchange_rounds(self) -> int:
        return self.num_blocks

    def meta(self) -> dict:
        return _pba_stream_meta(self.cfg, self.table, self._auto_capacity,
                                self.num_procs, self.round_cap,
                                self.urn_budget)

    def dispatch_block(self, i: int):
        """Enqueue round ``i``; returns the in-flight (u, v, counts,
        event) handle without waiting for the round."""
        if not 0 <= i < self.num_blocks:
            raise ValueError(f"block {i} out of range [0, {self.num_blocks})")
        u, v, counts = pba.pba_stream_round_block(
            i, self._a, self._occ, self._recv, self._pool, self._ranks,
            self.cfg, self.num_procs, self.round_cap, self.urn_budget,
            self.block_cap, self.topology)
        event = None
        if self._side is not None:
            event = torch.cuda.Event()
            event.record()
        return u, v, counts, event

    def gather_block(self, handle) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a dispatched round, check it and return its kept
        edges on the host, in the host stream's block order.

        The round's per-provider band counts (the histogram kernel) must
        sum to the number of band slots the compaction kept (the
        band-compaction kernel); a mismatch raises. Kept edges are the
        slots with u >= 0 and v >= 0 (v is -1 for urn-exhausted grants),
        row-major."""
        u, v, counts, event = handle
        if event is None:
            src, dst = self._compact(u, v, counts)
        else:
            with torch.cuda.stream(self._side):
                self._side.wait_event(event)
                src, dst = self._compact(u, v, counts)
                src, dst = src.cpu(), dst.cpu()
        return src.numpy(), dst.numpy()

    def gather_block_on_device(self, handle
                               ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`gather_block`'s check and edges, left on the device
        (the memory sink's form: no copy to the host and back). Runs on
        the current stream, so it also waits for any round dispatched
        after this one."""
        return self._compact(*handle[:3])

    def _compact(self, u, v, counts) -> tuple[torch.Tensor, torch.Tensor]:
        u, v = u.reshape(-1), v.reshape(-1)
        band_slots, counted = blocking.all_reduce_sum(
            torch.stack([(u >= 0).sum(), counts.sum()]),
            self.topology).tolist()
        if band_slots != counted:
            raise AssertionError(
                f"round block inconsistency: compaction kept {band_slots} "
                f"band slots but the count kernel saw {counted}")
        keep = (u >= 0) & (v >= 0)
        return u[keep], v[keep]

    def block(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Edges resolved in round ``i``: request ranks [i*C_r, (i+1)*C_r)."""
        return self.gather_block(self.dispatch_block(i))

    def iter_blocks(self) -> Iterator[EdgeBlock]:
        for i in range(self.num_blocks):
            src, dst = self.block(i)
            yield EdgeBlock(i, src, dst)


class PKStream:
    """Per-slab streaming PK: contiguous index ranges, zero communication.

    Block ``i`` covers edge indices [i*slab_edges, (i+1)*slab_edges); the
    slab start is digit-decomposed exactly on the host, so block
    generation needs only int32 device arithmetic (the ``pk_expand``
    kernel) whatever the global edge count. The slab index doubles as the
    RNG rank, so blocks are deterministic given (cfg.seed, slab_edges) —
    independent of how many were already written. Every block expands the
    full slab width (the noise draws are (levels, slab_edges) per block,
    as in the JAX package) and keeps its first ``m`` edges. Blocks stay on
    the device (:meth:`block_on_device`); :meth:`block` copies one to the
    host.
    """

    def __init__(self, seed: SeedGraph, cfg: PKConfig,
                 slab_edges: int = 1 << 20, *, device=None):
        SeedGraph.validate(seed)
        if slab_edges < 1:
            raise ValueError(f"slab_edges must be >= 1, got {slab_edges}")
        if slab_edges > 2**31 - 1:
            raise ValueError(f"slab_edges {slab_edges} exceeds int32")
        self.seed = seed
        self.cfg = cfg
        self.slab_edges = slab_edges
        n, e = pk.pk_sizes(seed, cfg)
        if n > 2**31 - 1:
            raise ValueError(f"n0^L = {n} exceeds int32 vertex-id space")
        self.num_vertices = n
        self.requested_edges = e
        self.num_blocks = -(-e // slab_edges)
        self.exchange_rounds = 1
        self.device = spmd.resolve_device(device)
        self._su, self._sv = pk.seed_tables(seed, self.device)
        self._t = torch.arange(slab_edges, dtype=torch.int32,
                               device=self.device)

    def meta(self) -> dict:
        # spec_digest covers the seed graph's actual edge arrays: two seeds
        # with the same (n0, e0) but different edges produce the same
        # legacy meta and manifest shapes, and only the digest stops a
        # resume from interleaving their shards.
        return {"generator": "pk", "seed": self.cfg.seed,
                "levels": self.cfg.levels, "noise": self.cfg.noise,
                "delete_prob": self.cfg.delete_prob,
                "slab_edges": self.slab_edges,
                "spec_digest": spec_digest(self.seed, self.cfg,
                                           self.slab_edges)}

    def block_on_device(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Block ``i``'s kept (src, dst) int32 tensors on the device."""
        if not 0 <= i < self.num_blocks:
            raise ValueError(f"block {i} out of range [0, {self.num_blocks})")
        t0 = i * self.slab_edges
        base = pk.decompose_base(t0, self.seed.num_edges, self.cfg.levels)
        u, v = pk.expand_chunk(self._t, base, self._su, self._sv,
                               self.seed.num_vertices, self.seed.num_edges,
                               self.cfg.levels, self.cfg, rank=i)
        m = min(self.slab_edges, self.requested_edges - t0)
        u, v = u[:m], v[:m]
        keep = (u >= 0) & (v >= 0)
        return u[keep], v[keep]

    def block(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        u, v = self.block_on_device(i)
        return u.cpu().numpy(), v.cpu().numpy()

    def iter_blocks(self) -> Iterator[EdgeBlock]:
        for i in range(self.num_blocks):
            src, dst = self.block(i)
            yield EdgeBlock(i, src, dst)


def drain_on_device(stream, device) -> tuple[torch.Tensor, torch.Tensor]:
    """All of a stream's blocks, made on the device by
    ``stream.block_on_device``, copied in order into one preallocated
    (requested_edges,) pair on ``device`` and returned as views of the
    kept prefix. Peak memory is the output plus one block: no list of
    blocks and no concatenation."""
    src = torch.empty(stream.requested_edges, dtype=torch.int32,
                      device=device)
    dst = torch.empty_like(src)
    n = 0
    for i in range(stream.num_blocks):
        u, v = stream.block_on_device(i)
        k = u.numel()
        src[n:n + k] = u
        dst[n:n + k] = v
        n += k
    return src[:n], dst[:n]


def stream_topology(stream) -> Topology:
    """The topology a stream's blocks are spread over (the host topology
    for the streams that run on one device)."""
    return getattr(stream, "topology", None) or Topology.host()


def kept_total(stream, kept: int) -> int:
    """The edges every rank of the stream's topology kept, from this
    rank's ``kept``: the same on every rank."""
    return blocking.all_reduce_sum(int(kept), stream_topology(stream),
                                   stream.device)


def stream_stats(stream, emitted: int) -> GenStats:
    """The one stats contract for a drained stream (shards or memory);
    ``emitted`` counts the edges of every rank."""
    return GenStats(requested_edges=stream.requested_edges,
                    emitted_edges=emitted,
                    dropped_edges=stream.requested_edges - emitted,
                    num_vertices=stream.num_vertices,
                    exchange_rounds=stream.exchange_rounds,
                    pair_capacity=getattr(stream, "pair_capacity", 0),
                    fallback_counts=ops.fallback_counts())


def stream_to_shards(stream, out_dir: str, meta: Optional[dict] = None,
                     overlap: bool = True) -> tuple[dict, GenStats]:
    """Drive a stream's blocks into the resumable shard writer.

    Returns (manifest, stats). On restart only the blocks the manifest
    reports missing are generated. Streams with the
    ``dispatch_block`` / ``gather_block`` pair (the device stream) are
    driven double-buffered: block i+1's round is dispatched before block i
    is gathered and written (``overlap=False`` serializes them). A stream
    spread over a process group writes through :func:`_shards_from_ranks`.
    """
    if blocking.collective(stream_topology(stream)):
        return _shards_from_ranks(stream, out_dir, meta, overlap)
    writer = storage.ShardWriter(out_dir, stream.num_vertices,
                                 stream.num_blocks,
                                 meta={**stream.meta(), **(meta or {})})
    missing = writer.missing()
    if hasattr(stream, "dispatch_block"):
        streaming.drive_rounds(
            missing, stream.dispatch_block,
            lambda i, handle: writer.write_block(
                i, *stream.gather_block(handle)),
            overlap=overlap)
    else:
        for i in missing:
            src, dst = stream.block(i)
            writer.write_block(i, src, dst)
    return writer.manifest, stream_stats(stream, writer.edges_written)


def _shards_from_ranks(stream, out_dir: str, meta: Optional[dict],
                       overlap: bool) -> tuple[dict, GenStats]:
    """:func:`stream_to_shards` for a stream spread over a process group.

    Rank 0 opens (or resumes) the shard set and sends every rank the
    blocks it is missing, so all ranks drive the same blocks in the same
    order; each block's kept edges are gathered to rank 0 in rank order
    (the one-device block) and written there. Other ranks write nothing
    and wait for rank 0's manifest, which every rank returns.
    """
    topo, dev = stream_topology(stream), stream.device
    writer = None

    def open_writer():
        nonlocal writer
        writer = storage.ShardWriter(out_dir, stream.num_vertices,
                                     stream.num_blocks,
                                     meta={**stream.meta(), **(meta or {})})
        return writer.missing()

    missing = blocking.run_on_root(open_writer, topo, dev)

    def write(i, src, dst):
        block = blocking.gather_to_root((src, dst), topo)
        if writer is not None:
            writer.write_block(i, block[0].cpu().numpy(),
                               block[1].cpu().numpy())

    if hasattr(stream, "dispatch_block"):
        streaming.drive_rounds(
            missing, stream.dispatch_block,
            lambda i, handle: write(i, *stream.gather_block_on_device(
                handle)),
            overlap=overlap)
    else:
        for i in missing:
            write(i, *stream.block_on_device(i))
    manifest = blocking.run_on_root(lambda: writer.manifest, topo, dev)
    return manifest, stream_stats(stream, sum(manifest["counts"].values()))
