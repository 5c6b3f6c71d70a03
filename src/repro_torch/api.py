"""One front door: ``GraphSpec -> plan() -> generate()``, on the card.

The JAX package's ``repro.api`` in torch:

    from repro_torch import api

    spec = api.preset("paper_smoke")
    pl = api.plan(spec)            # validated, inspectable; nothing runs
    res = api.generate(pl)         # EdgeList of torch tensors + GenStats

Entry points run on the current CUDA device and raise when there is none;
``plan(spec, device="cpu")`` / ``generate(spec, device="cpu")`` run the
plain PyTorch path on the CPU. The device is a keyword, not a spec field:
every field of a spec is part of its digest.

Every model and execution of the JAX package, into memory or into
resumable shards: ``execution="host"`` (one device), ``"sharded"``
(``generate_pba`` / ``generate_pba_sharded``, ``generate_pk``,
``generate_cfree``) and ``"streamed"`` (``PBAStream`` and
``PBAShardedStream``, ``PKStream``, ``CFreeStream``).

A device topology of D > 1 devices runs one process per device under a
``torch.distributed`` process group of world size D that the caller
initialises (``torchrun``: NCCL on the card, gloo on the CPU); the
process rank is the linear device index, and with no device given a rank
runs on ``cuda:LOCAL_RANK``. The planner reads D from the group (1 with
no group). Each rank's ``GenResult`` holds the global ``GenStats`` and
its own share of the edges: its rows [d*lp, (d+1)*lp) of the sharded
arrays, or its rows' edges of each streamed block; rank 0 writes the
shards of the whole graph and every rank returns the manifest.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import cfree as cfree_lib
from repro_torch.core import factions as factions_lib
from repro_torch.core import pba as pba_lib
from repro_torch.core import pk as pk_lib
from repro_torch.core import storage as storage_lib
from repro_torch.core import stream as stream_lib
from repro_torch.core.cfree import CFreeConfig
from repro_torch.core.factions import FactionSpec, FactionTable, validate_table
from repro_torch.core.graph import EdgeList, GenStats
from repro_torch.core.pba import PBAConfig
from repro_torch.core.pk import PKConfig, SeedGraph
from repro_torch.core.spec import EXECUTIONS, MODELS, SINKS, GraphSpec
from repro_torch.runtime import blocking, spmd, streaming
from repro_torch.runtime import topology as topology_lib
from repro_torch.runtime.topology import Topology

__all__ = ["GraphSpec", "GenPlan", "GenResult", "plan", "generate",
           "preset", "PRESETS", "Topology", "FactionSpec"]

# --- plan ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class GenPlan:
    """A validated, inspectable compilation of a :class:`GraphSpec`.

    The same fields as the JAX package's GenPlan (executor, topology and
    P = lp * D, derived budgets, byte estimates), plus the ``device`` the
    plan was made for (the derived pair capacity reads its memory) and
    the ``rank`` of this process: its device index in the topology.
    """

    spec: GraphSpec
    model: str
    execution: str              # resolved: host | sharded | streamed
    sink: str
    executor: str               # internal entry point the plan dispatches to
    topology: Topology
    num_procs: int              # logical processors P
    lp: int                     # logical procs per device (P = lp * D)
    num_vertices: int
    requested_edges: int
    pair_capacity: int          # per-(sender, receiver) budget C
    exchange_rounds: int        # configured rounds R (1 = single-shot)
    round_capacity: int         # C_r = ceil(C / R)
    urn_budget: int             # phase-2 urn slots per proc
    device_bytes: int           # rough per-device working set
    host_bytes: int             # rough host-RAM working set
    disk_bytes: int             # rough on-disk size (0 for memory sink)
    config: Union[PBAConfig, PKConfig, CFreeConfig]
    table: Optional[FactionTable] = None
    seed_graph: Optional[SeedGraph] = None
    block_bytes: int = 0        # streamed: per-round gathered block
    overlap_bytes: int = 0      # streamed: extra in-flight double-buffer
    device: Optional[torch.device] = None
    rank: int = 0               # this process's device index (0 on host)

    def describe(self) -> str:
        """Human-readable resolved plan."""
        d = self.topology.num_devices
        lines = [
            f"GraphSpec[{self.model}] seed={self.config.seed} -> "
            f"{self.num_vertices:,} vertices, "
            f"{self.requested_edges:,} edges",
            f"  executor:  {self.executor} (execution={self.execution}, "
            f"sink={self.sink}, device={self.device})",
            f"  topology:  {self.topology.label}  "
            f"P = lp*D = {self.lp} * {d} = {self.num_procs}"
            + (f"; rank {self.rank} of {d} holds logical procs "
               f"[{self.rank * self.lp}, {(self.rank + 1) * self.lp})"
               if d > 1 else ""),
            f"  exchange:  pair_capacity={self.pair_capacity}, "
            f"rounds={self.exchange_rounds}, C_r={self.round_capacity}, "
            f"urn_budget={self.urn_budget}",
        ]
        if self.execution == "streamed":
            lines.append(
                f"  stream:    block ~{_fmt_bytes(self.block_bytes)}/round"
                + (f", overlap buffer ~{_fmt_bytes(self.overlap_bytes)}"
                   if self.overlap_bytes else ", overlap off"))
        lines.append(
            f"  bytes:     device ~{_fmt_bytes(self.device_bytes)}, "
            f"host ~{_fmt_bytes(self.host_bytes)}, "
            f"disk ~{_fmt_bytes(self.disk_bytes)}")
        return "\n".join(lines)


@dataclasses.dataclass
class GenResult:
    """What ``generate`` returns: the plan it ran, stats, and the sink's
    product -- an in-memory :class:`EdgeList` and/or a shard manifest.
    ``stream_meta`` is the stream's meta (streamed execution: the dict a
    shard manifest records, with the run's ``urn_budget``)."""

    plan: GenPlan
    stats: GenStats
    edges: Optional[EdgeList] = None
    manifest: Optional[dict] = None
    out_dir: Optional[str] = None
    stream_meta: Optional[dict] = None


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def _resolve_factions(spec: GraphSpec) -> FactionTable:
    f = spec.factions
    p = spec.procs
    if isinstance(f, FactionTable):
        table = f
    elif isinstance(f, FactionSpec):
        table = factions_lib.make_factions(p, f)
    elif isinstance(f, str):
        if f == "hub":
            table = factions_lib.hub_factions(p)
        elif f.startswith("block:"):
            table = factions_lib.block_factions(p, int(f.split(":", 1)[1]))
        else:
            raise ValueError(
                f"unknown faction layout {f!r}: use 'hub', 'block:<size>', "
                "a FactionSpec, or a FactionTable")
    elif f is None:
        table = factions_lib.make_factions(
            p, FactionSpec(max(p // 2, 1), min(2, p),
                           min(max(p // 2, 2), p), seed=1))
    else:
        raise ValueError(f"cannot build factions from {type(f).__name__}")
    validate_table(table)
    if table.num_procs != p:
        raise ValueError(
            f"faction table covers {table.num_procs} processors but the "
            f"spec asks for procs={p}")
    return table


def _resolve_execution(spec: GraphSpec, divisible: bool) -> str:
    """Pick the execution path for ``auto`` as the JAX package does, with
    D the process group's world size; validate explicit requests."""
    ex = spec.execution
    if ex not in EXECUTIONS:
        raise ValueError(f"unknown execution {ex!r}: one of {EXECUTIONS}")
    topo = spec.topology
    if ex == "auto":
        if spec.sink == "shards":
            ex = "streamed"
        elif topo is not None and topo.is_host:
            ex = "host"
        else:
            d = topo.num_devices if topo is not None \
                else spmd.device_count()
            ex = "sharded" if d > 1 and divisible else "host"
    if ex == "host" and topo is not None and not topo.is_host:
        raise ValueError(
            f"host execution cannot run over device topology "
            f"{topo.label}; use execution='sharded'")
    if ex == "sharded" and topo is not None and topo.is_host:
        raise ValueError(
            "sharded execution needs a device topology, got "
            "Topology.host(); use execution='host'")
    return ex


def _device_topology(spec: GraphSpec, device: torch.device,
                     num_procs: Optional[int] = None
                     ) -> tuple[Topology, int]:
    """(topology, lp) for a run over a device topology, checked before any
    work: D must be the process group's world size (1 with no group),
    and the group's backend must carry ``device``'s tensors.
    ``num_procs=None`` skips the P = lp * D factorization (PK partitions
    the index space per device)."""
    topo = topology_lib.resolve(spec.topology, device=device)
    lp = topo.lp(num_procs) if num_procs is not None else 1
    return topo, lp


def _streamed_pba_topology(spec: GraphSpec, num_procs: int,
                           device: torch.device
                           ) -> tuple[Topology, int, str]:
    """(topology, lp, executor) for a streamed PBA plan, resolved as the
    JAX package resolves it: the device stream whenever a device topology
    is usable (an explicit one, or a process group of D > 1 ranks that P
    divides), the host-driven stream otherwise and for
    ``Topology.host()``."""
    topo = spec.topology
    if topo is not None:
        if topo.is_host:
            return Topology.host(), num_procs, "pba_stream"
        topo, lp = _device_topology(spec, device, num_procs)
        return topo, lp, "pba_stream_sharded"
    d = spmd.device_count()
    if d > 1 and num_procs % d == 0:
        topo, lp = _device_topology(spec, device, num_procs)
        return topo, lp, "pba_stream_sharded"
    return Topology.host(), num_procs, "pba_stream"


def _plan_pba(spec: GraphSpec, device: torch.device) -> GenPlan:
    if spec.procs < 1 or spec.vertices_per_proc < 1 \
            or spec.edges_per_vertex < 1:
        raise ValueError(
            "pba scale incomplete: procs, vertices_per_proc and "
            f"edges_per_vertex must all be >= 1, got ({spec.procs}, "
            f"{spec.vertices_per_proc}, {spec.edges_per_vertex})")
    table = _resolve_factions(spec)
    cfg = PBAConfig(vertices_per_proc=spec.vertices_per_proc,
                    edges_per_vertex=spec.edges_per_vertex,
                    interfaction_prob=spec.interfaction_prob,
                    pair_capacity=spec.pair_capacity,
                    exchange_rounds=spec.exchange_rounds,
                    total_capacity_factor=spec.total_capacity_factor,
                    seed=spec.seed)
    p = spec.procs
    execution = _resolve_execution(
        spec, divisible=p % spmd.device_count() == 0
        if spec.topology is None else True)
    if execution == "sharded":
        topo, lp = _device_topology(spec, device, p)
        executor = ("generate_pba" if lp == 1 and topo.num_devices == p
                    else "generate_pba_sharded")
    elif execution == "streamed":
        topo, lp, executor = _streamed_pba_topology(spec, p, device)
    else:
        topo, lp, executor = Topology.host(), p, "generate_pba_host"

    pair_capacity = pba_lib._derived_pair_capacity(cfg, table, device)
    rounds = cfg.exchange_rounds or 1
    c_r = streaming.round_capacity(pair_capacity, rounds)
    e = cfg.edges_per_proc
    t_cap = cfg.total_capacity_factor * e
    requested = p * e
    # Rough working sets (int32 everywhere), as the JAX package counts
    # them: edges, counts, one round buffer and the pool per processor.
    # Streamed auto_capacity pools are demand-sized at run time; the
    # static budget stands in here (plan() never runs phase 1).
    per_proc = 4 * (4 * e + p + p * c_r + (e + t_cap))
    block_bytes = overlap_bytes = 0
    if execution == "streamed":
        block_cap = pba_lib.stream_block_capacity(e, p, c_r)
        block_bytes = 8 * p * block_cap  # gathered (u, v) block per round
        if executor == "pba_stream_sharded":
            # Resident per device: tags + ranks (2E), pool (E + t_cap),
            # demand row (P), the round's emit and receive buffers and
            # the compacted block, per logical proc, times lp.
            device_bytes = 4 * lp * (3 * e + t_cap + p + 2 * p * c_r
                                     + 2 * block_cap)
            host_bytes = block_bytes
            if spec.overlap:
                # A second block in flight: its device output plus the
                # host copy being written back.
                overlap_bytes = 2 * block_bytes
                host_bytes += block_bytes
        else:
            # Host-driven: phase 1 over all P on the device, one pool at a
            # time; the host keeps O(edges) tags, ranks and pools.
            device_bytes = 4 * (2 * p * e + p * p) + 4 * (e + t_cap)
            host_bytes = 4 * 4 * p * e
    else:
        device_bytes = lp * per_proc
        host_bytes = 8 * requested if spec.sink == "memory" else 0
    disk_bytes = 8 * requested if spec.sink == "shards" else 0
    return GenPlan(spec=spec, model="pba", execution=execution,
                   sink=spec.sink, executor=executor, topology=topo,
                   num_procs=p, lp=lp,
                   num_vertices=p * cfg.vertices_per_proc,
                   requested_edges=requested, pair_capacity=pair_capacity,
                   exchange_rounds=rounds, round_capacity=c_r,
                   urn_budget=t_cap, device_bytes=device_bytes,
                   host_bytes=host_bytes, disk_bytes=disk_bytes,
                   config=cfg, table=table, block_bytes=block_bytes,
                   overlap_bytes=overlap_bytes, device=device,
                   rank=blocking.device_index(topo))


def _plan_pk(spec: GraphSpec, device: torch.device) -> GenPlan:
    if spec.levels < 1:
        raise ValueError(f"pk needs levels >= 1, got {spec.levels}")
    seed_graph = spec.seed_graph or pk_lib.star_clique_seed(5)
    SeedGraph.validate(seed_graph)
    cfg = PKConfig(levels=spec.levels, noise=spec.noise,
                   delete_prob=spec.delete_prob, seed=spec.seed)
    n, e = pk_lib.pk_sizes(seed_graph, cfg)
    if n > 2**31 - 1:
        raise ValueError(
            f"n0^L = {n} exceeds int32 vertex-id space "
            f"(n0={seed_graph.num_vertices}, L={cfg.levels})")
    execution = _resolve_execution(spec, divisible=True)
    if execution == "streamed" and spec.topology is not None \
            and not spec.topology.is_host:
        raise ValueError(
            f"pk streamed execution is host-driven (slabs are already "
            f"communication-free); it cannot run over device topology "
            f"{spec.topology.label} — use execution='sharded' for "
            "on-device expansion or drop the topology")
    if execution == "sharded":
        topo, lp = _device_topology(spec, device)
        num_procs = topo.num_devices
        chunk = -(-e // num_procs)
        executor = "generate_pk"
    else:
        topo, num_procs, lp = Topology.host(), 1, 1
        chunk = spec.slab_edges if execution == "streamed" else e
        executor = ("pk_stream" if execution == "streamed"
                    else "generate_pk_host")
    if chunk > 2**31 - 1:
        raise ValueError(
            f"per-device chunk {chunk} exceeds int32 — shard over more "
            "devices or use streamed execution with a smaller slab_edges")

    # Expansion materializes (L, m) digit planes plus the (m,) outputs
    # (the JAX package's estimate; the kernel holds no digit planes).
    device_bytes = 4 * chunk * (2 * cfg.levels + 4)
    host_bytes = 8 * e if spec.sink == "memory" else 8 * chunk
    disk_bytes = 8 * e if spec.sink == "shards" else 0
    block_bytes = 8 * min(spec.slab_edges, e) \
        if execution == "streamed" else 0
    return GenPlan(spec=spec, model="pk", execution=execution,
                   sink=spec.sink, executor=executor, topology=topo,
                   num_procs=num_procs, lp=lp, num_vertices=n,
                   requested_edges=e, pair_capacity=0, exchange_rounds=1,
                   round_capacity=0, urn_budget=0,
                   device_bytes=device_bytes, host_bytes=host_bytes,
                   disk_bytes=disk_bytes, config=cfg,
                   seed_graph=seed_graph, block_bytes=block_bytes,
                   device=device, rank=blocking.device_index(topo))


def _plan_cfree(spec: GraphSpec, device: torch.device) -> GenPlan:
    cfg = CFreeConfig(model=spec.model, vertices=spec.cfree_vertices,
                      edges=spec.cfree_edges, ba_degree=spec.ba_degree,
                      rmat_a=spec.rmat_a, rmat_b=spec.rmat_b,
                      rmat_c=spec.rmat_c, seed=spec.seed)
    CFreeConfig.validate(cfg)
    n, e = cfree_lib.cfree_sizes(cfg)
    p_req = spec.procs
    d = spmd.device_count()
    execution = _resolve_execution(
        spec, divisible=True if spec.topology is not None or p_req == 0
        else p_req % max(d, 1) == 0)

    # Working set per logical rank: the index vector, the endpoint pair,
    # and the ba chain-resolution temporaries — a handful of int32 arrays
    # of the rank's chunk, no pools, no round buffers, no exchange (the
    # JAX package's estimate).
    block_bytes = 0
    if execution == "sharded":
        p = p_req or (spec.topology.num_devices if spec.topology is not None
                      else d)
        topo, lp = _device_topology(spec, device, p)
        executor = "generate_cfree"
        chunk = -(-e // p) if e else 0
        device_bytes = 4 * lp * chunk * 6
    elif execution == "streamed":
        topo = spec.topology
        if topo is None and d > 1:
            topo = Topology.flat(d)
        if topo is not None and not topo.is_host:
            topo = topology_lib.resolve(topo, device=device)
            p, lp, executor = topo.num_devices, 1, "cfree_stream_sharded"
        else:
            topo, p, lp = Topology.host(), 1, 1
            executor = "cfree_stream"
        slab = min(spec.slab_edges, e) if e else 0
        block_bytes = 8 * slab
        device_bytes = 4 * -(-slab // max(topo.num_devices, 1)) * 6
    else:
        topo, lp = Topology.host(), max(p_req, 1)
        p = lp
        executor = "generate_cfree_host"
        device_bytes = 4 * e * 6
    host_bytes = (block_bytes if execution == "streamed"
                  and spec.sink == "shards" else 8 * e)
    disk_bytes = 8 * e if spec.sink == "shards" else 0
    return GenPlan(spec=spec, model=spec.model, execution=execution,
                   sink=spec.sink, executor=executor, topology=topo,
                   num_procs=p, lp=lp, num_vertices=n,
                   requested_edges=e, pair_capacity=0, exchange_rounds=0,
                   round_capacity=0, urn_budget=0,
                   device_bytes=device_bytes, host_bytes=host_bytes,
                   disk_bytes=disk_bytes, config=cfg,
                   block_bytes=block_bytes, device=device,
                   rank=blocking.device_index(topo))


def plan(spec: GraphSpec, *, device=None) -> GenPlan:
    """Compile a :class:`GraphSpec` into a validated :class:`GenPlan` for
    ``device`` (default: the current CUDA device; raises without one).

    Pure resolution: nothing is generated. Raises ``ValueError`` for an
    invalid spec, and for a device topology that the process group
    cannot run (D other than the world size, or a backend that cannot
    carry the device's tensors).
    """
    device = spmd.resolve_device(device)
    if spec.model not in MODELS:
        raise ValueError(f"unknown model {spec.model!r}: one of {MODELS}")
    if spec.sink not in SINKS:
        raise ValueError(f"unknown sink {spec.sink!r}: one of {SINKS}")
    if spec.sink == "shards" and not spec.out_dir:
        raise ValueError("sink='shards' needs out_dir")
    if spec.model == "pba":
        return _plan_pba(spec, device)
    if spec.model == "pk":
        return _plan_pk(spec, device)
    return _plan_cfree(spec, device)


# --- generate -----------------------------------------------------------------

def _edges_from_stream(stream, device: torch.device, overlap: bool = True
                       ) -> tuple[EdgeList, GenStats]:
    """Drain a stream's blocks into one EdgeList on ``device`` + stats.

    The device stream is drained double-buffered (block i+1's round in
    flight while block i is gathered), and its blocks stay on the device;
    PK and communication-free blocks are made on the device and copied
    into one preallocated output there; the host-driven stream's numpy
    blocks are copied to the device once. Over a process group the edges
    are this rank's and the stats the whole graph's."""
    if hasattr(stream, "block_on_device"):
        src, dst = stream_lib.drain_on_device(stream, device)
        edges = EdgeList(src=src, dst=dst, num_vertices=stream.num_vertices)
        return edges, stream_lib.stream_stats(
            stream, stream_lib.kept_total(stream, src.numel()))
    srcs, dsts = [], []
    if hasattr(stream, "dispatch_block"):
        def gather(i, handle):
            src, dst = stream.gather_block_on_device(handle)
            srcs.append(src)
            dsts.append(dst)

        streaming.drive_rounds(range(stream.num_blocks),
                               stream.dispatch_block, gather,
                               overlap=overlap)
    else:
        for block in stream.iter_blocks():
            srcs.append(torch.from_numpy(block.src))
            dsts.append(torch.from_numpy(block.dst))
    empty = torch.empty(0, dtype=torch.int32)
    src = (torch.cat(srcs) if srcs else empty).to(device)
    del srcs
    dst = (torch.cat(dsts) if dsts else empty).to(device)
    del dsts
    edges = EdgeList(src=src, dst=dst, num_vertices=stream.num_vertices)
    return edges, stream_lib.stream_stats(
        stream, stream_lib.kept_total(stream, src.numel()))


def _write_shards(edges: EdgeList, pl: GenPlan) -> dict:
    """Write a generated graph as ``num_shards`` shards: the whole graph's
    padded edge arrays in rank order, gathered to rank 0 and written
    there; every rank returns the manifest."""
    topo = pl.topology
    flat = edges.flat()
    whole = blocking.gather_to_root((flat.src, flat.dst), topo)
    del flat
    return blocking.run_on_root(
        lambda: storage_lib.write_shards(
            EdgeList(*whole, edges.num_vertices), pl.spec.out_dir,
            num_shards=pl.spec.num_shards,
            meta={"spec_digest": pl.spec.digest()}),
        topo, pl.device)


def _make_stream(pl: GenPlan):
    if pl.model == "pk":
        return stream_lib.PKStream(pl.seed_graph, pl.config,
                                   slab_edges=pl.spec.slab_edges,
                                   device=pl.device)
    if pl.model != "pba":
        return cfree_lib.CFreeStream(
            pl.config, slab_edges=pl.spec.slab_edges,
            topology=pl.topology if pl.executor == "cfree_stream_sharded"
            else None, device=pl.device)
    if pl.executor == "pba_stream_sharded":
        return stream_lib.PBAShardedStream(
            pl.config, pl.table, topology=pl.topology,
            auto_capacity=pl.spec.auto_capacity, device=pl.device)
    return stream_lib.PBAStream(pl.config, pl.table,
                                auto_capacity=pl.spec.auto_capacity,
                                device=pl.device)


def generate(plan_or_spec: Union[GenPlan, GraphSpec], *,
             device=None) -> GenResult:
    """Execute a plan (or plan a spec for ``device`` and execute it).

    Bit-identical to the JAX package's ``generate`` for the same spec and
    pair capacity: over a process group, the concatenation of the ranks'
    edges in rank order. A plan runs on the device it was made for;
    passing another ``device`` with a plan raises.
    """
    if isinstance(plan_or_spec, GenPlan):
        pl = plan_or_spec
        if device is not None and spmd.resolve_device(device) != pl.device:
            raise ValueError(
                f"plan was made for {pl.device}, not {device}: plan the "
                "spec again for that device")
    else:
        pl = plan(plan_or_spec, device=device)
    spec = pl.spec

    if pl.execution == "streamed":
        stream = _make_stream(pl)
        if pl.sink == "shards":
            manifest, stats = stream_lib.stream_to_shards(
                stream, spec.out_dir, overlap=spec.overlap)
            return GenResult(plan=pl, stats=stats, manifest=manifest,
                             out_dir=spec.out_dir,
                             stream_meta=stream.meta())
        edges, stats = _edges_from_stream(stream, pl.device,
                                          overlap=spec.overlap)
        return GenResult(plan=pl, stats=stats, edges=edges,
                         stream_meta=stream.meta())

    dev = pl.device
    if pl.model == "pba":
        if pl.execution == "host":
            edges, stats = pba_lib.generate_pba_host(pl.config, pl.table,
                                                     device=dev)
        elif pl.executor == "generate_pba":
            edges, stats = pba_lib.generate_pba(
                pl.config, pl.table, topology=pl.topology, device=dev)
        else:
            edges, stats = pba_lib.generate_pba_sharded(
                pl.config, pl.table, topology=pl.topology, device=dev)
    elif pl.model == "pk":
        if pl.execution == "host":
            edges, stats = pk_lib.generate_pk_host(pl.seed_graph, pl.config,
                                                   device=dev)
        else:
            edges, stats = pk_lib.generate_pk(
                pl.seed_graph, pl.config, topology=pl.topology, device=dev)
    elif pl.execution == "host":
        edges, stats = cfree_lib.generate_cfree_host(pl.config, device=dev)
    else:
        edges, stats = cfree_lib.generate_cfree(
            pl.config, topology=pl.topology, num_procs=pl.num_procs,
            device=dev)
    result = GenResult(plan=pl, stats=stats, edges=edges)
    if pl.sink == "shards":
        result.manifest = _write_shards(edges, pl)
        result.out_dir = spec.out_dir
    return result


# --- presets ------------------------------------------------------------------

def _preset_paper_1b_5b() -> GraphSpec:
    """The paper's headline run: 1000 ranks, 1B vertices, 5B edges,
    streamed out-of-core."""
    return GraphSpec(model="pba", procs=1000, vertices_per_proc=1_000_000,
                     edges_per_vertex=5, exchange_rounds=8, seed=7,
                     execution="streamed")


def _preset_pod_1000rank() -> GraphSpec:
    """P=1000 logical ranks over whatever devices are present."""
    return GraphSpec(model="pba", procs=1000, vertices_per_proc=40,
                     edges_per_vertex=2, pair_capacity=8, seed=7)


def _preset_paper_smoke() -> GraphSpec:
    """Small end-to-end PBA smoke."""
    return GraphSpec(model="pba", procs=8, vertices_per_proc=2000,
                     edges_per_vertex=4, seed=7)


def _preset_hub_stress() -> GraphSpec:
    """Adversarial hub factions + streamed exchange: zero drops."""
    return GraphSpec(model="pba", procs=8, vertices_per_proc=300,
                     edges_per_vertex=4, factions="hub", pair_capacity=16,
                     exchange_rounds=4, total_capacity_factor=8, seed=5)


def _preset_pk_smoke() -> GraphSpec:
    """Small PK expansion (star-clique seed, 9^5 edges)."""
    return GraphSpec(model="pk", levels=5, noise=0.05, seed=3)


def _preset_pk_3b() -> GraphSpec:
    """Paper-scale PK: ~3.5B edges, streamed slab by slab."""
    return GraphSpec(model="pk", levels=10, seed=3, execution="streamed")


def _preset_rmat_smoke() -> GraphSpec:
    """Small communication-free R-MAT (2^14 vertices, 2^16 edges)."""
    return GraphSpec(model="rmat", cfree_vertices=1 << 14,
                     cfree_edges=1 << 16, seed=7)


def _preset_ba_cfree_1b() -> GraphSpec:
    """Paper-scale communication-free BA: 250M vertices x degree 4."""
    return GraphSpec(model="ba_cfree", cfree_vertices=250_000_000,
                     ba_degree=4, seed=7, execution="streamed")


PRESETS = {
    "paper_1b_5b": _preset_paper_1b_5b,
    "pod_1000rank": _preset_pod_1000rank,
    "paper_smoke": _preset_paper_smoke,
    "hub_stress": _preset_hub_stress,
    "pk_smoke": _preset_pk_smoke,
    "pk_3b": _preset_pk_3b,
    "rmat_smoke": _preset_rmat_smoke,
    "ba_cfree_1b": _preset_ba_cfree_1b,
}


def preset(name: str, **overrides) -> GraphSpec:
    """A named scenario as a one-liner; overrides are applied on top."""
    try:
        spec = PRESETS[name]()
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}: one of {sorted(PRESETS)}") from None
    return spec.replace(**overrides) if overrides else spec
