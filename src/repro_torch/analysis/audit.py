"""The collective auditor: SPMD uniformity of the port's programs, shown
by their runs.

The port of the JAX package's ``repro.analysis.audit``. The reference
traces a plan's programs (jaxpr and optimised HLO, never executing) and
proves uniformity from their structure: identical collectives on every
``cond`` branch, ``while`` predicates all-reduced, all_to_all
instructions as many as the topology's hops. A torch program has no
jaxpr or HLO; what replaces them is the run itself. :class:`Recorder`, a
``TorchDispatchMode``, sees every ``c10d::`` dispatcher op a program
issues, with its tensors: its kind, each rank's bytes in and out, and
its group's ranks (``launch/op_stats.Call``). Then:

* **Counts.** :func:`expected_all_to_alls` restates the reference's pin
  for calls made rather than instructions compiled: a blocked transpose
  is one all_to_all a topology hop (flat 1, pods 2), the single-shot
  exchange runs two transposes (``hops * 2``), the streamed exchange one
  for exchange 1 and one a round (``hops * (1 + rounds)``), a stream
  round one, the stream's setup one, and the communication-free
  expansion none, on every topology. On ``pods(r, c)`` with r, c > 1
  the second hop of each transpose must be strided (cross-pod), the
  first contiguous: ``op_stats.all_to_all_span_bytes``'s split.
* **Uniformity.** Every rank's sequence of (op, bytes in, bytes out,
  group size, group span) is gathered to rank 0 and must be the same on
  every rank, trip count included. The reference proves this from its
  while-predicates and cond branches; here it is shown on data whose
  ranks' demands differ (the ``hub_stress`` preset's hub factions), where
  a collective skipped on one rank, or one round more on another, shows
  as a difference. (A collective issued on one rank alone would hang a
  real group; a recorder on a rank sees it before it blocks.)

:func:`audit_plan` and :func:`inventory` follow the reference's.
:func:`run_audit` spawns gloo ranks on the CPU and audits the gate
topologies (``python -m repro_torch.analysis audit``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Callable, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.op_stats import (Call, all_to_all_span_bytes,
                                         collect_collective_stats,
                                         collect_opcode_stats)
from repro_torch.runtime import spmd


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


class Recorder(TorchDispatchMode):
    """Records every ``c10d::`` op dispatched inside it as a
    :class:`~repro_torch.launch.op_stats.Call` (in :attr:`calls`, issue
    order), then runs it. Output arguments (schema names holding
    "output") count as bytes out, the others as bytes in; an op that
    works in place (all_reduce, broadcast) counts its tensors both ways."""

    def __init__(self):
        super().__init__()
        self.calls: list[Call] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            self.calls.append(self._call(func, args, kwargs))
        return func(*args, **kwargs)

    @staticmethod
    def _call(func, args, kwargs) -> Call:
        names = [a.name for a in func._schema.arguments]
        values = dict(zip(names, args))
        values.update(kwargs)
        b_in = b_out = 0
        ranks = None
        for name, v in values.items():
            if isinstance(v, torch.ScriptObject) and ranks is None:
                ranks = spmd.group_ranks(v)
                continue
            n = _tensor_bytes(v)
            if "output" in name:
                b_out += n
            else:
                b_in += n
        op = func.name().split("::", 1)[1].split(".")[0]
        if b_out == 0:                     # in place: the same buffers
            b_out = b_in
        return Call(op, b_in, b_out, ranks)


def record(fn: Callable, *args):
    """(fn(*args), the c10d calls it issued on this rank)."""
    rec = Recorder()
    with rec:
        out = fn(*args)
    return out, rec.calls


def expected_all_to_alls(topo, program: str, rounds: int = 1) -> int:
    """All_to_all calls a program makes on ``topo``: one a topology hop a
    blocked transpose; the single-shot exchange two transposes, the
    streamed one 1 + ``rounds``, a stream round one, the stream's setup
    one, the communication-free expansion none (on every topology: that
    absence is its contract, audited as strictly as the exchange's
    presence)."""
    if program == "cfree":
        return 0
    hops = max(topo.ndim, 1)
    if program == "exchange":
        return hops * 2 if rounds <= 1 else hops * (1 + rounds)
    if program == "exchange_streamed":
        return hops * (1 + rounds)
    return {"stream_round": hops, "stream_setup": hops}[program]


@dataclasses.dataclass
class ProgramAudit:
    label: str
    program: str
    topology: str
    num_devices: int
    counts_by_kind: dict
    bytes_by_kind: dict
    all_to_alls: int
    expected_all_to_alls: int
    span: dict
    rounds: int
    ranks_recorded: int
    uniform: bool
    problems: list
    calls: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("calls")
        d["opcodes"] = collect_opcode_stats(self.calls)
        d["ok"] = self.ok
        return d


def check_calls(per_rank: list, topo, label: str, program: str,
                rounds: int = 1) -> ProgramAudit:
    """Audit the call lists of every rank (rank order) of one program run
    on ``topo``: uniformity, the all_to_all count and, on pods, the
    hops' spans."""
    problems = []
    calls = per_rank[0]
    sigs = [[c.signature() for c in r] for r in per_rank]
    uniform = all(s == sigs[0] for s in sigs[1:])
    if not uniform:
        for rank, s in enumerate(sigs[1:], 1):
            if s == sigs[0]:
                continue
            first = next((i for i, (a, b) in enumerate(zip(sigs[0], s))
                          if a != b), min(len(s), len(sigs[0])))
            problems.append(
                f"uniformity: rank {rank} issues another collective "
                "sequence than "
                f"rank 0: {len(s)} calls against {len(sigs[0])}, the "
                f"first difference at call {first} "
                f"({s[first] if first < len(s) else None} against "
                f"{sigs[0][first] if first < len(sigs[0]) else None})")
    stats = collect_collective_stats(calls)
    span = all_to_all_span_bytes(calls)
    a2a = span["n_local"] + span["n_cross"]
    expect = expected_all_to_alls(topo, program, rounds)
    for rank, r in enumerate(per_rank):
        got = sum(c.kind == "all-to-all" for c in r)
        if got != expect:
            problems.append(
                f"all_to_all count: {topo.label} {program} issued {got} "
                f"all_to_alls on rank "
                f"{rank}, expected {expect} (one a topology hop a blocked "
                "transpose)")
    if topo.ndim == 2 and min(topo.axis_sizes) > 1 and expect:
        hops = [c.span for c in calls if c.kind == "all-to-all"]
        if hops[0::2] != ["local"] * len(hops[0::2]) or \
                hops[1::2] != ["cross"] * len(hops[1::2]):
            problems.append(
                f"hop span: {topo.label} {program}: the hops' spans are "
                f"{hops}; each "
                "transpose must go intra-pod (contiguous ranks) and then "
                "cross-pod (strided ranks)")
    return ProgramAudit(
        label=label, program=program, topology=topo.label,
        num_devices=topo.num_devices, counts_by_kind=stats.count_by_kind,
        bytes_by_kind=stats.bytes_by_kind, all_to_alls=a2a,
        expected_all_to_alls=expect, span=span, rounds=rounds,
        ranks_recorded=len(per_rank), uniform=uniform, problems=problems,
        calls=calls)


def audit_program(fn: Callable, args: tuple, topo, label: str,
                  program: str, rounds_of: Optional[Callable] = None
                  ) -> Optional[ProgramAudit]:
    """Run ``fn(*args)`` on every rank of the group under a recorder and
    audit it (a collective call: every rank calls it). ``rounds_of(out)``
    reads the rounds the run took from its output. Returns the audit on
    rank 0, None on the others."""
    out, calls = record(fn, *args)
    rounds = rounds_of(out) if rounds_of else 1
    gathered = spmd.gather_objects([c.to_json() for c in calls])
    if gathered is None:
        return None
    per_rank = [[Call.from_json(c) for c in r] for r in gathered]
    return check_calls(per_rank, topo, label, program, rounds)


def audit_exchange(pl, label: Optional[str] = None):
    """Audit a sharded plan's exchange program (phase 1 and both
    exchanges; streamed plans' exchange 2 runs its rounds)."""
    from repro_torch.launch.bench import sharded_pba
    fn, args = sharded_pba(pl)
    program = "exchange" if pl.config.exchange_rounds is None \
        else "exchange_streamed"
    return audit_program(fn, args, pl.topology,
                         label or f"{pl.topology.label}/exchange", program,
                         rounds_of=lambda out: int(out[4]))


def audit_stream_setup(pl, label: Optional[str] = None):
    """Audit a streamed plan's setup program (phase 1 and exchange 1)."""
    from repro_torch.launch.bench import sharded_stream_setup
    fn, args = sharded_stream_setup(pl)
    return audit_program(fn, args, pl.topology,
                         label or f"{pl.topology.label}/stream_setup",
                         "stream_setup")


def audit_stream_round(pl, label: Optional[str] = None):
    """Audit one round of a streamed plan's device-sharded exchange 2."""
    from repro_torch.launch.bench import sharded_stream_round
    fn, args = sharded_stream_round(pl)
    return audit_program(fn, args, pl.topology,
                         label or f"{pl.topology.label}/stream_round",
                         "stream_round")


def audit_cfree(pl, label: Optional[str] = None):
    """Audit a communication-free plan's expansion: zero collectives, on
    any topology."""
    from repro_torch.launch.bench import sharded_cfree
    fn, args = sharded_cfree(pl)
    return audit_program(fn, args, pl.topology,
                         label or f"{pl.topology.label}/cfree_{pl.model}",
                         "cfree")


def audit_plan(pl) -> list:
    """Every SPMD program a resolved plan launches, audited (rank 0's
    list; the other ranks' entries are None). Host plans have none."""
    if pl.topology.is_host or pl.executor in ("generate_pba_host",
                                              "generate_pk_host",
                                              "pba_stream_host",
                                              "generate_cfree_host"):
        return []
    if pl.model in ("ba_cfree", "rmat", "er"):
        return [audit_cfree(pl)]
    if pl.model != "pba":
        return []
    if pl.executor == "pba_stream_sharded":
        return [audit_stream_setup(pl), audit_stream_round(pl)]
    return [audit_exchange(pl)]


def inventory(audits: Iterable[ProgramAudit], extra: Optional[dict] = None
              ) -> dict:
    """Machine-readable audit inventory (the baseline artifact)."""
    audits = [a for a in audits if a is not None]
    out = {"torch_version": torch.__version__,
           "programs": {a.label: a.to_json() for a in audits},
           "ok": all(a.ok for a in audits)}
    if extra:
        out.update(extra)
    return out


def structural_view(inv: dict) -> dict:
    """The reviewed subtree of an inventory: each program's counts and
    bytes by kind, all_to_alls against the pin, spans and rounds. Drops
    the volatile fields (versions, ok flags)."""
    keep = ("program", "topology", "num_devices", "counts_by_kind",
            "bytes_by_kind", "all_to_alls", "expected_all_to_alls", "span",
            "rounds", "uniform", "opcodes")
    return {"devices": inv.get("devices"),
            "programs": {label: {k: p.get(k) for k in keep}
                         for label, p in inv.get("programs", {}).items()}}


# --- the gate suite over gloo ranks ------------------------------------------

def gate_specs(n_dev: int) -> list:
    """(label, spec, kind) of the gate programs on ``n_dev`` ranks: per
    topology (flat, and pods(2, n/2) from 4 ranks) the single-shot and
    4-round exchanges, the stream's setup and a round, the three
    communication-free models, and the hub_stress preset's exchange."""
    from repro_torch import api
    from repro_torch.core import FactionSpec
    topos = [api.Topology.flat(n_dev)]
    if n_dev >= 4 and n_dev % 2 == 0:
        topos.append(api.Topology.pods(2, n_dev // 2))
    out = []
    for topo in topos:
        procs = 2 * n_dev
        spec = api.GraphSpec(
            model="pba", procs=procs, vertices_per_proc=200,
            edges_per_vertex=3, seed=7, pair_capacity=256,
            factions=FactionSpec(max(procs // 2, 1), 2,
                                 max(procs // 2, 2), seed=1),
            topology=topo, execution="sharded")
        r4 = spec.replace(exchange_rounds=4, pair_capacity=64)
        t = topo.label
        out += [(f"{t}/exchange", spec, "exchange"),
                (f"{t}/exchange_r4", r4, "exchange"),
                (f"{t}/stream_setup", r4.replace(execution="streamed"),
                 "stream_setup"),
                (f"{t}/stream_round", r4.replace(execution="streamed"),
                 "stream_round"),
                (f"{t}/hub_stress", api.preset(
                    "hub_stress", procs=2 * n_dev, topology=topo,
                    execution="sharded"), "exchange")]
        for model, kw in (("ba_cfree", {"cfree_vertices": 64 * n_dev,
                                        "ba_degree": 2}),
                          ("rmat", {"cfree_vertices": 256,
                                    "cfree_edges": 128 * n_dev}),
                          ("er", {"cfree_vertices": 101,
                                  "cfree_edges": 128 * n_dev})):
            out.append((f"{t}/cfree_{model}", api.GraphSpec(
                model=model, seed=7, topology=topo, execution="sharded",
                **kw), "cfree"))
    return out


def run_gate(n_dev: int) -> list:
    """Audit :func:`gate_specs` on the current group (every rank calls
    it); rank 0 gets the audits."""
    from repro_torch import api
    audits = []
    for label, spec, kind in gate_specs(n_dev):
        pl = api.plan(spec, device="cpu")
        if kind == "exchange":
            audits.append(audit_exchange(pl, label))
        elif kind == "stream_setup":
            audits.append(audit_stream_setup(pl, label))
        elif kind == "stream_round":
            audits.append(audit_stream_round(pl, label))
        else:
            audits.append(audit_cfree(pl, label))
    return audits


def _gate_worker(rank: int, n_dev: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    spmd.init_group("gloo", init, n_dev, rank)
    try:
        audits = run_gate(n_dev)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(inventory(audits, extra={"devices": n_dev}), f)
    finally:
        spmd.destroy_group()


def spawn_ranks(fn: Callable, args: tuple, world: int,
                timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes; raises if
    one fails or they do not all finish within ``timeout`` seconds (then
    every one is killed)."""
    import time

    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    end = time.monotonic() + timeout
    while not ctx.join(timeout=2):
        if time.monotonic() > end:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{world} ranks did not finish within "
                               f"{timeout:.0f} s")


def run_audit(n_dev: int = 2, timeout: float = 600.0) -> dict:
    """Spawn ``n_dev`` gloo ranks on the CPU (``file://`` rendezvous in a
    temporary directory), audit the gate suite and return rank 0's
    inventory."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "audit.json")
        spawn_ranks(_gate_worker, (n_dev, "file://" + os.path.join(
            tmp, "rdv"), out), n_dev, timeout)
        with open(out) as f:
            return json.load(f)
