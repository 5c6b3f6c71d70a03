"""flowcheck: the port's three flow contracts, shown by runs.

The port of the JAX package's ``repro.analysis.flowcheck``, which proves
them by abstract interpretation over the jaxprs of the front-door
programs. A torch program has no jaxpr; each pass here runs the programs
and compares what they did:

  FC001 RNG lineage      the draw entry points of ``core/rng.py`` are
                         tapped (``rng.tapped``): each draw is recorded as
                         (stream id, rank, offset, count), its key traced
                         back through ``device_key``. For every front-door
                         program (``launch/bench.py``) and the host
                         executors, two runs that share (seed, rank,
                         budgets) and differ in runtime data (the faction
                         rows, and so the demand) must record the same
                         draws, and every draw's key must derive from the
                         spec's seed (``core.spec.DETERMINISM_ROOTS``). A
                         draw whose key or size reads runtime data shows
                         as a difference. (The reference slices each
                         ``random_*`` primitive to its input leaves.)
  FC002 axis roles       tag-valued tensors (each element's value encodes
                         its (lp, P, ...) source position) go through
                         ``blocking.transpose_counts`` and
                         ``transpose_payload`` on every gate topology over
                         the process group; each all_to_all hop's send
                         buffer must be split exactly by its
                         ``dev_dst:<axis>`` role (flat: the destination
                         device; pods: the destination chip, then the
                         destination pod), and the output must carry the
                         ``out`` roles of ``blocking.AXIS_ROLES``.
  FC003 digest soundness each GraphSpec field is perturbed and checked
                         against its class (``GraphSpec._ROUTING_FIELDS``,
                         ``_SINK_FIELDS``, ``_RUNTIME_ONLY_FIELDS``,
                         ``_MODEL_OWNED_FIELDS``): an identity field moves
                         both ``spec_digest`` and the edges of a tiny plan
                         on the CPU; a routing field (topology, execution,
                         overlap) may move the plan but never the digest
                         or the edges; a sink field (sink, out_dir,
                         num_shards) moves neither; a runtime-only field
                         moves the digest. (The reference compares traced
                         programs where this compares edges.)

:func:`run_flow` spawns gloo ranks for FC001's sharded programs and
FC002 and runs the host executors and FC003 in the calling process; its
inventory's :func:`structural_view` is what
``results/torch_flow_audit_baseline.json`` commits.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

KIND_TITLES = {
    "FC000": "run error",
    "FC001": "RNG draw depends on runtime data",
    "FC002": "blocked-layout axis role violated",
    "FC003": "spec_digest unsound for field",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One dataflow defect, addressed by (kind, program, where)."""

    kind: str          # FC000..FC003
    program: str       # program label, e.g. "flat_1x4/exchange"
    where: str         # "draws", a hop, "out", or the GraphSpec field
    message: str

    def format(self) -> str:
        return (f"{self.program}[{self.where}]: {self.kind} "
                f"{KIND_TITLES.get(self.kind, '')} - {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# --- FC001: RNG lineage ------------------------------------------------------

class DrawLog:
    """The draws of one scope: (stream, rank, offset, count) each, in
    order, with the seed each key came from ("?" for a key no
    ``device_key`` made)."""

    def __init__(self):
        self.keys: dict = {}
        self.draws: list = []

    def __call__(self, event, *d):
        if event == "device_key":
            out, seed, stream, rank = d
            self.keys[tuple(out)] = (seed, stream, rank)
        elif event == "bits":
            k, offset, count = d
            seed, stream, rank = self.keys.get(tuple(k), ("?", "?", "?"))
            self.draws.append((seed, stream, rank, offset, count))


def record_draws(fn: Callable, *args):
    """(fn(*args), its DrawLog)."""
    from repro_torch.core import rng
    log = DrawLog()
    with rng.tapped(log):
        out = fn(*args)
    return out, log


def lineage_findings(label: str, log_a: DrawLog, log_b: DrawLog,
                     seed: int, rng_expected: bool = True) -> list:
    """FC001 over two runs of one program that differ in runtime data."""
    out = []
    if log_a.draws != log_b.draws:
        first = next((i for i, (x, y) in enumerate(zip(log_a.draws,
                                                      log_b.draws))
                      if x != y), min(len(log_a.draws), len(log_b.draws)))
        out.append(Finding(
            "FC001", label, "draws",
            f"two runs with the same (seed, rank, budgets) and other "
            f"runtime data drew differently: {len(log_a.draws)} against "
            f"{len(log_b.draws)} draws, the first difference at draw "
            f"{first}"))
    bad = sorted({d[:3] for d in log_a.draws if d[0] != seed}, key=str)
    if bad:
        out.append(Finding(
            "FC001", label, "draws",
            f"draws keyed by {bad[:4]}, not by the spec's seed {seed} "
            "through device_key(seed, stream, rank)"))
    if rng_expected and not log_a.draws:
        out.append(Finding(
            "FC000", label, "draws", "the program was expected to draw "
            "and drew nothing: the pass is checking the wrong program"))
    return out


def draw_summary(log: DrawLog) -> dict:
    """Draws by stream: {stream: [calls, words]}."""
    out: dict = {}
    for _, stream, _, _, count in log.draws:
        c = out.setdefault(str(stream), [0, 0])
        c[0] += 1
        c[1] += int(count)
    return dict(sorted(out.items()))


@dataclasses.dataclass(frozen=True)
class FlowProgram:
    """One front-door program FC001 runs twice: ``build(spec)`` -> (fn,
    args); ``other`` is the spec with other runtime data (faction rows)."""

    label: str
    program: str
    spec: object
    other: object
    build: Callable
    rng_expected: bool = True


def _base_spec(n_dev: int, topo):
    from repro_torch.core import FactionSpec
    from repro_torch.core.spec import GraphSpec
    procs = 2 * n_dev
    return GraphSpec(
        model="pba", procs=procs, vertices_per_proc=20, edges_per_vertex=2,
        seed=7, pair_capacity=16, exchange_rounds=2,
        factions=FactionSpec(max(procs // 2, 1), 2, max(procs // 2, 2),
                             seed=1),
        topology=topo, execution="sharded")


def _other_factions(spec):
    return spec.replace(factions=dataclasses.replace(
        spec.factions, seed=spec.factions.seed + 1))


def front_door_programs(n_dev: int) -> list:
    """The sharded front-door programs over the gate topologies (flat, and
    pods(2, n/2) from 4 ranks)."""
    from repro_torch import api
    from repro_torch.launch import bench
    topos = [api.Topology.flat(n_dev)]
    if n_dev >= 4 and n_dev % 2 == 0:
        topos.append(api.Topology.pods(2, n_dev // 2))
    out = []
    for topo in topos:
        t = topo.label
        base = _base_spec(n_dev, topo)
        single = base.replace(exchange_rounds=None)
        streamed = base.replace(execution="streamed", auto_capacity=False)
        out += [FlowProgram(f"{t}/exchange", "exchange", single,
                            _other_factions(single), bench.sharded_pba),
                FlowProgram(f"{t}/exchange_r2", "exchange", base,
                            _other_factions(base), bench.sharded_pba),
                FlowProgram(f"{t}/stream_setup", "stream_setup", streamed,
                            _other_factions(streamed),
                            bench.sharded_stream_setup),
                FlowProgram(f"{t}/stream_round", "stream_round", streamed,
                            _other_factions(streamed),
                            bench.sharded_stream_round, rng_expected=False)]
        for model, kw in (("ba_cfree", {"cfree_vertices": 16 * n_dev,
                                        "ba_degree": 2}),
                          ("rmat", {"cfree_vertices": 256,
                                    "cfree_edges": 64 * n_dev}),
                          ("er", {"cfree_vertices": 101,
                                  "cfree_edges": 64 * n_dev})):
            cs = api.GraphSpec(model=model, seed=7, topology=topo,
                               execution="sharded", **kw)
            out.append(FlowProgram(f"{t}/cfree_{model}", "cfree", cs, cs,
                                   bench.sharded_cfree))
    return out


def check_program(prog: FlowProgram, device="cpu") -> tuple[list, dict]:
    """FC001 over one program: two runs, the draws compared."""
    from repro_torch import api
    logs = []
    try:
        for spec in (prog.spec, prog.other):
            fn, args = prog.build(api.plan(spec, device=device))
            logs.append(record_draws(fn, *args)[1])
    except Exception as exc:                       # noqa: BLE001
        return ([Finding("FC000", prog.label, "run",
                         f"failed to build or run: {exc!r}")],
                {"error": repr(exc)})
    findings = lineage_findings(prog.label, logs[0], logs[1],
                                prog.spec.seed, prog.rng_expected)
    return findings, {"program": prog.program,
                      "draws": draw_summary(logs[0]), "ok": not findings}


def host_programs() -> list:
    """(label, spec, other spec) of the host executors: PBA (its faction
    rows changed), PK with noise and deletions, and ba_cfree."""
    from repro_torch import api
    pba = _base_spec(1, None).replace(execution="host", topology=None)
    pk = api.preset("pk_smoke", levels=3, delete_prob=0.05)
    cf = api.GraphSpec(model="ba_cfree", cfree_vertices=64, ba_degree=2,
                       seed=7)
    return [("host/pba", pba, _other_factions(pba)),
            ("host/pba_r2", pba.replace(exchange_rounds=None),
             _other_factions(pba.replace(exchange_rounds=None))),
            ("host/pk", pk, pk), ("host/ba_cfree", cf, cf)]


def check_host(label: str, spec, other) -> tuple[list, dict]:
    """FC001 over a host executor, through ``api.generate`` on the CPU."""
    from repro_torch import api
    logs = [record_draws(lambda s=s: api.generate(s, device="cpu"))[1]
            for s in (spec, other)]
    findings = lineage_findings(label, logs[0], logs[1], spec.seed)
    return findings, {"program": "host", "draws": draw_summary(logs[0]),
                      "ok": not findings}


# --- FC002: axis roles -------------------------------------------------------

def _tags(lp: int, p: int, width: int, d: int) -> torch.Tensor:
    """(lp, P[, width]) int64: element (i, q, k) holds ((d*lp + i) * P + q)
    * width + k, its source row, destination column and payload index."""
    i = torch.arange(lp, dtype=torch.int64)[:, None]
    q = torch.arange(p, dtype=torch.int64)[None, :]
    base = (d * lp + i) * p + q
    if width == 0:
        return base
    return base[..., None] * width + torch.arange(width, dtype=torch.int64)


def _dst_device(tags: torch.Tensor, p: int, lp: int, width: int):
    q = (tags // max(width, 1)) % p
    return q // lp


class _SendTap(TorchDispatchMode):
    """Keeps a copy of every all_to_all's send buffer."""

    def __init__(self):
        super().__init__()
        self.sends: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d" and "alltoall" in func.name():
            self.sends.append(args[1].clone())
        return func(*args, **kwargs)


def check_transpose_roles(transpose: Callable, topo, entry: str, lp: int,
                          width: int = 0, label: str = "") -> tuple:
    """FC002 on this rank: push tags through ``transpose`` (an entry point
    of ``runtime/blocking.py``, or a stand-in) on ``topo`` over the
    current group. Returns (findings, report)."""
    from repro_torch.runtime import blocking
    roles = blocking.AXIS_ROLES[entry]
    label = label or f"{topo.label}/{entry}"
    d = blocking.device_index(topo)
    dev_n = topo.num_devices
    p = lp * dev_n
    x = _tags(lp, p, width, d)
    tap = _SendTap()
    with tap:
        out = transpose(x, topo)
    findings = []
    hops = []
    # the hops' axes in send order: flat its one axis; pods the chip, then
    # the pod
    axes = list(reversed(topo.axis_names))
    for h, send in enumerate(tap.sends):
        axis = axes[h] if h < len(axes) else "?"
        role = f"dev_dst:{axis}"
        dst = _dst_device(send, p, lp, width)
        if topo.ndim == 2:
            c = topo.axis_sizes[1]
            coord = dst % c if h == 0 else dst // c
        else:
            coord = dst
        want = torch.arange(send.shape[0], dtype=torch.int64).reshape(
            (-1,) + (1,) * (send.dim() - 1))
        ok = bool((coord == want).all())
        hops.append({"hop": h, "role": role, "ok": ok})
        if not ok:
            findings.append(Finding(
                "FC002", label, f"hop{h}",
                f"the all_to_all's send slabs are not split by {role}: "
                "a slab holds elements bound for another "
                f"{axis} coordinate"))
    expect_hops = 0 if not blocking.collective(topo) else max(topo.ndim, 1)
    if len(tap.sends) != expect_hops:
        findings.append(Finding(
            "FC002", label, "hops", f"{len(tap.sends)} all_to_all hops, "
            f"the topology's axes claim {expect_hops}"))
    # out[i, q, k] = X[q, d*lp + i, k]: my local proc, the source rank
    i = torch.arange(lp, dtype=torch.int64)[:, None]
    q = torch.arange(p, dtype=torch.int64)[None, :]
    want = q * p + (d * lp + i)
    if width:
        want = want[..., None] * width + torch.arange(width,
                                                      dtype=torch.int64)
    if tuple(out.shape) != tuple(want.shape) or not torch.equal(out, want):
        findings.append(Finding(
            "FC002", label, "out",
            f"the output does not carry the roles {roles['out']} "
            f"(out[i, q] must hold X[q, d*lp + i])"))
    return findings, {"in": list(roles["in"]), "out": list(roles["out"]),
                      "hops": hops, "ok": not findings}


# --- FC003: digest soundness -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FieldRule:
    """How one spec field is classified and perturbed for FC003."""

    name: str
    cls: str                      # identity | routing | sink | runtime
    perturb: Callable             # spec -> perturbed spec
    #: spec -> the spec the field is checked at (where it binds: the pair
    #: capacity under the single-shot exchange, which drops what does not
    #: fit; the urn budget under skewed demand)
    context: Optional[Callable] = None


def edges_fingerprint(spec, out_dir: Optional[str] = None) -> str:
    """sha256 of the multiset of (src, dst) pairs a spec generates on the
    CPU (padding dropped, sorted: layouts of different executions
    compare)."""
    from repro_torch import api
    from repro_torch.core import storage
    res = api.generate(spec, device="cpu")
    if res.edges is not None:
        src, dst = res.edges.src.reshape(-1), res.edges.dst.reshape(-1)
        src, dst = src.numpy(), dst.numpy()
    else:
        src, dst = storage.read_shards(spec.out_dir)[:2]
    keep = (src >= 0) & (dst >= 0)
    pairs = np.stack([src[keep], dst[keep]], 1).astype(np.int64)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    return hashlib.sha256(pairs.tobytes()).hexdigest()[:16]


def digest_soundness_findings(base, rules: Iterable[FieldRule],
                              digest_fn: Callable, edges_fn: Callable,
                              label: str = "spec") -> tuple[list, dict]:
    """Perturb each field and compare the digest's and the edges'
    movement against the field's class. Returns (findings, report)."""
    findings: list = []
    report: dict = {}
    at = {None: (digest_fn(base), edges_fn(base))}
    for rule in sorted(rules, key=lambda r: r.name):
        try:
            here = rule.context(base) if rule.context else base
            if rule.context not in at:
                at[rule.context] = (digest_fn(here), edges_fn(here))
            base_digest, base_edges = at[rule.context]
            pert = rule.perturb(here)
            digest_changed = digest_fn(pert) != base_digest
            edges_changed = edges_fn(pert) != base_edges
        except Exception as exc:                  # noqa: BLE001
            findings.append(Finding("FC000", label, rule.name,
                                    f"perturbation failed to plan or run: "
                                    f"{exc!r}"))
            report[rule.name] = {"class": rule.cls, "error": repr(exc)}
            continue
        report[rule.name] = {"class": rule.cls,
                             "digest_changed": digest_changed,
                             "edges_changed": edges_changed}
        if rule.cls == "identity":
            if edges_changed and not digest_changed:
                findings.append(Finding(
                    "FC003", label, rule.name,
                    "perturbing it changes the edges but not spec_digest: "
                    "a resume could interleave two graphs under one "
                    "fingerprint"))
            elif digest_changed and not edges_changed:
                findings.append(Finding(
                    "FC003", label, rule.name,
                    "spec_digest covers it but the edges do not move: a "
                    "dead field, or a missing non-identity declaration"))
            elif not digest_changed and not edges_changed:
                findings.append(Finding(
                    "FC003", label, rule.name,
                    "neither spec_digest nor the edges move: a dead "
                    "identity field"))
        elif rule.cls == "routing":
            if digest_changed:
                findings.append(Finding(
                    "FC003", label, rule.name,
                    "routing field in spec_digest: the same graph made "
                    "over another topology would refuse to resume"))
            if edges_changed:
                findings.append(Finding(
                    "FC003", label, rule.name,
                    "routing field moves the edges: the route must never "
                    "change what is generated"))
        elif rule.cls == "sink":
            if digest_changed:
                findings.append(Finding("FC003", label, rule.name,
                                        "sink field in spec_digest"))
            if edges_changed:
                findings.append(Finding(
                    "FC003", label, rule.name,
                    "sink field moves the edges: where edges land must "
                    "never change what is generated"))
        elif rule.cls == "runtime" and not digest_changed:
            findings.append(Finding(
                "FC003", label, rule.name,
                "runtime-binding identity field missing from spec_digest"))
    return findings, report


def fc003_base_spec():
    """The tiny PBA plan FC003 perturbs: one device topology without a
    group, sharded, the streamed exchange (2 rounds) over a small pair
    capacity, so the single-shot exchange would drop edges."""
    from repro_torch import api
    from repro_torch.core import FactionSpec
    return api.GraphSpec(
        model="pba", procs=8, vertices_per_proc=20, edges_per_vertex=2,
        seed=7, pair_capacity=2, exchange_rounds=2,
        factions=FactionSpec(4, 2, 4, seed=1),
        topology=api.Topology.flat(1), execution="sharded")


def _single_shot(spec):
    return spec.replace(exchange_rounds=None)


def _hub_demand(spec):
    return spec.replace(factions="hub")


def graphspec_rules(spec, tmp: str) -> tuple[list, list]:
    """FieldRules for every GraphSpec field from the classes declared on
    the dataclass; (rules, unclassified field names)."""
    from repro_torch.core.spec import GraphSpec
    from repro_torch.runtime.topology import Topology
    routing = set(GraphSpec._ROUTING_FIELDS)
    sink = set(GraphSpec._SINK_FIELDS)
    runtime = set(GraphSpec._RUNTIME_ONLY_FIELDS)
    non_identity = set(GraphSpec._NON_IDENTITY_FIELDS)
    other_model = set()
    for model, fields in GraphSpec._MODEL_OWNED_FIELDS.items():
        if model != spec.model:
            other_model.update(fields)
    other_model -= set(GraphSpec._MODEL_OWNED_FIELDS.get(spec.model, ()))
    perturbs = {
        "procs": lambda s: s.replace(procs=s.procs * 2),
        "vertices_per_proc":
            lambda s: s.replace(vertices_per_proc=s.vertices_per_proc + 1),
        "edges_per_vertex":
            lambda s: s.replace(edges_per_vertex=s.edges_per_vertex + 1),
        "factions": _other_factions,
        "interfaction_prob":
            lambda s: s.replace(interfaction_prob=s.interfaction_prob + 0.2),
        "pair_capacity": lambda s: s.replace(
            pair_capacity=(s.pair_capacity or 16) * 4),
        # the single-shot exchange drops what the streamed one serves
        "exchange_rounds": lambda s: s.replace(
            exchange_rounds=None if s.exchange_rounds else 2),
        "total_capacity_factor":
            lambda s: s.replace(total_capacity_factor=1),
        "auto_capacity":
            lambda s: s.replace(auto_capacity=not s.auto_capacity),
        "seed": lambda s: s.replace(seed=s.seed + 1),
        "topology": lambda s: s.replace(topology=Topology.pods(1, 1)),
        "execution": lambda s: s.replace(execution="streamed"),
        "overlap": lambda s: s.replace(overlap=not s.overlap),
        "sink": lambda s: s.replace(sink="shards",
                                    out_dir=os.path.join(tmp, "a")),
        "out_dir": lambda s: s.replace(out_dir=os.path.join(tmp, "b")),
        "num_shards": lambda s: s.replace(num_shards=s.num_shards + 1),
    }
    contexts = {"pair_capacity": _single_shot,
                "total_capacity_factor": _hub_demand}
    rules, unclassified = [], []
    for f in dataclasses.fields(spec):
        name = f.name
        if name == "model" or name in other_model:
            continue
        if name in runtime:
            cls = "runtime"
        elif name in routing:
            cls = "routing"
        elif name in sink:
            cls = "sink"
        elif name in non_identity:
            unclassified.append(name)
            continue
        else:
            cls = "identity"
        if name not in perturbs:
            unclassified.append(name)
            continue
        rules.append(FieldRule(name, cls, perturbs[name],
                               contexts.get(name)))
    if routing | sink != non_identity or routing & sink:
        unclassified.append("_NON_IDENTITY_FIELDS")
    return rules, unclassified


def check_digest(digest_fn: Optional[Callable] = None) -> tuple[list, dict]:
    """FC003 over the GraphSpec fields on the CPU. ``digest_fn`` replaces
    ``GraphSpec.digest`` (the tests hand in a broken one)."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = fc003_base_spec()
        rules, unclassified = graphspec_rules(spec, tmp)
        findings = [Finding(
            "FC003", "spec", name, "field has no flowcheck classification "
            "(identity / routing / sink / runtime-only / model-owned): "
            "declare it on GraphSpec") for name in unclassified]
        f, report = digest_soundness_findings(
            spec, rules, digest_fn or (lambda s: s.digest()),
            edges_fingerprint)
    return findings + f, report


# --- the driver --------------------------------------------------------------

def _flow_worker(rank: int, n_dev: int, init: str, out: str) -> None:
    from repro_torch.runtime import blocking, spmd
    torch.set_num_threads(1)
    spmd.init_group("gloo", init, n_dev, rank)
    try:
        findings, programs, transposes = [], {}, {}
        for prog in front_door_programs(n_dev):
            f, programs[prog.label] = check_program(prog)
            findings += f
        topos = {prog.spec.topology.label: prog.spec.topology
                 for prog in front_door_programs(n_dev)}
        for label, topo in topos.items():
            for entry, fn, width in (
                    ("transpose_counts", blocking.transpose_counts, 0),
                    ("transpose_payload", blocking.transpose_payload, 3)):
                f, transposes.setdefault(label, {})[entry] = \
                    check_transpose_roles(fn, topo, entry, 2, width)
                findings += f
        gathered = spmd.gather_objects(
            ([x.to_json() for x in findings], programs, transposes))
        if rank == 0:
            merged, progs, trans = [], {}, {}
            for r, (f, p, t) in enumerate(gathered):
                merged += [dict(x, program=f"rank{r}:{x['program']}")
                           for x in f]
                for k, v in p.items():
                    progs.setdefault(k, v)
                    progs[k]["ok"] = progs[k].get("ok", True) and v.get(
                        "ok", False)
                for k, v in t.items():
                    trans.setdefault(k, v)
            with open(out, "w") as fh:
                json.dump({"findings": merged, "programs": progs,
                           "transposes": trans}, fh)
    finally:
        spmd.destroy_group()


def run_flow(n_dev: int = 4, digest: bool = True,
             timeout: float = 600.0) -> tuple[list, dict]:
    """All three passes: FC001 and FC002 on ``n_dev`` spawned gloo ranks
    (``file://`` rendezvous in a temporary directory), FC001 of the host
    executors and FC003 here. Returns (findings, inventory)."""
    from repro_torch.analysis.audit import spawn_ranks
    from repro_torch.core.spec import DETERMINISM_ROOTS
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "flow.json")
        spawn_ranks(_flow_worker, (n_dev, "file://" + os.path.join(
            tmp, "rdv"), out), n_dev, timeout)
        with open(out) as f:
            sharded = json.load(f)
    findings = [Finding(**x) for x in sharded["findings"]]
    programs = dict(sharded["programs"])
    for label, spec, other in host_programs():
        f, programs[label] = check_host(label, spec, other)
        findings += f
    digest_report: dict = {}
    if digest:
        f, digest_report = check_digest()
        findings += f
    inv = {"schema": 1, "torch_version": torch.__version__,
           "devices": n_dev, "roots": list(DETERMINISM_ROOTS),
           "transposes": sharded["transposes"], "programs": programs,
           "digest_fields": digest_report,
           "findings": [f.to_json() for f in findings],
           "ok": not findings}
    return findings, inv


def structural_view(inv: dict) -> dict:
    """The reviewed subtree: the roots, the role-checked transposes, each
    program's draws by stream, and each field's class and movement."""
    return {
        "roots": inv.get("roots", []),
        "transposes": inv.get("transposes", {}),
        "programs": {label: {"program": p.get("program"),
                             "draws": p.get("draws", {})}
                     for label, p in inv.get("programs", {}).items()},
        "digest_fields": inv.get("digest_fields", {}),
    }


def diff_paths(base: dict, new: dict) -> list:
    from repro_torch.analysis.kernelcheck import diff_paths as _dp
    return _dp(base, new)
