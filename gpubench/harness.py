"""One run of one cell: set up, measure for ``--seconds``, check, report.

The system under test is ``repro_torch`` (the PyTorch and CUDA port); the
benchmark takes from it only the front door (``api.plan`` and
``api.generate``), its stats and its kernel launch counters. A run:

1. set-up: imports, the card, the cell's files, one warm-up graph of the
   cell's own shape (the first run in a checkout builds the kernels
   here); ``setup_s`` ends when the window starts;
2. the window: the traffic's closed loop, graph after graph, each timed
   from ``api.plan`` to the synchronise after ``api.generate``, checked
   for its edge count and freed, until the program has had ``--seconds``;
   the graphs the seed picks for the full comparison leave their digest,
   and with positional samples every graph leaves the edges at the
   sampled positions. That check is the benchmark's own work: it runs
   between two synchronisations, and its time is taken out of the
   window's clock and out of the traced stretch;
3. after the window: the peak memory, the trace (``--trace 1``), the
   program's state freed, then the plain reference works the checked
   graphs out again and the comparison decides ``correct``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import os
import pathlib
import random
import sys
import time
from typing import Optional

import torch

from gpubench import check
from gpubench import peaks as peaks_lib
from gpubench import trace as trace_lib
from gpubench import traffic as traffic_lib

HERE = traffic_lib.HERE
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*args) -> None:
    print("gpubench:", *args, file=sys.stderr, flush=True)


def _load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reference(name: str, dirs=(HERE,)):
    """``reference/<name>.py``: the configuration's plain reference."""
    return _load_module(traffic_lib.find("reference", name, ".py", dirs),
                        f"gpubench_reference_{name}")


def load_metric(name: str, dirs=(HERE,)):
    """``metrics/<name>.py``: a metric's reader, whose ``read(run)``
    returns a number or None (nothing to read). A quantity split by cells
    (``<base>.<cells>``) reads with ``metrics/<base>.py`` unless it has a
    reader of its own."""
    try:
        path = traffic_lib.find("metrics", name, ".py", dirs)
    except FileNotFoundError:
        if "." not in name:
            raise
        path = traffic_lib.find("metrics", name.split(".")[0], ".py", dirs)
    return _load_module(path, f"gpubench_metric_{name.replace('.', '_')}")


@contextlib.contextmanager
def span(name: str):
    """A host span, named ``gpubench.<name>`` in the trace."""
    with torch.profiler.record_function(trace_lib.SPAN_PREFIX + name):
        yield


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run must not load: the
    JAX package and JAX itself, compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Graph:
    """One graph of the window, as the metric readers see it."""

    index: int
    seed: int
    plan_s: float
    graph_s: float
    emitted: int
    rounds: int
    ok: bool
    check_s: float = 0.0


@dataclasses.dataclass
class Run:
    """Everything a metric reader reads."""

    config: dict
    graphs: list
    window_s: float
    setup_s: float
    peak_bytes: int
    launches: dict
    spans: dict
    peaks: dict
    trace: Optional[trace_lib.Trace] = None

    @property
    def done(self) -> list:
        """The graphs that completed."""
        return [g for g in self.graphs if g.graph_s is not None]


class Program:
    """The system under test, driven through its front door."""

    def __init__(self, device):
        from repro_torch import api
        from repro_torch.kernels import ops
        self.api, self.ops, self.device = api, ops, device

    def spec(self, graph: dict, traffic: dict, chips: int):
        """The ``GraphSpec`` of ``graph`` under ``traffic``: every key of
        the mix that is a field of the spec passes through, and its
        ``topology`` is built by :func:`topology`."""
        names = {f.name for f in dataclasses.fields(self.api.GraphSpec)}
        fields = {**graph, **{k: v for k, v in traffic.items()
                              if k in names}}
        if isinstance(fields.get("factions"), dict):
            fields["factions"] = self.api.FactionSpec(**fields["factions"])
        fields["topology"] = topology(self.api.Topology,
                                      traffic.get("topology"), chips)
        return self.api.GraphSpec(**fields)

    def package_dir(self) -> pathlib.Path:
        """Where the program lives, and builds its kernels."""
        return pathlib.Path(self.api.__file__).resolve().parent

    def plan(self, spec):
        return self.api.plan(spec, device=self.device)

    def generate(self, plan):
        return self.api.generate(plan)

    def launch_counts(self) -> dict:
        return dict(self.ops.launch_counts())

    @contextlib.contextmanager
    def layer_spans(self, spans: dict, sync):
        """Host spans around the program's inner layers, for the traced
        run: the stream's set-up (phase 1 and exchange 1, synchronised
        at both ends) and its rounds. A layer the program no longer has
        gets no span, and its metric reads nothing."""
        import repro_torch.runtime.streaming as streaming
        api = self.api
        made = getattr(api, "_make_stream", None)
        rounds = getattr(streaming, "drive_rounds", None)

        def make_stream(pl):
            sync()
            t0 = time.perf_counter()
            with span("stream_setup"):
                out = made(pl)
                sync()
            spans.setdefault("stream_setup", []).append(
                time.perf_counter() - t0)
            return out

        def drive_rounds(*args, **kwargs):
            with span("rounds"):
                return rounds(*args, **kwargs)

        if made is not None:
            api._make_stream = make_stream
        if rounds is not None:
            streaming.drive_rounds = drive_rounds
        try:
            yield
        finally:
            if made is not None:
                api._make_stream = made
            if rounds is not None:
                streaming.drive_rounds = rounds


#: A mix's ``topology`` by name, over the cell's chips.
TOPOLOGIES = {
    "flat": lambda topo, chips: topo.flat(chips),
}


def topology(topo_cls, spec, chips: int):
    """A traffic mix's ``topology``: null (the program's default), a name
    of :data:`TOPOLOGIES`, or ``{"<constructor>": [arguments]}`` for any
    of the program's ``Topology`` constructors, such as
    ``{"pods": [2, 2]}``."""
    if spec is None:
        return None
    if isinstance(spec, str):
        return TOPOLOGIES[spec](topo_cls, chips)
    (name, args), = spec.items()
    return getattr(topo_cls, name)(*args)


def picks(seed: int, traffic: dict, config: dict):
    """Which graphs a run with ``seed`` compares whole (their indices in
    the window), and, for a graph too large to make again whole, which of
    its rows (None: the whole graph). The run and its control both ask
    here."""
    gen = random.Random(seed)
    full_at = sorted(gen.sample(range(traffic["check_among_first"]),
                                traffic["full_checks"]))
    rows = (sorted(gen.sample(range(config["graph"]["procs"]),
                              traffic["check_rows"]))
            if traffic.get("check_rows") else None)
    return full_at, rows


def files_under(path: pathlib.Path) -> dict:
    """Each file under ``path`` with its size and time of change: what
    set-up wrote there shows as a difference."""
    out = {}
    for root, _, names in os.walk(path):
        for n in names:
            p = os.path.join(root, n)
            with contextlib.suppress(OSError):
                st = os.stat(p)
                out[p] = (st.st_size, st.st_mtime_ns)
    return out


class Group:
    """The ranks of a run, one process a chip, under the default process
    group; with one rank every method is local and costs nothing."""

    def __init__(self, device):
        import torch.distributed as dist
        self.dist = dist if dist.is_initialized() else None
        self.rank = self.dist.get_rank() if self.dist else 0
        self.world = self.dist.get_world_size() if self.dist else 1
        self.device = device

    def barrier(self) -> None:
        if self.world > 1:
            self.all([0], "max")

    def all(self, values: list, op: str) -> list:
        """``values`` (ints) summed (mod 2^64) or maxed over the ranks."""
        if self.world == 1:
            return list(values)
        t = torch.tensor([check.signed64(v) for v in values],
                         dtype=torch.int64, device=self.device)
        self.dist.all_reduce(t, op=getattr(self.dist.ReduceOp,
                                           op.upper()))
        return [int(x) for x in t.tolist()]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device, t0: float, bench_path=None, dirs=(HERE,),
             program=None) -> dict:
    """One run of cell ``name``: the result line's object on rank 0, None
    on the other ranks of a run over several chips. ``dirs`` are searched
    in order for the cell's files; ``program`` stands in for the system
    under test (:class:`Program`)."""
    bench = traffic_lib.benchmark(bench_path or traffic_lib.ROOT
                                  / "BENCHMARK.json")
    entry = traffic_lib.cell(bench, name)
    config = traffic_lib.load("configs", entry["config"], dirs)
    traffic = traffic_lib.load("traffic", entry["traffic"], dirs)
    metrics = traffic_lib.metrics_of(bench, name, trace)
    readers = {m["name"]: load_metric(m["name"], dirs) for m in metrics}
    reference = load_reference(config["reference"], dirs)
    chips = entry["chips"]
    program = program or Program(device)
    built_before = files_under(program.package_dir())
    group = Group(device)
    trace = trace and group.rank == 0
    say = log if group.rank == 0 else (lambda *_: None)
    say(f"set-up: program loaded at {time.perf_counter() - t0:.3f} s")
    sync = lambda: _sync(device)                       # noqa: E731
    full_at, rows = picks(seed, traffic, config)
    samples = traffic.get("edge_samples", 0)
    requested = reference.requested_edges(config["graph"])
    positions = (check.sample_positions(traffic_lib.derived_seed(seed, -2),
                                        requested, samples, device)
                 if samples else None)

    def one_graph(i: int, gseed: int, keep: dict) -> Graph:
        spec = program.spec(traffic_lib.graph_config(config, gseed),
                            traffic, chips)
        g = Graph(i, gseed, None, None, 0, 0, False)
        group.barrier()
        with span("graph"):
            start = time.perf_counter()
            with span("plan"):
                plan = program.plan(spec)
            g.plan_s = time.perf_counter() - start
            with span("generate"):
                res = program.generate(plan)
                sync()
                group.barrier()
            g.graph_s = time.perf_counter() - start
        # The benchmark's own check: it starts with the device idle and
        # ends synchronised, so its time is the benchmark's alone.
        check_start = time.perf_counter()
        with span("check"):
            stats, src, dst = res.stats, res.edges.src, res.edges.dst
            g.emitted, g.rounds = int(stats.emitted_edges), \
                int(stats.exchange_rounds)
            g.ok = (int(stats.requested_edges) == requested
                    and g.emitted == requested
                    and int(stats.dropped_edges) == 0
                    and group.all([src.numel()], "sum")[0] == requested)
            if positions is not None and g.ok:
                keep["samples"].append(
                    (gseed, src.reshape(-1)[positions].cpu(),
                     dst.reshape(-1)[positions].cpu()))
            if i in full_at:
                if rows is not None:
                    mine = torch.isin(reference.row_of(
                        config["graph"], src.reshape(-1)),
                        torch.tensor(rows, device=src.device))
                    src, dst = src.reshape(-1)[mine], dst.reshape(-1)[mine]
                keep["digests"].append(
                    (i, gseed, tuple(check.unsigned64(x) for x in group.all(
                        check.digest(src, dst), "sum"))))
            sync()
            group.barrier()
        g.check_s = time.perf_counter() - check_start
        with span("free"):
            del res, plan, stats, src, dst
        return g

    # -- set-up ---------------------------------------------------------
    one_graph(-1, traffic_lib.derived_seed(seed, -1),
              {"samples": [], "digests": []})
    say(f"set-up: warm-up graph done at {time.perf_counter() - t0:.3f} s")
    check.digest(*(torch.zeros(16, dtype=torch.int32, device=device),) * 2)
    spans: dict = {}
    if trace:
        _warm_profiler(device)
    sync()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = program.launch_counts()
    setup_s = time.perf_counter() - t0
    # The first run in a checkout builds the program's kernels in set-up.
    built = files_under(program.package_dir()) != built_before
    say(f"set-up: {setup_s:.3f} s; "
        f"{'built' if built else 'wrote nothing under'} the program's "
        f"directory")

    # -- the window -----------------------------------------------------
    keep = {"samples": [], "digests": []}
    graphs, failed, prof, traced = [], 0, None, None
    trace_for = traffic.get("trace_seconds", seconds)
    with (program.layer_spans(spans, sync) if trace
          else contextlib.nullcontext()):
        if trace:
            prof = torch.profiler.profile(activities=_activities(device))
            prof.start()
        start, checking = time.perf_counter(), 0.0
        while True:
            i = len(graphs)
            gseed = traffic_lib.derived_seed(seed, i)
            try:
                g = one_graph(i, gseed, keep)
            except Exception as exc:                    # noqa: BLE001
                log(f"graph {i} (seed {gseed}) raised "
                    f"{type(exc).__name__}: {exc}")
                g = Graph(i, gseed, None, None, 0, 0, False)
            failed += 0 if g.ok else 1
            graphs.append(g)
            checking += g.check_s
            # the program's time: the window's wall less the checks
            now = time.perf_counter() - checking
            if prof is not None and (now - start >= trace_for
                                     or now - start >= seconds):
                prof.stop()
                traced, prof = prof, None
            # rank 0's clock closes the window for every rank
            if group.all([group.rank == 0 and now - start >= seconds],
                         "max")[0]:
                break
        window_s = time.perf_counter() - checking - start
    peak = group.all([_peak(device)], "max")[0]
    launches1 = program.launch_counts()
    t_read = time.perf_counter()
    tr = trace_lib.from_profile(traced) if trace else None
    slow = max((g for g in graphs if g.graph_s is not None),
               key=lambda g: g.graph_s, default=None)
    say(f"window: {len(graphs)} graphs in {window_s:.3f} s, checks "
        f"{checking:.3f} s besides"
        + (f"; slowest graph {slow.index}, {slow.graph_s:.3f} s"
           if slow else "")
        + f"; trace read in {time.perf_counter() - t_read:.3f} s")
    # -- the comparison -------------------------------------------------
    _free(device)
    failed = group.all([failed], "sum")[0]
    if group.rank != 0:
        # every rank runs the program: each looks at what it loaded
        forbidden_anywhere(group)
        return None
    t_ref = time.perf_counter()
    checks = compare(reference, config, keep, positions, device,
                     failed, len(full_at), rows)
    log(f"comparison with the reference in "
        f"{time.perf_counter() - t_ref:.3f} s")
    forbidden_anywhere(group)
    correct = (failed == 0 and bool(graphs)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    run = Run(config=config, graphs=graphs, window_s=window_s,
              setup_s=setup_s, peak_bytes=peak,
              launches={k: launches1.get(k, 0) - launches0.get(k, 0)
                        for k in launches1},
              spans=spans, peaks=_peaks(device), trace=tr)
    values = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else torch.device(device).type,
           "kind": _kind(device), "count": chips,
           "memory_peak_bytes": peak}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": correct, "attempted": len(graphs),
              "failed": failed, "metrics": values, "device": dev,
              "setup_built": built}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    return result


def forbidden_anywhere(group: Group) -> None:
    """Raises :class:`ForbiddenModules` on every rank if any rank has
    loaded a module it must not load; on one rank, a look at its own."""
    found = group.all([int(n in forbidden_modules()) for n in FORBIDDEN],
                      "sum")
    bad = [f"{n} ({k} of {group.world} ranks)"
           for n, k in zip(FORBIDDEN, found) if k]
    if bad:
        raise ForbiddenModules(bad)


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules loaded that the run must not load: "
                         f"{', '.join(names)}")
        self.names = names


def compare(reference, config: dict, keep: dict, positions, device,
            failed: int, full_checks: int, rows=None) -> dict:
    """The numbers compared, each with its limit: graphs that failed,
    full comparisons not made, full comparisons (of the whole graph, or
    of ``rows``) that differ from the reference, and sampled edges that
    differ from it."""
    mismatch = 0
    for i, gseed, got in keep["digests"]:
        graph = traffic_lib.graph_config(config, gseed)
        want = check.blocks_digest(
            reference.edge_blocks(graph, device) if rows is None
            else reference.row_blocks(graph, rows, device))
        if got != want:
            mismatch += 1
            log(f"graph {i} (seed {gseed}): digest {got} != reference "
                f"{want}")
    checks = {
        "failed_graphs": {"value": failed, "limit": 0},
        "graphs_unchecked": {"value": full_checks - len(keep["digests"]),
                             "limit": 0},
        "digest_mismatch": {"value": mismatch, "limit": 0},
    }
    if positions is not None:
        wrong = 0
        for a in range(0, len(keep["samples"]), 256):
            batch = keep["samples"][a:a + 256]
            ru, rv = reference.endpoints_at(
                [traffic_lib.graph_config(config, s) for s, _, _ in batch],
                positions)
            u = torch.stack([u for _, u, _ in batch])
            v = torch.stack([v for _, _, v in batch])
            wrong += int(((u != ru.cpu()) | (v != rv.cpu())).sum())
        checks["sampled_edges_wrong"] = {"value": wrong, "limit": 0}
    return checks


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _warm_profiler(device) -> None:
    """One short trace, so the tracer's own start-up falls in set-up."""
    with torch.profiler.profile(activities=_activities(device)):
        with span("warm"):
            (torch.ones(1024, device=device) * 2).sum().item()


def _kind(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _peaks(device) -> dict:
    try:
        return peaks_lib.of(_kind(device))
    except KeyError:
        return {}
