"""Fixtures of the benchmark's CPU tests: a small copy of the benchmark.

``tiny_bench`` writes, into a temporary directory, a ``BENCHMARK.json``
whose cells run the benchmark's own configurations cut to CPU sizes
(``pba_tiny``: 8 ranks x 3,000 vertices; ``rmat_tiny``: 2^12 vertices,
2^16 edges) under copies of the benchmark's traffic mixes that check
their first graph, one cell on two ranks (``pba_t2``), and returns what
``harness.run_cell`` needs to run them on the CPU.
"""
import copy
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

BENCH = ROOT / "gpubench"
# Small runs on a shared CPU: few threads a test process.
torch.set_num_threads(2)


def load(path):
    with open(path) as f:
        return json.load(f)


def tiny_pba_graph() -> dict:
    graph = copy.deepcopy(load(BENCH / "configs/pba_paper.json")["graph"])
    graph.update(procs=8, vertices_per_proc=3000, pair_capacity=4096,
                 factions={"num_factions": 4, "min_size": 2, "max_size": 4,
                           "seed": 1})
    return graph


def tiny_rmat_graph() -> dict:
    graph = copy.deepcopy(load(BENCH / "configs/graph500_rmat.json")["graph"])
    graph.update(cfree_vertices=1 << 12, cfree_edges=1 << 16)
    return graph


def write_tiny_bench(tmp: pathlib.Path) -> dict:
    for kind in ("configs", "traffic", "metrics", "reference"):
        (tmp / kind).mkdir(exist_ok=True)
    bench = load(ROOT / "BENCHMARK.json")
    for name, src, graph in (("pba_tiny", "pba_paper", tiny_pba_graph()),
                             ("rmat_tiny", "graph500_rmat",
                              tiny_rmat_graph())):
        cfg = load(BENCH / f"configs/{src}.json")
        cfg.update(name=name, graph=graph)
        (tmp / f"configs/{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"configs/{name}.json",
                                 "reduced": [], "why": "CPU test size"})
    for name in ("closed_loop_streamed", "closed_loop_host",
                 "closed_loop_streamed_rows"):
        mix = load(BENCH / f"traffic/{name}.json")
        # the first graph is always checked, however slow the CPU
        mix.update(name=f"{name}_tiny", check_among_first=1, full_checks=1)
        if mix.get("check_rows"):
            mix["check_rows"] = 3
        (tmp / f"traffic/{name}_tiny.json").write_text(json.dumps(mix))
    cells = {"pba_t": ("pba_tiny", "closed_loop_streamed_tiny", 1),
             "rmat_t": ("rmat_tiny", "closed_loop_host_tiny", 1),
             "pba_t2": ("pba_tiny", "closed_loop_streamed_rows_tiny", 2)}
    bench["workloads"] = [{"name": n, "config": c, "traffic": t,
                           "chips": chips, "why": "CPU test"}
                          for n, (c, t, chips) in cells.items()]
    tiny = {"pba_r64_1c": "pba_t", "rmat_s26_1c": "rmat_t",
            "pba_r1000_4c": "pba_t2"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny[w] for w in m["workloads"]]
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return {"bench_path": path, "dirs": (tmp, BENCH)}


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    return write_tiny_bench(tmp_path_factory.mktemp("tiny_bench"))


@pytest.fixture
def run_tiny(tiny_bench):
    """run_tiny(cell, seed, seconds=..., trace=..., program=...)."""
    import time

    from gpubench import harness

    def run(cell, seed=2**31 + 7, seconds=0.3, trace=False, program=None):
        return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                                t0=time.perf_counter(), program=program,
                                **tiny_bench)

    return run
