"""The one traffic generator: the graphs a cell asks for, from its files.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``: the graph as it is run) under a traffic mix
(``traffic/<traffic>.json``: how the graphs are asked for, executed and
checked). Every mix is a closed loop of one client that asks for graph
i + 1 once graph i is made, checked and freed; graph i's seed is drawn
from the run's ``--seed`` and i, so every seed asks for graphs of the
same sizes and the same work.
"""
from __future__ import annotations

import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

_M64 = (1 << 64) - 1


def find(kind: str, name: str, suffix: str, dirs=(HERE,)) -> pathlib.Path:
    """``<dir>/<kind>/<name><suffix>`` in the first of ``dirs`` that has
    it: a later directory's files stand unless an earlier one adds its
    own of that name."""
    for d in dirs:
        path = pathlib.Path(d) / kind / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                            f"{', '.join(str(d) for d in dirs)}")


def load(kind: str, name: str, dirs=(HERE,)) -> dict:
    """The JSON file ``<kind>/<name>.json``."""
    with open(find(kind, name, ".json", dirs)) as f:
        return json.load(f)


def benchmark(path: pathlib.Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry called ``name``."""
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: the end-to-end ones
    with ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` key only in the cells it lists."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if name in m.get("workloads", [name])]


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def derived_seed(run_seed: int, index: int) -> int:
    """A seed in [0, 2^31) for draw ``index`` of a run: graph i's seed is
    ``derived_seed(seed, i)``; the warm-up graph takes index -1."""
    return _splitmix(_splitmix(int(run_seed) & _M64) ^ (index & _M64)) \
        % (2**31 - 1)


def graph_config(config: dict, seed: int) -> dict:
    """The graph's fields as the plain reference reads them."""
    return {**config["graph"], "seed": seed}
