"""Every file of the benchmark loads, and ``BENCHMARK.json`` keeps to its
contract and names only what exists."""
import json
import re

import pytest

from conftest import BENCH, ROOT, load

from gpubench import harness, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return load(ROOT / "BENCHMARK.json")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(bench):
    assert set(bench) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_a_full_check_fits_with_every_cell(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_are_unique_and_well_formed(bench):
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[key]]
        assert all(NAME.match(n) for n in names)
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs_exist_and_are_used(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"gpubench/configs/{c['name']}.json"
        cfg = load(ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        harness.load_reference(cfg["reference"])


def test_workloads_name_what_exists(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        traffic.load("traffic", w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics_keep_to_the_contract(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert _line(m["layer"])
        layers.add(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        harness.load_metric(m["name"])


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in traffic.metrics_of(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert traffic.metrics_of(bench, w["name"], True)


def test_every_file_loads():
    for path in sorted((BENCH / "configs").glob("*.json")) + \
            sorted((BENCH / "traffic").glob("*.json")):
        data = json.loads(path.read_text())
        assert data["name"] == path.stem
    for path in sorted((BENCH / "metrics").glob("*.py")):
        assert callable(harness.load_metric(path.stem).read)
    for path in sorted((BENCH / "reference").glob("*.py")):
        if path.stem not in ("__init__", "rng"):
            ref = harness.load_reference(path.stem)
            assert callable(ref.edge_blocks)
            assert callable(ref.requested_edges)


def test_traffic_checks_what_a_window_holds():
    for path in sorted((BENCH / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        assert 1 <= mix["full_checks"] <= mix["check_among_first"]
        assert mix["execution"] in ("host", "streamed", "sharded")
        assert mix["sink"] == "memory"
