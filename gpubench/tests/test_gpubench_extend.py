"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and ``BENCHMARK.json`` entries alone: here
from a temporary directory, in front of the benchmark's own."""
import json

from conftest import load, tiny_rmat_graph

from gpubench import harness


def test_new_config_cell_and_metric_from_files(tmp_path, run_tiny,
                                               tiny_bench):
    bench = load(tiny_bench["bench_path"])
    cfg = load(tiny_bench["dirs"][1] / "configs/graph500_rmat.json")
    cfg.update(name="er_tiny", reference="er_ref",
               graph={**tiny_rmat_graph(), "model": "er"})
    for kind in ("configs", "traffic", "metrics", "reference"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs/er_tiny.json").write_text(json.dumps(cfg))
    mix = load(tiny_bench["dirs"][0] / "traffic/closed_loop_host_tiny.json")
    mix.update(name="two_checks", edge_samples=0)
    (tmp_path / "traffic/two_checks.json").write_text(json.dumps(mix))
    # a plain reference of G(n, m), as the program defines it
    (tmp_path / "reference/er_ref.py").write_text('''
import torch
from gpubench.reference import rmat, rng

def requested_edges(cfg):
    return cfg["cfree_edges"]

def _hash(w0, w1, t):
    x = rmat._mix32(((t ^ w0) + (rmat._GOLDEN & rmat._M32)) & rmat._M32)
    return rmat._mix32(x ^ w1)

def edge_blocks(cfg, device, control=False):
    ku = rng.device_key(cfg["seed"], 11, 0)
    kv = rng.device_key(cfg["seed"], 12, 0)
    wu, wv = [int(w) for w in rng.bits(ku, 2)], [int(w) for w in rng.bits(kv, 2)]
    t = torch.arange(cfg["cfree_edges"], dtype=torch.int64, device=device)
    n = cfg["cfree_vertices"]
    yield ((_hash(*wu, t) % n).to(torch.int32),
           (_hash(*wv, t) % n).to(torch.int32))
''')
    (tmp_path / "metrics/graphs_per_s.py").write_text(
        "def read(run):\n    return len(run.done) / run.window_s\n")
    bench["configs"].append({"name": "er_tiny", "source": "test",
                             "file": "configs/er_tiny.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "er_t", "config": "er_tiny",
                               "traffic": "two_checks", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "edges_per_s":
            m["workloads"].append("er_t")
    bench["per_layer"].append({"name": "graphs_per_s", "unit": "graphs/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "front door", "moves": "edges_per_s",
                               "workloads": ["er_t"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    dirs = (tmp_path,) + tuple(tiny_bench["dirs"])
    import time
    for trace in (False, True):
        out = harness.run_cell("er_t", 2**31 + 3, 0.3, trace, device="cpu",
                               t0=time.perf_counter(), bench_path=path,
                               dirs=dirs)
        assert out["correct"], out["checks"]
        assert out["checks"]["graphs_unchecked"]["value"] == 0
        if trace:
            assert out["metrics"]["graphs_per_s"]["value"] > 0
        else:
            # no peak memory on the CPU
            assert set(out["metrics"]) == {"edges_per_s", "setup_s"}


def test_a_mix_passes_spec_fields_and_names_its_topology():
    from repro_torch import api
    program = harness.Program("cpu")
    graph = tiny_rmat_graph()
    mix = {"name": "m", "full_checks": 1, "execution": "host",
           "sink": "memory", "slab_edges": 1 << 10, "topology": None}
    spec = program.spec(graph, mix, 1)
    assert spec.slab_edges == 1 << 10 and spec.execution == "host"
    assert spec.topology is None
    for topo, chips, want in (("flat", 4, api.Topology.flat(4)),
                              ({"host": []}, 1, api.Topology.host()),
                              ({"pods": [2, 2]}, 4, api.Topology.pods(2, 2))):
        assert program.spec(graph, {**mix, "topology": topo},
                            chips).topology == want


def test_the_run_and_its_control_check_the_same_graphs(tiny_bench,
                                                       monkeypatch):
    from gpubench import control
    asked = []
    picks = harness.picks

    def spy(seed, traffic, config):
        asked.append((seed, traffic["name"]))
        return picks(seed, traffic, config)

    monkeypatch.setattr(harness, "picks", spy)
    control.control_checks("pba_t2", 2**31 + 5, 1, "cpu", **tiny_bench)
    assert asked == [(2**31 + 5, "closed_loop_streamed_rows_tiny")]
    full_at, rows = picks(2**31 + 5, {"check_among_first": 4,
                                      "full_checks": 2, "check_rows": 3},
                          {"graph": {"procs": 8}})
    assert full_at == sorted(full_at) and len(set(full_at)) == 2
    assert set(full_at) <= set(range(4))
    assert len(set(rows)) == 3 and set(rows) <= set(range(8))
