"""The metric arithmetic: interval union, rate, tail, roofline, and the
digest that decides ``correct``."""
import pytest
import torch

from gpubench import check, harness, peaks, trace, work


def graph(i, graph_s, emitted=100, plan_s=0.001, rounds=0):
    return harness.Graph(i, i, plan_s, graph_s, emitted, rounds, True)


def run_of(graphs, window_s=1.0, **kw):
    fields = dict(config={"graph": {}}, graphs=graphs,
                  window_s=window_s, setup_s=1.0, peak_bytes=0, launches={},
                  spans={}, peaks=peaks.H100)
    fields.update(kw)
    return harness.Run(**fields)


def test_union_merges_overlaps_and_gaps():
    assert trace.union([]) == 0.0
    assert trace.union([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert trace.union([(0, 10), (1, 2), (3, 4)]) == pytest.approx(10.0)
    assert trace.merged([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert trace.clipped_union([(0, 2), (3, 6)], 1, 4) == pytest.approx(2.0)
    assert trace.idle_gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3),
                                                       (4, 5)]


def test_idle_gaps_are_named_by_the_innermost_span():
    spans = [("graph", 0, 10), ("plan", 0, 1), ("generate", 1, 9)]
    tr = trace.Trace(start=0, end=12, device=[(1.5, 9)], ops={"k": 7.5},
                     spans=spans)
    # a gap is named by the span innermost at its middle
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert gaps == {"plan": pytest.approx(1.5),
                    "between_spans": pytest.approx(3.0)}
    assert tr.busy_s == pytest.approx(7.5)
    assert tr.breakdown()["device_ops"] == [["k", 7.5]]


def test_the_benchmarks_check_is_cut_from_the_trace():
    spans = [("graph", 0, 4), ("check", 4, 6), ("free", 6, 6.5),
             ("graph", 6.5, 10)]
    # the check's own kernel (4.2-5) counts nowhere
    kernels = [(0.5, 4), (4.2, 5), (7, 10)]
    tr = trace.Trace(0.0, 10.0, trace.merged(kernels), {}, spans)
    assert tr.stretches() == [(0.0, 4), (6, 10.0)]
    assert tr.window_s == pytest.approx(8.0)
    assert tr.busy_s == pytest.approx(6.5)
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert "check" not in gaps
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)
    reader = harness.load_metric("device_idle_pct")
    assert reader.read(run_of([], trace=tr)) == pytest.approx(18.75)


def test_rate_is_all_work_over_all_time():
    reader = harness.load_metric("edges_per_s")
    graphs = [graph(i, 0.1, emitted=1000) for i in range(7)]
    # the window holds the graphs and the gaps between them
    assert reader.read(run_of(graphs, window_s=2.0)) == pytest.approx(3500)
    failed = harness.Graph(7, 7, None, None, 0, 0, False)
    assert reader.read(run_of(graphs + [failed], window_s=2.0)) == \
        pytest.approx(3500)


def test_p95_is_over_all_graphs():
    reader = harness.load_metric("graph_s_p95")
    graphs = [graph(i, t) for i, t in enumerate(range(1, 101))]
    assert reader.read(run_of(graphs)) == 95
    assert reader.read(run_of(graphs[:10])) == 10
    assert reader.read(run_of([graph(0, 3.0)])) == 3.0
    assert reader.read(run_of([])) is None


def test_counters_per_graph():
    graphs = [graph(i, 0.1, rounds=r) for i, r in enumerate((6, 7, 7, 8))]
    run = run_of(graphs, launches={"gather": 30, "histogram": 10},
                 spans={"stream_setup": [2.0, 2.2]})
    assert harness.load_metric("rounds_per_graph").read(run) == 7.0
    assert harness.load_metric("launches_per_graph").read(run) == 10.0
    assert harness.load_metric("stream_setup_s").read(run) == \
        pytest.approx(2.1)
    assert harness.load_metric("plan_ms").read(run) == pytest.approx(1.0)
    flat = run_of([graph(0, 0.1)])
    assert harness.load_metric("rounds_per_graph").read(flat) is None
    assert harness.load_metric("stream_setup_s").read(flat) is None


def test_roofline_reads_spec_derived_work():
    g = {"model": "rmat", "cfree_vertices": 1 << 26, "cfree_edges": 1 << 30}
    ops, nbytes = work.rmat(g)
    assert ops == (1 << 30) * (29 * 26 + 1)
    assert nbytes == 8 << 30
    bound, which = work.bound_s(ops, nbytes, peaks.H100)
    assert which == "ops"
    assert bound == pytest.approx(ops / (132 * 128 * 1.98e9))
    # two graphs, each busy for twice the bound: 50%
    spans = [("graph", 0.0, 1.0), ("graph", 2.0, 3.0)]
    device = [(0.1, 0.1 + bound), (0.2 + bound, 0.2 + 2 * bound),
              (2.1, 2.1 + 2 * bound)]
    tr = trace.Trace(0.0, 3.0, trace.merged(device), {}, spans)
    reader = harness.load_metric("cfree_expand_roofline")
    run = run_of([], config={"graph": g}, trace=tr)
    assert reader.read(run) == pytest.approx(50.0)
    assert reader.read(run_of([], config={"graph": g})) is None
    pba = run_of([], config={"graph": {"model": "pba"}}, trace=tr)
    assert reader.read(pba) is None


def test_idle_share():
    tr = trace.Trace(0.0, 4.0, [(0.0, 3.0)], {}, [("graph", 0, 4)])
    reader = harness.load_metric("device_idle_pct")
    assert reader.read(run_of([], trace=tr)) == pytest.approx(25.0)
    assert reader.read(run_of([])) is None


def test_peak_and_setup():
    run = run_of([], peak_bytes=12_892_078_080)
    assert harness.load_metric("peak_device_gb").read(run) == \
        pytest.approx(12.89207808)
    assert harness.load_metric("setup_s").read(run) == 1.0


def test_digest_is_a_multiset_digest():
    gen = torch.Generator().manual_seed(3)
    u = torch.randint(0, 2**31 - 1, (5000,), generator=gen,
                      dtype=torch.int32)
    v = torch.randint(0, 2**31 - 1, (5000,), generator=gen,
                      dtype=torch.int32)
    d = check.digest(u, v)
    perm = torch.randperm(5000, generator=gen)
    assert check.digest(u[perm], v[perm]) == d
    assert check.blocks_digest([(u[:1234], v[:1234]),
                                (u[1234:], v[1234:])]) == d
    v2 = v.clone()
    v2[17] += 1
    assert check.digest(u, v2) != d
    assert check.digest(v, u) != d                 # direction counts
    assert check.digest(u[:-1], v[:-1]) != d
    assert check.digest(torch.cat([u, u[:1]]), torch.cat([v, v[:1]])) != d
    assert d[0] == 5000 and all(0 <= x < 2**64 for x in d[1:])


def test_digest_in_chunks_equals_one_chunk(monkeypatch):
    u = torch.arange(1000, dtype=torch.int32)
    v = torch.arange(1000, dtype=torch.int32).flip(0)
    whole = check.digest(u, v)
    monkeypatch.setattr(check, "CHUNK", 7)
    assert check.digest(u, v) == whole


def test_sampled_positions_are_seeded_and_in_range():
    a = check.sample_positions(5, 1 << 30, 4096, "cpu")
    assert torch.equal(a, check.sample_positions(5, 1 << 30, 4096, "cpu"))
    assert not torch.equal(a, check.sample_positions(6, 1 << 30, 4096,
                                                     "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 1 << 30
    assert bool((a[1:] >= a[:-1]).all())


def test_graph_seeds_fit_the_generators():
    from gpubench import traffic
    seeds = [traffic.derived_seed(s, i) for s in (0, 2**31 + 5, 2**40)
             for i in range(-2, 50)]
    assert all(0 <= s < 2**31 for s in seeds)
    assert len(set(seeds)) == len(seeds)
    assert traffic.derived_seed(2**31 + 5, 3) == \
        traffic.derived_seed(2**31 + 5, 3)


def test_metrics_of_a_cell():
    from gpubench import traffic
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "c", "workloads": ["y"]}, {"name": "d"}]}
    assert [m["name"] for m in traffic.metrics_of(bench, "y", False)] == ["a"]
    assert [m["name"] for m in traffic.metrics_of(bench, "x", False)] == \
        ["a", "b"]
    assert [m["name"] for m in traffic.metrics_of(bench, "y", True)] == \
        ["c", "d"]


def test_a_split_metric_reads_with_its_base_reader(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics/plan_ms.other.py").write_text(
        "def read(run):\n    return -1.0\n")
    run = run_of([graph(0, 0.1, plan_s=0.002)])
    dirs = (tmp_path, harness.HERE)
    assert harness.load_metric("plan_ms.four_chips", dirs).read(run) == \
        pytest.approx(2.0)
    assert harness.load_metric("plan_ms.other", dirs).read(run) == -1.0
    with pytest.raises(FileNotFoundError):
        harness.load_metric("no_such_metric", dirs)
