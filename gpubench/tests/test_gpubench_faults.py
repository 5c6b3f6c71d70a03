"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a chip is skipped and the rest of a run is driven
on the CPU at small sizes, with each fault a cell can have planted in
the program."""
import dataclasses
import time

import pytest

from gpubench import harness


class Broken(harness.Program):
    """The program with its answers broken after ``generate``."""

    def __init__(self, fault):
        super().__init__("cpu")
        self.fault, self.first = fault, None

    def generate(self, plan):
        res = super().generate(plan)
        e = res.edges
        if self.fault == "half_left_out":
            # half of the graph's edges left out, the count claimed whole
            n = e.src.numel() // 2
            res.edges = dataclasses.replace(e, src=e.src[:n], dst=e.dst[:n])
        elif self.fault == "half_left_out_and_counted":
            n = e.src.numel() // 2
            res.edges = dataclasses.replace(e, src=e.src[:n], dst=e.dst[:n])
            res.stats = dataclasses.replace(res.stats, emitted_edges=n)
        elif self.fault == "answer_altered":
            # one edge's endpoint altered where it is produced
            dst = e.dst.clone()
            dst[dst.numel() // 3] = (dst[dst.numel() // 3] + 1) \
                % e.num_vertices
            res.edges = dataclasses.replace(e, dst=dst)
        elif self.fault == "state_unchanged":
            # every graph is the first one made: a stale answer
            if self.first is None:
                self.first = res
            res = dataclasses.replace(self.first, plan=plan)
        return res


CASES = [(cell, fault) for cell in ("pba_t", "rmat_t")
         for fault in ("half_left_out", "half_left_out_and_counted",
                       "answer_altered", "state_unchanged")]


def test_the_sound_program_is_correct(run_tiny):
    for cell in ("pba_t", "rmat_t"):
        out = run_tiny(cell)
        assert out["correct"], out["checks"]
        assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_answer_is_not_correct(run_tiny, cell, fault):
    out = run_tiny(cell, program=Broken(fault))
    assert not out["correct"]
    failing = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    if fault.startswith("half"):
        assert "failed_graphs" in failing
    else:
        assert "digest_mismatch" in failing


def test_the_exchange_left_out_is_not_correct(run_tiny, monkeypatch):
    import repro_torch.runtime.blocking as blocking
    monkeypatch.setattr(blocking, "transpose_payload",
                        lambda buf, topo: buf.clone())
    out = run_tiny("pba_t")
    assert not out["correct"]


def test_a_graph_that_raises_is_failed(run_tiny):
    class Raises(harness.Program):
        calls = 0

        def generate(self, plan):
            self.calls += 1
            if self.calls > 1:          # set-up's warm-up graph is sound
                raise RuntimeError("out of memory")
            return super().generate(plan)

    out = run_tiny("rmat_t", program=Raises("cpu"))
    assert not out["correct"]
    assert out["failed"] == out["attempted"] >= 1


def test_set_up_that_raises_gives_no_result(run_tiny):
    class Raises(harness.Program):
        def generate(self, plan):
            raise RuntimeError("no kernel")

    with pytest.raises(RuntimeError):
        run_tiny("rmat_t", program=Raises("cpu"))


def test_a_run_that_checks_fewer_graphs_than_asked_is_not_correct(
        run_tiny, monkeypatch):
    monkeypatch.setattr(harness.random.Random, "sample",
                        lambda self, pop, k: [10**6] * k)
    out = run_tiny("rmat_t")
    assert out["checks"]["graphs_unchecked"]["value"] > 0
    assert not out["correct"]


def test_the_window_clock_leaves_out_the_benchmarks_check(run_tiny,
                                                          monkeypatch):
    from gpubench import check
    digest = check.digest

    def slow_digest(u, v):
        time.sleep(0.5)
        return digest(u, v)

    monkeypatch.setattr(check, "digest", slow_digest)
    out = run_tiny("rmat_t", seconds=0.2)
    assert out["correct"], out["checks"]
    window_s = out["attempted"] * (1 << 16) / \
        out["metrics"]["edges_per_s.rmat"]["value"]
    # graph 0's check slept 0.5 s; the window holds the program's time
    assert 0.2 <= window_s < 0.45


def test_the_result_line_keeps_its_shape(run_tiny):
    out = run_tiny("rmat_t", trace=True)
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert {"busy_s", "window_s", "memory_peak_bytes", "count", "kind",
            "platform"} <= set(out["device"])
    assert out["setup_built"] in (True, False)
    assert len(out["breakdown"]["device_ops"]) <= 10
    assert len(out["breakdown"]["idle_gaps"]) <= 10
