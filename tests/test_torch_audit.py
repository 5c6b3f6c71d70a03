"""The collective auditor (``repro_torch.analysis.audit``) on gloo ranks.

Spawns of 2 and 4 ranks run the gate programs (the single-shot and
4-round exchanges, the stream's setup and a round, the three
communication-free models, the hub_stress preset whose ranks' demands
differ) over flat and pods topologies under the c10d recorder: every
all_to_all count equals ``expected_all_to_alls``, cfree issues none, the
pods' second hop is strided, and every rank issues the same sequence.
Broken fixtures (a collective issued on one rank only, an extra
all_to_all, hops in the wrong order) give exactly their problems, and
the structural view equals the committed
``results/torch_collective_audit_baseline.json``.
"""
import datetime
import json
import os
import pathlib

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import api
from repro_torch.analysis import audit, cli
from repro_torch.launch import bench, op_stats
from repro_torch.runtime import blocking

REPO = pathlib.Path(__file__).resolve().parents[1]
BASELINE = REPO / "results" / "torch_collective_audit_baseline.json"
SPAWN_TIMEOUT_S = 180


@pytest.fixture(scope="module")
def inventories():
    return {n: audit.run_audit(n, timeout=SPAWN_TIMEOUT_S) for n in (2, 4)}


def _kinds(problems):
    return {p.split(":")[0] for p in problems}


def test_every_gate_program_passes(inventories):
    for n, inv in inventories.items():
        assert inv["ok"], {k: p["problems"] for k, p in
                           inv["programs"].items() if p["problems"]}
        labels = sorted(inv["programs"])
        topos = ["flat_1x2"] if n == 2 else ["flat_1x4", "pods_2x2"]
        assert labels == sorted(f"{t}/{p}" for t in topos for p in (
            "exchange", "exchange_r4", "stream_setup", "stream_round",
            "hub_stress", "cfree_ba_cfree", "cfree_rmat", "cfree_er"))


def test_counts_equal_the_pin(inventories):
    for inv in inventories.values():
        for label, p in inv["programs"].items():
            topo = api.Topology.from_label(p["topology"])
            prog = {"exchange_r4": "exchange", "hub_stress": "exchange"}.get(
                label.split("/")[1], p["program"])
            want = audit.expected_all_to_alls(topo, prog, p["rounds"])
            assert p["all_to_alls"] == p["expected_all_to_alls"] == want
            assert p["ranks_recorded"] == topo.num_devices
            if p["program"] == "cfree":
                assert p["counts_by_kind"] == {} and want == 0


def test_pods_second_hop_is_strided(inventories):
    for label, p in inventories[4]["programs"].items():
        if not label.startswith("pods") or p["program"] == "cfree":
            continue
        assert p["span"]["n_local"] == p["span"]["n_cross"] > 0
        assert p["span"]["cross_wire"] == p["span"]["cross"] / 2


def test_uniform_under_skewed_demand(inventories):
    for inv in inventories.values():
        for label, p in inv["programs"].items():
            assert p["uniform"], label
        hub = [p for k, p in inv["programs"].items()
               if k.endswith("/hub_stress")]
        assert hub and all(p["rounds"] > 8 for p in hub)


def test_structural_view_matches_the_committed_baseline(inventories):
    view = {str(n): audit.structural_view(inv)
            for n, inv in inventories.items()}
    base = json.loads(BASELINE.read_text())
    from repro_torch.analysis.kernelcheck import diff_paths
    assert diff_paths(base, json.loads(json.dumps(view))) == []


def test_expected_all_to_alls_table():
    flat, pods = api.Topology.flat(4), api.Topology.pods(2, 2)
    assert [audit.expected_all_to_alls(flat, p) for p in (
        "exchange", "stream_round", "stream_setup", "cfree")] == [2, 1, 1, 0]
    assert [audit.expected_all_to_alls(pods, p) for p in (
        "exchange", "stream_round", "stream_setup", "cfree")] == [4, 2, 2, 0]
    assert audit.expected_all_to_alls(flat, "exchange_streamed", 5) == 6
    assert audit.expected_all_to_alls(pods, "exchange", 3) == 8


def _call(op, b, ranks):
    return op_stats.Call(op, b, b, ranks)


def test_op_stats_spans_and_wire_bytes():
    calls = [_call("alltoall_base_", 64, (0, 1)),
             _call("alltoall_base_", 64, (0, 2)),
             _call("allreduce_", 8, (0, 1, 2, 3)),
             op_stats.Call("_reduce_scatter_base_", 32, 8, (0, 1, 2, 3))]
    span = op_stats.all_to_all_span_bytes(calls)
    assert span == {"local": 64.0, "cross": 64.0, "local_wire": 32.0,
                    "cross_wire": 32.0, "n_local": 1, "n_cross": 1}
    st = op_stats.collect_collective_stats(calls)
    assert st.count_by_kind == {"all-to-all": 2, "all-reduce": 1,
                                "reduce-scatter": 1}
    assert st.bytes_by_kind == {"all-to-all": 128.0, "all-reduce": 8.0,
                                "reduce-scatter": 32.0}
    assert st.wire_bytes_by_kind["all-reduce"] == 12.0
    assert st.total_bytes == 168.0
    assert op_stats.collect_opcode_stats(calls)["c10d::alltoall_base_"] == 2


# --- the broken-fixture corpus -----------------------------------------------

FLAT2, PODS4 = api.Topology.flat(2), api.Topology.pods(2, 2)
A2A = [_call("alltoall_base_", 64, (0, 1)), _call("allreduce_", 8, (0, 1)),
       _call("alltoall_base_", 64, (0, 1))]
HOPS = [_call("alltoall_base_", 64, (0, 1)), _call("alltoall_base_", 64,
                                                    (0, 2)),
        _call("alltoall_base_", 64, (0, 1)), _call("alltoall_base_", 64,
                                                    (0, 2))]

CORPUS = {
    "clean": ([A2A, A2A], FLAT2, "exchange", set()),
    "one_rank_only": ([A2A, A2A + [_call("allreduce_", 8, (0, 1))]], FLAT2,
                      "exchange", {"uniformity"}),
    "bytes_differ": ([A2A, A2A[:1] + [_call("allreduce_", 16, (0, 1))]
                      + A2A[2:]], FLAT2, "exchange", {"uniformity"}),
    "extra_all_to_all": ([A2A + A2A[:1]] * 2, FLAT2, "exchange",
                         {"all_to_all count"}),
    "cfree_collective": ([A2A[:1]] * 2, FLAT2, "cfree",
                         {"all_to_all count"}),
    "pods_clean": ([HOPS] * 4, PODS4, "exchange", set()),
    "pods_hops_swapped": ([HOPS[1:2] + HOPS[0:1] + HOPS[2:]] * 4, PODS4,
                          "exchange", {"hop span"}),
}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_fixture_gives_exactly_its_problems(name):
    per_rank, topo, program, want = CORPUS[name]
    got = audit.check_calls(per_rank, topo, name, program)
    assert _kinds(got.problems) == want
    assert got.uniform == ("uniformity" not in want)


def _extra_a2a_worker(rank, world, init_file, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        topo = api.Topology.flat(world)
        pl = api.plan(api.preset("paper_smoke", procs=2 * world,
                                 vertices_per_proc=50, topology=topo,
                                 execution="sharded"), device="cpu")
        fn, args = bench.sharded_pba(pl)

        def extra(*a):
            res = fn(*a)
            blocking.transpose_counts(res[0][:, :2 * world], topo)
            return res
        got = [audit.audit_program(f, args, topo, label, "exchange")
               for label, f in (("fixture/clean", fn),
                                ("fixture/extra", extra))]
        if rank == 0:
            with open(out, "w") as f:
                json.dump({a.label: a.problems for a in got}, f)
    finally:
        dist.destroy_process_group()


def test_extra_all_to_all_on_gloo_ranks(tmp_path):
    out = tmp_path / "extra.json"
    ctx = mp.spawn(_extra_a2a_worker, args=(2, str(tmp_path / "rdzv"),
                                            str(out)), nprocs=2, join=False)
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=2):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ranks did not finish")
    got = json.loads(out.read_text())
    assert got["fixture/clean"] == []
    assert _kinds(got["fixture/extra"]) == {"all_to_all count"}


def test_audit_plan_of_host_plans_is_empty():
    pl = api.plan(api.preset("paper_smoke"), device="cpu")
    assert audit.audit_plan(pl) == []


def test_audit_command_exits_clean(capsys):
    assert cli.main(["audit", "--ranks", "1"]) == 0
    out = capsys.readouterr().out
    assert "audit OK   flat_1x1/exchange" in out
