"""flowcheck for the port (``repro_torch.analysis.flowcheck``).

The three passes run clean on four gloo ranks and the CPU: FC001 (every
front-door program and host executor draws the same (stream, rank,
offset, count) sequence from the spec's seed whatever its faction rows),
FC002 (the blocked transposes' hops split by their ``dev_dst:<axis>``
roles, the outputs carry the ``out`` roles) and FC003 (each GraphSpec
field moves the digest and the edges as its class says). Broken
fixtures give exactly their findings: a draw keyed by demand, a
mis-routed transpose (locally and on gloo ranks), a digest that misses
a live field. The copied tables equal the JAX package's, and the
structural view equals ``results/torch_flow_audit_baseline.json``.
"""
import dataclasses
import datetime
import json
import pathlib

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import spec as jspec
from repro.runtime import blocking as jblocking
from repro_torch import api
from repro_torch.analysis import cli, flowcheck
from repro_torch.core import rng, spec as tspec
from repro_torch.core.spec import spec_digest
from repro_torch.runtime import blocking

REPO = pathlib.Path(__file__).resolve().parents[1]
BASELINE = REPO / "results" / "torch_flow_audit_baseline.json"
SPAWN_TIMEOUT_S = 180


@pytest.fixture(scope="module")
def flow():
    return flowcheck.run_flow(4, timeout=SPAWN_TIMEOUT_S)


def test_the_passes_run_clean(flow):
    findings, inv = flow
    assert findings == [] and inv["ok"]
    assert sorted(inv["transposes"]) == ["flat_1x4", "pods_2x2"]
    assert inv["transposes"]["pods_2x2"]["transpose_payload"]["hops"] == [
        {"hop": 0, "role": "dev_dst:proc", "ok": True},
        {"hop": 1, "role": "dev_dst:pod", "ok": True}]
    draws = inv["programs"]["flat_1x4/exchange"]["draws"]
    assert draws == {"0": [2, 80], "1": [2, 80], "2": [2, 80],
                     "3": [2, 240]}
    assert inv["programs"]["pods_2x2/stream_round"]["draws"] == {}
    assert set(inv["digest_fields"]) >= {"seed", "topology", "sink",
                                         "auto_capacity"}


def test_structural_view_matches_the_committed_baseline(flow):
    view = json.loads(json.dumps(flowcheck.structural_view(flow[1])))
    base = json.loads(BASELINE.read_text())
    assert flowcheck.diff_paths(base, view) == []


def test_tables_are_the_references():
    assert tspec.DETERMINISM_ROOTS == jspec.DETERMINISM_ROOTS
    assert blocking.AXIS_ROLES == jblocking.AXIS_ROLES
    for name in ("_NON_IDENTITY_FIELDS", "_ROUTING_FIELDS", "_SINK_FIELDS",
                 "_RUNTIME_ONLY_FIELDS", "_MODEL_OWNED_FIELDS"):
        assert getattr(tspec.GraphSpec, name) == \
            getattr(jspec.GraphSpec, name), name


# --- FC001 --------------------------------------------------------------------

def _program(keyed_by_demand: bool):
    def fn(s):
        k = rng.device_key(7, rng.STREAM_PBA_URN, 0)
        rng.bits(k, 4)
        if keyed_by_demand:
            rng.bits(rng.device_key(7, rng.STREAM_PBA_PHASE2_URN,
                                    int(s.sum())), 4)
        else:
            rng.bits(rng.device_key(7, rng.STREAM_PBA_PHASE2_URN, 0),
                     int(s.numel()))
        return s
    return fn


@pytest.mark.parametrize("keyed,want", [
    (False, set()), (True, {("FC001", "fixture", "draws")})])
def test_draw_keyed_by_demand(keyed, want):
    fn = _program(keyed)
    logs = [flowcheck.record_draws(fn, torch.tensor(d))[1]
            for d in ([1, 2, 3], [3, 3, 3])]
    got = flowcheck.lineage_findings("fixture", *logs, seed=7)
    assert {(f.kind, f.program, f.where) for f in got} == want


def test_draw_from_another_seed():
    fn = lambda: rng.bits(rng.device_key(8, 0, 0), 4)  # noqa: E731
    logs = [flowcheck.record_draws(fn)[1] for _ in range(2)]
    got = flowcheck.lineage_findings("fixture", *logs, seed=7)
    assert [(f.kind, f.where) for f in got] == [("FC001", "draws")]


# --- FC002 --------------------------------------------------------------------

def _no_transpose(x, topo):
    return x.clone()


def test_mis_routed_local_transpose():
    topo = api.Topology.flat(1)
    ok, _ = flowcheck.check_transpose_roles(
        blocking.transpose_counts, topo, "transpose_counts", 4)
    bad, _ = flowcheck.check_transpose_roles(
        _no_transpose, topo, "transpose_counts", 4, label="fixture")
    assert ok == []
    assert [(f.kind, f.program, f.where) for f in bad] == [
        ("FC002", "fixture", "out")]


def _misrouted(x, topo):
    """A flat transpose whose send slabs are in reverse device order."""
    lp, p = x.shape
    d = topo.num_devices
    send = x.reshape(lp, d, lp).transpose(0, 1).flip(0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return recv.movedim(2, 0).reshape(lp, p)


def _roles_worker(rank, world, init_file, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        topo = api.Topology.flat(world)
        good, _ = flowcheck.check_transpose_roles(
            blocking.transpose_counts, topo, "transpose_counts", 2)
        bad, _ = flowcheck.check_transpose_roles(
            _misrouted, topo, "transpose_counts", 2, label="fixture")
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"good": [x.to_json() for x in good],
                           "bad": [x.to_json() for x in bad]}, f)
    finally:
        dist.destroy_process_group()


def test_mis_routed_transpose_on_gloo_ranks(tmp_path):
    out = tmp_path / "roles.json"
    ctx = mp.spawn(_roles_worker, args=(2, str(tmp_path / "rdzv"),
                                        str(out)), nprocs=2, join=False)
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=2):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ranks did not finish")
    got = json.loads(out.read_text())
    assert got["good"] == []
    assert {(f["kind"], f["program"], f["where"]) for f in got["bad"]} == {
        ("FC002", "fixture", "hop0"), ("FC002", "fixture", "out")}


# --- FC003 --------------------------------------------------------------------

def _digest_without(field):
    def digest(s):
        return spec_digest({f.name: getattr(s, f.name)
                            for f in dataclasses.fields(s)
                            if f.name not in s._NON_IDENTITY_FIELDS
                            and f.name != field})
    return digest


def _digest_with(field):
    def digest(s):
        return spec_digest(s.digest(), getattr(s, field))
    return digest


@pytest.mark.parametrize("digest,want", [
    (_digest_without("seed"), {("FC003", "spec", "seed")}),
    (_digest_without("pair_capacity"), {("FC003", "spec", "pair_capacity")}),
    (_digest_with("num_shards"), {("FC003", "spec", "num_shards")}),
    (_digest_with("overlap"), {("FC003", "spec", "overlap")}),
], ids=["misses_seed", "misses_pair_capacity", "sink_in_digest",
        "routing_in_digest"])
def test_broken_digest_gives_exactly_its_finding(digest, want):
    got, _ = flowcheck.check_digest(digest)
    assert {(f.kind, f.program, f.where) for f in got} == want


def test_flow_command_exits_clean(capsys):
    assert cli.main(["flow", "--ranks", "2", "--no-digest"]) == 0
    out = capsys.readouterr().out
    assert "flowcheck: clean" in out and "flat_1x2" in out
