"""repro_torch over several devices: gloo process groups on the CPU.

Each spawn starts one process per device of a topology
(``torch.multiprocessing.spawn``, a ``file://`` rendezvous under the
test's tmp dir, so parallel test workers never share a port). The
children import torch and repro_torch only, run the port's runtime,
generators, streams and front door as ranks of a gloo group, and write
each rank's arrays to ``.npz``; the tests here compute the JAX package's
result on the host path and compare bit for bit:

  * the one-hop (flat) and two-hop (pods) transposes against the global
    matrix's swapaxes, the logical ranks and the reductions;
  * generate_pba / generate_pba_sharded on flat(2/8), pods(2,4) and
    pods(4,2), single-shot and in rounds, against generate_pba_host;
  * the sharded PBA stream on flat(2) and pods(2,2), into memory (each
    rank's share is the one-device stream's edges its rows own) and into
    shards (the one-device shard set; resumed on the group, and by the
    JAX package);
  * generate_pk on flat(3), generate_cfree with P = 2 D, CFreeStream on
    flat(2) with an odd slab, and the refusals;
  * the sharded analytics (degree counts, edge count, max degree) of each
    PBA run's shares, every rank against the host path's degree counts.
"""
import dataclasses
import datetime
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import api as tapi
from repro_torch.core import distributed_analysis as tdist
from repro_torch.core import factions as tfactions
from repro_torch.core import pba as tpba
from repro_torch.core import pk as tpk
from repro_torch.runtime import blocking, spmd, topology as ttopology
from repro_torch.runtime.topology import Topology

CPU = "cpu"
SPAWN_TIMEOUT_S = 120
PBA_TABLE = (8, dict(num_factions=4, min_size=2, max_size=4, seed=2))
PBA_CFG = dict(vertices_per_proc=100, edges_per_vertex=3, seed=5)
TRANSPOSE_LP = 3
STREAM_SPEC = dict(execution="streamed")      # on preset hub_stress
CFREE_SPEC = dict(model="ba_cfree", cfree_vertices=1001, ba_degree=3,
                  seed=4)
CFREE_SLAB = 333                              # odd: ragged per-rank spans
RMAT_SPEC = dict(model="rmat", cfree_vertices=1 << 10, cfree_edges=1001,
                 seed=6)
PK_LEVELS = 5                                 # star_clique(4): 7^5 edges
PK_CFG = dict(levels=PK_LEVELS, noise=0.05, delete_prob=0.01, seed=3)


# --- the spawn helper and the ranks' jobs ---------------------------------------

def _rank_main(rank, world, init_file, job, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        results = JOBS[job](rank, world, out)
        np.savez(os.path.join(out, f"{job}_rank{rank}.npz"), **results)
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, job: str, world: int) -> list:
    """Run ``job`` on ``world`` gloo ranks; returns each rank's arrays."""
    out = tmp_path / job
    out.mkdir()
    ctx = mp.spawn(_rank_main, args=(world, str(tmp_path / f"{job}.rdzv"),
                                     job, str(out)),
                   nprocs=world, join=False)
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=5):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{job}: {world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    return [dict(np.load(out / f"{job}_rank{r}.npz")) for r in range(world)]


def _jsonify(obj) -> np.ndarray:
    return np.array(json.dumps(obj))


def _stats(st) -> np.ndarray:
    return _jsonify(dataclasses.asdict(st))


def _global_matrices(p: int):
    rng = np.random.default_rng(1)
    return (rng.integers(0, 100, (p, p)).astype(np.int32),
            rng.integers(0, 100, (p, p, 2)).astype(np.int32))


def _transposes(rank, topo, res):
    lp = TRANSPOSE_LP
    counts, buf = _global_matrices(lp * topo.num_devices)
    rows = slice(rank * lp, (rank + 1) * lp)
    res[f"{topo.label}_counts"] = blocking.transpose_counts(
        torch.from_numpy(counts[rows]), topo).numpy()
    res[f"{topo.label}_payload"] = blocking.transpose_payload(
        torch.from_numpy(buf[rows]), topo).numpy()
    res[f"{topo.label}_ranks"] = blocking.logical_ranks(lp, topo).numpy()


def _pba(topo, gen, rounds, res):
    table = tfactions.make_factions(
        PBA_TABLE[0], tfactions.FactionSpec(**PBA_TABLE[1]))
    cfg = tpba.PBAConfig(exchange_rounds=rounds, **PBA_CFG)
    edges, st = gen(cfg, table, topology=topo, device=CPU)
    key = f"{gen.__name__}_{topo.label}_{rounds}"
    res[key + "_src"] = edges.src.numpy()
    res[key + "_dst"] = edges.dst.numpy()
    res[key + "_stats"] = _stats(st)
    res[key + "_degrees"] = tdist.degree_counts_sharded(
        edges, topology=topo).numpy()
    res[key + "_edge_count"] = np.array(
        tdist.edge_count_sharded(edges, topology=topo))
    res[key + "_max_degree"] = np.array(
        tdist.max_degree_sharded(edges, topology=topo))


def _job_world8(rank, world, out):
    res = {}
    for topo in (Topology.flat(8), Topology.pods(2, 4), Topology.pods(4, 2)):
        _transposes(rank, topo, res)
    flat = Topology.flat(8)
    res["sum_int"] = np.array(blocking.all_reduce_sum(rank + 1, flat, CPU))
    res["sum_tensor"] = blocking.all_reduce_sum(
        torch.tensor([rank, 1]), flat).numpy()
    res["max_int"] = np.array(blocking.all_reduce_max(rank * 3, flat, CPU))
    for rounds in (None, 4):
        _pba(Topology.flat(8), tpba.generate_pba, rounds, res)
        for topo in (Topology.pods(2, 4), Topology.pods(4, 2)):
            _pba(topo, tpba.generate_pba_sharded, rounds, res)
    plans = {}
    for procs in (8, 16):
        pl = tapi.plan(tapi.preset("paper_smoke", procs=procs,
                                   vertices_per_proc=50,
                                   execution="sharded"), device=CPU)
        plans[procs] = [pl.executor, pl.topology.label, pl.lp, pl.rank]
    res["plans"] = _jsonify(plans)
    return res


def _stream_runs(rank, topo, out, res):
    """hub_stress streamed over ``topo``: into memory, into shards, then
    resumed after two shards are dropped from the manifest."""
    spec = tapi.preset("hub_stress", topology=topo, **STREAM_SPEC)
    mem = tapi.generate(spec, device=CPU)
    key = f"stream_{topo.label}"
    res[key + "_src"] = mem.edges.src.numpy()
    res[key + "_dst"] = mem.edges.dst.numpy()
    res[key + "_stats"] = _stats(mem.stats)
    res[key + "_executor"] = np.array(mem.plan.executor)
    shards = os.path.join(out, f"shards_{topo.label}")
    sres = tapi.generate(spec.replace(sink="shards", out_dir=shards),
                         device=CPU)
    res[key + "_manifest"] = _jsonify(sres.manifest)
    res[key + "_shard_stats"] = _stats(sres.stats)
    if rank == 0:
        n = _drop_last_two(shards)
        for i in range(n):
            os.utime(os.path.join(shards, f"shard_{i:05d}.npz"), ns=(0, 0))
    dist.barrier()
    again = tapi.generate(spec.replace(sink="shards", out_dir=shards),
                          device=CPU)
    res[key + "_resumed_manifest"] = _jsonify(again.manifest)
    res[key + "_rewritten"] = np.array(sorted(
        i for i in range(again.manifest["num_shards"])
        if os.stat(os.path.join(shards, f"shard_{i:05d}.npz")).st_mtime_ns))
    dist.barrier()
    # Kept aside for the JAX package's resume (the last two shards
    # dropped once more, by the test).
    res[key + "_dir"] = np.array(shards)


def _drop_last_two(shards: str) -> int:
    """Drop the last two shards from a manifest; returns the shard count."""
    path = os.path.join(shards, "manifest.json")
    with open(path) as f:
        man = json.load(f)
    n = man["num_shards"]
    man["complete"] = [i for i in man["complete"] if i < n - 2]
    for i in (n - 2, n - 1):
        man["counts"].pop(str(i))
    with open(path, "w") as f:
        json.dump(man, f)
    return n


def _job_world4(rank, world, out):
    res = {}
    _transposes(rank, Topology.flat(4), res)
    _stream_runs(rank, Topology.pods(2, 2), out, res)
    return res


def _job_world2(rank, world, out):
    res = {}
    for rounds in (None, 4):
        _pba(Topology.flat(2), tpba.generate_pba_sharded, rounds, res)
    _stream_runs(rank, Topology.flat(2), out, res)
    # generate_cfree with P = 2 D, through the front door.
    for name, spec in (("rmat", RMAT_SPEC), ("ba_cfree", CFREE_SPEC)):
        r = tapi.generate(tapi.GraphSpec(execution="sharded", procs=4,
                                         **spec), device=CPU)
        res[f"cfree_{name}_src"] = r.edges.src.numpy()
        res[f"cfree_{name}_dst"] = r.edges.dst.numpy()
        res[f"cfree_{name}_plan"] = _jsonify(
            [r.plan.executor, r.plan.topology.label, r.plan.lp])
    # CFreeStream on flat(2), an odd slab: memory and shards.
    spec = tapi.GraphSpec(execution="streamed", slab_edges=CFREE_SLAB,
                          topology=Topology.flat(2), **CFREE_SPEC)
    r = tapi.generate(spec, device=CPU)
    res["cfree_stream_src"] = r.edges.src.numpy()
    res["cfree_stream_dst"] = r.edges.dst.numpy()
    res["cfree_stream_executor"] = np.array(r.plan.executor)
    d = os.path.join(out, "cfree_shards")
    r = tapi.generate(spec.replace(sink="shards", out_dir=d), device=CPU)
    res["cfree_shards_manifest"] = _jsonify(r.manifest)
    # Sharded execution into shards: rank 0 writes the whole graph.
    d = os.path.join(out, "sharded_shards")
    r = tapi.generate(tapi.preset("paper_smoke", vertices_per_proc=50,
                                  execution="sharded", sink="shards",
                                  out_dir=d, num_shards=5), device=CPU)
    res["sharded_shards_manifest"] = _jsonify(r.manifest)
    # Refusals, each before any work.
    refused = {}
    for name, fn in (
            ("world", lambda: tapi.plan(tapi.preset(
                "paper_smoke", execution="sharded",
                topology=Topology.flat(4)), device=CPU)),
            ("gloo_cuda", lambda: spmd.check_backend(torch.device("cuda"))),
            ("resolve_cuda", lambda: ttopology.resolve(
                Topology.flat(2), device=torch.device("cuda", 0))),
            ("three_d", lambda: blocking.transpose_counts(
                torch.zeros((1, 2), dtype=torch.int32),
                Topology(("a", "b", "c"), (1, 2, 1))))):
        try:
            fn()
            refused[name] = None
        except (ValueError, NotImplementedError) as e:
            refused[name] = [type(e).__name__, str(e)]
    res["refused"] = _jsonify(refused)
    return res


def _job_world3(rank, world, out):
    res = {}
    seed = tpk.star_clique_seed(4)
    edges, st = tpk.generate_pk(seed, tpk.PKConfig(**PK_CFG),
                                topology=Topology.flat(3), device=CPU)
    res["pk_src"], res["pk_dst"] = edges.src.numpy(), edges.dst.numpy()
    res["pk_stats"] = _stats(st)
    r = tapi.generate(tapi.GraphSpec(model="pk", seed_graph=seed,
                                     execution="sharded", **PK_CFG),
                      device=CPU)
    res["pk_api_src"] = r.edges.src.numpy()
    res["pk_api_plan"] = _jsonify([r.plan.executor, r.plan.topology.label])
    return res


JOBS = {"world8": _job_world8, "world4": _job_world4,
        "world2": _job_world2, "world3": _job_world3}


# --- the spawns, once per module ------------------------------------------------

@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("dist"), "world8", 8)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("dist"), "world4", 4)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("dist"), "world2", 2)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("dist"), "world3", 3)


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _json(a):
    return json.loads(str(a))


# --- the runtime ------------------------------------------------------------------

@pytest.mark.parametrize("label", ["flat_1x8", "pods_2x4", "pods_4x2",
                                   "flat_1x4"])
def test_transposes_match_the_global_swapaxes(label, world8, world4):
    ranks = world4 if label == "flat_1x4" else world8
    d = len(ranks)
    p = TRANSPOSE_LP * d
    counts, buf = _global_matrices(p)
    np.testing.assert_array_equal(_cat(ranks, f"{label}_counts"), counts.T)
    np.testing.assert_array_equal(_cat(ranks, f"{label}_payload"),
                                  np.swapaxes(buf, 0, 1))
    # Rank order is the linear device index: the logical ranks are
    # contiguous, [d*lp, (d+1)*lp) on rank d.
    np.testing.assert_array_equal(_cat(ranks, f"{label}_ranks"),
                                  np.arange(p))


def test_reductions_and_tail_mask(world8):
    for r in world8:
        assert int(r["sum_int"]) == sum(range(1, 9))
        np.testing.assert_array_equal(r["sum_tensor"], [28, 8])
        assert int(r["max_int"]) == 21
    u = torch.arange(5, dtype=torch.int32)
    got = blocking.mask_tail((u, u + 1), 2, 5, 12)
    np.testing.assert_array_equal(got[0].numpy(), [0, 1, -1, -1, -1])
    np.testing.assert_array_equal(got[1].numpy(), [1, 2, -1, -1, -1])
    assert blocking.all_reduce_sum(7, Topology.flat(1)) == 7


# --- PBA ---------------------------------------------------------------------------

def _jax_pba_host(rounds):
    from repro.core import factions as jfactions
    from repro.core import pba as jpba
    table = jfactions.make_factions(
        PBA_TABLE[0], jfactions.FactionSpec(**PBA_TABLE[1]))
    cfg = jpba.PBAConfig(exchange_rounds=rounds, **PBA_CFG)
    return jpba.generate_pba_host(cfg, table)


@pytest.mark.parametrize("rounds", [None, 4], ids=["single", "rounds4"])
@pytest.mark.parametrize("case", [
    ("generate_pba", "flat_1x8"), ("generate_pba_sharded", "pods_2x4"),
    ("generate_pba_sharded", "pods_4x2"),
    ("generate_pba_sharded", "flat_1x2")], ids=lambda c: "-".join(c))
def test_pba_over_ranks_matches_the_host_path(case, rounds, world8, world2):
    gen, label = case
    ranks = world2 if label == "flat_1x2" else world8
    edges, want = _jax_pba_host(rounds)
    key = f"{gen}_{label}_{rounds}"
    for end, arr in (("_src", edges.src), ("_dst", edges.dst)):
        np.testing.assert_array_equal(_cat(ranks, key + end),
                                      np.asarray(arr))
    for r in ranks:
        st = _json(r[key + "_stats"])
        assert st["dropped_edges"] == want.dropped_edges
        assert st["emitted_edges"] == want.emitted_edges
        assert st["pair_capacity"] == want.pair_capacity > 0
        assert st["exchange_rounds"] == int(want.exchange_rounds)
    if rounds:
        assert int(want.exchange_rounds) > 1


@pytest.mark.parametrize("rounds", [None, 4], ids=["single", "rounds4"])
@pytest.mark.parametrize("case", [
    ("generate_pba", "flat_1x8"), ("generate_pba_sharded", "pods_2x4"),
    ("generate_pba_sharded", "pods_4x2"),
    ("generate_pba_sharded", "flat_1x2")], ids=lambda c: "-".join(c))
def test_sharded_analytics_equal_the_host_path(case, rounds, world8, world2):
    """Each rank counts its own rows; every rank gets the JAX package's
    degree_counts of the host path's edges, their valid count and max."""
    from repro.core import graph as jgraph
    gen, label = case
    ranks = world2 if label == "flat_1x2" else world8
    edges, _ = _jax_pba_host(rounds)
    want = np.asarray(jgraph.degree_counts(edges))
    for r in ranks:
        key = f"{gen}_{label}_{rounds}"
        np.testing.assert_array_equal(r[key + "_degrees"], want)
        assert int(r[key + "_edge_count"]) == int(edges.num_valid())
        assert int(r[key + "_max_degree"]) == want.max()


def test_sharded_plans_read_the_world_size(world8):
    for r in world8:
        assert _json(r["plans"]) == {
            "8": ["generate_pba", "flat_1x8", 1, int(r["flat_1x8_ranks"][0])
                  // TRANSPOSE_LP],
            "16": ["generate_pba_sharded", "flat_1x8", 2,
                   int(r["flat_1x8_ranks"][0]) // TRANSPOSE_LP]}


# --- the sharded PBA stream --------------------------------------------------------

def _jax_stream():
    from repro import api as japi
    from repro.core import stream as jstream
    pl = japi.plan(japi.preset("hub_stress", **STREAM_SPEC))
    return pl, jstream.PBAStream(pl.config, pl.table)


@pytest.mark.parametrize("label", ["flat_1x2", "pods_2x2"])
def test_stream_shares_are_the_one_device_stream_by_owner(label, world2,
                                                          world4):
    ranks = world2 if label == "flat_1x2" else world4
    pl, stream = _jax_stream()
    owned = pl.num_vertices // len(ranks)
    key = f"stream_{label}"
    for d, r in enumerate(ranks):
        want = [stream.block(i) for i in range(stream.num_blocks)]
        keep = [(u // owned) == d for u, _ in want]
        np.testing.assert_array_equal(
            r[key + "_src"], np.concatenate([u[k] for (u, _), k in
                                             zip(want, keep)]))
        np.testing.assert_array_equal(
            r[key + "_dst"], np.concatenate([v[k] for (_, v), k in
                                             zip(want, keep)]))
        st = _json(r[key + "_stats"])
        assert st["emitted_edges"] == pl.requested_edges
        assert st["dropped_edges"] == 0
        assert st["exchange_rounds"] == stream.num_blocks
        assert str(r[key + "_executor"]) == "pba_stream_sharded"


@pytest.mark.parametrize("label", ["flat_1x2", "pods_2x2"])
def test_stream_shards_equal_the_one_device_set_and_resume(
        label, world2, world4, tmp_path):
    from repro.core import storage as jstorage
    from repro.core import stream as jstream
    ranks = world2 if label == "flat_1x2" else world4
    pl, stream = _jax_stream()
    alone = str(tmp_path / "alone")
    jman, _ = jstream.stream_to_shards(stream, alone)
    key = f"stream_{label}"
    for r in ranks:
        assert _json(r[key + "_manifest"]) == jman
        assert _json(r[key + "_resumed_manifest"])["counts"] == jman["counts"]
        n = jman["num_shards"]
        assert r[key + "_rewritten"].tolist() == [n - 2, n - 1]
    d = str(ranks[0][key + "_dir"])
    want = jstorage.read_shards(alone)
    got = jstorage.read_shards(d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # The set resumes under the JAX package: its meta is topology-free.
    _drop_last_two(d)
    jman2, _ = jstream.stream_to_shards(jstream.PBAStream(pl.config,
                                                          pl.table), d)
    assert jman2["counts"] == jman["counts"]
    got = jstorage.read_shards(d)
    np.testing.assert_array_equal(got[0], want[0])


# --- PK and the communication-free family ------------------------------------------

def test_pk_over_three_ranks_matches_the_reference(world3):
    import jax.numpy as jnp
    from repro.core import pk as jpk
    from repro.runtime import blocking as jblocking
    seed = jpk.star_clique_seed(4)
    cfg = jpk.PKConfig(**PK_CFG)
    n, e = jpk.pk_sizes(seed, cfg)
    assert e % 3
    chunk = -(-e // 3)
    su, sv = jnp.asarray(seed.u), jnp.asarray(seed.v)
    emitted = 0
    for rank, r in enumerate(world3):
        # The JAX package's generate_pk body for device ``rank``.
        base = jnp.asarray(jpk.decompose_base(min(rank * chunk, e),
                                              seed.num_edges, cfg.levels))
        u, v = jpk.expand_chunk(jnp.arange(chunk, dtype=jnp.int32), base,
                                su, sv, seed.num_vertices, seed.num_edges,
                                cfg.levels, cfg, rank)
        u, v = jblocking.mask_tail((u, v), rank, chunk, e)
        np.testing.assert_array_equal(r["pk_src"], np.asarray(u))
        np.testing.assert_array_equal(r["pk_dst"], np.asarray(v))
        np.testing.assert_array_equal(r["pk_api_src"], np.asarray(u))
        assert _json(r["pk_api_plan"]) == ["generate_pk", "flat_1x3"]
        emitted += int((np.asarray(u) >= 0).sum())
    for r in world3:
        st = _json(r["pk_stats"])
        assert (st["requested_edges"], st["emitted_edges"]) == (e, emitted)
        assert st["dropped_edges"] == e - emitted > 0


@pytest.mark.parametrize("name", ["rmat", "ba_cfree"])
def test_cfree_over_logical_ranks_matches_the_reference(name, world2):
    from repro.core import cfree as jcfree
    from repro.runtime.topology import Topology as JTopology
    spec = dict(RMAT_SPEC if name == "rmat" else CFREE_SPEC)
    model = spec.pop("model")
    kw = {"vertices": spec.pop("cfree_vertices"),
          "edges": spec.pop("cfree_edges", None), **spec}
    cfg = jcfree.CFreeConfig(model=model, **kw)
    want, _ = jcfree.generate_cfree(cfg, topology=JTopology.flat(1),
                                    num_procs=4)
    got_src = _cat(world2, f"cfree_{name}_src")
    np.testing.assert_array_equal(got_src,
                                  np.asarray(want.src).reshape(4, -1))
    np.testing.assert_array_equal(_cat(world2, f"cfree_{name}_dst"),
                                  np.asarray(want.dst).reshape(4, -1))
    host, _ = jcfree.generate_cfree_host(cfg)
    np.testing.assert_array_equal(got_src[got_src >= 0],
                                  np.asarray(host.src))
    for r in world2:
        assert _json(r[f"cfree_{name}_plan"]) == ["generate_cfree",
                                                  "flat_1x2", 2]


def test_cfree_stream_spans_an_odd_slab(world2, tmp_path):
    from repro.core import cfree as jcfree
    from repro.core import stream as jstream
    spec = dict(CFREE_SPEC)
    cfg = jcfree.CFreeConfig(model=spec.pop("model"),
                             vertices=spec.pop("cfree_vertices"), **spec)
    stream = jcfree.CFreeStream(cfg, CFREE_SLAB)
    per_dev = -(-CFREE_SLAB // 2)
    for d, r in enumerate(world2):
        want = [stream.block(i) for i in range(stream.num_blocks)]
        for k, key in ((0, "cfree_stream_src"), (1, "cfree_stream_dst")):
            np.testing.assert_array_equal(r[key], np.concatenate(
                [b[k][d * per_dev:(d + 1) * per_dev] for b in want]))
        assert str(r["cfree_stream_executor"]) == "cfree_stream_sharded"
    assert stream.requested_edges % CFREE_SLAB and \
        (stream.requested_edges % CFREE_SLAB) < per_dev
    jman, _ = jstream.stream_to_shards(stream, str(tmp_path))
    for r in world2:
        assert _json(r["cfree_shards_manifest"]) == jman


def test_sharded_execution_shards_equal_the_reference(world2, tmp_path):
    from repro import api as japi
    res = japi.generate(japi.preset(
        "paper_smoke", vertices_per_proc=50, execution="host", sink="shards",
        out_dir=str(tmp_path / "jax"), num_shards=5))
    want = res.manifest
    for r in world2:
        got = _json(r["sharded_shards_manifest"])
        assert got["counts"] == want["counts"]
        assert got["num_shards"] == 5 and got["complete"] == want["complete"]


@pytest.mark.parametrize("case", ["world", "gloo_cuda", "resolve_cuda",
                                  "three_d"])
def test_refusals_before_any_work(case, world2):
    for r in world2:
        kind, msg = _json(r["refused"])[case]
        if case == "world":
            assert kind == "ValueError" and "4 devices" in msg \
                and "world size is 2" in msg
        elif case == "three_d":
            assert kind == "NotImplementedError" and "3-D" in msg
        else:
            assert kind == "ValueError" and "gloo" in msg


def test_no_group_refuses_topologies_of_several_devices():
    assert not spmd.group_active()
    assert spmd.world_size() == 1 and spmd.device_count() == 1
    for topo in (Topology.flat(2), Topology.pods(2, 2)):
        with pytest.raises(ValueError, match="world size 1"):
            ttopology.resolve(topo)
        with pytest.raises(ValueError, match="world size 1"):
            blocking.transpose_counts(torch.zeros((1, 4), dtype=torch.int32),
                                      topo)
    with pytest.raises(ValueError, match="host topology"):
        ttopology.resolve(Topology.host())
    assert ttopology.resolve(None) == Topology.flat(1)


def test_nccl_group_refuses_cpu_tensors(tmp_path, monkeypatch):
    """A NCCL group carries CUDA tensors only: a CPU run under it raises
    before any work. (NCCL cannot start without a card, so a one-process
    gloo group stands in and reports itself as NCCL.)"""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
        with pytest.raises(ValueError, match="NCCL"):
            spmd.check_backend(torch.device("cpu"))
        with pytest.raises(ValueError, match="NCCL"):
            tapi.plan(tapi.preset("paper_smoke", execution="sharded",
                                  topology=Topology.flat(1)), device=CPU)
        spmd.check_backend(torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
