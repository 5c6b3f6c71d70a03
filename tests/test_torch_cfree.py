"""repro_torch's communication-free family (ba_cfree / rmat / er) against
the JAX package's, bit-exact (tolerance 0), on the CPU: the plain
``cfree_expand`` against ``cfree_expand_pallas`` in interpret mode at the
kernel registry's sizes, the hash (also where the 64-bit product of a
word and a mixing constant passes 2^63), the stream words, the serial
Batagelj–Brandes oracle, the host executor, ``CFreeStream`` blocks, meta
and spec digests, cross-package shard resume, and the front door's
communication-free plans.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import api as japi
from repro.core import cfree as jcfree
from repro.core import spec as jspec
from repro.core import storage as jstorage
from repro.kernels import _cfree_expand_case, _cfree_expand_sizes
from repro.runtime.topology import Topology as JTopology
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import cfree as tcfree
from repro_torch.core import spec as tspec
from repro_torch.core import storage as tstorage
from repro_torch.kernels import cfree_expand as tcfree_expand
from repro_torch.kernels import ops, ref

import cfree_queue_model

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers per machine; torch's intra-op thread
    pool then oversubscribes the cores. One thread per worker keeps the
    CPU path's time stable."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(jcfg):
    """The reference's CFreeConfig rebuilt as the port's."""
    return convert.cfree_config_from_fields(dataclasses.asdict(jcfg))


# --- the kernel's plain version ------------------------------------------------

@pytest.mark.parametrize("size", _cfree_expand_sizes(),
                         ids=lambda s: "{model}_m{m}_n{n}".format(**s))
def test_cfree_expand_matches_pallas(size):
    """The registry's four sizes: the JAX package's Pallas kernel in
    interpret mode against the port's plain version and wrapper."""
    case = _cfree_expand_case(**size)
    assert case.execute
    want = case.fn(*case.args, interpret=True)
    t = torch.from_numpy(np.array(case.args[0]))
    words = torch.from_numpy(np.array(case.args[1]).astype(np.int64))
    degree = size.get("degree", 2)
    e = size["n"] * degree if size["model"] == "ba_cfree" else size["m"]
    th = jcfree.rmat_thresholds(jcfree.CFreeConfig(
        model=size["model"], vertices=size["n"], edges=e, ba_degree=degree))
    for got in (ref.cfree_expand_ref(t, words, model=size["model"],
                                     n=size["n"], ba_degree=degree,
                                     thresholds=th),
                tcfree_expand.cfree_expand(t, words, model=size["model"],
                                           n=size["n"], ba_degree=degree,
                                           thresholds=th)):
        assert got[0].dtype == got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_cfree_expand_plain_chunks_agree(monkeypatch):
    """Chunking the plain version along the edge axis changes no value."""
    cfg = tcfree.CFreeConfig(model="ba_cfree", vertices=5000, ba_degree=3,
                             seed=2)
    t = torch.arange(15000, dtype=torch.int32)
    words = tcfree.cfree_words(cfg)
    whole = ref.cfree_expand_ref(t, words, model="ba_cfree", n=5000,
                                 ba_degree=3, thresholds=(0, 0, 0))
    monkeypatch.setattr(ref, "CHUNK", 999)
    chunked = ref.cfree_expand_ref(t, words, model="ba_cfree", n=5000,
                                   ba_degree=3, thresholds=(0, 0, 0))
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])


# --- hash and words --------------------------------------------------------------

def test_cfree_hash_matches_hash_int_past_2_63():
    """Words and counters near 2^32: every (x * MIX) product of the mixing
    steps passes 2^63 in int64, which the port never forms."""
    rng = np.random.default_rng(0)
    t = np.concatenate([np.arange(2**32 - 200, 2**32, dtype=np.int64),
                        rng.integers(2**31, 2**32, 300, dtype=np.int64),
                        np.arange(0, 100, dtype=np.int64)])
    assert int(t.max()) * jcfree._MIX2 > 2**63
    for w0, w1 in ((2**32 - 1, 2**32 - 2), (0x9E3779B9, 0), (1, 2**31)):
        for ctr in (0, 5, 31):
            got = tcfree.cfree_hash([w0, w1], torch.from_numpy(t), ctr)
            want = [jcfree.hash_int(w0, w1, int(x), ctr) for x in t]
            np.testing.assert_array_equal(got.numpy(), np.array(want))
            assert int(got.min()) >= 0 and int(got.max()) <= 2**32 - 1
            jgot = jcfree.cfree_hash(
                jnp.asarray([w0, w1], jnp.uint32),
                jnp.asarray(t.astype(np.uint32)), ctr)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jgot).astype(np.int64))
    assert tcfree.hash_int(5, 6, 7, 8) == jcfree.hash_int(5, 6, 7, 8)


@pytest.mark.parametrize("model", ["ba_cfree", "rmat", "er"])
def test_cfree_words_match_reference(model):
    for seed in (0, 1, 7, 12345, 2**31 - 1):
        jcfg = jcfree.CFreeConfig(model=model, vertices=1024, edges=100,
                                  seed=seed)
        want = np.asarray(jcfree.cfree_words(jcfg)).astype(np.int64)
        got = tcfree.cfree_words(_cfg(jcfg))
        assert got.dtype == torch.int64 and got.shape == (4,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_rmat_thresholds_and_sizes_match_reference():
    for abc in ((0.57, 0.19, 0.19), (0.25, 0.25, 0.25), (0.5, 0.3, 0.2),
                (1.0, 0.0, 0.0)):
        jcfg = jcfree.CFreeConfig("rmat", 1 << 10, 10, rmat_a=abc[0],
                                  rmat_b=abc[1], rmat_c=abc[2])
        assert tcfree.rmat_thresholds(_cfg(jcfg)) == \
            jcfree.rmat_thresholds(jcfg)
    for jcfg in (jcfree.CFreeConfig("ba_cfree", 77, ba_degree=3),
                 jcfree.CFreeConfig("er", 77, 500)):
        assert tcfree.cfree_sizes(_cfg(jcfg)) == jcfree.cfree_sizes(jcfg)
    for e, p in ((0, 3), (10, 3), (7, 8), (1000, 7)):
        assert tcfree.edge_slices(e, p) == jcfree.edge_slices(e, p)


def test_validation_matches_reference():
    for kw in (dict(model="nope", vertices=4),
               dict(model="rmat", vertices=100, edges=10),
               dict(model="rmat", vertices=64, edges=10, rmat_a=0.9),
               dict(model="er", vertices=10, edges=0),
               dict(model="ba_cfree", vertices=2**30, ba_degree=4),
               dict(model="ba_cfree", vertices=10, ba_degree=0)):
        with pytest.raises(ValueError):
            jcfree.CFreeConfig.validate(jcfree.CFreeConfig(**kw))
        with pytest.raises(ValueError):
            tcfree.CFreeConfig.validate(tcfree.CFreeConfig(**kw))


# --- executors --------------------------------------------------------------------

def test_ba_cfree_matches_serial_batagelj_brandes():
    jcfg = jcfree.CFreeConfig(model="ba_cfree", vertices=500, ba_degree=3,
                              seed=4)
    want = jcfree.serial_ba_cfree_reference(jcfg)
    cfg = _cfg(jcfg)
    edges, stats = tcfree.generate_cfree_host(cfg, device=CPU)
    np.testing.assert_array_equal(edges.src.numpy(), want[0])
    np.testing.assert_array_equal(edges.dst.numpy(), want[1])
    for g, w in zip(tcfree.serial_ba_cfree_reference(cfg), want):
        np.testing.assert_array_equal(g, w)
    assert stats.exchange_rounds == 0 and stats.dropped_edges == 0


def test_ba_chain_counts_the_draws_of_each_chain():
    """``ba_chain``'s last draws and per-edge draw counts against a serial
    walk of each chain through the reference's ``hash_int`` (one draw per
    edge, one more per hop while the draw is odd)."""
    jcfg = jcfree.CFreeConfig(model="ba_cfree", vertices=700, ba_degree=3,
                              seed=9)
    w0, w1 = (int(x) for x in np.asarray(jcfree.cfree_words(jcfg))[:2])
    want_r, want_draws = [], []
    for t in range(700 * 3):
        r, draws = jcfree.hash_int(w0, w1, t, 0) % (2 * t + 1), 1
        while r & 1 and draws <= jcfree.CHAIN_BOUND:
            j = r >> 1
            r, draws = jcfree.hash_int(w0, w1, j, 0) % (2 * j + 1), draws + 1
        want_r.append(r)
        want_draws.append(draws)
    r, draws = tcfree.ba_chain(tcfree.cfree_words(_cfg(jcfg)),
                               torch.arange(700 * 3, dtype=torch.int32))
    np.testing.assert_array_equal(r.numpy(), np.array(want_r))
    assert draws.dtype == torch.int32
    np.testing.assert_array_equal(draws.numpy(), np.array(want_draws))
    assert int(draws.sum()) > 700 * 3


@settings(max_examples=60, deadline=None)
@given(degree=st.integers(2, 2**31 - 1),
       extra=st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=16))
def test_degree_magic_is_exact(degree, extra):
    """The kernel's u = t / degree and v = (r >> 1) / degree, as
    umulhi(n, magic) >> shift with the wrapper's magic, emulated as
    (n * magic) >> (32 + shift), equal // for numerators below 2^31 (t is
    int32 >= 0; r < 2j + 1 <= 2^32 - 1): the edges of each quotient step
    near 0, near the top and around a few multiples of the degree."""
    magic, shift = tcfree_expand.division_magic(degree)
    assert 0 < magic < 2**32
    top = 2**31 - 1
    k = top // degree
    near = [0, 1, degree - 1, degree, degree + 1, top - 1, top,
            k * degree - 1, k * degree, 2 * degree - 1, 2 * degree]
    n = np.array([x for x in near + extra if 0 <= x <= top], np.uint64)
    q = (n * np.uint64(magic)) >> np.uint64(32 + shift)
    np.testing.assert_array_equal(q, n // np.uint64(degree))


def _model_draws(rng, m):
    """Chain lengths shaped like the slab's: each draw odd w.p. 1/2, at
    most 65 draws (mean 2)."""
    return np.minimum(rng.geometric(0.5, m), 65)


@settings(max_examples=40, deadline=None)
@given(m=st.integers(1, 3000), per_lane=st.sampled_from([1, 2, 4, 8, 16]),
       seed=st.integers(0, 2**16))
def test_queue_schedule_claims_each_edge_once_in_order(m, per_lane, seed):
    """The numpy model of the ba_cfree kernel's warp queue: every edge is
    started exactly once, a tile's edges start in edge order (lane i takes
    edge i first, then finishing lanes take the next ones in lane order),
    and the lane-trips that draw are the draws the chains take."""
    rng = np.random.default_rng(seed)
    draws = _model_draws(rng, m)
    draws[rng.integers(0, m)] = 65                # a chain at the bound
    start, trips = cfree_queue_model.queue_schedule(draws, per_lane)
    width = 32 * per_lane
    assert start.shape == (m,) and (start >= 0).all()
    for k in range(len(trips)):
        s = start[k * width:(k + 1) * width]
        assert (np.diff(s) >= 0).all()
        assert (s[:32] == 0).all() and trips[k] >= s.max() + 1
        d = draws[k * width:(k + 1) * width]
        assert trips[k] >= max(-(-int(d.sum()) // 32), int(d.max()))
    assert 0 < cfree_queue_model.queue_lane_use(draws, per_lane) <= 1


def test_queue_keeps_lanes_busier_than_one_edge_per_trip():
    """On chains of the slab's shape the queue's modelled lane use is well
    above one edge per lane per trip (the earlier design), and rises with
    the edges each lane owns; the kernel's own edges per lane lie in the
    range modelled."""
    draws = _model_draws(np.random.default_rng(1), 1 << 16)
    old = cfree_queue_model.trip_lane_use(draws)
    uses = [cfree_queue_model.queue_lane_use(draws, k) for k in (4, 8, 16)]
    assert old < 0.45 and uses[0] > 0.55 and uses[0] < uses[1] < uses[2]
    assert cfree_queue_model.kernel_per_lane() in (4, 8, 16)


def test_queue_model_on_ba_cfree_1b_chains():
    """The model over real chain lengths: ``ba_chain``'s per-edge draws
    for 2^14 edges from the middle of ba_cfree_1b, at the kernel's own
    edges per lane. Every edge starts once, the draws equal the chains'
    total, and the queue keeps lanes busier than one edge per trip."""
    cfg = tcfree.CFreeConfig(model="ba_cfree", vertices=250_000_000,
                             ba_degree=4, seed=7)
    t0 = tcfree.cfree_sizes(cfg)[1] // 2
    _, draws = tcfree.ba_chain(
        tcfree.cfree_words(cfg),
        torch.arange(t0, t0 + (1 << 14), dtype=torch.int32))
    draws = draws.numpy()
    per_lane = cfree_queue_model.kernel_per_lane()
    start, _ = cfree_queue_model.queue_schedule(draws, per_lane)
    assert (start >= 0).all() and draws.min() >= 1
    assert cfree_queue_model.queue_lane_use(draws, per_lane) > \
        cfree_queue_model.trip_lane_use(draws) + 0.2


HOST_CASES = {
    "ba_cfree": dict(model="ba_cfree", vertices=3000, ba_degree=4, seed=7),
    "rmat": dict(model="rmat", vertices=1 << 12, edges=20000, seed=3),
    "rmat_abc": dict(model="rmat", vertices=1 << 9, edges=5000,
                     rmat_a=0.45, rmat_b=0.25, rmat_c=0.3, seed=1),
    "er": dict(model="er", vertices=777, edges=12345, seed=2),
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_generate_cfree_host_matches_reference(name):
    jcfg = jcfree.CFreeConfig(**HOST_CASES[name])
    jedges, jstats = jcfree.generate_cfree_host(jcfg)
    tedges, tstats = tcfree.generate_cfree_host(_cfg(jcfg), device=CPU)
    np.testing.assert_array_equal(tedges.src.numpy(), np.asarray(jedges.src))
    np.testing.assert_array_equal(tedges.dst.numpy(), np.asarray(jedges.dst))
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tedges.num_vertices == jedges.num_vertices


@pytest.mark.parametrize("slab", [64, 977])
@pytest.mark.parametrize("model", ["ba_cfree", "rmat", "er"])
def test_cfree_stream_blocks_match_reference(slab, model):
    kw = {"ba_cfree": dict(vertices=1000, ba_degree=3),
          "rmat": dict(vertices=1 << 10, edges=3001),
          "er": dict(vertices=999, edges=2500)}[model]
    jcfg = jcfree.CFreeConfig(model=model, seed=5, **kw)
    js = jcfree.CFreeStream(jcfg, slab)
    for topology in (None, tapi.Topology.host(), tapi.Topology.flat(1)):
        ts = tcfree.CFreeStream(_cfg(jcfg), slab, topology=topology,
                                device=CPU)
        assert ts.num_blocks == js.num_blocks
        assert (ts.num_vertices, ts.requested_edges, ts.exchange_rounds) \
            == (js.num_vertices, js.requested_edges, js.exchange_rounds)
        assert ts.meta() == js.meta()
        for i in range(ts.num_blocks):
            got, want = ts.block(i), js.block(i)
            assert got[0].dtype == np.int32
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        ts.block(ts.num_blocks)
    with pytest.raises(ValueError, match="world size 1"):
        tcfree.CFreeStream(_cfg(jcfg), slab, topology=tapi.Topology.flat(2),
                           device=CPU)


def test_cfree_meta_and_digests_match_reference():
    for kw in HOST_CASES.values():
        jcfg = jcfree.CFreeConfig(**kw)
        assert tspec.spec_digest(_cfg(jcfg)) == jspec.spec_digest(jcfg)
        assert tcfree.CFreeStream(_cfg(jcfg), 100, device=CPU).meta() == \
            jcfree.CFreeStream(jcfg, 100).meta()
    a = tcfree.CFreeStream(tcfree.CFreeConfig("er", 10, 50, seed=1), 7,
                           device=CPU).meta()
    b = tcfree.CFreeStream(tcfree.CFreeConfig("er", 10, 50, seed=1), 9,
                           device=CPU).meta()
    assert a == b    # slab size is not part of a cfree graph's identity


# --- front door -------------------------------------------------------------------

CF_SHARDS = dict(cfree_vertices=4000, slab_edges=1500, sink="shards")


@pytest.mark.parametrize("started_by", ["repro", "repro_torch"])
def test_cfree_shards_started_by_one_package_resume_under_the_other(
        tmp_path, started_by):
    jspec_ = japi.preset("ba_cfree_1b", **CF_SHARDS)
    tspec_ = tapi.preset("ba_cfree_1b", **CF_SHARDS)
    japi.generate(jspec_.replace(out_dir=str(tmp_path / "alone")))
    want = tstorage.read_shards(str(tmp_path / "alone"))
    d = str(tmp_path / "mixed")
    if started_by == "repro":
        pl = japi.plan(jspec_.replace(out_dir=d))
        stream = jcfree.CFreeStream(pl.config, pl.spec.slab_edges)
        writer = jstorage.ShardWriter(d, stream.num_vertices,
                                      stream.num_blocks, meta=stream.meta())
    else:
        pl = tapi.plan(tspec_.replace(out_dir=d), device=CPU)
        stream = tapi._make_stream(pl)
        writer = tstorage.ShardWriter(d, stream.num_vertices,
                                      stream.num_blocks, meta=stream.meta())
    for i in (1, 3):
        writer.write_block(i, *stream.block(i))
    if started_by == "repro":
        res = tapi.generate(tspec_.replace(out_dir=d), device=CPU)
    else:
        res = japi.generate(jspec_.replace(out_dir=d))
    assert res.stats.dropped_edges == 0 and res.out_dir == d
    got = tstorage.read_shards(d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2]["meta"] == want[2]["meta"]
    assert got[2]["counts"] == want[2]["counts"]


@pytest.mark.parametrize("preset,overrides", [
    ("rmat_smoke", {}),
    ("rmat_smoke", dict(execution="streamed", slab_edges=5000)),
    ("rmat_smoke", dict(execution="streamed", slab_edges=5000,
                        topology="flat_1x1")),
    ("rmat_smoke", dict(model="er", cfree_vertices=5000, cfree_edges=30000,
                        execution="streamed")),
    ("ba_cfree_1b", dict(cfree_vertices=6000, execution="host")),
    ("ba_cfree_1b", dict(cfree_vertices=6000, slab_edges=7000,
                         topology="host")),
    ("ba_cfree_1b", dict(cfree_vertices=3000, slab_edges=2000,
                         sink="shards")),
])
def test_generate_cfree_matches_reference(tmp_path, preset, overrides):
    jover, tover = dict(overrides), dict(overrides)
    if "topology" in overrides:
        topo = tapi.Topology.from_label(overrides["topology"])
        tover["topology"] = topo
        jover["topology"] = JTopology(topo.axis_names, topo.axis_sizes)
    if overrides.get("sink") == "shards":
        jover["out_dir"] = str(tmp_path / "j")
        tover["out_dir"] = str(tmp_path / "t")
    jres = japi.generate(japi.preset(preset, **jover))
    tres = tapi.generate(tapi.preset(preset, **tover), device=CPU)
    assert tres.plan.executor == jres.plan.executor
    assert dataclasses.asdict(tres.stats) == dataclasses.asdict(jres.stats)
    if tres.manifest is not None:
        assert tres.manifest == jres.manifest
        got = tstorage.read_shards(str(tmp_path / "t"))
        want = tstorage.read_shards(str(tmp_path / "j"))
    else:
        got = (tres.edges.src.numpy(), tres.edges.dst.numpy())
        want = (np.asarray(jres.edges.src).reshape(-1),
                np.asarray(jres.edges.dst).reshape(-1))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_cfree_launch_counters_are_registered():
    assert {"pk_expand", "cfree_expand"} <= set(ops.launch_counts())
