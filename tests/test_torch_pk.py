"""repro_torch's PK path against the JAX package's, bit-exact (tolerance 0),
on the CPU: the plain ``pk_expand`` against ``pk_expand_pallas`` in
interpret mode at the kernel registry's sizes, chunked RNG draws,
``generate_pk_host`` with noise and deletion, ``PKStream`` blocks, meta and
spec digests, cross-package shard resume, ``xor_randomize``, the seed
builders and the dense Kronecker oracle, and the front door's PK plans.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import pk as jpk
from repro.core import rng as jrng
from repro.core import spec as jspec
from repro.core import storage as jstorage
from repro.core import stream as jstream
from repro.core.graph import EdgeList as JEdgeList
from repro.kernels import _pk_expand_case, _pk_expand_sizes
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import pk as tpk
from repro_torch.core import rng as trng
from repro_torch.core import spec as tspec
from repro_torch.core import storage as tstorage
from repro_torch.core import stream as tstream
from repro_torch.core.graph import EdgeList
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pk_expand as tpk_expand

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


def _t(a):
    return torch.from_numpy(np.array(a))


def _seed(jseed):
    """The reference's SeedGraph rebuilt as the port's."""
    return convert.seed_graph_from_numpy(jseed.u, jseed.v,
                                         jseed.num_vertices)


# --- the kernel's plain version ------------------------------------------------

@pytest.mark.parametrize("size", _pk_expand_sizes(),
                         ids=lambda s: "m{m}_n{n0}_L{levels}_{noise}"
                         .format(**s))
def test_pk_expand_matches_pallas(size):
    """The registry's three sizes (one with noise): the JAX package's
    Pallas kernel in interpret mode against the port's plain version and
    wrapper on the same inputs."""
    case = _pk_expand_case(**size)
    want = case.fn(*case.args, interpret=True)
    n0, levels = size["n0"], size["levels"]
    t, base, su, sv = (_t(a) for a in case.args[:4])
    noise = [_t(a) for a in case.args[4:]] or [None, None]
    e0 = su.shape[0]
    for got in (ref.pk_expand_ref(t, base, su, sv, n0, e0, levels, *noise),
                tpk_expand.pk_expand(t, base.numpy(), su, sv, n0, e0,
                                      levels, *noise)):
        assert got[0].dtype == got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_division_magic_is_exact():
    """The kernel's quotient, umulhi(n, magic) >> shift, emulated as
    (n * magic) >> (32 + shift), equals // and % (by one multiply-subtract)
    for every e0 in [1, 8192] at the edge numerators and 64 random ones
    below 2^31, and for a few divisors up to 2^31 - 1."""
    rng = np.random.default_rng(8192)
    randoms = rng.integers(0, 2**31, 64, dtype=np.uint64)
    divisors = list(range(1, 8193)) + [65_535, 2**24 + 1, 2**30 - 1,
                                       2**30, 2**30 + 1, 2**31 - 1]
    for e0 in divisors:
        magic, shift = tpk_expand.division_magic(e0)
        assert 0 <= shift <= 30 and (magic < 2**32 or e0 == 1)
        n = np.concatenate([np.array([0, 1, e0 - 1, e0, min(e0 + 1,
                                                             2**31 - 1),
                                      2**31 - 1], np.uint64), randoms])
        q = (n * np.uint64(magic)) >> np.uint64(32 + shift)
        d = np.uint64(e0)
        np.testing.assert_array_equal(q, n // d, err_msg=f"e0={e0}")
        np.testing.assert_array_equal(n - q * d, n % d, err_msg=f"e0={e0}")
    for bad in (0, 2**31):
        with pytest.raises(ValueError):
            tpk_expand.division_magic(bad)


def test_pk_expand_plain_chunks_agree(monkeypatch):
    """Chunking the plain version along the edge axis changes no value."""
    case = _pk_expand_case(m=3000, n0=5, levels=4, noise=False)
    t, base, su, sv = (_t(a) for a in case.args)
    whole = ref.pk_expand_ref(t, base, su, sv, 5, 9, 4)
    monkeypatch.setattr(ref, "CHUNK", 77)
    chunked = ref.pk_expand_ref(t, base, su, sv, 5, 9, 4)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])


@pytest.mark.parametrize("noise,delete_prob,rank", [(0.0, 0.0, 0),
                                                    (0.2, 0.0, 3),
                                                    (0.0, 0.3, 1),
                                                    (0.1, 0.05, 7)])
def test_ops_pk_expand_matches_reference(monkeypatch, noise, delete_prob,
                                         rank):
    """Draws (chunked through ``rng``'s offset), kernel and deletion
    against the JAX package's ``ops.pk_expand`` (its plain route)."""
    from repro.kernels import ops as jops
    seed = jpk.star_clique_seed(4)
    rng = np.random.default_rng(rank)
    m, levels, e0 = 1500, 4, seed.num_edges
    t = rng.integers(0, e0 ** levels - m, m).astype(np.int32)
    base = jpk.decompose_base(int(rng.integers(0, e0 ** levels // 2)), e0,
                              levels)
    want = jops.pk_expand(jnp.asarray(t), jnp.asarray(base),
                          jnp.asarray(seed.u), jnp.asarray(seed.v),
                          seed.num_vertices, e0, levels, noise, delete_prob,
                          11, rank=rank)
    monkeypatch.setattr(ops, "DRAW_CHUNK", 1000)   # several chunks
    got = ops.pk_expand(_t(t), base, _t(seed.u), _t(seed.v),
                        seed.num_vertices, e0, levels, noise, delete_prob,
                        11, rank=rank)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# --- rng: chunked draws ----------------------------------------------------------

@pytest.mark.parametrize("shape,chunk", [((7, 1000), 999), ((3, 4096), 4096),
                                         ((2, 50), 1)])
def test_offset_chunked_draw_equals_the_whole_draw(shape, chunk):
    key = trng.device_key(5, trng.STREAM_PK_NOISE_DIGIT, 2)
    whole = trng.bits(key, shape).reshape(-1)
    n = whole.numel()
    parts = torch.cat([trng.bits(key, min(chunk, n - a), offset=a)
                       for a in range(0, n, chunk)])
    assert torch.equal(parts, whole)
    jkey = jrng.device_key(5, jrng.STREAM_PK_NOISE_DIGIT, 2)
    jwhole = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
    np.testing.assert_array_equal(parts.numpy(), jwhole.reshape(-1))
    u = trng.uniform(key, 100, offset=n - 100)
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jax.random.uniform(jkey, shape)).reshape(-1)
        [n - 100:])
    with pytest.raises(ValueError):
        trng.bits(key, 3, offset=-1)


# --- generators -------------------------------------------------------------------

SEEDS = {"star5": lambda: jpk.star_clique_seed(5),
         "star3": lambda: jpk.star_clique_seed(3),
         "dense": lambda: jpk.dense_power_seed(4, 3, seed=2)}


def test_seed_builders_match():
    for n in (1, 2, 5, 9):
        got, want = tpk.star_clique_seed(n), jpk.star_clique_seed(n)
        np.testing.assert_array_equal(got.u, want.u)
        np.testing.assert_array_equal(got.v, want.v)
        assert got.num_vertices == want.num_vertices
    for args in ((4, 3, 2), (40, 200, 3)):
        got, want = tpk.dense_power_seed(*args), jpk.dense_power_seed(*args)
        np.testing.assert_array_equal(got.u, want.u)
        np.testing.assert_array_equal(got.v, want.v)
    assert tpk.SeedGraph is tspec.SeedGraph
    for t0, base, levels in ((0, 9, 4), (6560, 9, 4), (12345, 7, 6)):
        np.testing.assert_array_equal(tpk.decompose_base(t0, base, levels),
                                      jpk.decompose_base(t0, base, levels))
    with pytest.raises(ValueError):
        tpk.decompose_base(9 ** 4, 9, 4)


@pytest.mark.parametrize("seed_name,levels,noise,delete_prob", [
    ("star5", 4, 0.0, 0.0), ("star5", 5, 0.05, 0.0), ("star3", 5, 0.1, 0.02),
    ("dense", 3, 0.2, 0.1)])
def test_generate_pk_host_matches_reference(seed_name, levels, noise,
                                            delete_prob):
    jseed = SEEDS[seed_name]()
    jcfg = jpk.PKConfig(levels=levels, noise=noise, delete_prob=delete_prob,
                        seed=9)
    jedges, jstats = jpk.generate_pk_host(jseed, jcfg)
    tcfg = convert.pk_config_from_fields(dataclasses.asdict(jcfg))
    tedges, tstats = tpk.generate_pk_host(_seed(jseed), tcfg, device=CPU)
    np.testing.assert_array_equal(tedges.src.numpy(), np.asarray(jedges.src))
    np.testing.assert_array_equal(tedges.dst.numpy(), np.asarray(jedges.dst))
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tedges.num_vertices == jedges.num_vertices
    if delete_prob:
        assert 0 < tstats.dropped_edges < tstats.requested_edges


def test_noise_free_expansion_is_the_dense_kronecker_power():
    seed = tpk.star_clique_seed(3)
    edges, _ = tpk.generate_pk_host(seed, tpk.PKConfig(levels=3),
                                    device=CPU)
    got = np.zeros((27, 27), np.int32)
    np.add.at(got, (edges.src.numpy(), edges.dst.numpy()), 1)
    want = tpk.dense_kronecker_power(seed, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        want, jpk.dense_kronecker_power(jpk.star_clique_seed(3), 3))


def test_int32_checks_match_reference():
    seed = tpk.star_clique_seed(5)
    for levels in (14, 10):   # n0^L past int32; e0^L past the host chunk
        with pytest.raises(ValueError):
            tpk.generate_pk_host(seed, tpk.PKConfig(levels=levels),
                                 device=CPU)
        with pytest.raises(ValueError):
            jpk.generate_pk_host(jpk.star_clique_seed(5),
                                 jpk.PKConfig(levels=levels))


@pytest.mark.parametrize("flip_fraction,seed", [(0.01, 0), (0.3, 4),
                                                (2.0, 1)])
def test_xor_randomize_matches_reference(flip_fraction, seed):
    rng = np.random.default_rng(seed)
    n = 40
    src = rng.integers(0, n, 500).astype(np.int32)
    dst = rng.integers(0, n, 500).astype(np.int32)
    src[:50], dst[:50] = src[50:100], dst[50:100]   # multiplicities > 1
    want = jpk.xor_randomize(JEdgeList(jnp.asarray(src), jnp.asarray(dst),
                                       n), flip_fraction, seed)
    got = tpk.xor_randomize(EdgeList(_t(src), _t(dst), n), flip_fraction,
                            seed)
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(want.src))
    np.testing.assert_array_equal(got.dst.numpy(), np.asarray(want.dst))
    er_u = rng.integers(0, n, 300)
    er_v = rng.integers(0, n, 300)
    for g, w in zip(tpk._xor_apply(src, dst, er_u, er_v, n),
                    jpk._xor_apply(src, dst, er_u, er_v, n)):
        np.testing.assert_array_equal(g, w)


# --- PKStream ---------------------------------------------------------------------

@pytest.mark.parametrize("slab", [64, 977])
@pytest.mark.parametrize("noise,delete_prob", [(0.0, 0.0), (0.1, 0.05)])
def test_pk_stream_blocks_match_reference(slab, noise, delete_prob):
    jseed = jpk.star_clique_seed(4)
    jcfg = jpk.PKConfig(levels=4, noise=noise, delete_prob=delete_prob,
                        seed=3)
    js = jstream.PKStream(jseed, jcfg, slab_edges=slab)
    ts = tstream.PKStream(_seed(jseed), convert.pk_config_from_fields(
        dataclasses.asdict(jcfg)), slab_edges=slab, device=CPU)
    assert ts.num_blocks == js.num_blocks == -(-7 ** 4 // slab)
    assert (ts.num_vertices, ts.requested_edges, ts.exchange_rounds) == \
        (js.num_vertices, js.requested_edges, js.exchange_rounds)
    assert ts.meta() == js.meta()
    for i in range(ts.num_blocks):
        got, want = ts.block(i), js.block(i)
        assert got[0].dtype == np.int32
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        ts.block(ts.num_blocks)


def test_pk_stream_meta_digest_covers_the_seed_edges():
    a = tpk.star_clique_seed(4)
    b = tpk.SeedGraph(a.u[::-1].copy(), a.v[::-1].copy(), a.num_vertices)
    cfg = tpk.PKConfig(levels=3, seed=1)
    ma = tstream.PKStream(a, cfg, 100, device=CPU).meta()
    mb = tstream.PKStream(b, cfg, 100, device=CPU).meta()
    assert ma["spec_digest"] != mb["spec_digest"]
    assert {k: v for k, v in ma.items() if k != "spec_digest"} == \
        {k: v for k, v in mb.items() if k != "spec_digest"}
    jb = jpk.SeedGraph(b.u, b.v, b.num_vertices)
    assert mb["spec_digest"] == jspec.spec_digest(
        jb, jpk.PKConfig(levels=3, seed=1), 100)
    assert tspec.spec_digest(cfg) == jspec.spec_digest(
        jpk.PKConfig(levels=3, seed=1))


# --- front door -------------------------------------------------------------------

def _read(d):
    return tstorage.read_shards(str(d))


PK_SHARDS = dict(levels=5, noise=0.05, delete_prob=0.02, slab_edges=5000,
                 sink="shards", seed=3)


@pytest.mark.parametrize("started_by", ["repro", "repro_torch"])
def test_pk_shards_started_by_one_package_resume_under_the_other(
        tmp_path, started_by):
    jspec_ = japi.preset("pk_smoke", **PK_SHARDS)
    tspec_ = tapi.preset("pk_smoke", **PK_SHARDS)
    japi.generate(jspec_.replace(out_dir=str(tmp_path / "alone")))
    want = _read(tmp_path / "alone")
    d = str(tmp_path / "mixed")
    if started_by == "repro":
        pl = japi.plan(jspec_.replace(out_dir=d))
        stream = jstream.PKStream(pl.seed_graph, pl.config, pl.spec.slab_edges)
        writer = jstorage.ShardWriter(d, stream.num_vertices,
                                      stream.num_blocks, meta=stream.meta())
    else:
        pl = tapi.plan(tspec_.replace(out_dir=d), device=CPU)
        stream = tapi._make_stream(pl)
        writer = tstorage.ShardWriter(d, stream.num_vertices,
                                      stream.num_blocks, meta=stream.meta())
    for i in (0, 2):
        writer.write_block(i, *stream.block(i))
    if started_by == "repro":
        res = tapi.generate(tspec_.replace(out_dir=d), device=CPU)
    else:
        res = japi.generate(jspec_.replace(out_dir=d))
    assert res.out_dir == d and res.stats.emitted_edges == len(want[0])
    got = _read(d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2]["meta"] == want[2]["meta"]
    assert got[2]["counts"] == want[2]["counts"]


@pytest.mark.parametrize("overrides", [
    {}, dict(execution="streamed", slab_edges=4096),
    dict(execution="streamed", slab_edges=1 << 20, delete_prob=0.1),
    dict(levels=3, seed_graph="dense", noise=0.3)])
def test_generate_pk_matches_reference(overrides):
    overrides = dict(overrides)
    if overrides.get("seed_graph") == "dense":
        dense = jpk.dense_power_seed(5, 4, seed=1)
        jover = {**overrides, "seed_graph": dense}
        tover = {**overrides, "seed_graph": _seed(dense)}
    else:
        jover = tover = overrides
    jres = japi.generate(japi.preset("pk_smoke", **jover))
    tres = tapi.generate(tapi.preset("pk_smoke", **tover), device=CPU)
    assert tres.plan.executor == jres.plan.executor
    np.testing.assert_array_equal(tres.edges.src.numpy(),
                                  np.asarray(jres.edges.src).reshape(-1))
    np.testing.assert_array_equal(tres.edges.dst.numpy(),
                                  np.asarray(jres.edges.dst).reshape(-1))
    assert dataclasses.asdict(tres.stats) == dataclasses.asdict(jres.stats)
    if tres.plan.execution == "streamed":
        assert tres.stream_meta == jstream.PKStream(
            jres.plan.seed_graph, jres.plan.config,
            jres.plan.spec.slab_edges).meta()


def test_pk_plan_errors_match_reference():
    for spec in (dict(model="pk", levels=0),
                 dict(model="pk", levels=14),
                 dict(model="pk", levels=10, execution="host"),
                 dict(model="pk", levels=3, execution="streamed",
                      topology="flat_1x1")):
        jover, tover = dict(spec), dict(spec)
        if "topology" in spec:
            from repro.runtime.topology import Topology as JTopology
            jover["topology"] = JTopology.flat(1)
            tover["topology"] = tapi.Topology.flat(1)
        with pytest.raises(ValueError):
            japi.plan(japi.GraphSpec(**jover))
        with pytest.raises(ValueError):
            tapi.plan(tapi.GraphSpec(**tover), device=CPU)
