"""repro_torch PBA on the host topology against repro.core.pba, bit-exact
(tolerance 0): the generator end to end with ``pair_capacity`` pinned,
and its stages one by one. Both packages get the same faction table and
config; the port runs its plain path on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import api as japi
from repro.core import pba as jpba
from repro.runtime import streaming as jstreaming
from repro_torch import convert
from repro_torch.core import pba as tpba
from repro_torch.runtime import streaming as tstreaming

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers per machine; torch's intra-op thread
    pool then oversubscribes the cores (a 10^5-word draw went from 0.3 s
    to 30 s). One thread per worker keeps the CPU path's time stable."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pinned(name, **overrides):
    """(JAX config, table) and the port's, for a preset with the
    reference-derived pair capacity pinned."""
    pl = japi.plan(japi.preset(name, **overrides))
    cfg = dataclasses.replace(pl.config, pair_capacity=pl.pair_capacity)
    tcfg = convert.pba_config_from_fields(dataclasses.asdict(cfg))
    ttab = convert.faction_table_from_numpy(pl.table.procs, pl.table.s,
                                            pl.table.factions)
    return cfg, pl.table, tcfg, ttab


@pytest.mark.parametrize("name,overrides", [
    ("paper_smoke", {}),                                  # single-shot
    ("hub_stress", {}),                                   # streamed, R=4
    ("paper_smoke", dict(procs=16, vertices_per_proc=500,  # streamed, R=8
                         exchange_rounds=8, pair_capacity=64)),
], ids=["paper_smoke", "hub_stress", "p16_r8"])
def test_generate_pba_host_matches_reference(name, overrides):
    cfg, table, tcfg, ttab = _pinned(name, **overrides)
    je, js = jpba.generate_pba_host(cfg, table)
    te, ts = tpba.generate_pba_host(tcfg, ttab, device="cpu")
    np.testing.assert_array_equal(te.src.numpy(), np.asarray(je.src))
    np.testing.assert_array_equal(te.dst.numpy(), np.asarray(je.dst))
    assert te.src.dtype == te.dst.dtype == torch.int32
    for field in ("requested_edges", "emitted_edges", "dropped_edges",
                  "num_vertices", "exchange_rounds", "pair_capacity"):
        assert getattr(ts, field) == getattr(js, field), field
    assert ts.fallback_counts == {}
    if overrides.get("exchange_rounds") or name == "hub_stress":
        assert ts.exchange_rounds > 1 and ts.dropped_edges == 0


def test_occurrence_rank_matches_reference():
    rng = np.random.default_rng(3)
    a = rng.integers(-1, 9, (4, 5000)).astype(np.int32)
    want = np.asarray(jax.vmap(jpba.occurrence_rank)(jnp.asarray(a)))
    got = tpba.occurrence_rank(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), want)


def test_resolve_pointers_matches_reference():
    """Batched rows with different chain depths: the shared round counter
    must not disturb rows that resolved early."""
    rng = np.random.default_rng(4)
    m = 6000
    j = np.arange(m)
    terminal = np.zeros((3, m), bool)
    terminal[:, 0] = True
    terminal[0, rng.random(m) < 0.5] = True      # shallow chains
    terminal[2, rng.random(m) < 0.01] = True
    ptr = np.where(terminal, j, rng.integers(0, np.maximum(j, 1))
                   ).astype(np.int32)
    want = np.asarray(jax.vmap(jpba.resolve_pointers)(
        jnp.asarray(ptr), jnp.asarray(terminal)))
    got = tpba.resolve_pointers(torch.from_numpy(ptr),
                                torch.from_numpy(terminal))
    np.testing.assert_array_equal(got.numpy(), want)
    assert terminal[np.arange(3)[:, None], got.numpy()].all()


def _jax_resolve(ptr, terminal):
    """The JAX package's resolve_pointers, vmapped over rows as its
    generators call it (a 1-D input goes in as it is)."""
    fn = jpba.resolve_pointers if ptr.ndim == 1 \
        else jax.vmap(jpba.resolve_pointers)
    return np.asarray(fn(jnp.asarray(ptr), jnp.asarray(terminal)))


def _resolve_case(name):
    """(ptr, terminal) of a named chain layout."""
    rng = np.random.default_rng(17)
    if name == "chain_4097":                 # 12 doubling rounds
        m = 4097
        ptr = np.arange(-1, m - 1, dtype=np.int32)
        ptr[0] = 0
        terminal = np.arange(m) == 0
    elif name == "rows_of_depths":          # depths 1, ~log m and m - 1
        m = 3000
        j = np.arange(m)
        ptr = np.stack([np.zeros(m), rng.integers(0, np.maximum(j, 1)),
                        np.maximum(j - 1, 0)]).astype(np.int32)
        terminal = np.zeros((3, m), bool)
        terminal[:, 0] = True
    elif name == "roots_only":
        m = 777
        ptr = np.tile(np.arange(m, dtype=np.int32), (2, 1))
        terminal = np.ones((2, m), bool)
        terminal[1, 5:] = False              # roots that are not terminal
    elif name == "self_loop_slot0":         # s = 0: the reference runs all
        m = 1500                             # 64 rounds
        j = np.arange(m)
        ptr = rng.integers(0, np.maximum(j, 1), (2, m)).astype(np.int32)
        terminal = rng.random((2, m)) < 0.05
        terminal[:, 0] = False
        ptr = np.where(terminal, j, ptr).astype(np.int32)
    else:                                    # one_d
        m = 5000
        j = np.arange(m)
        terminal = (rng.random(m) < 0.02) | (j == 0)
        ptr = np.where(terminal, j, rng.integers(0, np.maximum(j, 1))
                       ).astype(np.int32)
    return ptr, terminal


@pytest.mark.parametrize("name", ["chain_4097", "rows_of_depths",
                                  "roots_only", "self_loop_slot0", "one_d"])
def test_resolve_pointers_chain_layouts_match_reference(name):
    """The port's one-launch resolve equals the reference's doubling
    while_loop, in place, on chains the urns rarely draw."""
    ptr, terminal = _resolve_case(name)
    want = _jax_resolve(ptr, terminal)
    arg = torch.from_numpy(ptr.copy())
    got = tpba.resolve_pointers(arg, torch.from_numpy(terminal))
    assert got.data_ptr() == arg.data_ptr()          # in place
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["paper_smoke", "hub_stress"])
def test_resolve_pointers_on_the_urns_matches_reference(name):
    """The real phase-1 urns and phase-2 pools of the preset's ranks."""
    _, _, tcfg, ttab = _pinned(name)
    p = ttab.num_procs
    ranks = torch.arange(p, dtype=torch.int32)
    e_local = tcfg.edges_per_proc
    t_cap = tcfg.total_capacity_factor * e_local
    from repro_torch.runtime import blocking
    ptr, terminal, _ = blocking.map_logical(
        lambda r, fr, ss: tpba._phase1_urn(r, fr, ss, tcfg, p), ranks,
        torch.from_numpy(ttab.procs), torch.from_numpy(ttab.s))
    pool = blocking.map_logical(
        lambda r: tpba._phase2_pool_urn(r, tcfg, t_cap, CPU), ranks)
    pool_terminal = np.broadcast_to(np.arange(e_local + t_cap) < e_local,
                                    pool.shape)
    for urn, term in ((ptr, terminal.numpy()), (pool, pool_terminal)):
        want = _jax_resolve(urn.numpy(), term)
        got = tpba.resolve_pointers(urn, torch.from_numpy(term.copy()))
        np.testing.assert_array_equal(got.numpy(), want)


def _doubling_fixpoint(ptr):
    p = ptr.copy()
    while not np.array_equal(p[p], p):
        p = p[p]
    return p


def _kernel_schedule(ptr, rng):
    """One row through the resolve kernel's schedule, in numpy: the slots'
    walks interleaved in a random order, one read per step; a walk that
    reaches a self-pointer writes that root into its own slot. A read of
    a slot already written returns the root or, at random, the pointer it
    replaced (a relaxed load may see either)."""
    orig, cur = ptr.copy(), ptr.copy()
    written = np.zeros(ptr.shape[0], bool)
    walks = {j: j for j in range(ptr.shape[0])}   # slot -> where it is
    while walks:
        j = list(walks)[rng.integers(len(walks))]
        x = walks[j]
        nxt = cur[x] if written[x] and rng.random() < 0.5 else orig[x]
        if nxt == x:
            if x != j:
                cur[j], written[j] = x, True
            del walks[j]
        else:
            walks[j] = nxt
    return cur


@settings(max_examples=150, deadline=None)
@given(m=st.integers(1, 70), seed=st.integers(0, 2**32 - 1),
       root_share=st.floats(0.0, 1.0))
def test_kernel_schedule_reaches_the_doubling_fixpoint(m, seed, root_share):
    """Whatever the interleaving of the walks and whichever of its two
    values a written slot shows, every slot ends at the doubling pass's
    fixpoint: the kernel's result does not depend on its schedule."""
    rng = np.random.default_rng(seed)
    j = np.arange(m)
    ptr = np.where(rng.random(m) < root_share, j,
                   rng.integers(0, j + 1)).astype(np.int32)
    np.testing.assert_array_equal(_kernel_schedule(ptr, rng),
                                  _doubling_fixpoint(ptr))


@pytest.mark.parametrize("seed", range(3))
def test_kernel_schedule_on_deep_chains(seed):
    rng = np.random.default_rng(100 + seed)
    m = 2000
    j = np.arange(m)
    # mostly one step down: chains hundreds of slots deep
    ptr = np.where(rng.random(m) < 0.9, np.maximum(j - 1, 0),
                   rng.integers(0, j + 1)).astype(np.int32)
    ptr[0] = 0
    np.testing.assert_array_equal(_kernel_schedule(ptr, rng),
                                  _doubling_fixpoint(ptr))


@pytest.mark.parametrize("bad", [("up", 5, 7), ("negative", 3, -1)])
def test_resolve_roots_plain_version_raises_on_a_bad_pointer(bad):
    from repro_torch.kernels import ops, ref
    _, slot, value = bad
    ptr = torch.arange(10, dtype=torch.int32).repeat(2, 1)
    ptr[1, slot] = value
    with pytest.raises(ValueError, match="outside"):
        ref.resolve_roots_ref(ptr.clone())
    with pytest.raises(ValueError, match="outside"):
        ops.resolve_roots(ptr[1].clone())
    with pytest.raises(ValueError, match="fixpoint"):
        tpba.resolve_pointers(ptr[0].clone(), ptr[0] >= 0, max_rounds=3)


def test_phase1_and_pool_match_reference():
    cfg, table, tcfg, ttab = _pinned("paper_smoke", vertices_per_proc=700)
    p = table.num_procs
    ranks = torch.arange(p, dtype=torch.int32)
    a, counts = tpba._phase1(ranks, torch.from_numpy(ttab.procs),
                             torch.from_numpy(ttab.s), tcfg, p)
    pool = tpba._phase2_pool(ranks, tcfg)
    phase1 = jax.jit(jpba._phase1, static_argnums=(3, 4))
    phase2_pool = jax.jit(jpba._phase2_pool, static_argnums=(1,))
    for r in range(p):
        ja, jc = phase1(jnp.int32(r), jnp.asarray(table.procs[r]),
                        jnp.int32(table.s[r]), cfg, p)
        np.testing.assert_array_equal(a[r].numpy(), np.asarray(ja))
        np.testing.assert_array_equal(counts[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(
            pool[r].numpy(), np.asarray(phase2_pool(jnp.int32(r), cfg)))


@pytest.mark.parametrize("e,min_s,procs,rounds,mem", [
    (8000, 3, 0, None, None), (20, 1, 4, None, 1 << 20),
    (5_000_000, 33, 64, 8, 8 << 30), (5_000_000, 33, 64, 8, 80 << 30),
    (100, 2, 1000, 4, 1 << 16), (40, 1, 1000, None, 1 << 12)])
def test_default_pair_capacity_matches_reference(e, min_s, procs, rounds,
                                                 mem):
    assert tpba.default_pair_capacity(e, min_s, procs, rounds, mem) == \
        jpba.default_pair_capacity(e, min_s, procs, rounds, mem)


def test_cpu_pair_capacity_probe_matches_reference():
    """On the CPU both packages budget the same fixed device memory."""
    assert tpba.default_pair_capacity(5_000_000, 33, 64, 8, device=CPU) == \
        jpba.default_pair_capacity(5_000_000, 33, 64, 8)


def test_streaming_round_math_matches_reference():
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 300, (5, 5)).astype(np.int32)
    for r in range(6):
        np.testing.assert_array_equal(
            tstreaming.round_window(torch.from_numpy(counts), r, 64).numpy(),
            np.asarray(jstreaming.round_window(jnp.asarray(counts), r, 64)))
        np.testing.assert_array_equal(
            tstreaming.residual_counts(torch.from_numpy(counts), r,
                                       64).numpy(),
            np.asarray(jstreaming.residual_counts(jnp.asarray(counts), r,
                                                  64)))
    for total, rounds in [(1, 1), (17, 4), (262144, 8)]:
        assert tstreaming.round_capacity(total, rounds) == \
            jstreaming.round_capacity(total, rounds)
        assert tstreaming.rounds_needed(5_000_000, rounds) == \
            jstreaming.rounds_needed(5_000_000, rounds)


@pytest.mark.parametrize("r", [0, 3, 7])
def test_round_indices_match_reference(r):
    """pba.grant_indices and pba.receive_indices, which the generator and
    chip_smoke.py's gather cases share, against the JAX package's own
    round code on sources that name their slots. jpba._grant_round over a
    pool holding its slot numbers returns each granted slot (and -1 where
    none is granted); jpba.pba_stream_round_block over pools numbered by
    (provider, slot) returns, for every band edge in edge order, the slot
    its receive read."""
    from repro.runtime import blocking as jblocking
    from repro.runtime.topology import Topology as JTopology
    cfg, table, tcfg, _ = _pinned("paper_smoke", procs=16,
                                  vertices_per_proc=500, exchange_rounds=8,
                                  pair_capacity=64)
    p, e_local = table.num_procs, cfg.edges_per_proc
    t_cap = cfg.total_capacity_factor * e_local
    pool_n = e_local + t_cap
    c_r = jstreaming.round_capacity(cfg.pair_capacity, cfg.exchange_rounds)
    jtopo = JTopology.host()
    ranks = jnp.arange(p, dtype=jnp.int32)
    a, occ, recv_counts = jpba.pba_stream_setup_block(
        ranks, jnp.asarray(table.procs), jnp.asarray(table.s), cfg, p, jtopo)

    # Grants: the path's demand, and rows whose runs pass the urn budget.
    rng = np.random.default_rng(40 + r)
    extra = rng.integers(0, 400, (2, p)).astype(np.int32)
    extra[0, 2] = 2 * t_cap
    counts = np.concatenate([np.asarray(recv_counts), extra])
    idx, valid = tpba.grant_indices(torch.from_numpy(counts), r, c_r,
                                    e_local, t_cap)
    assert idx.shape == valid.shape == (len(counts), p, c_r)
    assert idx.dtype == torch.int32
    assert bool(((idx >= e_local) & (idx < pool_n)).all())
    slots = jnp.arange(pool_n, dtype=jnp.int32)
    for q, row in enumerate(counts):
        out = np.asarray(jpba._grant_round(slots, jnp.asarray(row), r, c_r,
                                           e_local, t_cap))
        np.testing.assert_array_equal(valid[q].numpy(), out != -1)
        np.testing.assert_array_equal(idx[q].numpy()[out != -1],
                                      out[out != -1])
        one, one_valid = tpba.grant_indices(torch.from_numpy(row), r, c_r,
                                            e_local, t_cap)
        assert torch.equal(one, idx[q]) and torch.equal(one_valid, valid[q])
    assert not bool(valid[p].all())        # the budget clip was exercised

    # Receives, into the grants of pools numbered by (provider, slot).
    pool = ranks[:, None] * pool_n + jnp.arange(pool_n, dtype=jnp.int32)
    block_cap = jpba.stream_block_capacity(e_local, p, c_r)
    _, jv, jcounts = jpba.pba_stream_round_block(
        r, a, occ, recv_counts, pool, ranks, cfg, p, c_r, t_cap, block_cap,
        jtopo)
    grants = jax.vmap(lambda pl_, rc: jpba._grant_round(
        pl_, rc, r, c_r, e_local, t_cap))(pool, recv_counts)
    recv = torch.from_numpy(np.array(
        jblocking.transpose_payload(grants, jtopo))).reshape(p, p * c_r)
    ta = torch.from_numpy(np.array(a))
    band, ridx = tpba.receive_indices(ta, torch.from_numpy(np.array(occ)),
                                      r, c_r)
    assert ridx.dtype == torch.int32 and band.shape == ridx.shape
    assert torch.equal(ridx // c_r, ta)    # inside the provider's segment
    vals = recv.gather(1, ridx.long())
    jv, jcounts = np.asarray(jv), np.asarray(jcounts)
    for q in range(p):
        nb = int(band[q].sum())
        assert nb == int(jcounts[q].sum()) > 0
        np.testing.assert_array_equal(vals[q][band[q]].numpy(), jv[q, :nb])


@pytest.mark.parametrize("r", [0, 2, 5])
def test_round_compact_inputs_match_reference(r):
    """pba.round_compact_inputs, which the device stream's round and
    chip_smoke.py's band_compact path cases share, against the JAX
    package's own round: the plain band compaction of the helper's
    (u, v, band) must be jpba.pba_stream_round_block's (u, v), on the
    same setup and pools."""
    from repro.runtime.topology import Topology as JTopology
    from repro_torch.kernels import ref
    from repro_torch.runtime.topology import Topology
    cfg, table, tcfg, _ = _pinned("paper_smoke", procs=16,
                                  vertices_per_proc=500, exchange_rounds=8,
                                  pair_capacity=64)
    p, e_local = table.num_procs, cfg.edges_per_proc
    t_cap = cfg.total_capacity_factor * e_local
    c_r = jstreaming.round_capacity(cfg.pair_capacity, cfg.exchange_rounds)
    jtopo = JTopology.host()
    ranks = jnp.arange(p, dtype=jnp.int32)
    a, occ, recv_counts = jpba.pba_stream_setup_block(
        ranks, jnp.asarray(table.procs), jnp.asarray(table.s), cfg, p, jtopo)
    assert r < jstreaming.rounds_needed(int(recv_counts.max()), c_r)
    pool = jax.vmap(lambda q: jpba._phase2_pool(q, cfg, t_cap))(ranks)
    block_cap = jpba.stream_block_capacity(e_local, p, c_r)
    ju, jv, _ = jpba.pba_stream_round_block(
        r, a, occ, recv_counts, pool, ranks, cfg, p, c_r, t_cap, block_cap,
        jtopo)

    def t(x):
        return torch.from_numpy(np.array(x))

    u, v, band = tpba.round_compact_inputs(
        r, t(a), t(occ), t(recv_counts), t(pool), t(ranks), tcfg, p, c_r,
        t_cap, Topology.host())
    assert u.shape == v.shape == band.shape == (p, e_local)
    assert band.dtype == torch.bool and 0 < int(band.sum()) < band.numel()
    cu, cv = ref.band_compact_ref(u, v, band, block_cap)
    np.testing.assert_array_equal(cu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(cv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("r", [0, 3, 7])
def test_round_census_matches_reference(r):
    """The round's census, per provider: the counts of the port's
    pba_stream_round_block (its third output, from pba.round_census) equal
    those of the JAX package's round on the same setup and pools, and
    pba.round_census of (a, band) equals the unmasked count of
    where(band, a, -1), which the JAX round counts."""
    from repro.runtime.topology import Topology as JTopology
    from repro_torch.kernels import ops
    from repro_torch.runtime.topology import Topology
    cfg, table, tcfg, _ = _pinned("paper_smoke", procs=16,
                                  vertices_per_proc=500, exchange_rounds=8,
                                  pair_capacity=64)
    p, e_local = table.num_procs, cfg.edges_per_proc
    t_cap = cfg.total_capacity_factor * e_local
    c_r = jstreaming.round_capacity(cfg.pair_capacity, cfg.exchange_rounds)
    jtopo = JTopology.host()
    ranks = jnp.arange(p, dtype=jnp.int32)
    a, occ, recv_counts = jpba.pba_stream_setup_block(
        ranks, jnp.asarray(table.procs), jnp.asarray(table.s), cfg, p, jtopo)
    assert r < jstreaming.rounds_needed(int(recv_counts.max()), c_r)
    pool = jax.vmap(lambda q: jpba._phase2_pool(q, cfg, t_cap))(ranks)
    block_cap = jpba.stream_block_capacity(e_local, p, c_r)
    _, _, jcounts = jpba.pba_stream_round_block(
        r, a, occ, recv_counts, pool, ranks, cfg, p, c_r, t_cap, block_cap,
        jtopo)
    jcounts = np.asarray(jcounts)
    assert jcounts.shape == (p, p) and jcounts.sum() > 0

    def t(x):
        return torch.from_numpy(np.array(x))

    ta, tocc, trc, tpool, tranks = (t(x) for x in (a, occ, recv_counts,
                                                    pool, ranks))
    _, _, counts = tpba.pba_stream_round_block(
        r, ta, tocc, trc, tpool, tranks, tcfg, p, c_r, t_cap, block_cap,
        Topology.host())
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    band, _ = tpba.receive_indices(ta, tocc, r, c_r)
    census = tpba.round_census(ta, band, p)
    np.testing.assert_array_equal(census.numpy(), jcounts)
    np.testing.assert_array_equal(
        ops.histogram(torch.where(band, ta, -1), p).numpy(), jcounts)


def test_host_rejects_device_topology():
    from repro_torch.runtime.topology import Topology
    _, _, tcfg, ttab = _pinned("paper_smoke", vertices_per_proc=10)
    with pytest.raises(ValueError, match="host topology"):
        tpba.generate_pba_host(tcfg, ttab, Topology.flat(2), device="cpu")
