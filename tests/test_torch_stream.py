"""repro_torch's streamed PBA path against the JAX package's, bit-exact
(tolerance 0), on the CPU: the band-compaction kernel's plain version
against ``band_compact_pallas`` (interpret mode) and the reference oracle,
the round driver, both stream drivers (blocks, budgets and meta), the
shard storage across packages (a manifest started by either package
resumes under the other), and the front door's streamed plans and sinks.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import storage as jstorage
from repro.core import stream as jstream
from repro.kernels import ref as jref
from repro.kernels.band_compact import band_compact_pallas
from repro.runtime.topology import Topology as JTopology
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import storage as tstorage
from repro_torch.core import stream as tstream
from repro_torch.core.graph import EdgeList
from repro_torch.kernels import ops, ref
from repro_torch.runtime import blocking, streaming
from repro_torch.runtime import topology as topology_lib
from repro_torch.runtime.topology import Topology

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


# --- band_compact ---------------------------------------------------------------

def _band_inputs(rows, e, cap, p_band=0.35):
    """The kernel registry's inputs for a (rows, e, cap) case."""
    rng = np.random.default_rng(rows * 131 + e * 17 + cap)
    u = rng.integers(0, 2**30, (rows, e)).astype(np.int32)
    v = rng.integers(0, 2**30, (rows, e)).astype(np.int32)
    band = rng.random((rows, e)) < p_band
    return u, v, band


def _assert_compacts(u, v, band, cap, want):
    tu, tv, tb = (torch.from_numpy(x) for x in (u, v, band))
    for got in (ref.band_compact_ref(tu, tv, tb, cap),
                ops.band_compact(tu, tv, tb, cap)):
        assert got[0].dtype == got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("rows,e,cap", [(1, 1, 1), (2, 1500, 600),
                                        (4, 8192, 2048)])
def test_band_compact_matches_pallas(rows, e, cap):
    u, v, band = _band_inputs(rows, e, cap)
    want = band_compact_pallas(jnp.asarray(u), jnp.asarray(v),
                               jnp.asarray(band), cap, interpret=True)
    _assert_compacts(u, v, band, cap, want)


@pytest.mark.parametrize("rows,e,cap,p_band", [
    (1, 262144, 65536, 0.35),      # the registry's largest size
    (3, 5000, 700, 0.5),           # overflow: ~2500 band entries > cap
    (2, 3000, 3000, 0.0),          # empty band
    (2, 3000, 4000, 1.0),          # all band, cap past e
])
def test_band_compact_matches_reference_oracle(rows, e, cap, p_band):
    u, v, band = _band_inputs(rows, e, cap, p_band)
    want = jref.band_compact_ref(jnp.asarray(u), jnp.asarray(v),
                                 jnp.asarray(band), cap)
    _assert_compacts(u, v, band, cap, want)


def test_band_compact_rows_are_stable_and_truncated():
    u, v, band = _band_inputs(4, 999, 100, 0.2)
    band[0] = False
    band[1] = True
    cu, cv = ops.band_compact(*(torch.from_numpy(x) for x in (u, v, band)),
                              100)
    for r in range(4):
        kept = np.flatnonzero(band[r])[:100]
        np.testing.assert_array_equal(cu[r, :len(kept)].numpy(), u[r, kept])
        np.testing.assert_array_equal(cv[r, :len(kept)].numpy(), v[r, kept])
        assert (cu[r, len(kept):] == -1).all()
    assert (cu[0] == -1).all()
    with pytest.raises(ValueError):
        ops.band_compact(torch.from_numpy(u), torch.from_numpy(v),
                         torch.from_numpy(band), 0)


# --- runtime -----------------------------------------------------------------

def test_drive_rounds_overlap_dispatch_before_writeback():
    events = []

    def dispatch(i):
        events.append(("dispatch", i))
        return i * 10

    def writeback(i, handle):
        assert handle == i * 10
        events.append(("write", i))

    assert streaming.drive_rounds([0, 1, 2], dispatch, writeback,
                                  overlap=True) == 3
    assert events == [("dispatch", 0), ("dispatch", 1), ("write", 0),
                      ("dispatch", 2), ("write", 1), ("write", 2)]
    events.clear()
    assert streaming.drive_rounds([4, 2], dispatch, writeback,
                                  overlap=False) == 2
    assert events == [("dispatch", 4), ("write", 4),
                      ("dispatch", 2), ("write", 2)]
    events.clear()
    assert streaming.drive_rounds([5], dispatch, writeback) == 1
    assert events == [("dispatch", 5), ("write", 5)]
    for overlap in (True, False):
        assert streaming.drive_rounds([], dispatch, writeback,
                                      overlap=overlap) == 0


def test_one_device_topologies_and_labels():
    x = torch.arange(2 * 2 * 3, dtype=torch.int32).reshape(2, 2, 3)
    for topo in (Topology.host(), Topology.flat(1)):
        np.testing.assert_array_equal(
            blocking.transpose_payload(x, topo).numpy(),
            x.numpy().swapaxes(0, 1))
        assert blocking.all_reduce_sum(7, topo) == 7
        assert blocking.logical_ranks(3, topo).tolist() == [0, 1, 2]
    # More than one device needs a process group of that world size.
    for topo in (Topology.flat(2), Topology.pods(1, 2)):
        with pytest.raises(ValueError, match="world size 1"):
            blocking.transpose_payload(x, topo)
        with pytest.raises(ValueError, match="world size 1"):
            topology_lib.resolve(topo)
    for topo in (Topology.host(), Topology.flat(1), Topology.flat(8),
                 Topology.pods(2, 4)):
        assert Topology.from_label(topo.label) == topo
    with pytest.raises(ValueError):
        Topology.from_label("ring_3")
    e = EdgeList(x[0], x[1], 12).flat()
    assert e.src.shape == (6,) and e.num_vertices == 12


# --- streams -------------------------------------------------------------------

STREAM_CASES = {
    "hub_stress": ("hub_stress", {}),
    "p16_r8": ("paper_smoke", dict(procs=16, vertices_per_proc=300,
                                   exchange_rounds=8, pair_capacity=64)),
}


def _stream_inputs(name):
    """The JAX config and table of a preset with the reference-derived
    pair capacity pinned, and the port's."""
    preset, overrides = STREAM_CASES[name]
    pl = japi.plan(japi.preset(preset, **overrides))
    cfg = dataclasses.replace(pl.config, pair_capacity=pl.pair_capacity)
    tcfg = convert.pba_config_from_fields(dataclasses.asdict(cfg))
    ttab = convert.faction_table_from_numpy(pl.table.procs, pl.table.s,
                                            pl.table.factions)
    return cfg, pl.table, tcfg, ttab


@pytest.mark.parametrize("auto", [True, False], ids=["auto", "parity"])
@pytest.mark.parametrize("name", sorted(STREAM_CASES))
def test_streams_match_reference(name, auto):
    cfg, table, tcfg, ttab = _stream_inputs(name)
    want = jstream.PBAStream(cfg, table, auto_capacity=auto)
    jsh = jstream.PBAShardedStream(cfg, table, topology=JTopology.flat(1),
                                   auto_capacity=auto)
    host = tstream.PBAStream(tcfg, ttab, auto_capacity=auto, device=CPU)
    dev = tstream.PBAShardedStream(tcfg, ttab, topology=Topology.flat(1),
                                   auto_capacity=auto, device=CPU)
    assert want.num_blocks > 1
    for got in (host, dev):
        assert got.num_blocks == want.num_blocks == jsh.num_blocks
        assert got.urn_budget == want.urn_budget == jsh.urn_budget
        assert got.round_cap == want.round_cap
        assert got.meta() == want.meta() == jsh.meta()
    assert dev.block_cap == jsh.block_cap
    for i in range(want.num_blocks):
        wu, wv = want.block(i)
        for got in (host, dev):
            gu, gv = got.block(i)
            assert gu.dtype == gv.dtype == np.int32
            np.testing.assert_array_equal(gu, wu)
            np.testing.assert_array_equal(gv, wv)
    with pytest.raises(ValueError, match="out of range"):
        dev.block(dev.num_blocks)


def test_device_stream_rounds_match_reference_round_program():
    """The device stream's raw rounds (before the host-side compaction)
    equal the JAX package's compiled round program, counts included."""
    cfg, table, tcfg, ttab = _stream_inputs("p16_r8")
    jsh = jstream.PBAShardedStream(cfg, table, topology=JTopology.flat(1))
    dev = tstream.PBAShardedStream(tcfg, ttab, topology=Topology.flat(1),
                                   device=CPU)
    for i in (0, dev.num_blocks - 1):
        ju, jv, jc = jsh.dispatch_block(i)
        u, v, counts, event = dev.dispatch_block(i)
        assert event is None
        for got, want in ((u, ju), (v, jv), (counts, jc)):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want).reshape(got.shape))


def test_device_stream_needs_a_one_device_topology():
    _, _, tcfg, ttab = _stream_inputs("hub_stress")
    with pytest.raises(ValueError, match="host topology"):
        tstream.PBAShardedStream(tcfg, ttab, topology=Topology.host(),
                                 device=CPU)
    with pytest.raises(ValueError, match="world size 1"):
        tstream.PBAShardedStream(tcfg, ttab, topology=Topology.flat(2),
                                 device=CPU)


# --- storage across packages --------------------------------------------------

SHARD_SPEC = dict(execution="streamed", exchange_rounds=4, pair_capacity=512,
                  vertices_per_proc=400)


def _read(d):
    src, dst, man = jstorage.read_shards(str(d))
    tsrc, tdst, tman = tstorage.read_shards(str(d))
    np.testing.assert_array_equal(tsrc, src)
    np.testing.assert_array_equal(tdst, dst)
    assert tman == man
    return src, dst, man


@pytest.mark.parametrize("started_by", ["repro", "repro_torch"])
def test_manifest_started_by_one_package_resumes_under_the_other(
        tmp_path, started_by):
    jspec = japi.preset("paper_smoke", **SHARD_SPEC)
    tspec = tapi.preset("paper_smoke", **SHARD_SPEC)
    japi.generate(jspec.replace(sink="shards",
                                out_dir=str(tmp_path / "alone")))
    want = _read(tmp_path / "alone")

    d = str(tmp_path / "mixed")
    if started_by == "repro":
        pl = japi.plan(jspec)
        stream = jstream.PBAStream(pl.config, pl.table)
        writer = jstorage.ShardWriter(d, stream.num_vertices,
                                      stream.num_blocks, meta=stream.meta())
    else:
        pl = tapi.plan(tspec, device=CPU)
        stream = tstream.PBAStream(pl.config, pl.table, device=CPU)
        writer = tstorage.ShardWriter(d, stream.num_vertices,
                                      stream.num_blocks, meta=stream.meta())
    for i in (0, 1):
        writer.write_block(i, *stream.block(i))
    if started_by == "repro":
        res = tapi.generate(tspec.replace(sink="shards", out_dir=d),
                            device=CPU)
    else:
        res = japi.generate(jspec.replace(sink="shards", out_dir=d))
    assert res.stats.dropped_edges == 0 and res.out_dir == d
    got = _read(d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2]["meta"] == want[2]["meta"]
    assert got[2]["counts"] == want[2]["counts"]
    assert got[2]["complete"][:2] == [0, 1]


def test_resume_rejects_a_different_graph(tmp_path):
    """Parity mode has the same blocks count but another urn budget: the
    same shapes, a different graph."""
    d = str(tmp_path)
    tapi.generate(tapi.preset("paper_smoke", sink="shards", out_dir=d,
                              **SHARD_SPEC), device=CPU)
    with pytest.raises(ValueError, match="meta mismatch"):
        tapi.generate(tapi.preset("paper_smoke", sink="shards", out_dir=d,
                                  auto_capacity=False, **SHARD_SPEC),
                      device=CPU)
    with pytest.raises(ValueError, match="meta mismatch"):
        japi.generate(japi.preset("paper_smoke", sink="shards", out_dir=d,
                                  auto_capacity=False, **SHARD_SPEC))
    with pytest.raises(ValueError, match="shard count mismatch"):
        tapi.generate(tapi.preset("paper_smoke", sink="shards", out_dir=d,
                                  seed=8, **SHARD_SPEC), device=CPU)


def test_host_execution_shards_match_reference(tmp_path):
    spec = dict(execution="host", pair_capacity=8000, vertices_per_proc=300,
                sink="shards", num_shards=5)
    jres = japi.generate(japi.preset("paper_smoke",
                                     out_dir=str(tmp_path / "j"), **spec))
    tres = tapi.generate(tapi.preset("paper_smoke",
                                     out_dir=str(tmp_path / "t"), **spec),
                         device=CPU)
    assert tres.manifest == jres.manifest
    assert tres.edges is not None and tres.out_dir == str(tmp_path / "t")
    want = _read(tmp_path / "j")
    got = _read(tmp_path / "t")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_resume_rewrites_only_the_missing_shards(tmp_path):
    d = str(tmp_path)
    spec = tapi.preset("paper_smoke", sink="shards", out_dir=d,
                       topology=Topology.flat(1), **SHARD_SPEC)
    first = tapi.generate(spec, device=CPU)
    n = first.manifest["num_shards"]
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man["complete"] = [i for i in man["complete"] if i < n - 2]
    for i in (n - 2, n - 1):
        del man["counts"][str(i)]
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(man, f)
    stamp = {i: os.stat(os.path.join(d, f"shard_{i:05d}.npz")).st_mtime_ns
             for i in range(n)}
    for i in (n - 2, n - 1):
        os.utime(os.path.join(d, f"shard_{i:05d}.npz"), ns=(0, 0))
    again = tapi.generate(spec.replace(overlap=False), device=CPU)
    for i in range(n):
        t = os.stat(os.path.join(d, f"shard_{i:05d}.npz")).st_mtime_ns
        assert (t == stamp[i]) == (i < n - 2), i
    assert again.manifest["counts"] == first.manifest["counts"]
    assert again.stats == first.stats


# --- front door ----------------------------------------------------------------

PLAN_CASES = {
    "paper_1b_5b": ("paper_1b_5b", {}),
    "paper_1b_5b_flat1": ("paper_1b_5b", dict(procs=64,
                                              topology="flat_1x1")),
    "hub_flat1_no_overlap": ("hub_stress", dict(execution="streamed",
                                                topology="flat_1x1",
                                                overlap=False)),
    "smoke_auto_shards": ("paper_smoke", dict(sink="shards", out_dir="x")),
    "smoke_host_shards": ("paper_smoke", dict(execution="host",
                                              sink="shards", out_dir="x")),
}


def _both_specs(preset, overrides):
    jo, to = dict(overrides), dict(overrides)
    if "topology" in overrides:
        topo = Topology.from_label(overrides["topology"])
        to["topology"] = topo
        jo["topology"] = JTopology(topo.axis_names, topo.axis_sizes)
    return japi.preset(preset, **jo), tapi.preset(preset, **to)


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_streamed_plan_fields_match(name):
    jspec, tspec = _both_specs(*PLAN_CASES[name])
    assert tspec.digest() == jspec.digest()
    jp = japi.plan(jspec)
    tp = tapi.plan(tspec, device=CPU)
    for f in dataclasses.fields(jp):
        if f.name in ("spec", "config", "table", "topology"):
            continue
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    assert tp.topology == Topology.from_label(jp.topology.label)
    assert tp.executor in tp.describe()


@pytest.mark.parametrize("topology", [None, "flat_1x1"])
def test_generate_streamed_into_memory_matches_reference(topology):
    overrides = dict(execution="streamed", vertices_per_proc=300,
                     exchange_rounds=4, pair_capacity=256)
    if topology:
        overrides["topology"] = topology
    jspec, tspec = _both_specs("paper_smoke", overrides)
    jres = japi.generate(jspec)
    tres = tapi.generate(tspec, device=CPU)
    assert tres.plan.executor == jres.plan.executor
    np.testing.assert_array_equal(tres.edges.src.numpy(),
                                  np.asarray(jres.edges.src))
    np.testing.assert_array_equal(tres.edges.dst.numpy(),
                                  np.asarray(jres.edges.dst))
    assert tres.edges.src.device == CPU
    assert dataclasses.asdict(tres.stats) == dataclasses.asdict(jres.stats)
    assert tres.stream_meta["urn_budget"] >= 1
    assert tres.manifest is None


def test_generate_streamed_into_shards_matches_reference(tmp_path):
    jspec, tspec = _both_specs("hub_stress", dict(execution="streamed",
                                                  topology="flat_1x1",
                                                  sink="shards"))
    jres = japi.generate(jspec.replace(out_dir=str(tmp_path / "j")))
    tres = tapi.generate(tspec.replace(out_dir=str(tmp_path / "t")),
                         device=CPU)
    assert tres.edges is None
    assert tres.manifest == jres.manifest
    assert tres.stream_meta == tres.manifest["meta"]
    assert dataclasses.asdict(tres.stats) == dataclasses.asdict(jres.stats)
    want, got = _read(tmp_path / "j"), _read(tmp_path / "t")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
