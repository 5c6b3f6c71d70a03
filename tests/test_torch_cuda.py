"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
that has only torch: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``. Integer kernels: equality is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import _build, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _int32(rng, shape, lo, hi, dev):
    return torch.from_numpy(
        rng.integers(lo, hi, shape).astype(np.int32)).to(dev)


def test_kernels_build(dev):
    _build.build()
    for name in _build.SOURCES:
        assert _build.library_path(name).exists()


@pytest.mark.parametrize("rows,m", [(1, 1), (1, 1025), (3, 4097),
                                    (5, 100_003), (7, 1026)])
def test_resolve_step_matches_plain(dev, rows, m):
    """src == idx (one buffer) through the gather kernel."""
    rng = np.random.default_rng(rows * m)
    ptr = _int32(rng, (rows, m), 0, m, dev)
    before = ops.launch_counts()["resolve_step"]
    got = ops.resolve_step(ptr)
    torch.cuda.synchronize()
    assert ops.launch_counts()["resolve_step"] == before + 1
    assert torch.equal(got, ref.resolve_step_ref(ptr))
    assert torch.equal(ops.resolve_step(ptr[0]), ref.resolve_step_ref(ptr[0]))


def _urns(dev):
    """The phase-1 urns and phase-2 pools of a small preset's ranks,
    unresolved, on ``dev``."""
    from repro_torch.core import pba
    from repro_torch.runtime import blocking
    pl = api.plan(api.preset("paper_smoke", procs=8, vertices_per_proc=3000),
                  device=dev)
    cfg, table, p = pl.config, pl.table, pl.num_procs
    ranks = torch.arange(p, dtype=torch.int32, device=dev)
    ptr, _, _ = blocking.map_logical(
        lambda r, fr, ss: pba._phase1_urn(r, fr, ss, cfg, p), ranks,
        torch.from_numpy(table.procs).to(dev),
        torch.from_numpy(table.s).to(dev))
    t_cap = cfg.total_capacity_factor * cfg.edges_per_proc
    pool = blocking.map_logical(
        lambda r: pba._phase2_pool_urn(r, cfg, t_cap, dev), ranks)
    return ptr, pool


def test_resolve_roots_matches_plain_on_urns(dev):
    for urn in _urns(dev):
        want = ref.resolve_roots_ref(urn.clone())
        before = ops.launch_counts()["resolve_roots"]
        got = ops.resolve_roots(urn)
        torch.cuda.synchronize()
        assert got is urn
        assert ops.launch_counts()["resolve_roots"] == before + 1
        assert torch.equal(got, want)
        assert torch.equal(ops.resolve_roots(urn[0].clone()), want[0])


def test_resolve_roots_single_chain_and_repeats(dev):
    """ptr[j] = j - 1 at m = 100,003 (one chain, 17 doubling rounds), and
    urn rows resolved three times: identical results every run."""
    m = 100_003
    chain = torch.arange(-1, m - 1, dtype=torch.int32, device=dev)
    chain[0] = 0
    assert torch.equal(ops.resolve_roots(chain.clone()),
                       torch.zeros(m, dtype=torch.int32, device=dev))
    pool = _urns(dev)[1]
    runs = [ops.resolve_roots(pool.clone()) for _ in range(3)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[1], runs[2])
    assert torch.equal(runs[0], ref.resolve_roots_ref(pool.clone()))


def test_resolve_roots_raises_on_an_upward_pointer(dev):
    ptr = torch.arange(5000, dtype=torch.int32, device=dev).repeat(3, 1)
    ptr[2, 4000] = 4500
    with pytest.raises(ValueError, match="outside"):
        ops.resolve_roots(ptr)
    ptr[2, 4000] = -3
    with pytest.raises(ValueError, match="outside"):
        ops.resolve_roots(ptr)


@pytest.mark.parametrize("rows,m,n", [
    pytest.param(4, 1, 7, id="1-7"),
    pytest.param(4, 999, 1, id="999-1"),
    pytest.param(4, 70_001, 123_457, id="70001-123457"),
    # n % 4 from 0 to 3; odd n puts later rows off a 16-byte boundary
    pytest.param(3, 1000, 4096, id="n%4=0"),
    pytest.param(3, 1001, 4097, id="n%4=1"),
    pytest.param(3, 1001, 4098, id="n%4=2"),
    pytest.param(5, 1001, 4099, id="n%4=3"),
    pytest.param(2, 1, 9, id="m=1"),
    # one row whose tiles far outnumber the resident grid, so the tile
    # queue's claims go round the grid many times
    pytest.param(1, 3000, (1 << 24) + 3, id="n=2^24+3"),
    # more rows than a grid's y dimension admits, a few entries each
    pytest.param(70_001, 50, 3, id="rows=70001"),
])
def test_gather_forms_match_plain(dev, rows, m, n):
    rng = np.random.default_rng(m + n)
    src = _int32(rng, (rows, m), -2**31, 2**31 - 1, dev)
    idx = _int32(rng, (rows, n), -9, m + 9, dev)      # both ends clip
    assert torch.equal(ops.gather(src, idx), ref.gather_ref(src, idx))
    flat = idx.reshape(-1)
    idx3 = flat[:flat.numel() // 4 * 4].view(2, 2, -1)
    got = ops.gather(src[-1], idx3)                # 3-D on a 1-D source
    assert got.shape == idx3.shape
    assert torch.equal(got.reshape(-1),
                       ref.gather_ref(src[-1], idx3.reshape(-1)))


def _runs(rng, m, n):
    """Runs of consecutive indices (the grant lookups' pattern), two of
    them crossing the clip ends, the rest starting anywhere near [0, m)."""
    starts, lengths = [-7, m - 5], [19, 19]
    while sum(lengths) < n:
        lengths.append(int(rng.integers(1, 70)))
        starts.append(int(rng.integers(-30, m + 30)))
    return np.concatenate([np.arange(s, s + k) for s, k in
                           zip(starts, lengths)])[:n].astype(np.int32)


def test_gathers_on_two_streams_match_plain(dev):
    """The kernel's tile counter is per stream: gathers queued on two
    streams at once, several on each, all equal the plain version."""
    rng = np.random.default_rng(5)
    src = _int32(rng, (8, 300_001), -2**31, 2**31 - 1, dev)
    idx = [_int32(rng, (8, 200_003), -9, 300_010, dev) for _ in range(6)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize(dev)
    outs = []
    for i, ix in enumerate(idx):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(ops.gather(src, ix))
    torch.cuda.synchronize(dev)
    for ix, out in zip(idx, outs):
        assert torch.equal(out, ref.gather_ref(src, ix))


@pytest.mark.parametrize("src_off,idx_off", [(0, 1), (1, 0), (2, 3),
                                             (3, 3), (1, 2)])
@pytest.mark.parametrize("pattern", ["uniform", "runs", "hot", "hot-low"])
def test_gather_views_and_index_patterns(dev, src_off, idx_off, pattern):
    """src and idx views that start 1-3 entries off a 16-byte boundary
    (idx in and out of phase with the output), under uniform indices,
    runs of consecutive indices crossing both clip ends, and every index
    on one hot slot (or below the source)."""
    rng = np.random.default_rng(17 * src_off + idx_off)
    rows, m, n = 3, 5003, 20_011
    base = _int32(rng, rows * m + 8, -2**31, 2**31 - 1, dev)
    src = base[src_off:src_off + rows * m].view(rows, m)
    if pattern == "uniform":
        cols = rng.integers(-9, m + 9, (rows, n))
    elif pattern == "runs":
        cols = np.stack([_runs(rng, m, n) for _ in range(rows)])
    else:
        cols = np.full((rows, n), 77 if pattern == "hot" else -4)
    ibase = torch.zeros(rows * n + 8, dtype=torch.int32, device=dev)
    idx = ibase[idx_off:idx_off + rows * n].view(rows, n)
    idx.copy_(torch.from_numpy(cols.astype(np.int32)))
    assert src.data_ptr() % 16 == 4 * src_off
    assert idx.data_ptr() % 16 == 4 * idx_off
    assert torch.equal(ops.gather(src, idx), ref.gather_ref(src, idx))
    assert torch.equal(ops.gather(src[1], idx[2]),
                       ref.gather_ref(src[1], idx[2]))
    assert torch.equal(ops.gather(src[0], idx),
                       ref.gather_ref(src[0], idx.reshape(-1)).view(rows, n))


@pytest.mark.parametrize("rows,n,nbins", [(1, 1, 1), (3, 5000, 64),
                                          (2, 300_001, 12_288),
                                          (2, 70_000, 70_000)])
def test_histogram_matches_plain(dev, rows, n, nbins):
    rng = np.random.default_rng(n + nbins)
    vals = _int32(rng, (rows, n), -2, nbins + 2, dev)
    assert torch.equal(ops.histogram(vals, nbins),
                       ref.histogram_ref(vals, nbins))
    assert torch.equal(ops.histogram(vals[0], nbins),
                       ref.histogram_ref(vals[0], nbins))


def _hist_check(vals, nbins, mask=None):
    """One launch, equal to the plain version."""
    before = ops.launch_counts()["histogram"]
    got = ops.histogram(vals, nbins, mask)
    torch.cuda.synchronize()
    assert ops.launch_counts()["histogram"] == before + 1
    assert torch.equal(got, ref.histogram_ref(vals, nbins, mask))
    return got


def _regime_bins(dev):
    """Bin counts at each of the regime boundaries of this card, and one
    past each."""
    from repro_torch.kernels import histogram
    _, optin = histogram._limits(dev)
    per_block = (optin - histogram._layout()[1]) // 4
    top = histogram.CLUSTER_MAX * per_block
    return [12_288, 12_289, per_block, per_block + 1, top, top + 1]


@pytest.mark.parametrize("nbins", [1, 64, 70_000, 3_000_000])
def test_histogram_every_value_in_one_bin(dev, nbins):
    """A warp's worst contention: every lane adds to the same bin."""
    vals = torch.full((3, 100_003), nbins - 1, dtype=torch.int32, device=dev)
    got = _hist_check(vals, nbins)
    assert int(got[:, -1].min()) == 100_003


@pytest.mark.parametrize("nbins", [64, 70_000, 3_000_000])
def test_histogram_every_value_out_of_range(dev, nbins):
    rng = np.random.default_rng(nbins)
    vals = _int32(rng, (5, 40_001), nbins, 2**31 - 1, dev)
    vals[:, ::3] = -1
    vals[1] = torch.iinfo(torch.int32).min
    assert int(_hist_check(vals, nbins).abs().sum()) == 0


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 13, 4097, 4098, 4099])
def test_histogram_row_widths(dev, n):
    """n % 4 in 0..3: every row but the first starts off 16 bytes, and
    each row has a scalar tail."""
    rng = np.random.default_rng(n)
    vals = _int32(rng, (5, n), -1, 65, dev)
    _hist_check(vals, 64)
    mask = torch.from_numpy(rng.random((5, n)) < 0.5).to(dev)
    _hist_check(vals, 64, mask)


@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("nbins", [64, 70_000])
def test_histogram_views_off_16_bytes(dev, off, nbins):
    rng = np.random.default_rng(off)
    base = _int32(rng, (100_003 + 8,), -1, nbins + 1, dev)
    vals = base[off:off + 100_003]
    assert vals.data_ptr() % 16 == 4 * off
    _hist_check(vals, nbins)
    flags = torch.from_numpy(rng.random(100_003 + 32) < 0.3).to(dev)
    for moff in (0, 4 * off, off):       # in phase with the values, or not
        _hist_check(vals, nbins, flags[moff:moff + 100_003])


def test_histogram_many_rows(dev):
    """More rows than grid y holds, each owned by one block."""
    rng = np.random.default_rng(7)
    vals = _int32(rng, (70_001, 7), -1, 65, dev)
    _hist_check(vals, 64)
    _hist_check(vals, 64, torch.from_numpy(rng.random((70_001, 7)) < 0.5)
                .to(dev))


def test_histogram_at_each_regime_boundary(dev):
    from repro_torch.kernels import histogram
    _, optin = histogram._limits(dev)
    kinds = [histogram.regime(nb, optin, *histogram._layout()).kind
             for nb in _regime_bins(dev)]
    assert kinds == ["block", "block", "block", "cluster", "cluster",
                     "global"]
    rng = np.random.default_rng(3)
    for nbins in _regime_bins(dev):
        vals = _int32(rng, (3, 200_003), -1, nbins + 2, dev)
        vals[0, :1000] = nbins - 1             # the last bin of the slice
        _hist_check(vals, nbins)
        _hist_check(vals[1], nbins)


def test_histogram_power_law_past_the_cluster(dev):
    """Degree-count-like values: power-law hubs into bins past what a
    cluster holds (device-memory atomics), -1 mapped to n."""
    rng = np.random.default_rng(11)
    n = 2_000_000
    vals = np.minimum(rng.zipf(1.8, 3_000_000) - 1, n).astype(np.int32)
    vals[::97] = n
    _hist_check(torch.from_numpy(vals).to(dev), n + 1)


@pytest.mark.parametrize("density", [0.415, 0.316, 0.067, 0.0093, 1e-5,
                                     0.0, 1.0])
@pytest.mark.parametrize("nbins", [64, 70_000])
def test_histogram_masked_round_densities(dev, density, nbins):
    """The census: a band at each round's density (PBA rounds 0-10 run
    from 41.5% down to a few entries), as scattered entries and as
    windows of runs."""
    rng = np.random.default_rng(int(density * 1e6) + nbins)
    vals = _int32(rng, (6, 300_007), -1, nbins + 1, dev)
    scattered = torch.from_numpy(rng.random((6, 300_007)) < density).to(dev)
    _hist_check(vals, nbins, scattered)
    runs = np.zeros((6, 300_007), dtype=bool)
    for row in runs:
        for start in rng.integers(0, 300_007, max(1, int(density * 40))):
            row[start:start + int(rng.integers(1, 3000))] = density > 0
    _hist_check(vals, nbins, torch.from_numpy(runs).to(dev))


@pytest.mark.parametrize("rows,nbins", [(3000, 64), (64, 70_000)])
def test_histogram_over_stale_memory(dev, rows, nbins):
    """Where a block or cluster owns each row the counts come from
    torch.empty: every bin must be written over whatever the allocator's
    cache held."""
    junk = torch.full((rows * nbins + 4096,), 0x5A5A5A5A, dtype=torch.int32,
                      device=dev)
    del junk
    rng = np.random.default_rng(rows)
    vals = _int32(rng, (rows, 20_000), -1, nbins // 2, dev)
    _hist_check(vals, nbins)
    junk = torch.full((rows * nbins + 4096,), -7, dtype=torch.int32,
                      device=dev)
    del junk
    _hist_check(vals, nbins, vals > 3)


@pytest.mark.parametrize("rows,e,cap,p_band", [
    (1, 1, 1, 0.5), (3, 4096, 1000, 0.3), (2, 4097, 5000, 0.9),
    (4, 70_001, 20_000, 0.5), (3, 100_000, 9000, 1 / 12)])
def test_band_compact_matches_plain(dev, rows, e, cap, p_band):
    rng = np.random.default_rng(rows * e + cap)
    u = _int32(rng, (rows, e), -2**31, 2**31 - 1, dev)
    v = _int32(rng, (rows, e), -2**31, 2**31 - 1, dev)
    band = torch.from_numpy(rng.random((rows, e)) < p_band).to(dev)
    if rows > 2:
        band[0] = False                    # an empty row
        band[1] = True                     # an all-band row (overflows)
    before = ops.launch_counts()["band_compact"]
    got = ops.band_compact(u, v, band, cap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["band_compact"] == before + 1
    want = ref.band_compact_ref(u, v, band, cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _band_equal(u, v, band, cap):
    before = ops.launch_counts()["band_compact"]
    got = ops.band_compact(u, v, band, cap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["band_compact"] == before + 1
    want = ref.band_compact_ref(u, v, band, cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _window_band(rng, rows, e, providers, lo, hi, dev):
    """The path's band: edges whose rank among the row's edges with the
    same provider lies in [lo, hi), a window of the row."""
    a = rng.integers(0, providers, (rows, e))
    occ = np.zeros((rows, e), dtype=np.int64)
    for q in range(providers):
        hit = a == q
        occ += np.where(hit, np.cumsum(hit, axis=1) - 1, 0)
    return torch.from_numpy((occ >= lo) & (occ < hi)).to(dev)


@pytest.mark.parametrize("case", [
    "window_r0", "window_late", "all_empty", "total_is_cap",
    "total_is_cap_plus_1", "cap_1", "below_one_tile"])
def test_band_compact_path_like_bands(dev, case):
    rng = np.random.default_rng(len(case))
    rows, e, cap = 4, 100_000, 40_000
    u = _int32(rng, (rows, e), -2**31, 2**31 - 1, dev)
    v = _int32(rng, (rows, e), -2**31, 2**31 - 1, dev)
    if case == "window_r0":
        band = _window_band(rng, rows, e, 16, 0, 1024, dev)
    elif case == "window_late":
        band = _window_band(rng, rows, e, 16, 5000, 5100, dev)
    elif case == "all_empty":
        band = torch.zeros((rows, e), dtype=torch.bool, device=dev)
    elif case.startswith("total_is_cap"):
        band = torch.zeros((rows, e), dtype=torch.bool, device=dev)
        extra = case.endswith("plus_1")
        for r in range(rows):
            pos = rng.choice(e, cap + extra, replace=False)
            band[r, torch.from_numpy(pos).to(dev)] = True
    elif case == "cap_1":
        band = torch.from_numpy(rng.random((rows, e)) < 0.01).to(dev)
        band[0] = False
        cap = 1
    else:                                    # e below one tile
        e = 5000
        u, v = u[:, :e].contiguous(), v[:, :e].contiguous()
        band = torch.from_numpy(rng.random((rows, e)) < 0.3).to(dev)
        cap = 3000
    _band_equal(u, v, band, cap)


@pytest.mark.parametrize("e", list(range(1, 16)) + [16 * 1024 + 7])
def test_band_compact_row_widths_off_16(dev, e):
    """e % 16 != 0: every row after the first starts off a 16-byte
    boundary, so rows take a scalar head and tail."""
    rng = np.random.default_rng(e)
    rows = 37
    u = _int32(rng, (rows, e), -2**31, 2**31 - 1, dev)
    v = _int32(rng, (rows, e), -2**31, 2**31 - 1, dev)
    band = torch.from_numpy(rng.random((rows, e)) < 0.4).to(dev)
    for cap in (e, max(e // 2, 1)):
        _band_equal(u, v, band, cap)


@pytest.mark.parametrize("band_off,uv_off", [(0, 1), (3, 0), (5, 2),
                                             (15, 3)])
def test_band_compact_views_off_16_bytes(dev, band_off, uv_off):
    """band, u and v as contiguous views that start off 16 bytes: the
    scalar head, and u/v out of phase with band (scalar u/v loads)."""
    rng = np.random.default_rng(band_off * 4 + uv_off)
    rows, e = 5, 50_003
    n = rows * e
    ubuf = _int32(rng, (n + 3,), -2**31, 2**31 - 1, dev)
    vbuf = _int32(rng, (n + 3,), -2**31, 2**31 - 1, dev)
    bbuf = torch.from_numpy(rng.random(n + 15) < 0.2).to(dev)
    u = ubuf[uv_off:uv_off + n].view(rows, e)
    v = vbuf[uv_off:uv_off + n].view(rows, e)
    band = bbuf[band_off:band_off + n].view(rows, e)
    _band_equal(u, v, band, 20_000)


def test_band_compact_many_rows(dev):
    """More than 65,535 rows: the grid's y dimension loops."""
    rng = np.random.default_rng(70_001)
    rows, e = 70_001, 40
    u = _int32(rng, (rows, e), -2**31, 2**31 - 1, dev)
    v = _int32(rng, (rows, e), -2**31, 2**31 - 1, dev)
    band = torch.from_numpy(rng.random((rows, e)) < 0.3).to(dev)
    _band_equal(u, v, band, 17)


def test_band_compact_writes_every_output_element(dev):
    """Outputs come from torch.empty: fill the allocator's cache with a
    pattern other than -1 first, so a column the kernel leaves unwritten
    shows."""
    rng = np.random.default_rng(5)
    rows, e, cap = 6, 300_000, 120_000
    u = _int32(rng, (rows, e), -2**31, 2**31 - 1, dev)
    v = _int32(rng, (rows, e), -2**31, 2**31 - 1, dev)
    band = _window_band(rng, rows, e, 8, 100, 2000, dev)
    for _ in range(3):
        junk = torch.full((4, rows * cap), 0x5A5A5A5A, dtype=torch.int32,
                          device=dev)
        del junk
        _band_equal(u, v, band, cap)


def test_device_stream_on_the_card_equals_the_cpu(dev):
    spec = api.preset("paper_smoke", procs=16, vertices_per_proc=300,
                      exchange_rounds=8, pair_capacity=64,
                      execution="streamed",
                      topology=api.Topology.flat(1))
    ops.reset_launch_counts()
    on_card = api.generate(spec, device=dev)
    launches = ops.launch_counts()
    on_cpu = api.generate(spec, device="cpu")
    assert on_card.plan.executor == "pba_stream_sharded"
    assert launches["band_compact"] == on_card.stats.exchange_rounds
    # one resolve per urn: the phase-1 urns and the pools
    assert launches["resolve_roots"] == 2 and launches["resolve_step"] == 0
    assert min(launches[k] for k in ("gather", "histogram")) > 0, launches
    assert torch.equal(on_card.edges.src.cpu(), on_cpu.edges.src)
    assert torch.equal(on_card.edges.dst.cpu(), on_cpu.edges.dst)
    assert on_card.stats == on_cpu.stats
    assert on_card.stream_meta == on_cpu.stream_meta


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    t = torch.zeros((4, 6), dtype=torch.int32, device=dev)
    big = torch.empty(2**31, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="2\\^31"):
        ops.gather(big, t)                 # 32-bit in-row offsets
    with pytest.raises(ValueError, match="2\\^31"):
        ops.gather(t[0], big)
    del big
    with pytest.raises(TypeError):
        ops.gather(t.long(), t)
    with pytest.raises(ValueError):
        ops.gather(t, t.t())               # rows mismatch
    with pytest.raises(ValueError):
        ops.gather(t, t[:, ::2])           # non-contiguous indices
    with pytest.raises(ValueError):
        ops.gather(t, t.cpu())             # devices differ
    with pytest.raises(TypeError):
        ops.histogram(t.long(), 3)
    with pytest.raises(ValueError):
        ops.histogram(t[:, ::2], 3)
    with pytest.raises(TypeError):
        ops.histogram(t, 3, t)             # mask must be bool
    with pytest.raises(ValueError):
        ops.histogram(t, 3, (t > 0)[:, :2])   # mask's shape
    with pytest.raises(ValueError):
        ops.histogram(t, 3, (t > 0).t().contiguous().t())
    with pytest.raises(TypeError):
        ops.band_compact(t, t, t, 3)       # band must be bool
    with pytest.raises(ValueError):
        ops.band_compact(t, t[:, :3].contiguous(), t > 0, 3)
    with pytest.raises(ValueError):
        ops.band_compact(t, t, t > 0, 0)
    from repro_torch.kernels import cfree_expand, pk_expand
    tab = torch.zeros(5, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        pk_expand.pk_expand(t[0].long(), [0, 0], tab, tab, 2, 5, 2)
    with pytest.raises(ValueError):
        pk_expand.pk_expand(t[0], [0, 0], tab[:4], tab, 2, 5, 2)
    with pytest.raises(ValueError):
        pk_expand.pk_expand(t[0], [0, 7], tab, tab, 2, 5, 2)
    with pytest.raises(TypeError):
        cfree_expand.cfree_expand(t[0].long(), [1, 2, 3, 4], model="er",
                                  n=5, ba_degree=1, thresholds=(0, 0, 0))
    with pytest.raises(ValueError):
        cfree_expand.cfree_expand(t[0], [1, 2, 3], model="er", n=5,
                                  ba_degree=1, thresholds=(0, 0, 0))


@pytest.mark.parametrize("name,overrides", [
    ("paper_smoke", dict(vertices_per_proc=500, pair_capacity=128)),
    ("hub_stress", {}),
    ("paper_smoke", dict(procs=16, vertices_per_proc=300, exchange_rounds=8,
                         pair_capacity=64)),
])
def test_generate_on_the_card_equals_the_cpu(dev, name, overrides):
    spec = api.preset(name, **overrides)
    ops.reset_launch_counts()
    on_card = api.generate(spec, device=dev)
    launches = ops.launch_counts()
    on_cpu = api.generate(spec, device="cpu")
    # the host path's kernels (its sources stay below the chunked bound,
    # and band compaction belongs to the device stream); one resolve per
    # urn
    assert launches["resolve_roots"] == 2 and launches["resolve_step"] == 0
    assert min(launches[k] for k in ("gather", "histogram")) > 0, launches
    assert torch.equal(on_card.edges.src.cpu(), on_cpu.edges.src)
    assert torch.equal(on_card.edges.dst.cpu(), on_cpu.edges.dst)
    assert on_card.stats == on_cpu.stats


def _pk_inputs(rng, m, n0, levels, dev, seed_graph=None):
    """Registry-style PK kernel inputs: local indices, the digits of a
    random range start and the seed's tables on ``dev``."""
    from repro_torch.core import pk
    seed = seed_graph or pk.star_clique_seed(n0)
    e0 = seed.num_edges
    hi = min(e0 ** levels, 2**31 - 1)
    t = _int32(rng, (m,), 0, max(hi - m, 1), dev)
    base = pk.decompose_base(int(rng.integers(0, max(hi // 2, 1))), e0,
                             levels)
    su, sv = pk.seed_tables(seed, dev)
    return seed, t, base, su, sv


@pytest.mark.parametrize("m,n0,levels,noise", [
    (1, 3, 2, False), (100, 3, 2, False), (3000, 5, 4, False),
    (2048, 6, 3, True), (1 << 20, 5, 10, False), (300_001, 5, 9, True)])
def test_pk_expand_matches_plain(dev, m, n0, levels, noise):
    from repro_torch.kernels import pk_expand
    rng = np.random.default_rng(m * 13 + n0 * 7 + levels)
    seed, t, base, su, sv = _pk_inputs(rng, m, n0, levels, dev)
    e0 = seed.num_edges
    flip = redraw = None
    if noise:
        flip = torch.from_numpy(rng.random((levels, m)) < 0.3).to(dev)
        redraw = _int32(rng, (levels, m), 0, e0, dev)
    before = ops.launch_counts()["pk_expand"]
    got = pk_expand.pk_expand(t, base, su, sv, n0, e0, levels, flip, redraw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pk_expand"] == before + 1
    want = ref.pk_expand_ref(t, base, su, sv, n0, e0, levels, flip, redraw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("noise", [False, True])
def test_pk_expand_tables_past_shared_memory(dev, noise):
    """A dense seed with e0 = 8000 > 4096 entries per table reads the
    tables through the read-only cache, in the same kernel."""
    from repro_torch.core import pk
    from repro_torch.kernels import pk_expand
    rng = np.random.default_rng(8000 + noise)
    seed_graph = pk.dense_power_seed(40, 200, seed=3)
    levels, m = 3, 50_000
    seed, t, base, su, sv = _pk_inputs(rng, m, 40, levels, dev,
                                       seed_graph)
    e0 = seed.num_edges
    assert e0 == 8000
    flip = redraw = None
    if noise:
        flip = torch.from_numpy(rng.random((levels, m)) < 0.5).to(dev)
        redraw = _int32(rng, (levels, m), 0, e0, dev)
    got = pk_expand.pk_expand(t, base, su, sv, 40, e0, levels, flip, redraw)
    want = ref.pk_expand_ref(t, base, su, sv, 40, e0, levels, flip, redraw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _pk_case(rng, m, n0, e0, levels, noise, dev):
    """Random tables of e0 entries below n0, a random range start and
    indices from the top million below e0^L (capped at 2^31 - 1; for
    e0 = 1, whose digits are all 0 whatever t, below 2^31 - 1)."""
    hi = 2**31 - 1 if e0 == 1 else min(e0 ** levels, 2**31 - 1)
    t = _int32(rng, (m,), max(hi - max(m, 1_000_000), 0), hi, dev)
    base = rng.integers(0, e0, levels).astype(np.int32)
    su = _int32(rng, (e0,), 0, n0, dev)
    sv = _int32(rng, (e0,), 0, n0, dev)
    flip = redraw = None
    if noise:
        flip = torch.from_numpy(rng.random((levels, m)) < 0.3).to(dev)
        redraw = _int32(rng, (levels, m), 0, e0, dev)
    return t, base, su, sv, flip, redraw


def _pk_equal(dev, t, base, su, sv, n0, e0, levels, flip, redraw):
    from repro_torch.kernels import pk_expand
    got = pk_expand.pk_expand(t, base, su, sv, n0, e0, levels, flip, redraw)
    torch.cuda.synchronize()
    want = ref.pk_expand_ref(t, base, su, sv, n0, e0, levels, flip, redraw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 4097])
def test_pk_expand_vector_tail(dev, m, noise):
    """m not a multiple of 4: the four-edge path and the one-edge tail
    (with noise, flip rows that start off a word boundary)."""
    rng = np.random.default_rng(m * 2 + noise)
    t, base, su, sv, flip, redraw = _pk_case(rng, m, 5, 9, 6, noise, dev)
    _pk_equal(dev, t, base, su, sv, 5, 9, 6, flip, redraw)


@pytest.mark.parametrize("noise", [False, True])
def test_pk_expand_misaligned_view(dev, noise):
    rng = np.random.default_rng(31 + noise)
    t, base, su, sv, flip, redraw = _pk_case(rng, 10_003, 5, 9, 7, noise,
                                             dev)
    tv = t[3:]                                # 12 bytes off 16
    assert tv.data_ptr() % 16
    if noise:
        flip, redraw = flip[:, 3:].contiguous(), redraw[:, 3:].contiguous()
    _pk_equal(dev, tv, base, su, sv, 5, 9, 7, flip, redraw)


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("n0,e0,levels", [
    (7, 1, 5),                  # every digit 0
    (64, 4097, 2),              # tables past shared memory
    (40, 8000, 2),
    (3, 5, 1),                  # L = 1
    (3, 5, 64),                 # the kernel's most levels
    (2, 2, 31)])
def test_pk_expand_radix_and_depth_edges(dev, n0, e0, levels, noise):
    rng = np.random.default_rng(e0 * 100 + levels + noise)
    t, base, su, sv, flip, redraw = _pk_case(rng, 70_001, n0, e0, levels,
                                             noise, dev)
    _pk_equal(dev, t, base, su, sv, n0, e0, levels, flip, redraw)


@pytest.mark.parametrize("noise", [False, True])
def test_pk_expand_indices_near_int32_max(dev, noise):
    rng = np.random.default_rng(77 + noise)
    m = 50_000
    _, base, su, sv, flip, redraw = _pk_case(rng, m, 5, 9, 10, noise, dev)
    t = (2**31 - 1) - torch.arange(m, dtype=torch.int32, device=dev)
    _pk_equal(dev, t, base, su, sv, 5, 9, 10, flip, redraw)


@pytest.mark.parametrize("m,model,n,degree", [
    (1, "ba_cfree", 64, 3), (100, "ba_cfree", 64, 3),
    (3000, "ba_cfree", 4096, 2), (1 << 20, "ba_cfree", 250_000_000, 4),
    (2048, "rmat", 1024, 2), (1 << 20, "rmat", 1 << 26, 2),
    (1500, "er", 777, 2), (1 << 20, "er", 1 << 26, 2)])
def test_cfree_expand_matches_plain(dev, m, model, n, degree):
    from repro_torch.core import cfree
    from repro_torch.kernels import cfree_expand
    e = n * degree if model == "ba_cfree" else max(m, 1 << 30)
    cfg = cfree.CFreeConfig(model=model, vertices=n, edges=e,
                            ba_degree=degree, seed=m * 7 + n)
    words = cfree.cfree_words(cfg)
    th = cfree.rmat_thresholds(cfg)
    rng = np.random.default_rng(m * 29 + n)
    t = _int32(rng, (m,), 0, e, dev)
    before = ops.launch_counts()["cfree_expand"]
    got = cfree_expand.cfree_expand(t, words, model=model, n=n,
                                    ba_degree=degree, thresholds=th)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cfree_expand"] == before + 1
    want = ref.cfree_expand_ref(t, words, model=model, n=n,
                                ba_degree=degree, thresholds=th)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _cfree_model(model, degree=4, n=None):
    """(words, n, thresholds) of a small config of ``model``."""
    from repro_torch.core import cfree
    n = n or (1 << 20 if model == "rmat" else 300_000)
    cfg = cfree.CFreeConfig(model=model, vertices=n,
                            edges=0 if model == "ba_cfree" else 1 << 30,
                            ba_degree=degree, seed=degree * 13 + n % 97)
    return cfree.cfree_words(cfg), n, cfree.rmat_thresholds(cfg)


def _cfree_equal(t, model, degree=4, n=None):
    from repro_torch.kernels import cfree_expand
    words, n, th = _cfree_model(model, degree, n)
    kw = dict(model=model, n=n, ba_degree=degree, thresholds=th)
    before = ops.launch_counts()["cfree_expand"]
    got = cfree_expand.cfree_expand(t, words, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cfree_expand"] == before + 1
    assert got[0].is_contiguous() and got[0].shape == t.shape
    want = ref.cfree_expand_ref(t, words, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("model", ["ba_cfree", "rmat", "er"])
@pytest.mark.parametrize("off", [1, 2, 3])
def test_cfree_expand_misaligned_views(dev, model, off):
    """t as a view 1-3 entries off 16 bytes: scalar head and tail quads,
    outputs allocated at t's phase."""
    rng = np.random.default_rng(off)
    buf = _int32(rng, (20_011,), 0, 1_200_000, dev)
    _cfree_equal(buf[off:off + 20_003], model)


@pytest.mark.parametrize("model", ["ba_cfree", "rmat", "er"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 255, 256, 257, 4097])
def test_cfree_expand_lengths(dev, model, m):
    """m % 4 in 0..3, m = 1, one warp tile and its neighbours."""
    rng = np.random.default_rng(m)
    _cfree_equal(_int32(rng, (m,), 0, 1_200_000, dev), model)


@pytest.mark.parametrize("model", ["ba_cfree", "rmat", "er"])
def test_cfree_expand_indices_near_int32_max(dev, model):
    t = (2**31 - 1) - torch.arange(50_001, dtype=torch.int32, device=dev)
    _cfree_equal(t, model, degree=1, n=(1 << 30) if model == "rmat"
                 else 2**31 - 1)


@pytest.mark.parametrize("degree", [1, 2, 3, 7, 1 << 20])
def test_cfree_expand_ba_degrees(dev, degree):
    """u = t / degree and v = (r >> 1) / degree by the multiply-high (by
    nothing for degree 1)."""
    n = min(300_000, (2**31 - 1) // degree)
    rng = np.random.default_rng(degree)
    _cfree_equal(_int32(rng, (30_000,), 0, n * degree, dev), "ba_cfree",
                 degree=degree, n=n)


def test_cfree_expand_ba_cfree_1b_slab(dev):
    """A slab from the middle of ba_cfree_1b's 10^9 edges, as its stream
    hands it to the kernel."""
    slab = 1 << 20
    t0 = (1_000_000_000 // slab // 2) * slab
    t = torch.arange(t0, t0 + slab, dtype=torch.int32, device=dev)
    _cfree_equal(t, "ba_cfree", degree=4, n=250_000_000)


@pytest.mark.parametrize("name,overrides,kernel", [
    ("pk_smoke", {}, "pk_expand"),
    ("pk_smoke", dict(execution="streamed", slab_edges=977,
                      delete_prob=0.1), "pk_expand"),
    ("rmat_smoke", {}, "cfree_expand"),
    ("rmat_smoke", dict(execution="streamed", slab_edges=4000,
                        topology=api.Topology.flat(1)), "cfree_expand"),
    ("ba_cfree_1b", dict(cfree_vertices=20_000, slab_edges=977),
     "cfree_expand"),
])
def test_pk_and_cfree_on_the_card_equal_the_cpu(dev, name, overrides,
                                                kernel):
    spec = api.preset(name, **overrides)
    ops.reset_launch_counts()
    on_card = api.generate(spec, device=dev)
    launches = ops.launch_counts()
    on_cpu = api.generate(spec, device="cpu")
    assert launches[kernel] >= 1, launches
    assert torch.equal(on_card.edges.src.cpu(), on_cpu.edges.src)
    assert torch.equal(on_card.edges.dst.cpu(), on_cpu.edges.dst)
    assert on_card.stats == on_cpu.stats


def test_analytics_on_the_card_equal_the_cpu(dev, monkeypatch):
    """Every analytics function on a small PBA graph: the card's results
    equal the CPU's (the assortativity to rel 1e-9, abs 1e-12), BFS levels
    and clustering rows split into chunks of a few CSR entries included;
    the degree count on the histogram kernel takes one launch."""
    from repro_torch.core import analysis
    from repro_torch.core.graph import EdgeList
    cpu = api.generate(api.preset("paper_smoke"), device="cpu").edges
    card = EdgeList(cpu.src.to(dev), cpu.dst.to(dev), cpu.num_vertices)
    before = ops.launch_counts()["histogram"]
    counts = analysis.degree_counts_device(card, use_kernel=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["histogram"] == before + 1
    assert torch.equal(counts.cpu(), analysis.degree_counts(cpu))
    assert torch.equal(analysis.degree_counts(card).cpu(),
                       analysis.degree_counts(cpu))
    for chunk in (analysis.EXPAND_CHUNK, 7):
        monkeypatch.setattr(analysis, "EXPAND_CHUNK", chunk)
        for fn, args in ((analysis.sampled_path_stats, (16,)),
                         (analysis.sampled_clustering_coefficient, (200,))):
            assert fn(card, *args) == fn(cpu, *args)
    for fn, args in ((analysis.community_contrast, (16,)),
                     (analysis.self_similarity_score, (4,)),
                     (analysis.rich_club_coefficient, (10,))):
        assert fn(card, *args) == fn(cpu, *args)
    assert np.array_equal(analysis.block_density(card, 16),
                          analysis.block_density(cpu, 16))
    assert analysis.degree_assortativity(card) == pytest.approx(
        analysis.degree_assortativity(cpu), rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "stablelm-1.6b",
                                  "phi3-medium-14b", "phi-3-vision-4.2b",
                                  "llama4-scout-17b-a16e",
                                  "qwen3-moe-235b-a22b", "minicpm3-4b",
                                  "mamba2-130m", "recurrentgemma-2b",
                                  "whisper-medium"])
def test_lm_serving_on_the_card_equals_the_cpu(dev, arch):
    """The LM serving path of each reduced arch in float32 (TF32 off):
    the card's Engine completions (none for the encoder-decoder) and
    prefill / decode logits against the port on the CPU, with
    chip_smoke's check (rtol/atol 1e-4; a token chosen by a top-2 margin
    under 1e-3 ends its completion's check)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch).reduced()
    cpu = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    tree = convert.numpy_params(cpu, seed=0)
    convert.params_from_numpy(cpu, tree)
    card = convert.params_from_numpy(
        build_model(cfg, compute_dtype=torch.float32, device=dev), tree)
    assert card.tree["embed"]["tok"].device == dev
    args = (chip_smoke.LM_REDUCED_WORKLOAD, chip_smoke.LM_SEED)
    want = chip_smoke.lm_record(
        np, *chip_smoke.lm_port_outputs(torch, np, cpu, *args))
    comps, _, logits, _ = chip_smoke.lm_port_outputs(torch, np, card,
                                                     *args)
    assert chip_smoke.lm_mismatches(np, comps, logits, want, 1e-4,
                                    1e-4) == []
