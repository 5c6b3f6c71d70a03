"""The port's plain kernel versions against the JAX package's Pallas
kernels (interpret mode on the CPU, as the JAX package's own kernel tests
run them), bit-exact, at the kernel registry's small sizes; plus the
wrapper dispatch rules. The CUDA kernels themselves are held against the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.edge_resolve import (BLOCK, gather_chunked_pallas,
                                        gather_pallas, resolve_step_pallas)
from repro.kernels.histogram import histogram_pallas
from repro_torch.kernels import _build, dispatch, edge_resolve, ops, ref
from repro_torch.kernels import histogram as thist


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers per machine; torch's intra-op thread
    pool then oversubscribes the cores (a 10^5-word draw went from 0.3 s
    to 30 s). One thread per worker keeps the CPU path's time stable."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(a):
    """The same int32 array for both packages."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m", [1, 127, 1000, 4097])
def test_resolve_step_matches_pallas(m):
    rng = np.random.default_rng(1000 + m)
    pj, pt = _pair(rng.integers(0, m, m).astype(np.int32))
    want = np.asarray(resolve_step_pallas(pj, interpret=True))
    np.testing.assert_array_equal(ref.resolve_step_ref(pt).numpy(), want)
    np.testing.assert_array_equal(ops.resolve_step(pt).numpy(), want)


@pytest.mark.parametrize("rows,m", [(1, 1), (1, 127), (3, 1000),
                                    (2, 4097)])
def test_resolve_roots_is_the_fixpoint_of_pallas_passes(rows, m):
    """Urn-shaped pointers (downward, ~5% roots): resolve_roots equals
    resolve_step_pallas (interpret mode) passed until nothing changes, and
    writes it into its input."""
    rng = np.random.default_rng(2000 + rows * m)
    j = np.arange(m)
    ptr = np.where(rng.random((rows, m)) < 0.05, j,
                   rng.integers(0, np.maximum(j, 1), (rows, m))
                   ).astype(np.int32)
    want = []
    for row in ptr:
        p = jnp.asarray(row)
        while True:
            nxt = resolve_step_pallas(p, interpret=True)
            if bool((nxt == p).all()):
                break
            p = nxt
        want.append(np.asarray(p))
    arg = torch.from_numpy(ptr.copy())
    got = ops.resolve_roots(arg)
    assert got is arg
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    np.testing.assert_array_equal(
        ref.resolve_roots_ref(torch.from_numpy(ptr[0].copy())).numpy(),
        want[0])


def _gather_indices(rng, m, n, pattern, margin):
    """n int32 indices into a source of m entries. "uniform": drawn from
    [-margin, m + margin), so both clip ends are hit; "runs": runs of
    consecutive indices (the grant lookups' pattern), two of them
    crossing the clip ends; "hot": every index the same slot."""
    if pattern == "uniform":
        return rng.integers(-margin, m + margin, n).astype(np.int32)
    if pattern == "hot":
        return np.full(n, m // 2, dtype=np.int32)
    starts, lengths = [-7, m - 5], [15, 15]
    while sum(lengths) < n:
        lengths.append(int(rng.integers(1, 41)))
        starts.append(int(rng.integers(-20, m + 20)))
    return np.concatenate([np.arange(s, s + k) for s, k in
                           zip(starts, lengths)])[:n].astype(np.int32)


@pytest.mark.parametrize("m,n,pattern", [
    pytest.param(1, 5, "uniform", id="1-5"),
    pytest.param(300, 2048, "uniform", id="300-2048"),
    pytest.param(4097, 1500, "uniform", id="4097-1500"),
    pytest.param(1, 7, "runs", id="runs-1-7"),
    pytest.param(1001, 777, "runs", id="runs-1001-777"),
    pytest.param(4097, 1501, "runs", id="runs-4097-1501"),
    pytest.param(1001, 999, "hot", id="hot-1001-999"),
])
def test_gather_matches_pallas(m, n, pattern):
    rng = np.random.default_rng(m * 7 + n)
    sj, st = _pair(rng.integers(-2**31, 2**31 - 1, m).astype(np.int32))
    # indices past both ends exercise the clip contract
    ij, it = _pair(_gather_indices(rng, m, n, pattern, 5))
    want = np.asarray(gather_pallas(sj, ij, interpret=True))
    np.testing.assert_array_equal(ref.gather_ref(st, it).numpy(), want)
    np.testing.assert_array_equal(ops.gather(st, it).numpy(), want)


@pytest.mark.parametrize("m,n,pattern", [
    pytest.param(4097, 4097, "uniform", id="4097-4097"),
    pytest.param(3000, 777, "uniform", id="3000-777"),
    pytest.param(3001, 1999, "runs", id="runs-3001-1999"),
    pytest.param(3001, 513, "hot", id="hot-3001-513"),
])
def test_gather_chunked_multi_slab_matches_pallas(m, n, pattern):
    """Forced tiny slabs run the JAX package's multi-slab path."""
    rng = np.random.default_rng(m + n)
    sj, st = _pair(rng.integers(0, 2**30, m).astype(np.int32))
    ij, it = _pair(_gather_indices(rng, m, n, pattern, 3))
    want = np.asarray(gather_chunked_pallas(sj, ij, slab=BLOCK,
                                            dst_block=BLOCK, interpret=True))
    np.testing.assert_array_equal(
        edge_resolve.gather_chunked(st, it).numpy(), want)


def test_gather_rows_and_any_rank_forms():
    """Batched rows equal a per-row Pallas gather; a 1-D source with 3-D
    indices equals one flattened Pallas gather."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 10**6, (3, 500)).astype(np.int32)
    idx = rng.integers(-2, 502, (3, 700)).astype(np.int32)
    want = np.stack([np.asarray(gather_pallas(jnp.asarray(s), jnp.asarray(i),
                                              interpret=True))
                     for s, i in zip(src, idx)])
    got = ops.gather(torch.from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)

    idx3 = rng.integers(0, 500, (4, 5, 6)).astype(np.int32)
    want3 = np.asarray(gather_pallas(jnp.asarray(src[0]),
                                     jnp.asarray(idx3.reshape(-1)),
                                     interpret=True)).reshape(idx3.shape)
    got3 = ops.gather(torch.from_numpy(src[0]), torch.from_numpy(idx3))
    assert got3.shape == idx3.shape
    np.testing.assert_array_equal(got3.numpy(), want3)


@pytest.mark.parametrize("m,nbins", [(1, 1), (2048, 512), (5003, 700),
                                     (8192, 1537)])
def test_histogram_matches_pallas(m, nbins):
    rng = np.random.default_rng(m * 31 + nbins)
    # -1 and past-the-end values must be ignored, as the census relies on
    vals = rng.integers(-1, nbins + 3, m).astype(np.int32)
    vj, vt = _pair(vals)
    want = np.asarray(histogram_pallas(vj, nbins, interpret=True))
    np.testing.assert_array_equal(ref.histogram_ref(vt, nbins).numpy(), want)
    np.testing.assert_array_equal(ops.histogram(vt, nbins).numpy(), want)


def test_histogram_rows():
    rng = np.random.default_rng(11)
    vals = rng.integers(-1, 70, (4, 3000)).astype(np.int32)
    want = np.stack([np.asarray(histogram_pallas(jnp.asarray(r), 64,
                                                 interpret=True))
                     for r in vals])
    got = ops.histogram(torch.from_numpy(vals), 64)
    assert got.dtype == torch.int32 and got.shape == (4, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def _windows(rng, shape, runs):
    """A bool mask of ``runs`` windows of random length per row."""
    mask = np.zeros(shape, dtype=bool)
    for row in mask.reshape(-1, shape[-1]):
        for start in rng.integers(0, shape[-1], runs):
            row[start:start + int(rng.integers(1, 400))] = True
    return mask


@pytest.mark.parametrize("kind", ["none", "all", "windows", "scattered"])
def test_masked_histogram_matches_pallas(kind):
    """The masked plain version (the census's contract): the Pallas
    kernel's count of where(mask, values, -1)."""
    rng = np.random.default_rng(len(kind))
    vals = rng.integers(-1, 70, (3, 5003)).astype(np.int32)
    mask = {"none": np.zeros(vals.shape, dtype=bool),
            "all": np.ones(vals.shape, dtype=bool),
            "windows": _windows(rng, vals.shape, 6),
            "scattered": rng.random(vals.shape) < 0.3}[kind]
    want = np.stack([np.asarray(histogram_pallas(
        jnp.where(jnp.asarray(m), jnp.asarray(r), -1), 64, interpret=True))
        for r, m in zip(vals, mask)])
    vt, mt = torch.from_numpy(vals), torch.from_numpy(mask)
    np.testing.assert_array_equal(ref.histogram_ref(vt, 64, mt).numpy(), want)
    np.testing.assert_array_equal(ops.histogram(vt, 64, mt).numpy(), want)
    np.testing.assert_array_equal(
        ops.histogram(vt[1], 64, mt[1]).numpy(), want[1])
    with pytest.raises(ValueError, match="mask has shape"):
        ops.histogram(vt, 64, mt[:, 1:])


#: An H100's limits: 227 KB of opt-in shared memory per block, 8 blocks
#: in a portable cluster, 132 SMs; and a kernel layout of 1024 threads a
#: block and 16 KB of masked-step staging (what the library's
#: ``repro_histogram_threads`` / ``repro_histogram_stage_bytes`` give).
H100_OPTIN, H100_SMS = 232_448, 132
THREADS, STAGE_BYTES = 1024, 16384


def test_regime_at_each_boundary():
    """The pure choice of where the kernel's adds land, at each boundary
    of a given card's limits, and one past it."""
    per_block = (H100_OPTIN - STAGE_BYTES) // 4
    top = thist.CLUSTER_MAX * per_block

    def kind(nb, optin=H100_OPTIN, cluster_max=thist.CLUSTER_MAX):
        reg = thist.regime(nb, optin, THREADS, STAGE_BYTES, cluster_max)
        return reg.kind, reg.blocks

    assert kind(1) == kind(64) == kind(12_288) == kind(12_289) == \
        kind(per_block) == ("block", 1)
    assert kind(per_block + 1) == ("cluster", 2)
    assert kind(2 * per_block) == ("cluster", 2)
    assert kind(2 * per_block + 1) == ("cluster", 3)
    assert kind(top) == ("cluster", thist.CLUSTER_MAX)
    assert kind(top + 1) == ("global", 1)
    assert kind(2**31 - 1) == ("global", 1)
    # A card with the 48 KB default only, and clusters of at most 2.
    small = (48 * 1024 - STAGE_BYTES) // 4
    assert kind(small, 48 * 1024, 2) == ("block", 1)
    assert kind(small + 1, 48 * 1024, 2) == ("cluster", 2)
    assert kind(2 * small + 1, 48 * 1024, 2) == ("global", 1)


@pytest.mark.parametrize("nb", [1, 64, 12_288, 12_289, 53_000, 54_016,
                                54_017, 70_000, 432_128, 432_129])
def test_regime_windows_cover_the_bins(nb):
    """Each regime's shared memory fits the card, its copies fit their
    budget, and a cluster's windows cover [0, nb) exactly once."""
    reg = thist.regime(nb, H100_OPTIN, THREADS, STAGE_BYTES)
    if reg.kind == "global":
        assert reg.slice == 0
        return
    assert STAGE_BYTES + 4 * reg.slice * reg.copies <= H100_OPTIN
    assert reg.copies == 1 or 4 * reg.copies * nb <= thist.COPIES_BYTES
    assert 1 <= reg.copies <= THREADS // 32
    assert reg.blocks * reg.slice >= nb > (reg.blocks - 1) * reg.slice


@pytest.mark.parametrize("rows,nb,per_row,owned", [
    (64, 64, 2, False),            # phase 1 and the census
    (1, 64, 132, False),           # a 1-D call spreads over the card
    (64, 70_000, 2, True),         # one cluster of 2 per row
    (132, 64, 1, True), (70_001, 64, 1, True),
    (1, 64_000_001, 132, False)])  # the degree count: device memory
def test_blocks_per_row(rows, nb, per_row, owned):
    reg = thist.regime(nb, H100_OPTIN, THREADS, STAGE_BYTES)
    got = thist.blocks_per_row(rows, reg, H100_SMS)
    assert got == per_row and got % reg.blocks == 0
    assert (reg.kind != "global" and got == reg.blocks) == owned


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    t = torch.arange(10, dtype=torch.int32)
    ops.resolve_roots(t.clone())
    ops.resolve_step(t)
    ops.gather(t, t)
    ops.histogram(t, 4)
    ops.band_compact(t[None], t[None], t[None] > 3, 4)
    ops.pk_expand(t, [0, 0], t[:3], t[:3], 2, 3, 2, 0.5, 0.5, 1, 0)
    ops.cfree_expand(t, [1, 2, 3, 4], model="ba_cfree", n=5, ba_degree=2,
                     thresholds=(0, 0, 0))
    assert ops.launch_counts() == {"resolve_roots": 0, "resolve_step": 0,
                                   "gather": 0,
                                   "gather_chunked": 0, "histogram": 0,
                                   "band_compact": 0, "pk_expand": 0,
                                   "cfree_expand": 0}
    assert ops.fallback_counts() == {}


def test_dispatch_modes():
    t = torch.zeros(3, dtype=torch.int32)
    assert dispatch.mode(t) == "ref"
    with dispatch.forced_mode("ref"):
        assert dispatch.mode(t) == "ref"
    with pytest.raises(ValueError):
        with dispatch.forced_mode("cuda"):
            pass
    with pytest.raises(ValueError):
        dispatch.mode(torch.zeros(3, device="meta"))


def test_wrappers_reject_bad_shapes():
    t = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        thist.histogram(t, 4)
    with pytest.raises(ValueError):
        thist.histogram(t[0], 0)
    with pytest.raises(ValueError):
        ops.gather(t[0], t[1, :1])
    with pytest.raises(ValueError):
        ops.resolve_step(t)
    with pytest.raises(ValueError):
        ops.resolve_roots(t)


def test_build_paths_are_content_hashed_and_ignored(monkeypatch):
    for name in _build.SOURCES:
        p = _build.library_path(name)
        assert p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{name}_")
        assert (_build.CSRC / f"{name}.cu").exists()
    assert _build.library_path("gather") != _build.library_path("histogram")
    gitignore = (_build.CSRC.parents[3] / ".gitignore").read_text()
    assert "src/repro_torch/kernels/build/" in gitignore.split()
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(_build.CSRC / "no_such_toolkit"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()
