"""repro_torch's analytics against the JAX package's, on the CPU.

The same edges (the JAX package's, for the host-execution specs of
``reference_digests.json``, and small hand-made graphs) go through both
packages' ``core.analysis`` / ``core.graph`` functions: every result is
equal bit for bit, except ``degree_assortativity`` (its float64 sums run
in another order: rel 1e-9, abs 1e-12). The committed
``src/repro_torch/reference_analytics.json``, which ``chip_smoke.py``
holds the card to, is regenerated from the JAX package and must not have
gone stale; to rewrite it after a deliberate change:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_analysis.py
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the analytics record both sides share)

from repro import api as japi  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.core import analysis as janalysis  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import pba as jpba  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import analysis as tanalysis  # noqa: E402
from repro_torch.core import distributed_analysis as tdist  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import pba as tpba  # noqa: E402
from repro_torch.core.graph import edge_digest  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

PORT = REPO / "src" / "repro_torch"
ANALYTICS = PORT / "reference_analytics.json"
DIGEST_CASES = json.loads((PORT / "reference_digests.json").read_text())[
    "cases"]
#: The digest cases with host execution: the graphs both files share.
HOST_CASES = sorted(name for name, c in DIGEST_CASES.items()
                    if c["overrides"].get("execution") == "host")
#: A PK seed's vertex count, for self_similarity_score.
PK_N0 = {"pk_smoke": 5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (see test_torch_api.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _jax_edges(name: str):
    case = DIGEST_CASES[name]
    return japi.generate(japi.preset(case["preset"],
                                     **case["overrides"])).edges


def _port(edges) -> tgraph.EdgeList:
    """The JAX package's edges as the port's (CPU tensors)."""
    return tgraph.EdgeList(torch.from_numpy(np.array(edges.src)),
                           torch.from_numpy(np.array(edges.dst)),
                           edges.num_vertices)


def _jax(src, dst, n) -> jgraph.EdgeList:
    return jgraph.EdgeList(jnp.asarray(src, jnp.int32),
                           jnp.asarray(dst, jnp.int32), n)


def reference_analytics() -> dict:
    """The JAX package's analytics of every host digest case, and the
    serial BA oracle's edge digest: the content of
    reference_analytics.json."""
    cases = {name: {"n0": PK_N0.get(name),
                    "record": chip_smoke.analytics_record(
                        np, janalysis, _jax_edges(name),
                        lambda e: e.to_numpy(), np.asarray,
                        PK_N0.get(name))}
             for name in HOST_CASES}
    v, k, seed = chip_smoke.SERIAL_BA
    ba = jpba.serial_ba_reference(v, k, seed)
    return {
        "about": "The JAX package's core.analysis results on the CPU for "
                 "the host-execution graphs of reference_digests.json "
                 "(chip_smoke.analytics_record: arrays by sha256, scalars "
                 "as they are), and the edge digest of "
                 "serial_ba_reference(*serial_ba). tests/"
                 "test_torch_analysis.py regenerates them; chip_smoke.py "
                 "holds the port on the card to them (assortativity to "
                 "rel 1e-9, abs 1e-12; everything else exactly).",
        "serial_ba": [v, k, seed],
        "serial_ba_sha256": edge_digest(np.asarray(ba.src),
                                        np.asarray(ba.dst)),
        "cases": cases}


@pytest.fixture(scope="module")
def fresh():
    return reference_analytics()


# --- the committed reference and the digest specs ---------------------------------

def test_reference_analytics_are_current(fresh):
    committed = json.loads(ANALYTICS.read_text())
    assert sorted(committed["cases"]) == HOST_CASES == sorted(
        ["ba_cfree_1e5", "er_1e5", "hub_stress", "paper_smoke", "pk_smoke",
         "rmat_smoke"])
    assert committed == fresh


@pytest.mark.parametrize("name", HOST_CASES)
def test_port_analytics_equal_the_reference(name, fresh):
    """Every analytics function on a digest spec's edges, port vs JAX."""
    edges = _port(_jax_edges(name))
    got = chip_smoke.analytics_record(
        np, tanalysis, edges, tanalysis.valid_edges,
        lambda t: t.numpy(), PK_N0.get(name))
    want = fresh["cases"][name]["record"]
    assert chip_smoke.analytics_mismatches(got, want) == []
    assert got.keys() == want.keys()
    assert all(type(got[k]) is type(want[k]) for k in want)


def test_serial_ba_reference_equals_the_jax_oracle(fresh):
    v, k, seed = fresh["serial_ba"]
    ba = tpba.serial_ba_reference(v, k, seed, device="cpu")
    assert ba.src.dtype == ba.dst.dtype == torch.int32
    assert ba.num_vertices == v and ba.capacity == v * k
    assert edge_digest(ba.src, ba.dst) == fresh["serial_ba_sha256"]
    small = tpba.serial_ba_reference(50, 3, 9, device="cpu")
    want = jpba.serial_ba_reference(50, 3, 9)
    np.testing.assert_array_equal(small.dst.numpy(), np.asarray(want.dst))


def test_serial_ba_reference_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpba.serial_ba_reference(10, 2)


# --- graph.py's helpers -------------------------------------------------------------

@pytest.mark.parametrize("name", HOST_CASES)
def test_graph_helpers_equal_the_reference(name):
    jedges = _jax_edges(name)
    edges = _port(jedges)
    assert edges.capacity == jedges.capacity
    np.testing.assert_array_equal(edges.valid_mask().numpy(),
                                  np.asarray(jedges.valid_mask()))
    assert int(edges.num_valid()) == int(jedges.num_valid())
    n = edges.num_vertices
    for kw in ({}, {"directed": True}, {"num_vertices": n // 2},
               {"num_vertices": n + 7}):
        got = tgraph.degree_counts(edges, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jgraph.degree_counts(jedges, **kw)))
    s, d = jedges.to_numpy()
    for sym in (True, False):
        indptr, indices = tgraph.to_csr(torch.from_numpy(s),
                                        torch.from_numpy(d), n, sym)
        want = jgraph.to_csr(s, d, n, sym)
        assert indptr.dtype == indices.dtype == torch.int64
        np.testing.assert_array_equal(indptr.numpy(), want[0])
        np.testing.assert_array_equal(indices.numpy(), want[1])


def test_dense_adjacency_equals_the_reference():
    rng = np.random.default_rng(3)
    s, d = rng.integers(0, 40, (2, 120)).astype(np.int32)
    for sym in (True, False):
        got = tgraph.dense_adjacency(torch.from_numpy(s),
                                     torch.from_numpy(d), 40, sym)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), jgraph.dense_adjacency(s, d, 40, sym))


# --- edge cases, one function at a time ---------------------------------------------

def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _results(analysis, edges, valid_edges) -> dict:
    """Each analytics function's result, or the name of what it raised."""
    def run(fn, *args, **kw):
        try:
            out = fn(*args, **kw)
        except (ValueError, ZeroDivisionError) as e:
            return type(e).__name__
        if dataclasses.is_dataclass(out):
            return dataclasses.asdict(out)
        if isinstance(out, tuple):
            return [_np(a).tolist() for a in out]
        return _np(out).tolist() if hasattr(out, "shape") else out

    n = edges.num_vertices
    deg = _np(analysis.degree_counts(edges))
    src, dst = valid_edges(edges)
    csr = analysis.to_csr(src, dst, n)
    return {
        "degree_counts": deg.tolist(),
        "degree_histogram": run(analysis.degree_histogram, deg),
        "fit": run(analysis.fit_power_law, deg),
        "bfs": [run(analysis.bfs_distances, *csr, v, n) for v in range(n)],
        "paths": run(analysis.sampled_path_stats, edges, 16, seed=1),
        "blocks": run(analysis.block_density, edges, 4),
        "contrast": run(analysis.community_contrast, edges, 4),
        "self_similarity": run(analysis.self_similarity_score, edges, 2),
        "clustering": run(analysis.sampled_clustering_coefficient, edges,
                          200, seed=2),
        "assortativity": run(analysis.degree_assortativity, edges),
        "rich_club": [run(analysis.rich_club_coefficient, edges, k)
                      for k in (0, 1, 2, 3)]}


EDGE_CASES = {
    # name: (src, dst, n, a check of the port's results: the guard the
    # case reaches)
    "invalid_slots": ([0, -1, 1, 2, 3, -1, 4], [1, 2, -1, 3, 0, -1, 2], 6,
                      lambda r: sum(r["degree_counts"]) == 8),
    "self_loops_and_multi_edges": (
        [0, 0, 0, 1, 1, 2, 3, 3, 2, 4], [0, 1, 1, 2, 1, 0, 3, 4, 2, 0], 5,
        lambda r: r["fit"] == "ValueError"),
    "disconnected": ([0, 1, 3, 4], [1, 2, 4, 5], 8,
                     lambda r: -1 in r["bfs"][0]),
    "fewer_candidates_than_sources": (
        [0, 2], [1, 3], 20, lambda r: r["paths"]["num_sources"] == 4),
    "no_vertex_of_degree_2": ([0, 2, 4], [1, 3, 5], 6,
                              lambda r: r["clustering"] == 0.0),
    "degree_2_only_by_multi_edges": ([0, 0, 2, 3, 3], [1, 1, 3, 3, 3], 4,
                                     lambda r: r["clustering"] == 0.0),
    "one_rich_vertex": ([0, 0, 0, 1], [1, 2, 3, 4], 5,
                        lambda r: r["rich_club"] == [0.4, 1.0, 0.0, 0.0]),
    "zero_off_diagonal_blocks": (
        [0, 1, 4, 5, 8, 9, 12, 13], [1, 0, 5, 4, 9, 8, 13, 12], 16,
        lambda r: r["contrast"] == 1e6),
    "no_edges": ([-1], [-1], 4,
                 lambda r: r["paths"] == "ZeroDivisionError"),
    "star_tail_for_a_fit": ([0] * 30 + list(range(1, 12)),
                            list(range(1, 31)) + list(range(2, 13)), 31,
                            lambda r: isinstance(r["fit"], dict)),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_cases_equal_the_reference(case):
    src, dst, n, reaches_its_guard = EDGE_CASES[case]
    jedges = _jax(src, dst, n)
    want = _results(janalysis, jedges, lambda e: e.to_numpy())
    got = _results(tanalysis, _port(jedges), tanalysis.valid_edges)
    assert reaches_its_guard(got)
    r, w = got.pop("assortativity"), want.pop("assortativity")
    assert got == want
    if isinstance(w, float):
        assert r == pytest.approx(w, rel=1e-9, abs=1e-12)
    else:
        assert r == w


def test_block_ids_past_the_int32_overflow():
    """From n * B >= 2**31 the reference's int32 block ids wrap negative
    (numpy 2, NEP 50); the port's are computed in int64."""
    n, nb = 250_000_000, 16
    src = np.array([200_000_000, 10, 249_999_999, 150_000_000], np.int32)
    dst = np.array([5, 200_000_000, 100_000_000, 249_999_999], np.int32)
    edges = tgraph.EdgeList(torch.from_numpy(src), torch.from_numpy(dst), n)
    b = np.minimum(src.astype(np.int64) * nb // n, nb - 1)
    c = np.minimum(dst.astype(np.int64) * nb // n, nb - 1)
    m = np.zeros((nb, nb))
    np.add.at(m, (b, c), 1.0)
    m += m.T
    want = m / ((n / nb) ** 2)
    got = tanalysis.block_density(edges, nb)
    np.testing.assert_array_equal(got, want)
    ref = janalysis.block_density(_jax(src, dst, n), nb)
    assert not np.array_equal(ref, want)


def test_chunked_expansion_gives_the_same_results(monkeypatch):
    """BFS levels and the clustering's neighbour rows split into chunks of
    a few CSR entries (rows longer than a chunk stand alone) give what one
    chunk gives."""
    edges = _port(_jax_edges("paper_smoke"))
    s, d = tanalysis.valid_edges(edges)
    csr = tgraph.to_csr(s, d, edges.num_vertices)
    whole = (tanalysis.bfs_distances(*csr, 5, edges.num_vertices),
             tanalysis.sampled_clustering_coefficient(edges, 50),
             tanalysis.sampled_path_stats(edges, 3))
    monkeypatch.setattr(tanalysis, "EXPAND_CHUNK", 7)
    chunked = (tanalysis.bfs_distances(*csr, 5, edges.num_vertices),
               tanalysis.sampled_clustering_coefficient(edges, 50),
               tanalysis.sampled_path_stats(edges, 3))
    assert torch.equal(whole[0], chunked[0])
    assert whole[1:] == chunked[1:]


# --- degree counts on the histogram kernel ------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_degree_counts_device_equals_the_reference(use_kernel):
    """Both branches against the JAX function as its tests run it on the
    CPU: the plain histogram, and Pallas interpret mode."""
    jedges = _jax_edges("hub_stress")
    edges = _port(jedges)
    tops.reset_launch_counts()
    got = tanalysis.degree_counts_device(edges, use_kernel=use_kernel)
    assert tops.launch_counts()["histogram"] == 0     # CPU: the plain path
    for mode in ("off", "interpret"):
        with jdispatch.forced_mode(mode):
            want = np.asarray(janalysis.degree_counts_device(
                jedges, use_kernel=use_kernel))
        np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_functions_without_a_group_are_the_one_device_counts():
    jedges = _jax_edges("paper_smoke")
    edges = _port(jedges)
    want = np.asarray(jgraph.degree_counts(jedges))
    np.testing.assert_array_equal(
        tdist.degree_counts_sharded(edges).numpy(), want)
    assert tdist.edge_count_sharded(edges) == int(jedges.num_valid())
    assert tdist.max_degree_sharded(edges) == want.max()


# --- the package's public names -----------------------------------------------------

def test_core_exports_the_reference_names():
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for name in tcore.__all__:
            if name not in tcore._DEPRECATED_ENTRY_POINTS:
                getattr(tcore, name)
    for name, obj in tcore._DEPRECATED_ENTRY_POINTS.items():
        with pytest.warns(DeprecationWarning, match=name):
            assert getattr(tcore, name) is obj
    with pytest.raises(AttributeError):
        tcore.no_such_name  # noqa: B018


@pytest.mark.parametrize("first", ["repro_torch.kernels.ops",
                                   "repro_torch.core.analysis",
                                   "repro_torch.core.distributed_analysis"])
def test_modules_import_first_without_a_cycle(first):
    code = (f"import {first}\n"
            "from repro_torch.core import (degree_counts, fit_power_law, "
            "sampled_path_stats, community_contrast)\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(REPO / "src")})


if __name__ == "__main__":
    ANALYTICS.write_text(json.dumps(reference_analytics(), indent=1,
                                    sort_keys=True) + "\n")
    print(f"wrote {ANALYTICS}")
