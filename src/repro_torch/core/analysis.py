"""Graph-property analysis: the paper's evaluation metrics, on the edges'
device.

  * degree distribution + power-law exponent fit (Fig. 4)
  * sampled average path length / diameter via BFS (Table 2)
  * community block structure + self-similarity (Fig. 5)
  * clustering coefficient, assortativity, rich club

The JAX package's ``core/analysis.py`` with the same names, signatures
and results. Its integer work runs here as tensor passes on the edges'
device (degree counts, CSR, level-synchronous BFS, block counts, each
sampled vertex's triangle links, rich-club counts) and equals the
reference's exactly; its float post-processing runs the reference's own
numpy expressions on the host, over small results (the degree vector, a
B x B matrix, per-sample link counts), so the floats are bit-equal too.
The one exception is :func:`degree_assortativity`, whose float64 sums over
2E values run on the device in another order than numpy's pairwise sum.

Sampling is numpy's: the sources and samples are
``np.random.default_rng(seed).choice`` over the candidate vertices, as in
the reference. The draw depends only on the number of candidates, so it is
made over their count on the host and the candidates are indexed on the
device (the same picks as ``choice`` over the candidate array).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.core.graph import EdgeList, degree_counts, to_csr
from repro_torch.kernels import ops

#: Most CSR entries one expansion step holds (three int64 buffers of this
#: length: 1.5 GiB): a BFS level of the 64-rank graph can touch most of
#: its 640M entries.
EXPAND_CHUNK = 1 << 26


@dataclasses.dataclass
class PowerLawFit:
    gamma_ls: float       # least-squares slope on log-log histogram
    gamma_mle: float      # Clauset-style continuous MLE
    kmin: int
    num_tail: int         # samples with k >= kmin


def _host(a: Union[torch.Tensor, np.ndarray]) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def valid_edges(edges: EdgeList) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) with invalid slots removed, 1-D, on the edges' device:
    ``EdgeList.to_numpy``'s compaction without the trip to the host."""
    m = edges.valid_mask().reshape(-1)
    return edges.src.reshape(-1)[m], edges.dst.reshape(-1)[m]


def degree_histogram(degrees, max_degree: Optional[int] = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(k, count_of_vertices_with_degree_k), k >= 1, from a tensor or an
    ndarray of degrees (numpy on the host)."""
    d = _host(degrees)
    d = d[d > 0]
    kmax = int(max_degree or d.max())
    hist = np.bincount(d, minlength=kmax + 1)[: kmax + 1]
    k = np.nonzero(hist)[0]
    k = k[k > 0]
    return k, hist[k]


def fit_power_law(degrees, kmin: int = 2) -> PowerLawFit:
    """Fit P(k) ∝ k^-gamma two ways (the paper curve-fits; we add MLE),
    from a tensor or an ndarray of degrees (numpy on the host)."""
    d = np.asarray(_host(degrees), np.float64)
    d = d[d >= kmin]
    if d.size < 10:
        raise ValueError("not enough tail samples for a fit")
    # MLE (continuous approximation, Clauset et al. 2009)
    gamma_mle = 1.0 + d.size / np.sum(np.log(d / (kmin - 0.5)))
    # Least squares on the log-binned log-log histogram.
    k, cnt = degree_histogram(d.astype(np.int64))
    edges_ = np.unique(np.geomspace(kmin, k.max() + 1, num=24).astype(np.int64))
    if edges_.size < 4:
        edges_ = np.array([kmin, kmin * 2, kmin * 4, k.max() + 1])
    which = np.digitize(k, edges_) - 1
    ok = (which >= 0) & (which < edges_.size - 1)
    mass = np.zeros(edges_.size - 1)
    np.add.at(mass, which[ok], cnt[ok].astype(np.float64))
    width = np.diff(edges_).astype(np.float64)
    centers = np.sqrt(edges_[:-1].astype(np.float64) * edges_[1:])
    # Fit the populated region only (>= 10 samples/bin), weighted by
    # sqrt(mass).
    nz = mass >= 10
    if nz.sum() < 3:
        nz = mass > 0
    logs = np.log10(centers[nz])
    logc = np.log10(mass[nz] / width[nz])
    slope, _ = np.polyfit(logs, logc, 1, w=np.sqrt(mass[nz]))
    return PowerLawFit(gamma_ls=float(-slope), gamma_mle=float(gamma_mle),
                       kmin=kmin, num_tail=int(d.size))


def _row_chunks(indptr: torch.Tensor, rows: torch.Tensor
                ) -> Iterator[tuple[int, torch.Tensor, torch.Tensor]]:
    """The CSR positions of ``rows``' entries, row after row, in chunks of
    whole rows of about EXPAND_CHUNK entries (a longer row is a chunk of
    its own): yields (first row, positions, row of each position counted
    from the first)."""
    starts = indptr[rows]
    lens = indptr[rows + 1] - starts
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1]) if rows.numel() else 0
    if total == 0:
        return
    cuts = torch.arange(1, (total - 1) // EXPAND_CHUNK + 1,
                        device=rows.device) * EXPAND_CHUNK
    marks = torch.searchsorted(ends, cuts, right=True)
    bounds = sorted({0, rows.numel(), *marks.tolist()})
    last = ends[torch.tensor(bounds[1:], device=rows.device) - 1].tolist()
    first = 0
    for a, b, end in zip(bounds, bounds[1:], last):
        n = end - first
        lens_c = lens[a:b]
        owner = torch.repeat_interleave(
            torch.arange(b - a, device=rows.device), lens_c, output_size=n)
        base = starts[a:b] - (torch.cumsum(lens_c, 0) - lens_c)
        yield a, torch.arange(n, device=rows.device) + base[owner], owner
        first = end


def bfs_distances(indptr: torch.Tensor, indices: torch.Tensor, source: int,
                  num_vertices: int) -> torch.Tensor:
    """Level-synchronous BFS on the CSR's device; int32 distances (-1
    unreachable).

    Each level expands the frontier's CSR rows in chunks, marks every
    neighbour, and keeps the marked vertices not yet reached as the next
    frontier (sorted, as the reference's ``np.unique`` leaves it)."""
    dev = indptr.device
    dist = torch.full((num_vertices,), -1, dtype=torch.int32, device=dev)
    dist[source] = 0
    frontier = torch.tensor([source], dtype=torch.int64, device=dev)
    seen = torch.empty(num_vertices, dtype=torch.bool, device=dev)
    level = 0
    while frontier.numel():
        level += 1
        seen.zero_()
        for _, pos, _ in _row_chunks(indptr, frontier):
            seen[indices[pos]] = True
        seen &= dist < 0
        frontier = seen.nonzero().squeeze(1)
        dist[frontier] = level
    return dist


@dataclasses.dataclass
class PathStats:
    avg_path_length: float
    diameter_estimate: int
    num_sources: int
    reachable_fraction: float


def _sample(candidates: torch.Tensor, size: int, seed: int) -> torch.Tensor:
    """``np.random.default_rng(seed).choice(candidates, size,
    replace=False)``, drawn over the candidates' count and indexed on
    their device."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(candidates.numel(), size=size, replace=False)
    return candidates[torch.as_tensor(idx, device=candidates.device)]


def sampled_path_stats(edges: EdgeList, num_sources: int = 16,
                       seed: int = 0) -> PathStats:
    """Sampled avg path length + diameter estimate (paper Table 2 method)."""
    src, dst = valid_edges(edges)
    n = edges.num_vertices
    indptr, indices = to_csr(src, dst, n)
    del src, dst
    # sample sources that have at least one edge
    candidates = torch.nonzero(indptr[1:] > indptr[:-1]).squeeze(1)
    sources = _sample(candidates, min(num_sources, candidates.numel()),
                      seed).tolist()
    total, count, diameter, reach = 0.0, 0, 0, 0
    for s in sources:
        dist = bfs_distances(indptr, indices, s, n)
        mask = dist > 0
        dsum, dcount, dreach, dmax = torch.stack([
            dist[mask].sum(), mask.sum(), (dist >= 0).sum(),
            dist.max().long()]).tolist()
        total += float(dsum)
        count += dcount
        reach += dreach
        diameter = max(diameter, dmax)
    return PathStats(avg_path_length=total / max(count, 1),
                     diameter_estimate=diameter,
                     num_sources=len(sources),
                     reachable_fraction=reach / (len(sources) * n))


def block_cells(edges: EdgeList, num_blocks: int) -> torch.Tensor:
    """int32 cell ``b * B + c`` of each valid edge, on the edges' device:
    its source's block b and destination's block c, contiguous blocks of
    n / B vertices. The block ids are computed in int64: the reference's
    int32 ``src * B`` wraps once ``n * B >= 2**31``."""
    src, dst = valid_edges(edges)
    n, nb = edges.num_vertices, num_blocks
    b = torch.clamp_max(src.long() * nb // n, nb - 1)
    del src
    c = torch.clamp_max(dst.long() * nb // n, nb - 1)
    del dst
    return (b * nb + c).to(torch.int32)


def _block_counts(edges: EdgeList, num_blocks: int) -> np.ndarray:
    """(B, B) int64 counts of valid edges by (source block, destination
    block), counted on the edges' device by the histogram kernel over
    :func:`block_cells`."""
    nb = num_blocks
    return ops.histogram(block_cells(edges, nb), nb * nb).cpu().numpy() \
        .reshape(nb, nb).astype(np.int64)


def block_density(edges: EdgeList, num_blocks: int = 16) -> np.ndarray:
    """(B, B) edge-density matrix over contiguous vertex blocks (Fig. 5)."""
    n = edges.num_vertices
    m = _block_counts(edges, num_blocks).astype(np.float64)
    m += m.T  # undirected view
    per_block = n / num_blocks
    return m / (per_block * per_block)


def community_contrast(edges: EdgeList, num_blocks: int = 16) -> float:
    """Diagonal-block density / off-diagonal density (>1 ⇒ communities).

    Capped at 1e6 (zero off-diagonal edges == perfectly separated blocks).
    """
    m = block_density(edges, num_blocks)
    diag = np.trace(m) / num_blocks
    off = (m.sum() - np.trace(m)) / max(num_blocks * (num_blocks - 1), 1)
    if off <= 0:
        return 1e6 if diag > 0 else 0.0
    return float(min(diag / off, 1e6))


def self_similarity_score(edges: EdgeList, n0: int) -> float:
    """Correlation of block structure across two Kronecker scales.

    For a PK graph with seed size n0, the n0×n0 block-density pattern at the
    top scale should correlate with the seed-graph adjacency pattern repeated
    at the next scale down (communities-within-communities).
    """
    top = block_density(edges, n0)
    fine = block_density(edges, n0 * n0)
    # average the fine matrix's diagonal superblocks -> n0 x n0
    fine_diag = np.zeros((n0, n0))
    for b in range(n0):
        sub = fine[b * n0:(b + 1) * n0, b * n0:(b + 1) * n0]
        fine_diag += sub / max(sub.max(), 1e-12)
    fine_diag /= n0
    a = top / max(top.max(), 1e-12)
    va, vb = a.reshape(-1), fine_diag.reshape(-1)
    va = va - va.mean()
    vb = vb - vb.mean()
    denom = float(np.linalg.norm(va) * np.linalg.norm(vb))
    return float(va @ vb / denom) if denom > 0 else 0.0


def _triangle_links(indptr: torch.Tensor, indices: torch.Tensor,
                    picks: torch.Tensor, n: int
                    ) -> tuple[list[int], list[int]]:
    """For each pick v: d, the number of its distinct neighbours other
    than v (``nbrs``), and links = the sum over u in nbrs of
    ``|nbrs ∩ set(N(u))|`` (a self-loop of u counts, v never does)."""
    p = picks.numel()
    # (pick, u) for u in nbrs, as sorted keys pick * n + u
    parts = []
    for a, pos, owner in _row_chunks(indptr, picks):
        w = indices[pos]
        keep = w != picks[a + owner]
        parts.append((a + owner[keep]) * n + w[keep])
    keys = torch.unique(torch.cat(parts)) if parts else \
        torch.empty(0, dtype=torch.int64, device=picks.device)
    pick_of = keys // n
    degree = torch.bincount(pick_of, minlength=p)
    # (set entry j = (pick, u), w) for w in N(u) with (pick, w) a key,
    # counted once per distinct pair
    links = torch.zeros(p, dtype=torch.int64, device=picks.device)
    s = keys.numel()
    for a, pos, owner in _row_chunks(indptr, keys % n):
        j = a + owner
        probe = pick_of[j] * n + indices[pos]
        at = torch.searchsorted(keys, probe).clamp_max(s - 1)
        hit = keys[at] == probe
        pairs = torch.unique(j[hit] * s + at[hit])
        links += torch.bincount(pick_of[pairs // s], minlength=p)
    return degree.tolist(), links.tolist()


def sampled_clustering_coefficient(edges: EdgeList, num_samples: int = 200,
                                   seed: int = 0) -> float:
    """Average local clustering coefficient over sampled vertices."""
    src, dst = valid_edges(edges)
    n = edges.num_vertices
    indptr, indices = to_csr(src, dst, n)
    del src, dst
    candidates = torch.nonzero(indptr[1:] - indptr[:-1] >= 2).squeeze(1)
    if candidates.numel() == 0:
        return 0.0
    picks = _sample(candidates, min(num_samples, candidates.numel()), seed)
    total = 0.0
    for d, links in zip(*_triangle_links(indptr, indices, picks, n)):
        if d < 2:
            continue
        total += links / (d * (d - 1))
    return total / picks.numel()


def degree_assortativity(edges: EdgeList) -> float:
    """Pearson correlation of endpoint degrees (Newman's r).

    One of the paper's "other known and somewhat debatable properties"
    (Conclusions): BA-family graphs are mildly disassortative (r < 0),
    Kronecker graphs' r depends on the seed.

    Over the symmetrised endpoint pairs, as the reference: with x, y the
    degrees at each edge's ends, xs = (x, y) and ys = (y, x) share one
    mean and one sum of squares, so the float64 sums run over x and y on
    the device without building the 2E-long copies (another summation
    order than numpy's: equal to about 1e-12 relative).
    """
    src, dst = valid_edges(edges)
    if src.numel() == 0:
        return 0.0
    deg = degree_counts(edges)
    x = deg[src].double()
    y = deg[dst].double()
    del src, dst, deg
    mean = (x.sum() + y.sum()) / (2 * x.numel())
    x -= mean
    y -= mean
    cross = 2.0 * torch.dot(x, y)
    squares = torch.dot(x, x) + torch.dot(y, y)
    cross, squares = torch.stack([cross, squares]).tolist()
    return cross / squares if squares > 0 else 0.0


def rich_club_coefficient(edges: EdgeList, k: int) -> float:
    """Density of the subgraph induced by vertices with degree > k."""
    src, dst = valid_edges(edges)
    rich = degree_counts(edges) > k
    nr = int(rich.sum())
    if nr < 2:
        return 0.0
    among = int((rich[src] & rich[dst]).sum())
    return 2.0 * among / (nr * (nr - 1))


def degree_counts_device(edges: EdgeList,
                         use_kernel: bool = False) -> torch.Tensor:
    """Degree counts on the edges' device: with ``use_kernel``, one
    histogram over both endpoints (an invalid edge's to the trash bin n),
    the kernel on the card and its plain version on the CPU; else
    :func:`degree_counts`."""
    if not use_kernel:
        return degree_counts(edges)
    n = edges.num_vertices
    s = edges.src.reshape(-1)
    d = edges.dst.reshape(-1)
    valid = edges.valid_mask().reshape(-1)
    both = torch.cat([torch.where(valid, s, n), torch.where(valid, d, n)])
    return ops.histogram(both, n + 1)[:n]
