"""Edge-list graph container, generation stats and conversions over torch
tensors.

The generators produce COO edge lists: ``src``/``dst`` int32 tensors of
the same shape, where invalid slots (capacity overflow, urn exhaustion)
hold -1 rather than being compacted, so shapes stay static. The analysis
helpers here (the JAX package's ``core/graph.py``: degree counts, CSR, a
dense adjacency) run on the edges' device and give the reference's
integers exactly.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class EdgeList:
    """A COO edge list with static capacity.

    Attributes:
      src, dst: int32 tensors, same shape. Invalid slots hold -1.
      num_vertices: global vertex-id space size.
    """

    src: torch.Tensor
    dst: torch.Tensor
    num_vertices: int

    @property
    def capacity(self) -> int:
        return int(self.src.numel())

    def valid_mask(self) -> torch.Tensor:
        return (self.src >= 0) & (self.dst >= 0)

    def num_valid(self) -> torch.Tensor:
        return self.valid_mask().sum()

    def flat(self) -> "EdgeList":
        """The same edges as 1-D tensors."""
        return EdgeList(self.src.reshape(-1), self.dst.reshape(-1),
                        self.num_vertices)

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """Host-side compacted (src, dst) with invalid slots removed."""
        s = self.src.reshape(-1).cpu().numpy()
        d = self.dst.reshape(-1).cpu().numpy()
        m = (s >= 0) & (d >= 0)
        return s[m], d[m]


@dataclasses.dataclass
class GenStats:
    """Bookkeeping returned alongside a generated graph.

    exchange_rounds: how many rounds the endpoint exchange actually ran
    (1 for the single-shot exchange).
    pair_capacity: the per-(sender, receiver) exchange budget C the run
    used, explicit from the config or derived from device memory.
    fallback_counts: kernel-fallback counters at the time the result was
    assembled (``repro_torch.kernels.ops.fallback_counts``); always empty
    in this package, whose kernels have no size cap.
    """

    requested_edges: int
    emitted_edges: int
    dropped_edges: int
    num_vertices: int
    exchange_rounds: int = 1
    pair_capacity: int = 0
    fallback_counts: dict = dataclasses.field(default_factory=dict)


def degree_counts(edges: EdgeList, num_vertices: Optional[int] = None,
                  directed: bool = False) -> torch.Tensor:
    """Per-vertex degree from an edge list: int32 (n,) on the edges'
    device.

    Undirected by default: each edge contributes to both endpoints. An
    invalid slot (a negative id at either end) goes to the trash bin n,
    which is dropped, as is any id past it (the reference's scatter drops
    out-of-range updates).
    """
    n = num_vertices or edges.num_vertices
    s = edges.src.reshape(-1)
    d = edges.dst.reshape(-1)
    valid = edges.valid_mask().reshape(-1)
    counts = torch.bincount(torch.where(valid, s, n),
                            minlength=n + 1)[:n]
    if not directed:
        counts = counts + torch.bincount(torch.where(valid, d, n),
                                         minlength=n + 1)[:n]
    return counts.to(torch.int32)


def to_csr(src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
           symmetrize: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR (indptr, indices), both int64, on the inputs' device.

    Each vertex's row lists its neighbours in edge order (a stable sort by
    source), the forward copies of the edges before the reversed ones, as
    the reference's ``argsort(kind="stable")`` orders them.
    """
    if symmetrize:
        s = torch.cat([src.reshape(-1), dst.reshape(-1)])
        d = torch.cat([dst.reshape(-1), src.reshape(-1)])
    else:
        s, d = src.reshape(-1), dst.reshape(-1)
    s, order = torch.sort(s, stable=True)
    indices = d[order].long()
    del d, order
    indptr = torch.zeros(num_vertices + 1, dtype=torch.int64,
                         device=s.device)
    indptr[1:] = torch.cumsum(torch.bincount(s, minlength=num_vertices), 0)
    return indptr, indices


def dense_adjacency(src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
                    symmetrize: bool = True) -> torch.Tensor:
    """Small-graph dense 0/1 int32 adjacency (tests, community plots)."""
    a = torch.zeros((num_vertices, num_vertices), dtype=torch.int32,
                    device=src.device)
    a[src.long(), dst.long()] = 1
    if symmetrize:
        a[dst.long(), src.long()] = 1
    return a


def edge_digest(src, dst) -> str:
    """sha256 of the full (src, dst) arrays, padding slots included, as
    little-endian int32: a fingerprint that any array library's output of
    the same graph reproduces."""
    h = hashlib.sha256()
    for a in (src, dst):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        h.update(np.ascontiguousarray(np.asarray(a), dtype="<i4").tobytes())
    return h.hexdigest()
