"""Edge-list graph container and generation stats over torch tensors.

The generators produce COO edge lists: ``src``/``dst`` int32 tensors of
the same shape, where invalid slots (capacity overflow, urn exhaustion)
hold -1 rather than being compacted, so shapes stay static.
"""
from __future__ import annotations

import dataclasses
import hashlib

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
