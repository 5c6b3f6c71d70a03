"""Distributed analysis of a sharded edge list over ``torch.distributed``.

At paper scale (5B edges) the edges live sharded across devices and are
reduced in place: each rank counts its own share of a sharded result
(the rows [d*lp, (d+1)*lp) that ``generate`` returns on rank d) with the
histogram kernel, and the partial results are summed over every device
of the topology (``runtime/blocking.py``). Every rank gets the global
result, equal to the host path's. The JAX package's ``mesh`` and
``axis_name`` select a JAX mesh and are dropped; ``topology`` is
resolved against the process group as the generators resolve it (none:
flat over the world size, one device with no group).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.analysis import degree_counts_device
from repro_torch.core.graph import EdgeList
from repro_torch.runtime import blocking
from repro_torch.runtime import topology as topology_lib
from repro_torch.runtime.topology import Topology


def degree_counts_sharded(edges: EdgeList, bin_chunk: int = 1 << 20,
                          topology: Optional[Topology] = None
                          ) -> torch.Tensor:
    """Global per-vertex degrees (int32, n) from this rank's share.

    The rank counts its share with the histogram kernel
    (``analysis.degree_counts_device(use_kernel=True)``) and the counts
    are summed over the topology. ``bin_chunk`` is accepted and unused,
    as in the JAX package, whose body never reads it.
    """
    topology = topology_lib.resolve(topology, device=edges.src.device)
    counts = degree_counts_device(edges, use_kernel=True)
    return blocking.all_reduce_sum(counts, topology)


def edge_count_sharded(edges: EdgeList,
                       topology: Optional[Topology] = None) -> int:
    """Global valid-edge count (slots with src >= 0) without gathering the
    edge list."""
    topology = topology_lib.resolve(topology, device=edges.src.device)
    local = int((edges.src.reshape(-1) >= 0).sum())
    return blocking.all_reduce_sum(local, topology, edges.src.device)


def max_degree_sharded(edges: EdgeList,
                       topology: Optional[Topology] = None) -> int:
    """Global max degree (hub size), the Fig. 4 heavy-tail witness."""
    return int(degree_counts_sharded(edges, topology=topology).max())
