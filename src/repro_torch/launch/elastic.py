"""Elastic scaling and failure handling policies.

The port of the JAX package's ``launch/elastic.py``. The mechanisms are
stateless: the generators key every random draw and partition boundary
off (seed, rank, step), so surviving a failure or changing the device
count is a matter of recomputing the partition table, with no data
movement and no coordinator state.

* Generators: an edge-index range per device (PK) or a (vertices,
  factions) block per device (PBA). ``repartition`` maps any P -> P'
  assignment.
* Parameters: checkpoints hold the full logical arrays (mesh-agnostic);
  ``reshard_plan`` gives the layout of each leaf on the new mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RangeAssignment:
    """Contiguous [start, stop) global ranges per worker."""
    starts: np.ndarray
    stops: np.ndarray

    def for_rank(self, r: int) -> tuple[int, int]:
        return int(self.starts[r]), int(self.stops[r])


def partition_range(total: int, workers: int) -> RangeAssignment:
    """Balanced contiguous partition (sizes differ by at most 1)."""
    base, rem = divmod(total, workers)
    sizes = np.full(workers, base, np.int64)
    sizes[:rem] += 1
    stops = np.cumsum(sizes)
    starts = stops - sizes
    return RangeAssignment(starts, stops)


def repartition(total: int, old_workers: int, new_workers: int
                ) -> RangeAssignment:
    """Elastic re-partition: the new assignment regenerates identical edges
    because edge identity = global index, independent of worker count."""
    del old_workers  # identity is index-based; the old layout is irrelevant
    return partition_range(total, new_workers)


def surviving_assignment(total: int, workers: int,
                         failed: set[int]) -> RangeAssignment:
    """Failure handling: the dead ranks' ranges handed to survivors as
    extra work items. Survivors keep their original range and the orphan
    slices follow, in the failed ranks' order."""
    alive = [r for r in range(workers) if r not in failed]
    if not alive:
        raise RuntimeError("no survivors")
    base = partition_range(total, workers)
    extra_ranges = [(int(base.starts[r]), int(base.stops[r]))
                    for r in sorted(failed)]
    starts = list(base.starts[alive])
    stops = list(base.stops[alive])
    for s, e in extra_ranges:
        starts.append(s)
        stops.append(e)
    return RangeAssignment(np.asarray(starts), np.asarray(stops))


def reshard_plan(param_specs, rules):
    """The layout (a ``PartitionSpec`` per leaf) for restoring a
    mesh-agnostic checkpoint onto the mesh of ``rules``: each rank reads
    its blocks of the whole leaves (``train.checkpoint.load_checkpoint``
    with ``rules``), the optimizer's moments laid out as the parameters."""
    return rules.param_pspecs(param_specs)
