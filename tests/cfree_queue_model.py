"""numpy model of the ba_cfree ``cfree_expand`` kernel's warp queue
(``src/repro_torch/kernels/csrc/cfree_expand.cu``): the order in which a
warp's lanes claim edges, and the share of lane-trips that draw.

The kernel's outputs do not depend on the claim order, so the card tests
hold the kernel to its plain version and this model only documents the
intended order and predicts lane use. The edges per lane are read from
the kernel source's ``kPerLane``.

    PYTHONPATH=src python tests/cfree_queue_model.py

prints the modelled lane use on the slab ``chip_smoke.py`` times (2^20
edges from the middle of ba_cfree_1b), under the queue and under one
edge per lane per trip; the chains are walked by the port's
``core.cfree.ba_chain`` on the CPU.
"""
import json
import os
import re

import numpy as np

CU = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                  "src", "repro_torch", "kernels", "csrc", "cfree_expand.cu")


def kernel_per_lane() -> int:
    """The kernel's edges per lane (``kPerLane`` in its source)."""
    with open(CU) as f:
        return int(re.search(r"constexpr int kPerLane = (\d+);",
                             f.read()).group(1))


def queue_schedule(draws: np.ndarray, per_lane: int):
    """The warp queue over edges whose chains take ``draws`` draws each
    (``t`` 16-byte aligned).

    Each warp tile of ``32 * per_lane`` consecutive edges starts lane i on
    edge i; each trip of the loop, every live lane takes one draw, and the
    lanes whose chain ended take the tile's next unstarted edges in lane
    order. Returns (start, trips): the trip in which each edge's chain
    started, and the trips of each tile.
    """
    draws = np.asarray(draws, dtype=np.int64)
    m = draws.shape[0]
    width = 32 * per_lane
    tiles = -(-m // width)
    hi = np.minimum(m - np.arange(tiles) * width, width)
    base = np.arange(tiles)[:, None] * width
    idx = np.tile(np.arange(32), (tiles, 1))
    live = idx < hi[:, None]
    left = np.where(live, draws[np.minimum(base + idx, m - 1)], 0)
    nxt = np.full(tiles, 32)
    start = np.full(m, -1)
    start[(base + idx)[live]] = 0
    trips = np.zeros(tiles, dtype=np.int64)
    trip = 0
    while live.any():
        trips += live.any(1)
        trip += 1
        left -= live
        fin = live & (left == 0)
        idx = np.where(fin, nxt[:, None] + np.cumsum(fin, 1) - fin, idx)
        live = np.where(fin, idx < hi[:, None], live)
        fresh = fin & live
        start[(base + idx)[fresh]] = trip
        left = np.where(fresh, draws[np.minimum(base + idx, m - 1)], left)
        nxt += fin.sum(1)
    return start, trips


def queue_lane_use(draws: np.ndarray, per_lane: int) -> float:
    """Share of lane-trips that draw under the warp queue."""
    _, trips = queue_schedule(draws, per_lane)
    return float(np.sum(draws)) / (32 * float(trips.sum()))


def trip_lane_use(draws: np.ndarray) -> float:
    """The same share under one edge per lane per trip (the earlier
    design): a warp's trip lasts as long as its 32 edges' longest chain."""
    draws = np.asarray(draws, dtype=np.int64)
    pad = np.zeros(-(-draws.shape[0] // 32) * 32, dtype=np.int64)
    pad[:draws.shape[0]] = draws
    return float(draws.sum()) / (32 * float(pad.reshape(-1, 32).max(1).sum()))


def main() -> None:
    import torch

    from repro_torch.core import cfree
    slab = 1 << 20
    cfg = cfree.CFreeConfig(model="ba_cfree", vertices=250_000_000,
                            ba_degree=4, seed=7)
    t0 = (cfree.cfree_sizes(cfg)[1] // slab // 2) * slab
    _, draws = cfree.ba_chain(cfree.cfree_words(cfg),
                              torch.arange(t0, t0 + slab, dtype=torch.int32))
    draws = draws.numpy()
    per_lane = kernel_per_lane()
    print(json.dumps({
        "slab": [t0, slab], "draws_per_edge": float(draws.mean()),
        "longest_chain": int(draws.max()), "per_lane": per_lane,
        "modelled_lane_use": queue_lane_use(draws, per_lane),
        "modelled_lane_use_one_edge_per_trip": trip_lane_use(draws)}))


if __name__ == "__main__":
    main()
