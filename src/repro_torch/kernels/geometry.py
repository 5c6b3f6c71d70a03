"""Launch geometry of the CUDA kernels, as pure functions.

Each wrapper (``edge_resolve.py``, ``histogram.py``, ``band_compact.py``,
``pk_expand.py``, ``cfree_expand.py``) computes its launch with a pure
function of the shape and the card's limits, returning a :class:`Launch`,
and passes exactly that grid, block and dynamic shared memory to its C
entry, which checks them against what its kernel indexes and launches
with them. The kernel checker (``analysis/kernelcheck.py``, KC004) calls
the same functions, so the checked geometry and the launched one cannot
drift apart: the JAX package derives its ``MAX_VMEM_ENTRIES`` from its
VMEM budget model for the same reason.

The block sizes and the static shared memory of each kernel are the
``constexpr`` and ``__shared__`` declarations of its source, mirrored
here (the C side refuses a block size other than its own, and on the card
the checker reads the compiled attributes instead of the static
estimate). Nothing here touches a device.
"""
from __future__ import annotations

import dataclasses

#: Threads a block, per source (the ``kThreads`` of each ``csrc/*.cu``).
THREADS = {"resolve": 512, "gather": 256, "histogram": 1024,
           "band_compact": 256, "pk_expand": 256, "cfree_expand": 256}

#: Static shared memory a block, by compiled kernel (bytes, from the
#: ``__shared__`` arrays of each source).
STATIC_SMEM = {
    "resolve_roots_kernel": 512 * 4,
    "gather_rows_kernel": 2 * 4,
    "count_kernel": 8 * 4,
    "scatter_kernel": 2 * 4096 * 4 + 2 * 256 * 4 + 8 * 4 + 8 * 8,
    "histogram_kernel": 0,
    "pk_expand_kernel": 0,
    "cfree_expand_kernel_ba": 2 * 8 * 256 * 4,
    "cfree_expand_kernel_quad": 0,
}

#: pk_expand's seed tables sit in shared memory up to this many entries
#: each (``kSharedTab``).
PK_SHARED_TAB = 4096
#: cfree_expand's ba_cfree edges per warp tile (32 lanes x ``kPerLane``).
CFREE_WARP_TILE = 32 * 8
#: Largest grid y the kernels take (rows beyond it stride).
GRID_Y_MAX = 65535


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: the compiled kernel's name, grid and block (x,
    y, z), dynamic shared memory in bytes and the thread-block cluster
    size along x (1: no cluster)."""

    kernel: str
    grid: tuple
    block: tuple
    smem: int = 0
    cluster: int = 1

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]

    def to_json(self) -> dict:
        return {"kernel": self.kernel, "grid": list(self.grid),
                "block": list(self.block), "dynamic_smem": self.smem,
                "cluster": self.cluster}


@dataclasses.dataclass(frozen=True)
class Limits:
    """What a card allows a launch (``cudaDeviceProp``'s names)."""

    max_threads_per_block: int
    max_grid: tuple
    smem_optin: int               # sharedMemPerBlockOptin, bytes
    sms: int
    #: the largest cluster without the non-portable attribute (which no
    #: kernel sets)
    cluster_portable: int = 8
    #: resident blocks of the gather kernel an SM (the occupancy API's
    #: answer on the card; 2048 threads an SM / 256 on an H100)
    gather_blocks_per_sm: int = 8


#: An H100 SXM's limits, for the checks on a machine without the card.
H100 = Limits(max_threads_per_block=1024, max_grid=(2**31 - 1, 65535, 65535),
              smem_optin=227 * 1024, sms=132)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_roots(rows: int, m: int) -> Launch:
    """``resolve_roots_kernel``: a thread per slot along x, rows along y
    (striding past 65535)."""
    t = THREADS["resolve"]
    return Launch("resolve_roots_kernel", (_cdiv(m, t), min(rows, GRID_Y_MAX),
                                           1), (t, 1, 1))


def gather(rows: int, n: int, resident_blocks: int) -> Launch:
    """``gather_rows_kernel``: the card's resident blocks, or fewer, one a
    tile (per row, kThreads vectors of 4 outputs, at least one tile a
    row); the blocks claim tiles from a counter."""
    tiles = rows * max(_cdiv(n // 4, THREADS["gather"]), 1)
    return Launch("gather_rows_kernel",
                  (max(min(tiles, resident_blocks), 1), 1, 1),
                  (THREADS["gather"], 1, 1))


def band_compact(rows: int, e: int) -> tuple[Launch, Launch]:
    """The count pass and the scatter pass: a block per tile of 1024
    16-entry band vectors along x, rows along y."""
    n_tiles = max(_cdiv(e >> 4, 1024), 1)
    grid = (n_tiles, min(rows, GRID_Y_MAX), 1)
    block = (THREADS["band_compact"], 1, 1)
    return (Launch("count_kernel", grid, block),
            Launch("scatter_kernel", grid, block))


def histogram(rows: int, num_bins: int, masked: bool, sms: int,
              smem_optin: int) -> Launch:
    """``histogram_kernel`` in the regime ``histogram.regime`` picks on a
    card of ``sms`` SMs and ``smem_optin`` bytes of opt-in shared memory:
    ``blocks_per_row`` blocks along x, rows along y, the staging of a
    masked step's flags and the regime's bins in dynamic shared memory."""
    from repro_torch.kernels.histogram import (STAGE_BYTES, blocks_per_row,
                                               regime)
    t = THREADS["histogram"]
    reg = regime(num_bins, smem_optin, t, STAGE_BYTES)
    smem = (STAGE_BYTES if masked else 0) + (
        0 if reg.kind == "global" else 4 * reg.copies * reg.slice)
    return Launch("histogram_kernel",
                  (blocks_per_row(rows, reg, sms), min(rows, GRID_Y_MAX), 1),
                  (t, 1, 1), smem,
                  reg.blocks if reg.kind == "cluster" else 1)


def pk_expand(m: int, e0: int, sms: int) -> Launch:
    """``pk_expand_kernel``: 4 edges a thread, at most 8 blocks an SM
    (grid-stride past that); both seed tables in dynamic shared memory up
    to ``PK_SHARED_TAB`` entries."""
    t = THREADS["pk_expand"]
    need = _cdiv(_cdiv(m, 4), t)
    return Launch("pk_expand_kernel", (max(min(need, 8 * sms), 1), 1, 1),
                  (t, 1, 1), 2 * e0 * 4 if e0 <= PK_SHARED_TAB else 0)


def cfree_expand(m: int, phase: int, model: str, sms: int) -> Launch:
    """ba_cfree: a warp per tile of ``CFREE_WARP_TILE`` edges; rmat and
    er: 4 edges a thread; at most 8 blocks an SM, grid-stride. ``phase``:
    t's offset from 16 bytes, in entries."""
    t = THREADS["cfree_expand"]
    end = m + phase
    if model == "ba_cfree":
        need = _cdiv(_cdiv(end, CFREE_WARP_TILE), t // 32)
        name = "cfree_expand_kernel_ba"
    else:
        need = _cdiv(_cdiv(end, 4), t)
        name = "cfree_expand_kernel_quad"
    return Launch(name, (max(min(need, 8 * sms), 1), 1, 1), (t, 1, 1))
