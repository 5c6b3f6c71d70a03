"""Histogram kernel: PBA phase-1 demand counts and the round census.

``counts[r, b] = #{k : values[r, k] == b}`` for 0 <= b < num_bins; values
outside [0, num_bins) are ignored; with a bool ``mask`` of the values'
shape, only the values where it is set are counted (the census counts a
round's band without materialising ``where(band, a, -1)``). The CUDA
kernel is ``csrc/histogram.cu``.

Replaces: the JAX package's ``kernels/histogram.py::histogram_pallas``
(:47), whose ``_hist_kernel`` counts by a one-hot compare of each value
block against an iota of bins and accumulates over the grid in VMEM. On
the card integer atomics are exact in any order. The kernel reads the
values as 16-byte vectors (with a mask: 16 flags a load, and a value
vector only where one of its flags is set) and adds each value where
:func:`regime` says: private bins per block in shared memory, a window
of the bins per block of a thread-block cluster whose blocks all read
the row, or device memory.

Bound: bytes, the values read once (with a mask: the mask once and the
values where it is set), the counts written once.

The wrapper runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor (counted in :data:`launches`), on the current
stream, without synchronising. Where one block or cluster owns each row
it allocates the counts with ``torch.empty`` (the kernel writes every
bin); where several share a row, with ``torch.zeros``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import mode
# The plain version the wrapper runs for CPU tensors.
from repro_torch.kernels.ref import histogram_ref

#: Kernel launches since the last reset (a plain integer).
launches = {"histogram": 0}

#: The most shared memory a block's per-warp bin copies may take.
COPIES_BYTES = 16384
#: The largest portable thread-block cluster.
CLUSTER_MAX = 8

_KINDS = {"block": 0, "cluster": 1, "global": 2}


@dataclasses.dataclass(frozen=True)
class Regime:
    """Where the kernel's adds land for one bin count.

    kind: "block" (private bins per block in shared memory), "cluster"
      (the bins cut into windows, one per block of a ``blocks``-block
      cluster) or "global" (device-memory atomics).
    blocks: blocks that share one copy of a row's bins (the cluster size).
    slice: bins each block keeps (0 for "global").
    copies: copies of its slice each block keeps (one per warp while the
      copies fit in COPIES_BYTES).
    """

    kind: str
    blocks: int
    slice: int
    copies: int


def regime(num_bins: int, smem_optin_bytes: int, threads: int,
           stage_bytes: int, cluster_max: int = CLUSTER_MAX) -> Regime:
    """The regime for ``num_bins`` on a card whose blocks may opt in to
    ``smem_optin_bytes`` of shared memory and whose clusters hold up to
    ``cluster_max`` blocks, for a kernel of ``threads`` threads a block
    that sets aside ``stage_bytes`` of shared memory for a masked step's
    flags (the library's :func:`_layout`): a block's shared memory while
    the bins fit beside the staging, else the fewest cluster blocks that
    hold them, else device memory."""
    per_block = (smem_optin_bytes - stage_bytes) // 4
    if num_bins <= per_block:
        copies = threads // 32
        while copies > 1 and 4 * copies * num_bins > COPIES_BYTES:
            copies //= 2
        return Regime("block", 1, num_bins, copies)
    blocks = -(-num_bins // per_block)
    if blocks <= cluster_max:
        return Regime("cluster", blocks, -(-num_bins // blocks), 1)
    return Regime("global", 1, 0, 0)


def blocks_per_row(rows: int, reg: Regime, sms: int) -> int:
    """Blocks per row: one block per SM (the kernel's launch bounds) in
    one wave, spread over the rows, at least one block or cluster."""
    return max(1, sms // (rows * reg.blocks)) * reg.blocks


_c_fn = None
_card: dict[int, tuple[int, int]] = {}


def _fn():
    global _c_fn
    if _c_fn is None:
        lib = _build.library("histogram")
        fn = lib.repro_histogram_i32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 \
            + [ctypes.c_int32] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_histogram_smem_optin.argtypes = [ctypes.c_int]
        lib.repro_histogram_smem_optin.restype = ctypes.c_int
        lib.repro_histogram_threads.restype = ctypes.c_int
        lib.repro_histogram_stage_bytes.restype = ctypes.c_int
        lib.repro_histogram_error.argtypes = [ctypes.c_int]
        lib.repro_histogram_error.restype = ctypes.c_char_p
        _c_fn = (fn, lib.repro_histogram_smem_optin,
                 (lib.repro_histogram_threads(),
                  lib.repro_histogram_stage_bytes()),
                 lib.repro_histogram_error)
    return _c_fn


def _layout() -> tuple[int, int]:
    """(threads a block, bytes of a masked step's flag staging) of the
    kernel, as its source sets them."""
    return _fn()[2]


def _limits(device: torch.device) -> tuple[int, int]:
    """(SM count, opt-in shared memory per block) of the card."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _card:
        optin = _fn()[1](index)
        if optin <= 0:
            raise RuntimeError(f"histogram: cannot read the opt-in shared "
                               f"memory of cuda:{index} ({optin})")
        _card[index] = (
            torch.cuda.get_device_properties(index).multi_processor_count,
            optin)
    return _card[index]


def histogram(values: torch.Tensor, num_bins: int,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Count int32 values into [0, num_bins): (n,) -> (num_bins,), or
    (rows, n) -> (rows, num_bins); with a bool ``mask`` of the values'
    shape, only where it is set."""
    if values.ndim not in (1, 2):
        raise ValueError(f"histogram takes (n,) or (rows, n), got "
                         f"{tuple(values.shape)}")
    if not 1 <= num_bins < 2**31:
        raise ValueError(f"num_bins must lie in [1, 2**31), got {num_bins}")
    if mask is not None and mask.shape != values.shape:
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected "
                         f"{tuple(values.shape)}")
    if mode(values) == "ref":
        return histogram_ref(values, num_bins, mask)
    if values.dtype != torch.int32:
        raise TypeError(f"values must be int32, got {values.dtype}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    if mask is not None:
        if mask.dtype != torch.bool or mask.device != values.device:
            raise TypeError(f"mask must be bool on {values.device}, got "
                            f"{mask.dtype} on {mask.device}")
        if not mask.is_contiguous():
            raise ValueError("mask must be contiguous")
    rows = 1 if values.ndim == 1 else values.shape[0]
    n = values.shape[-1]
    fn, _, layout, err = _fn()
    sms, optin = _limits(values.device)
    reg = regime(num_bins, optin, *layout)
    per_row = blocks_per_row(rows, reg, sms)
    owned = reg.kind != "global" and per_row == reg.blocks
    shape = values.shape[:-1] + (num_bins,)
    counts = (torch.empty if owned else torch.zeros)(
        shape, dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(values.data_ptr(),
                  None if mask is None else mask.data_ptr(),
                  counts.data_ptr(), rows, n, num_bins, _KINDS[reg.kind],
                  reg.blocks, reg.copies, reg.slice, per_row, int(owned),
                  stream)
    if code:
        raise RuntimeError(
            f"histogram kernel launch failed: {err(code).decode()} ({code})")
    launches["histogram"] += 1
    return counts
