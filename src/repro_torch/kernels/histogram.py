"""Histogram kernel: PBA phase-1 demand counts (and the round census).

``counts[r, b] = #{k : values[r, k] == b}`` for 0 <= b < num_bins; values
outside [0, num_bins) are ignored. The CUDA kernel is
``csrc/histogram.cu``.

Replaces: the JAX package's ``kernels/histogram.py::histogram_pallas``
(:47), whose ``_hist_kernel`` counts by a one-hot compare of each value
block against an iota of bins and accumulates over the grid in VMEM. On
the card integer atomics are exact in any order: each block counts into
private shared-memory bins when they fit (48 KiB, 12288 bins) and adds
them to the row's counts once; larger bin counts add into device memory
directly.

Bound: bytes, one streamed read of ``values``.

The wrapper runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor (counted in :data:`launches`); it zeroes the
output with ``torch.zeros``, launches on the current stream and does not
synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import mode
# The plain version the wrapper runs for CPU tensors.
from repro_torch.kernels.ref import histogram_ref

#: Kernel launches since the last reset (a plain integer).
launches = {"histogram": 0}

_c_fn = None


def _fn():
    global _c_fn
    if _c_fn is None:
        lib = _build.library("histogram")
        fn = lib.repro_histogram_i32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_histogram_error.argtypes = [ctypes.c_int]
        lib.repro_histogram_error.restype = ctypes.c_char_p
        _c_fn = (fn, lib.repro_histogram_error)
    return _c_fn


def histogram(values: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Count int32 values into [0, num_bins): (n,) -> (num_bins,), or
    (rows, n) -> (rows, num_bins)."""
    if values.ndim not in (1, 2):
        raise ValueError(f"histogram takes (n,) or (rows, n), got "
                         f"{tuple(values.shape)}")
    if not 1 <= num_bins < 2**31:
        raise ValueError(f"num_bins must lie in [1, 2**31), got {num_bins}")
    if mode(values) == "ref":
        return histogram_ref(values, num_bins)
    if values.dtype != torch.int32:
        raise TypeError(f"values must be int32, got {values.dtype}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    rows = 1 if values.ndim == 1 else values.shape[0]
    n = values.shape[-1]
    counts = torch.zeros(values.shape[:-1] + (num_bins,), dtype=torch.int32,
                         device=values.device)
    fn, err = _fn()
    with torch.cuda.device(values.device):
        sms = torch.cuda.get_device_properties(values.device)\
            .multi_processor_count
        # Enough blocks to fill every SM (8 blocks of 256 threads each).
        per_row = max(1, -(-8 * sms // rows))
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(values.data_ptr(), counts.data_ptr(), rows, n, num_bins,
                  per_row, stream)
    if code:
        raise RuntimeError(
            f"histogram kernel launch failed: {err(code).decode()} ({code})")
    launches["histogram"] += 1
    return counts
