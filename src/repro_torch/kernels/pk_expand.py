"""Kronecker expansion kernel: the PK inner loop.

Edge ``t0 + t`` of the L-th Kronecker power of a seed graph (e0 edges
over n0 vertices) for each local index ``t``: the base-e0 digits of
``t``, carry-added to the (L,) MSB-first digits of the range start
``t0``, optionally redrawn where ``flip`` is set (the paper's noise),
pick one seed edge per level, and ``u = sum_i seed_u[d_i] * n0^(L-1-i)``
(likewise ``v``). The CUDA kernel is ``csrc/pk_expand.cu``.

Replaces: the JAX package's ``kernels/pk_expand.py::pk_expand_pallas``
(:72, ``pallas_call`` at :107), both bodies: ``_expand_kernel`` (:35) and
the noise variant ``_noise_wrapper`` (:119). The TPU kernel tiles edges as
(8, 128) VREGs and looks the seed tables up by one-hot matmuls (Mosaic has
no dynamic gather). On the card one thread expands four consecutive edges
with vector loads and stores, divides by e0 with the multiplier of
:func:`division_magic` (the card has no integer divider), the tables sit
in shared memory (or, past 4096 entries each, behind the read-only
cache), and a null ``flip`` selects the body without noise.

Bound: bytes (t read, u and v written: 12 B per edge; with noise,
``flip``'s byte per edge and level and the ``redraw`` sectors that set
flips touch), with the integer operations (nine per edge and level)
close behind.

The launch (a block of 256 threads per 1024 edges, at most 8 blocks an
SM, then grid-stride; the tables' shared memory) comes from
``kernels/geometry.py``'s ``pk_expand``, which the kernel checker reads
too. The wrapper runs the plain version (``kernels/ref.py``) for a CPU
tensor and launches the kernel for a CUDA tensor (counted in
:data:`launches`); it raises on anything the kernel does not take,
allocates the outputs with ``torch.empty``, launches on the current
stream and does not synchronise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build, geometry
from repro_torch.kernels.dispatch import mode
# The plain version the wrapper runs for CPU tensors.
from repro_torch.kernels.ref import pk_expand_ref

#: Kernel launches since the last reset (a plain integer).
launches = {"pk_expand": 0}

_c_fn = None


def _fn():
    global _c_fn
    if _c_fn is None:
        lib = _build.library("pk_expand")
        fn = lib.repro_pk_expand_i32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] \
            + [ctypes.c_int32] * 3 + [ctypes.c_uint32, ctypes.c_int32,
                                      ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_pk_expand_error.argtypes = [ctypes.c_int]
        lib.repro_pk_expand_error.restype = ctypes.c_char_p
        _c_fn = (fn, int(lib.repro_pk_expand_max_levels()),
                 lib.repro_pk_expand_error)
    return _c_fn


def division_magic(divisor: int) -> tuple[int, int]:
    """The round-up multiplier of ``divisor`` (Granlund-Montgomery):
    (magic, shift) with ``n // divisor == (n * magic) >> (32 + shift)``
    for every 0 <= n < 2^31, which the kernel computes as
    ``__umulhi(n, magic) >> shift`` (``cfree_expand`` divides by the BA
    degree with it too).

    shift = ceil(log2 divisor) - 1 (0 for 1 and 2) and magic =
    ceil(2^(32 + shift) / divisor). magic < 2^32 for every divisor >= 2;
    its error magic * divisor - 2^(32 + shift) is below divisor <=
    2^(shift + 1), so n * error < 2^(32 + shift) for n < 2^31 and the
    quotient is exact with no add-back. For divisor 1 magic is 2^32,
    which the kernel cannot hold: it takes e0 = 1 on its own (every digit
    is 0).
    """
    if not 1 <= divisor < 2**31:
        raise ValueError(f"divisor must lie in [1, 2^31), got {divisor}")
    shift = max((divisor - 1).bit_length() - 1, 0)
    return -(-(1 << (32 + shift)) // divisor), shift


def _check(name: str, x: torch.Tensor, dtype, shape, dev) -> None:
    if x.device != dev:
        raise ValueError(f"{name} must lie on {dev}, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pk_expand(t_local: torch.Tensor, base_digits, seed_u: torch.Tensor,
              seed_v: torch.Tensor, n0: int, e0: int, levels: int,
              flip: Optional[torch.Tensor] = None,
              redraw: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand (m,) int32 local indices ``t_local`` (>= 0) of the range
    whose start has MSB-first digits ``base_digits`` (L ints in [0, e0));
    ``seed_u``/``seed_v``: (e0,) int32 tables; optional (L, m) bool
    ``flip`` and int32 ``redraw``. Returns (u, v), (m,) int32 each."""
    if t_local.ndim != 1:
        raise ValueError(f"pk_expand takes (m,) indices, got "
                         f"{tuple(t_local.shape)}")
    base = np.asarray(base_digits, dtype=np.int64).reshape(-1)
    if base.shape[0] != levels or levels < 1:
        raise ValueError(f"base_digits has {base.shape[0]} digits for "
                         f"levels={levels}")
    if base.min() < 0 or base.max() >= e0:
        raise ValueError(f"base_digits must lie in [0, e0={e0})")
    if (flip is None) != (redraw is None):
        raise ValueError("flip and redraw come together")
    if mode(t_local) == "ref":
        return pk_expand_ref(t_local, base, seed_u, seed_v, n0, e0, levels,
                             flip, redraw)
    dev = t_local.device
    m = t_local.shape[0]
    _check("t_local", t_local, torch.int32, (m,), dev)
    _check("seed_u", seed_u, torch.int32, (e0,), dev)
    _check("seed_v", seed_v, torch.int32, (e0,), dev)
    if flip is not None:
        _check("flip", flip, torch.bool, (levels, m), dev)
        _check("redraw", redraw, torch.int32, (levels, m), dev)
    fn, max_levels, err = _fn()
    if levels > max_levels:
        raise ValueError(f"levels={levels} exceeds the kernel's "
                         f"{max_levels}")
    u = torch.empty(m, dtype=torch.int32, device=dev)
    v = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return u, v
    digits = (ctypes.c_int32 * levels)(*base.tolist())
    magic, shift = division_magic(e0)
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        launch = geometry.pk_expand(m, e0, sms)
        code = fn(t_local.data_ptr(), digits, seed_u.data_ptr(),
                  seed_v.data_ptr(),
                  flip.data_ptr() if flip is not None else None,
                  redraw.data_ptr() if redraw is not None else None,
                  u.data_ptr(), v.data_ptr(), m, n0, e0, levels,
                  magic & 0xFFFFFFFF, shift, launch.grid[0],
                  launch.block[0], launch.smem, stream)
    if code:
        raise RuntimeError(f"pk_expand kernel launch failed: "
                           f"{err(code).decode()} ({code})")
    launches["pk_expand"] += 1
    return u, v
