"""Communication-free expansion kernel: per-edge endpoints for ba_cfree,
rmat and er.

Edge ``t``'s endpoints are uint32 hashes of the model's four stream words
and ``t`` (``core/cfree.py`` holds the math and the plain functions):
ba_cfree recomputes the Batagelj–Brandes chain (at most CHAIN_BOUND = 64
hops), rmat descends log2 n quadrant levels, er draws two independent
uniforms. The CUDA kernel is ``csrc/cfree_expand.cu``.

Replaces: the JAX package's ``kernels/cfree_expand.py::cfree_expand_pallas``
(:74, ``pallas_call`` at :93, body ``_cfree_kernel`` at :40): (8, 128)
VREG tiles and a 64-hop masked unroll, since a TPU lane cannot branch.
On the card a chain ends at its first even draw, which gives the same
values as the 64 masked hops. ba_cfree runs a queue per warp over a tile
of consecutive edges: a lane whose chain ends takes the tile's next
unstarted edge, so lanes stay busy across chains of different lengths.
``t / degree`` and ``(r >> 1) / degree`` divide by the multiply-high of
:func:`repro_torch.kernels.pk_expand.division_magic`. rmat and er take 4
edges per thread. ``t`` is read and ``u``, ``v`` written with 16-byte
vectors.

Bound: bytes on the slabs (12 B per edge), integer operations for rmat.

The launch (at most 8 blocks of 256 threads an SM, grid-stride) comes
from ``kernels/geometry.py``'s ``cfree_expand``, which the kernel checker
reads too. The wrapper runs the plain version (``kernels/ref.py``) for a
CPU tensor and launches the kernel for a CUDA tensor (counted in
:data:`launches`); it raises on anything the kernel does not take,
allocates the outputs with ``torch.empty`` (at ``t``'s offset from 16 bytes, so that the three
share their vector boundaries), launches on the current stream and does
not synchronise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, geometry
from repro_torch.kernels.dispatch import mode
from repro_torch.kernels.pk_expand import division_magic
# The plain version the wrapper runs for CPU tensors.
from repro_torch.kernels.ref import cfree_expand_ref

MODELS = ("ba_cfree", "rmat", "er")   # the kernel's model codes, in order

#: Kernel launches since the last reset (a plain integer).
launches = {"cfree_expand": 0}

_c_fn = None


def _fn():
    global _c_fn
    if _c_fn is None:
        lib = _build.library("cfree_expand")
        fn = lib.repro_cfree_expand_i32
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_int64, ctypes.c_int32]
                       + [ctypes.c_uint32] * 6
                       + [ctypes.c_int32, ctypes.c_int32]
                       + [ctypes.c_uint32] * 3
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_cfree_expand_error.argtypes = [ctypes.c_int]
        lib.repro_cfree_expand_error.restype = ctypes.c_char_p
        _c_fn = (fn, lib.repro_cfree_expand_error)
    return _c_fn


# Per-launch host work the streams repeat for every slab, kept once.
_magic = functools.lru_cache(maxsize=None)(division_magic)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cfree_expand(t: torch.Tensor, words, *, model: str, n: int,
                 ba_degree: int, thresholds) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Endpoints of (m,) int32 global edge indices ``t`` (>= 0) under the
    (4,) stream ``words`` (uint32 values, any sequence of ints or a
    tensor). Returns (u, v), (m,) int32 each."""
    if t.ndim != 1:
        raise ValueError(f"cfree_expand takes (m,) indices, got "
                         f"{tuple(t.shape)}")
    if model not in MODELS:
        raise ValueError(f"model {model!r} not in {MODELS}")
    if len(words) != 4:
        raise ValueError(f"cfree_expand takes 4 stream words, got "
                         f"{len(words)}")
    words = [int(w) & 0xFFFFFFFF for w in words]
    ta, tb, tc = (int(x) for x in thresholds)
    if mode(t) == "ref":
        return cfree_expand_ref(t, words, model=model, n=n,
                                ba_degree=ba_degree, thresholds=(ta, tb, tc))
    if t.dtype != torch.int32:
        raise TypeError(f"t must be int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("t must be contiguous")
    if not 1 <= n <= 2**32 - 1 or not 1 <= ba_degree < 2**31:
        raise ValueError(f"n={n} or ba_degree={ba_degree} out of range")
    dev = t.device
    m = t.shape[0]
    # u and v start at t's offset from 16 bytes (the allocator's blocks
    # are 512-byte aligned), so all three take 16-byte vectors together.
    phase = t.data_ptr() // 4 % 4
    if phase:
        u = torch.empty(m + phase, dtype=torch.int32, device=dev)[phase:]
        v = torch.empty(m + phase, dtype=torch.int32, device=dev)[phase:]
    else:
        u = torch.empty(m, dtype=torch.int32, device=dev)
        v = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return u, v
    magic, shift = (_magic(ba_degree)
                    if model == "ba_cfree" and ba_degree > 1 else (0, 0))
    fn, err = _fn()
    launch = geometry.cfree_expand(m, phase, model, _sms(dev.index))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(t.data_ptr(), u.data_ptr(), v.data_ptr(), m,
                  MODELS.index(model), *words, n, magic, shift,
                  n.bit_length() - 1, ta, tb, tc, launch.grid[0],
                  launch.block[0], stream)
    if code:
        raise RuntimeError(f"cfree_expand kernel launch failed: "
                           f"{err(code).decode()} ({code})")
    launches["cfree_expand"] += 1
    return u, v
