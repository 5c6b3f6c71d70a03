"""Band-compaction kernel: the last step of every streamed PBA round.

Per row of (rows, e) int32 ``u``, ``v`` and bool ``band``: the pairs
whose band flag is set move to the front in index order, everything else
is -1, and the result is truncated to ``block_cap`` columns. The CUDA
kernel is ``csrc/band_compact.cu``.

Replaces: the JAX package's ``kernels/band_compact.py::band_compact_pallas``
(:107, ``pallas_call`` at :133, body ``_band_compact_kernel`` at :40), an
O(e * cap) one-hot accumulation with an SMEM cursor, because Mosaic has no
scatter. On the card the same permutation is a prefix-sum compaction in
two launches behind one C entry (counted as one launch here): a count
pass reads ``band`` as 16-byte vectors and keeps a 16-bit mask per 16
flags; a scatter pass sums its row's tile counts, writes its chunk of the
-1 padding, and, where its tile holds band entries, stages them in shared
memory and writes them with 16-byte stores.

Bound: bytes. The function must read ``band`` once (1 byte per entry),
``u`` and ``v`` only where ``band`` is set, and write both outputs once;
the kernel writes every output element once and adds the masks (an eighth
of ``band``'s bytes, written and read once).

The launch's grid and block come from ``kernels/geometry.py``'s
``band_compact``, which the kernel checker reads too. The wrapper runs
the plain version (``kernels/ref.py``) for a CPU tensor
and launches the kernel for a CUDA tensor (counted in :data:`launches`);
it raises on anything the kernel does not take, allocates the outputs and
the kernel's scratch with ``torch.empty``, launches on the current stream
and does not synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, geometry
from repro_torch.kernels.dispatch import mode
# The plain version the wrapper runs for CPU tensors.
from repro_torch.kernels.ref import band_compact_ref

#: Kernel launches since the last reset (a plain integer).
launches = {"band_compact": 0}

_c_fn = None


def _fn():
    global _c_fn
    if _c_fn is None:
        lib = _build.library("band_compact")
        fn = lib.repro_band_compact_i32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 5 \
            + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        scratch = lib.repro_band_compact_scratch_bytes
        scratch.argtypes = [ctypes.c_int64] * 2
        scratch.restype = ctypes.c_int64
        lib.repro_band_compact_error.argtypes = [ctypes.c_int]
        lib.repro_band_compact_error.restype = ctypes.c_char_p
        _c_fn = (fn, scratch, lib.repro_band_compact_error)
    return _c_fn


def _check(name: str, t: torch.Tensor, dtype, like: torch.Tensor) -> None:
    if not t.is_cuda or t.device != like.device:
        raise ValueError(f"{name} must lie on {like.device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def band_compact(u: torch.Tensor, v: torch.Tensor, band: torch.Tensor,
                 block_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable band compaction of (rows, e) ``u``, ``v`` by ``band``:
    returns two (rows, min(e, block_cap)) int32 tensors."""
    if u.ndim != 2:
        raise ValueError(f"band_compact takes (rows, e), got "
                         f"{tuple(u.shape)}")
    if block_cap < 1:
        raise ValueError(f"block_cap must be >= 1, got {block_cap}")
    if mode(u) == "ref":
        return band_compact_ref(u, v, band, block_cap)
    _check("u", u, torch.int32, u)
    _check("v", v, torch.int32, u)
    _check("band", band, torch.bool, u)
    rows, e = u.shape
    cap = min(e, block_cap)
    uo = torch.empty((rows, cap), dtype=torch.int32, device=u.device)
    vo = torch.empty((rows, cap), dtype=torch.int32, device=u.device)
    if rows == 0 or e == 0:
        return uo, vo
    fn, scratch_bytes, err = _fn()
    # int32 elements: the kernel's tile counts need 4-byte alignment.
    scratch = torch.empty(-(-scratch_bytes(rows, e) // 4), dtype=torch.int32,
                          device=u.device)
    launch, _ = geometry.band_compact(rows, e)     # both passes alike
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(u.data_ptr(), v.data_ptr(), band.data_ptr(), uo.data_ptr(),
                  vo.data_ptr(), scratch.data_ptr(), rows, e, cap,
                  launch.grid[0], launch.grid[1], launch.block[0], stream)
    if code:
        raise RuntimeError(f"band_compact kernel launch failed: "
                           f"{err(code).decode()} ({code})")
    launches["band_compact"] += 1
    return uo, vo
