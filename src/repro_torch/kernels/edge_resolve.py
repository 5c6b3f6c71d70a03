"""Kernels for PBA urn resolution, grants and receives.

:func:`resolve_roots` resolves an urn completely, in place, in one launch
of ``csrc/resolve.cu``: every slot gets the root of its pointer chain, the
fixpoint of the doubling pass. It replaces the JAX package's
``pba.resolve_pointers``, a while_loop of ``resolve_step_pallas`` passes;
see the source's note.

The gather primitive is ``values = src[clip(idx)]`` along the last axis:
one pointer-doubling pass (``ptr'[j] = ptr[ptr[j]]``,
:func:`resolve_step`) is the case src == idx, the grant and receive
lookups are the general case. One CUDA kernel, ``csrc/gather.cu``, serves
those entry points. No generator path calls :func:`resolve_step` any
more; it stays as the one-pass entry point of the reference's contract.

Replaces: the JAX package's ``kernels/edge_resolve.py`` —
``resolve_step_pallas`` (:87), ``gather_pallas`` (:110) and
``gather_chunked_pallas`` (:194). Those keep the source in TPU VMEM, whole
(up to ~2M entries) or in slabs whose partial gathers are summed. On the
card L2 and device memory serve the whole source, so the kernel has no
size cap and no slabs. ``gather_chunked`` stays as an entry point with
its own launch count: ``ops.gather`` sends it the sources whose rows hold
``CHUNKED_MIN_ENTRIES`` or more (the grant lookups into the phase-2
pools), where the TPU kernel would have swept slabs.

Bound: bytes. Gathers: a random 4-byte read of ``src`` per output plus a
streamed read of ``idx`` and a streamed write of ``out``. Resolve: the
pointer array read once and written once.

Each wrapper runs the plain version (from ``kernels/ref.py``) for a CPU
tensor, launches the kernel for a CUDA tensor (counting the launch in
:data:`launches`), and raises on anything the kernel does not take. It
launches on the current stream and allocates with ``torch.empty``; the
gathers do not synchronise, :func:`resolve_roots` reads its error word
once per launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import mode
# The plain versions the wrappers run for CPU tensors (and the kernel is
# held against on the card).
from repro_torch.kernels.ref import (gather_ref, resolve_roots_ref,
                                     resolve_step_ref)

#: Kernel launches per wrapper since the last reset (plain integers).
launches = {"resolve_roots": 0, "resolve_step": 0, "gather": 0,
            "gather_chunked": 0}

#: Source rows of this many entries or more (32 MiB of int32, a large
#: share of the card's 50 MB L2) go to :func:`gather_chunked`.
CHUNKED_MIN_ENTRIES = 1 << 23

_c_fn = None
_c_resolve = None


def _resolve_fn():
    global _c_resolve
    if _c_resolve is None:
        lib = _build.library("resolve")
        fn = lib.repro_resolve_roots_i32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_resolve_error.argtypes = [ctypes.c_int]
        lib.repro_resolve_error.restype = ctypes.c_char_p
        _c_resolve = (fn, lib.repro_resolve_error)
    return _c_resolve


def _fn():
    global _c_fn
    if _c_fn is None:
        lib = _build.library("gather")
        fn = lib.repro_gather_i32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_gather_error.argtypes = [ctypes.c_int]
        lib.repro_gather_error.restype = ctypes.c_char_p
        _c_fn = (fn, lib.repro_gather_error)
    return _c_fn


def _check_operand(name: str, t: torch.Tensor, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(src: torch.Tensor, idx: torch.Tensor, rows: int, m: int,
            n: int, src_stride: int) -> torch.Tensor:
    _check_operand("src", src, src.device)
    _check_operand("idx", idx, src.device)
    if m < 1:
        raise ValueError("gather from an empty source")
    if max(m, n) >= 2**31:
        raise ValueError(f"gather: rows of {m} source entries and {n} "
                         "indices must stay below 2^31 (32-bit offsets)")
    out = torch.empty(idx.shape, dtype=torch.int32, device=idx.device)
    fn, err = _fn()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, m,
                  n, src_stride, stream)
    if code:
        raise RuntimeError(
            f"gather kernel launch failed: {err(code).decode()} ({code})")
    return out


def resolve_roots(ptr: torch.Tensor) -> torch.Tensor:
    """Resolve every slot of an urn's pointers ptr (m,) or (rows, m) to
    the root of its chain, in place, and return ``ptr``.

    The contract is the fixpoint of the doubling pass, which is what the
    JAX package's ``resolve_pointers`` returns: the urns point strictly
    down from non-terminal slots and terminal slots point at themselves,
    so the doubling fixpoint holds each chain's root. A pointer outside
    [0, its slot] raises ``ValueError`` (on the card, after the launch,
    from the kernel's error word; the urn is then left partly resolved).
    """
    if ptr.ndim not in (1, 2):
        raise ValueError(f"resolve_roots takes (m,) or (rows, m), got "
                         f"{tuple(ptr.shape)}")
    if mode(ptr) == "ref":
        return resolve_roots_ref(ptr)
    _check_operand("ptr", ptr, ptr.device)
    rows = 1 if ptr.ndim == 1 else ptr.shape[0]
    err = torch.zeros(1, dtype=torch.int32, device=ptr.device)
    fn, err_str = _resolve_fn()
    with torch.cuda.device(ptr.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(ptr.data_ptr(), err.data_ptr(), rows, ptr.shape[-1],
                  stream)
    if code:
        raise RuntimeError(f"resolve kernel launch failed: "
                           f"{err_str(code).decode()} ({code})")
    launches["resolve_roots"] += 1
    if int(err.item()):
        raise ValueError("resolve_roots: a pointer lies outside [0, its "
                         "slot]")
    return ptr


def resolve_step(ptr: torch.Tensor) -> torch.Tensor:
    """One ptr[ptr] pass along the last axis of ptr (m,) or (rows, m).

    Writes a new tensor: the pass must read only the old pointers."""
    if ptr.ndim not in (1, 2):
        raise ValueError(f"resolve_step takes (m,) or (rows, m), got "
                         f"{tuple(ptr.shape)}")
    if mode(ptr) == "ref":
        return resolve_step_ref(ptr)
    rows = 1 if ptr.ndim == 1 else ptr.shape[0]
    m = ptr.shape[-1]
    out = _launch(ptr, ptr, rows, m, m, m)
    launches["resolve_step"] += 1
    return out


def _gather(src: torch.Tensor, idx: torch.Tensor, name: str
            ) -> torch.Tensor:
    """The gather contract for both entry points; a launch counts under
    ``name``."""
    if src.ndim == 1:
        flat = idx.reshape(-1)
        if mode(src) == "ref":
            return gather_ref(src, flat).reshape(idx.shape)
        out = _launch(src, flat, 1, src.shape[0], flat.shape[0], 0)
        launches[name] += 1
        return out.reshape(idx.shape)
    if src.ndim == 2 and idx.ndim == 2 and src.shape[0] == idx.shape[0]:
        if mode(src) == "ref":
            return gather_ref(src, idx)
        out = _launch(src, idx, src.shape[0], src.shape[1], idx.shape[1],
                      src.shape[1])
        launches[name] += 1
        return out
    raise ValueError(f"gather: unsupported shapes {tuple(src.shape)} / "
                     f"{tuple(idx.shape)}")


def gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values = src[..., clip(idx)] along the last axis.

    Two forms: a 1-D shared source with indices of any rank (the result
    has idx's shape), or batched rows, src (rows, m) with idx (rows, n).
    """
    return _gather(src, idx, "gather")


def gather_chunked(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The chunked regime's entry point (sources past the TPU's resident
    bound): the same contract and the same kernel as :func:`gather`, with
    its own launch count."""
    return _gather(src, idx, "gather_chunked")
