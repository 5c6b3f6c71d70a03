"""Build and load the CUDA kernels of ``kernels/csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` on first use into a shared library whose file name carries a
hash of the source and the flags, under ``kernels/build/`` (listed in
``.gitignore``); a later process with the same source loads it without
compiling. Libraries are loaded with ``ctypes``. Every C entry point
returns ``cudaGetLastError()`` after its launch, and its wrapper raises on
a non-zero code: a launch the card refuses never runs, and nothing else
would report it.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` on a machine without CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("gather", "resolve", "histogram", "band_compact", "pk_expand",
           "cfree_expand")
#: The compiled kernels of each source, in the order its
#: ``repro_<source>_kernel_attributes(k, out)`` numbers them.
KERNELS = {
    "gather": ("gather_rows_kernel",),
    "resolve": ("resolve_roots_kernel",),
    "histogram": tuple(f"histogram_kernel<{kind}, {masked}>"
                       for kind in ("kBlock", "kCluster", "kGlobal")
                       for masked in ("false", "true")),
    "band_compact": ("count_kernel", "scatter_kernel<true>",
                     "scatter_kernel<false>"),
    "pk_expand": ("pk_expand_kernel<true>", "pk_expand_kernel<false>"),
    "cfree_expand": ("cfree_expand_kernel_ba",
                     "cfree_expand_kernel_quad<kRmat>",
                     "cfree_expand_kernel_quad<kEr>"),
}
#: The ``cudaFuncAttributes`` fields each entry fills, in its order.
ATTRIBUTES = ("numRegs", "sharedSizeBytes", "maxThreadsPerBlock",
              "localSizeBytes")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME (default
    /usr/local/cuda). Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "repro_torch cannot be built")


def library_path(name: str) -> pathlib.Path:
    """Content-addressed output path of ``csrc/<name>.cu``."""
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def _compile_cmd(name: str, out: pathlib.Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source not built yet, one ``nvcc`` each, all
    started together. Returns seconds per compiled source; raises with the
    compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, time.perf_counter(), subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    seconds, errors = {}, []
    for name, (out, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def kernel_attributes(name: str) -> dict[str, dict[str, int]]:
    """The compiled attributes (:data:`ATTRIBUTES`) of every kernel of
    ``csrc/<name>.cu`` on the current device, by kernel (building the
    source on first use). Raises on a CUDA error."""
    fn = getattr(library(name), f"repro_{name}_kernel_attributes")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for k, kernel in enumerate(KERNELS[name]):
        vals = (ctypes.c_int * len(ATTRIBUTES))()
        code = fn(k, vals)
        if code:
            raise RuntimeError(f"cudaFuncGetAttributes({kernel}) failed "
                               f"({code})")
        out[kernel] = dict(zip(ATTRIBUTES, vals))
    return out


def device_limits(index: int):
    """What card ``index`` allows a launch, as a
    ``kernels.geometry.Limits`` (read by ``cudaDeviceGetAttribute``)."""
    from repro_torch.kernels.geometry import Limits
    fn = library("gather").repro_device_limits
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 7)()
    code = fn(index, vals)
    if code:
        raise RuntimeError(f"cudaDeviceGetAttribute on cuda:{index} failed "
                           f"({code})")
    threads, gx, gy, gz, optin, sms, cluster = vals
    import torch

    from repro_torch.kernels.edge_resolve import resident_blocks
    return Limits(max_threads_per_block=threads, max_grid=(gx, gy, gz),
                  smem_optin=optin, sms=sms,
                  cluster_portable=8 if cluster else 1,
                  gather_blocks_per_sm=resident_blocks(
                      torch.device("cuda", index)) // sms)
