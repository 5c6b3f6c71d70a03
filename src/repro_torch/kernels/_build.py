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
