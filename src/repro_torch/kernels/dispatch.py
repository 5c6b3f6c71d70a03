"""Execution-mode probe shared by every kernel wrapper.

A wrapper launches its CUDA kernel for a tensor on the card and runs its
plain PyTorch version for a tensor on the CPU. Where the tensor lies is
the only input: there is no environment switch, and no build or launch
failure ever drops to the plain version (a wrapper raises instead).
:func:`forced_mode` runs the plain versions on any device for one scope;
it exists so the port can be held against its own plain path on the card
(tests and ``chip_smoke.py``'s comparison phase).
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_FORCED_MODE: list[str] = []  # forced_mode() stack


def mode(t: torch.Tensor) -> str:
    """'ref' when forced or when ``t`` lies on the CPU, else 'cuda'."""
    if _FORCED_MODE:
        return _FORCED_MODE[-1]
    if t.is_cuda:
        return "cuda"
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for device {t.device}")
    return "ref"


@contextlib.contextmanager
def forced_mode(value: str) -> Iterator[None]:
    """Run every kernel wrapper's plain version for the scope."""
    if value != "ref":
        raise ValueError(
            f"forced_mode: only 'ref' can be forced, got {value!r} (the "
            "CUDA path is chosen by the tensor's device)")
    _FORCED_MODE.append(value)
    try:
        yield
    finally:
        _FORCED_MODE.pop()
