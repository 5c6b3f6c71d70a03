"""Device probes for the runtime layer.

:func:`resolve_device` picks the device an entry point runs on,
:func:`device_count` tells the planner how many devices a topology could
span, and :func:`device_memory_bytes` feeds the pair-capacity heuristic
(``core/pba.py::default_pair_capacity``). The JAX package's mesh and
shard_map shims are not ported: one device needs none.
"""
from __future__ import annotations

import torch

#: Fixed budget for devices that report no memory (the CPU). The JAX
#: package uses the same value, so capacities derived on the CPU agree.
_DEFAULT_DEVICE_MEMORY = 8 << 30


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the current CUDA device when
    ``device`` is None, else ``device``. Raises when CUDA is asked for (or
    implied) and absent: the port never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but CUDA is "
                               "not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use 'cuda' or 'cpu'")
    return device


def device_count(device) -> int:
    """Devices of ``device``'s kind a topology could span: the CUDA
    device count on CUDA, 1 on the CPU."""
    return torch.cuda.device_count() \
        if torch.device(device).type == "cuda" else 1


def device_memory_bytes(device) -> int:
    """Per-device memory budget in bytes: the card's total memory on CUDA,
    the fixed default on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return int(torch.cuda.get_device_properties(index).total_memory)
    return _DEFAULT_DEVICE_MEMORY
