"""Device and process-group probes for the runtime layer.

The port runs one process per device. A topology of more than one device
runs under a ``torch.distributed`` process group that the caller
initialises, as ``torchrun`` does: NCCL on the card, gloo on the CPU. The
global process rank is the topology's linear device index. This module
is the one place that asks the group who and where this process is:

  :func:`group_active`    whether a default process group is initialised
  :func:`world_size`, :func:`rank`   of that group (1 and 0 with none)
  :func:`device_count`    the devices a topology may span: the world size
  :func:`resolve_device`  the device an entry point runs on
  :func:`check_backend`   the group's backend against the device
  :func:`device_memory_bytes`   the pair-capacity heuristic's budget

The JAX package's mesh and shard_map shims have no counterpart: the
collectives are ``torch.distributed`` calls in ``runtime/blocking.py``.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

#: Fixed budget for devices that report no memory (the CPU). The JAX
#: package uses the same value, so capacities derived on the CPU agree.
_DEFAULT_DEVICE_MEMORY = 8 << 30


def group_active() -> bool:
    """Whether a default ``torch.distributed`` process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The default group's world size; 1 with no group."""
    return dist.get_world_size() if group_active() else 1


def rank() -> int:
    """This process's rank in the default group; 0 with no group."""
    return dist.get_rank() if group_active() else 0


def device_count() -> int:
    """Devices a topology may span: one per process of the group, so the
    world size (1 with no group, whatever cards the machine holds)."""
    return world_size()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``device`` None: under a process group, ``cuda:LOCAL_RANK`` (the
    environment's), else ``cuda:rank % device_count``; with no group the
    current CUDA device. Raises when CUDA is asked for (or implied) and
    absent: the port never drops to the CPU on its own.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if group_active():
            local = os.environ.get("LOCAL_RANK")
            index = int(local) if local is not None \
                else rank() % torch.cuda.device_count()
            return torch.device("cuda", index)
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


def check_backend(device) -> None:
    """Raise ``ValueError`` when the default group's backend cannot carry
    tensors on ``device``: gloo runs CPU tensors here, NCCL CUDA ones.
    Nothing is copied through the host to make them fit."""
    if not group_active():
        return
    backend = str(dist.get_backend()).lower()
    kind = torch.device(device).type
    if backend == "gloo" and kind != "cpu":
        raise ValueError(
            f"the process group's backend is gloo, which carries CPU "
            f"tensors here, but the run is on {device}: initialise NCCL "
            "for CUDA devices")
    if backend == "nccl" and kind != "cuda":
        raise ValueError(
            f"the process group's backend is NCCL, which carries CUDA "
            f"tensors, but the run is on {device}: initialise gloo for "
            "the CPU")


def device_memory_bytes(device) -> int:
    """Per-device memory budget in bytes: the card's total memory on CUDA,
    the fixed default on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return int(torch.cuda.get_device_properties(index).total_memory)
    return _DEFAULT_DEVICE_MEMORY
