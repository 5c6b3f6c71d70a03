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

and the group plumbing of the analysis tools and launchers
(``repro_torch.analysis``, ``launch/dryrun.py``, ``launch/generate.py``),
which may not touch ``torch.distributed``
themselves (spmdlint TRP001):

  :func:`init_group` / :func:`init_fake_group` / :func:`destroy_group`
  :func:`barrier`         every rank of the group waits for the others
  :func:`group_ranks`     the global ranks of a c10d op's process group
  :func:`gather_objects`  every rank's picklable object, on rank 0

The JAX package's mesh and shard_map shims have no counterpart: the
collectives are ``torch.distributed`` calls in ``runtime/blocking.py``.
"""
from __future__ import annotations

import os
from typing import Optional

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


def init_group(backend: str, init_method: str, world: int,
               rank_: int, *, device_id=None,
               timeout_s: Optional[float] = None) -> None:
    """Initialise the default process group (``backend`` "gloo" or
    "nccl", a ``tcp://``, ``file://`` or ``env://`` rendezvous);
    ``device_id`` binds an NCCL group to its card at once, ``timeout_s``
    bounds each collective's wait."""
    extra = {}
    if device_id is not None:
        extra["device_id"] = torch.device(device_id)
    if timeout_s is not None:
        import datetime
        extra["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank_, **extra)


def barrier() -> None:
    """Wait for every rank of the default group (nothing with none)."""
    if group_active():
        dist.barrier()


def init_fake_group(world: int, rank_: int = 0) -> None:
    """Initialise the default group on torch's ``fake`` backend: this
    process plays rank ``rank_`` of ``world`` and every collective returns
    at once, its output untouched (under ``FakeTensorMode`` only its shape
    exists). The dry run lays the production meshes out with it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), world_size=world,
                            rank=rank_)


def destroy_group() -> None:
    """Tear the default group down (nothing when there is none)."""
    if group_active():
        dist.destroy_process_group()


def group_ranks(group) -> Optional[tuple]:
    """The global ranks of ``group``, a ``ProcessGroup`` or the script
    object a c10d dispatcher op carries (None for anything else)."""
    try:
        pg = group if isinstance(group, dist.ProcessGroup) \
            else dist.ProcessGroup.unbox(group)
    except (RuntimeError, TypeError, AttributeError):
        return None
    try:
        return tuple(dist.get_process_group_ranks(pg))
    except (RuntimeError, ValueError):
        return tuple(range(pg.size()))


def gather_objects(obj) -> Optional[list]:
    """Every rank's ``obj`` (picklable), in rank order, on rank 0; None on
    the other ranks. With no group, ``[obj]``."""
    if not group_active():
        return [obj]
    out = [None] * world_size() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out
