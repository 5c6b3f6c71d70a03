"""Device-topology description for the exchange layer.

The same dataclass as the JAX package's ``runtime/topology.py`` (class and
field names match, so a spec that names a topology fingerprints alike),
without the mesh building:

  Topology.host()        no device axis: the whole logical program on one
                         device (transposes degenerate to local swapaxes)
  Topology.flat(d)       one ``proc`` axis of d devices
  Topology.pods(r, c)    r pods x c devices per pod

The logical-over-physical factorization P = lp * D is :meth:`lp`. A
device topology of D devices runs one process per device under a
``torch.distributed`` group of world size D (:func:`resolve` checks it);
the process rank is the linear device index, outer-major, so on
``pods(r, c)`` device d = pod * c + chip. :func:`pod_groups` builds the
subgroups the two-hop transpose runs over.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch.distributed as dist

from repro_torch.runtime import spmd


@dataclasses.dataclass(frozen=True)
class Topology:
    """Mesh axes the distributed exchange runs over.

    axis_names / axis_sizes: parallel tuples, outermost axis first. Empty
    tuples describe the host path (no device axis).
    """

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        names = tuple(self.axis_names)
        sizes = tuple(int(s) for s in self.axis_sizes)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)
        if len(names) != len(sizes):
            raise ValueError(
                f"axis_names {names} and axis_sizes {sizes} length mismatch")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names in {names}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"axis sizes must be >= 1, got {sizes}")

    @classmethod
    def host(cls) -> "Topology":
        """No device axis: the whole logical program runs on one device."""
        return cls((), ())

    @classmethod
    def flat(cls, num_devices: int, axis_name: str = "proc") -> "Topology":
        """One flat device axis."""
        return cls((axis_name,), (num_devices,))

    @classmethod
    def pods(cls, rows: int, cols: int, cross_axis: str = "pod",
             intra_axis: str = "proc") -> "Topology":
        """``rows`` pods x ``cols`` devices per pod (cross-pod axis outer)."""
        if rows < 1 or cols < 1:
            raise ValueError(f"pods({rows}, {cols}): both sizes must be >= 1")
        return cls((cross_axis, intra_axis), (rows, cols))

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    @property
    def is_host(self) -> bool:
        return self.ndim == 0

    @property
    def num_devices(self) -> int:
        return int(math.prod(self.axis_sizes)) if self.axis_sizes else 1

    def lp(self, num_procs: int) -> int:
        """Logical procs per device: P / D, validating divisibility."""
        d = self.num_devices
        if num_procs % d:
            raise ValueError(
                f"logical procs {num_procs} must divide over the "
                f"{d}-device topology {self.label}")
        return num_procs // d

    @classmethod
    def from_label(cls, label: str) -> "Topology":
        """The topology whose :attr:`label` is ``label`` (default axis
        names): 'host', 'flat_1x<d>' or 'pods_<r>x<c>'."""
        kind, _, dims = label.partition("_")
        sizes = [int(x) for x in dims.split("x")] if dims else []
        if kind == "host" and not sizes:
            return cls.host()
        if kind == "flat" and len(sizes) == 2 and sizes[0] == 1:
            return cls.flat(sizes[1])
        if kind == "pods" and len(sizes) == 2:
            return cls.pods(*sizes)
        raise ValueError(f"not a topology label: {label!r}")

    @property
    def label(self) -> str:
        """Stable key: 'host', 'flat_1x8', 'pods_2x4', ..."""
        if self.is_host:
            return "host"
        if self.ndim == 1:
            return f"flat_1x{self.axis_sizes[0]}"
        return "pods_" + "x".join(str(s) for s in self.axis_sizes)


def resolve(topology: Optional[Topology], default_devices: Optional[int] = None,
            *, device=None, axis_name: str = "proc") -> Topology:
    """The device topology a distributed program runs on, checked against
    the process group before any work.

    ``topology`` None means flat over ``default_devices`` (the group's
    world size when that is None too). The host topology is refused: its
    callers run the host-path generators. A topology of D devices needs
    D == the world size of the default group; with no group only D == 1
    runs (one device, no collectives). With a group, its backend must
    carry tensors on ``device`` (:func:`spmd.check_backend`). Raises
    ``ValueError`` naming both numbers.
    """
    if topology is None:
        topology = Topology.flat(default_devices if default_devices
                                 is not None else spmd.device_count(),
                                 axis_name)
    if topology.is_host:
        raise ValueError(
            "host topology has no devices to spread over: run the host-path "
            "generator (generate_*_host) instead")
    d, world = topology.num_devices, spmd.world_size()
    if spmd.group_active():
        if d != world:
            raise ValueError(
                f"topology {topology.label} spans {d} devices but the "
                f"process group's world size is {world}: run one process "
                "per device of the topology")
        if device is not None:
            spmd.check_backend(device)
    elif d != 1:
        raise ValueError(
            f"topology {topology.label} spans {d} devices and needs a "
            f"torch.distributed process group of world size {d}, one "
            f"process per device; none is initialised (world size "
            f"{world}): start the run with torchrun or call "
            "init_process_group first")
    return topology


#: Subgroups of each pods topology, built once per default group:
#: {label: (world group, intra-pod groups, cross-pod groups)}.
_POD_GROUPS: dict = {}


def pod_groups(topology: Topology):
    """(intra, cross): this rank's process subgroups on ``pods(r, c)``.

    ``intra`` holds the c chips of this rank's pod (group rank = chip),
    ``cross`` the r pods' ranks of this rank's chip column (group rank =
    pod). ``dist.new_group`` is a collective: every rank builds all r + c
    groups, pods first then columns, in one fixed order, and the groups
    are cached by label for the life of the default group.
    """
    if topology.ndim != 2:
        raise ValueError(f"pod groups need a 2-D topology, got "
                         f"{topology.label}")
    r, c = topology.axis_sizes
    world = dist.group.WORLD
    cached = _POD_GROUPS.get(topology.label)
    if cached is None or cached[0] is not world:
        intra = [dist.new_group([p * c + j for j in range(c)])
                 for p in range(r)]
        cross = [dist.new_group([p * c + j for p in range(r)])
                 for j in range(c)]
        cached = _POD_GROUPS[topology.label] = (world, intra, cross)
    pod, chip = divmod(spmd.rank(), c)
    return cached[1][pod], cached[2][chip]
