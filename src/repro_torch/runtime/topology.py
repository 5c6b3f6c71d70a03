"""Device-topology description for the exchange layer.

The same dataclass as the JAX package's ``runtime/topology.py`` (class and
field names match, so a spec that names a topology fingerprints alike),
without the mesh building:

  Topology.host()        no device axis: the whole logical program on one
                         device (transposes degenerate to local swapaxes)
  Topology.flat(d)       one ``proc`` axis of d devices
  Topology.pods(r, c)    r pods x c devices per pod

The logical-over-physical factorization P = lp * D is :meth:`lp`. This
package runs the one-device topologies so far (host, and ``flat(1)``:
one GPU); the others are accepted by the planner and refused with the
ROADMAP item that will port them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


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
