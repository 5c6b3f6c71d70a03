"""Process grids for sharded LM serving: the port's counterpart of the JAX
package's ``Topology.build_mesh()`` and of the collectives XLA's SPMD
partitioner inserts.

A :class:`ProcessMesh` lays the default process group's ranks over named
axes, outermost first (``("data", "model")`` or ``("pod", "data",
"model")``). The rank is the grid's linear index, row-major, as on the
generators' topologies (``runtime/spmd.py``). Every rank builds, in one
fixed order, one process group per line of the grid for each set of axes
(the ranks that differ only in those axes' coordinates), so a collective
over ``"model"`` runs among the ranks of one model row, and one over
``("pod", "data")`` among those of one batch column. Per axis (a name or
a tuple of names in mesh order):

  axis_size / axis_index     the axis's size and this rank's coordinate
  all_gather(x, axis, dim)   the ranks' blocks concatenated along ``dim``
                             in axis order
  reduce_scatter(x, axis, dim)   the sum over the axis, this rank keeping
                             its block of ``dim``
  all_reduce(x, axis, op)    "sum" or "max" over the axis, in place

Under autograd (grad mode on and ``x`` requiring grad) each is a
``torch.autograd.Function`` with its adjoint, for the training path:
``all_gather``'s is the reduce-scatter of the gradient (``grad="sum"``:
the ranks along the axis computed on different rows, so their parts
add) or this rank's block of it (``grad="slice"``: they computed the
same thing, and every rank holds the whole gradient already);
``reduce_scatter``'s is the all-gather. An all-reduce sum comes as
Megatron's conjugate pair: :meth:`ProcessMesh.reduce_from` ("g": summed
forward, the gradient passed through, for partial sums whose result every
rank then uses alike) and :meth:`ProcessMesh.copy_to` ("f": the identity
forward, the gradient summed, for a tensor every rank holds whole that
feeds each rank's own part of a computation). ``all_reduce`` itself stays
in place and refuses a tensor that requires grad. With grad mode off
(the serving path runs under ``torch.inference_mode``) every call is the
plain c10d call it was.

Each is the identity on an axis of size 1, and only there: a mesh of more
than one device needs a process group of exactly its size, with a backend
that carries the mesh's device (NCCL for the card, gloo for the CPU), and
refuses to be built otherwise (``ValueError``, before any work). No
collective is ever replaced by local arithmetic.

``shape`` (a dict of axis sizes) and ``axis_names`` are what the sharding
rules read, as they read a JAX mesh's.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.runtime import spmd
from repro_torch.runtime.topology import Topology

Axes = Union[str, Sequence[str]]

# torch 2.13 renames the tensor-to-tensor collectives; both take the same
# arguments.
_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class ProcessMesh:
    """Named axes over the ranks of the default process group."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int],
                 device=None):
        topo = Topology(tuple(axis_names), tuple(axis_sizes))
        self.axis_names = topo.axis_names
        self.axis_sizes = topo.axis_sizes
        self.shape = dict(zip(self.axis_names, self.axis_sizes))
        self.size = topo.num_devices
        self.device = None if device is None else torch.device(device)
        world = spmd.world_size()
        if spmd.group_active():
            if self.size != world:
                raise ValueError(
                    f"mesh {self.shape} spans {self.size} devices but the "
                    f"process group's world size is {world}: run one "
                    "process per device of the mesh")
            if self.device is not None:
                spmd.check_backend(self.device)
        elif self.size != 1:
            raise ValueError(
                f"mesh {self.shape} spans {self.size} devices and needs a "
                f"torch.distributed process group of world size "
                f"{self.size}; none is initialised: start the run with "
                "torchrun or call init_process_group first")
        self.rank = spmd.rank()
        coords, rest = [], self.rank
        for size in reversed(self.axis_sizes):
            rest, c = divmod(rest, size)
            coords.append(c)
        self.coords = dict(zip(self.axis_names, reversed(coords)))
        self._groups: dict = {}
        if self.size > 1:
            self._build_groups()

    @classmethod
    def build(cls, topology: Topology, device=None) -> "ProcessMesh":
        """The mesh of a ``Topology`` (``launch.mesh.make_production_mesh``
        returns one)."""
        return cls(topology.axis_names, topology.axis_sizes, device)

    def _build_groups(self) -> None:
        """One group per line of the grid for every set of axes whose size
        is neither 1 nor the world's, every rank calling ``new_group`` in
        the same order; the world's own set uses the default group."""
        names = self.axis_names
        for r in range(1, len(names) + 1):
            for subset in itertools.combinations(names, r):
                n = math.prod(self.shape[a] for a in subset)
                if n == 1:
                    continue
                if n == self.size:
                    self._groups[subset] = dist.group.WORLD
                    continue
                others = [a for a in names if a not in subset]
                mine = None
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in others)):
                    ranks = sorted(self._linear({**dict(zip(others, fixed)),
                                                 **dict(zip(subset, free))})
                                   for free in itertools.product(
                                       *(range(self.shape[a])
                                         for a in subset)))
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = group
                self._groups[subset] = mine

    def _linear(self, coords: dict) -> int:
        out = 0
        for a, size in zip(self.axis_names, self.axis_sizes):
            out = out * size + coords[a]
        return out

    def _axes(self, axes: Axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in mesh {self.shape}")
        if list(axes) != [a for a in self.axis_names if a in axes]:
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes: Axes) -> int:
        """The product of the named axes' sizes (1 for an absent one)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def axis_index(self, axes: Axes) -> int:
        """This rank's linear coordinate over ``axes`` (major first)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = 0
        for a in axes:
            out = out * self.shape.get(a, 1) + self.coords.get(a, 0)
        return out

    def _group(self, axes: tuple):
        return self._groups[tuple(a for a in self.axis_names if a in axes)]

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int = 0,
                   grad: str = "sum") -> torch.Tensor:
        """The blocks ``x`` of the ranks along ``axes``, concatenated along
        ``dim`` in axis order (every block the same shape). Under autograd
        the gradient comes back reduce-scattered (``grad="sum"``) or as
        this rank's block (``grad="slice"``; see the module)."""
        axes = self._axes(axes)
        n = self.axis_size(axes)
        if n == 1:
            return x
        if _tracked(x):
            return _AllGather.apply(x, self, axes, dim, grad)
        return self._gather(x, axes, dim)

    def _gather(self, x, axes: tuple, dim: int) -> torch.Tensor:
        n = self.axis_size(axes)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _gather_single(out, x, group=self._group(axes))
        return out.view((n,) + tuple(x.shape)).movedim(0, dim).flatten(
            dim, dim + 1)

    def reduce_scatter(self, x: torch.Tensor, axes: Axes,
                       dim: int = 0) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axes``, each keeping its
        block of ``dim`` (which the axes' size must divide)."""
        axes = self._axes(axes)
        n = self.axis_size(axes)
        if n == 1:
            return x
        if _tracked(x):
            return _ReduceScatter.apply(x, self, axes, dim)
        return self._scatter(x, axes, dim)

    def _scatter(self, x, axes: tuple, dim: int) -> torch.Tensor:
        n = self.axis_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter over {axes} ({n} ranks): dim "
                             f"{dim} of {tuple(x.shape)} does not divide")
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
        _scatter_single(out, xm, group=self._group(axes))
        return out.movedim(0, dim)

    def all_reduce(self, x: torch.Tensor, axes: Axes,
                   op: str = "sum") -> torch.Tensor:
        """``x`` reduced by ``op`` ("sum" or "max") over the ranks along
        ``axes``; in place when ``x`` is contiguous."""
        axes = self._axes(axes)
        if self.axis_size(axes) == 1:
            return x
        if _tracked(x):
            raise ValueError("all_reduce works in place and has no "
                             "adjoint: use reduce_from or copy_to on a "
                             "tensor that requires grad")
        return self._reduce(x, axes, op)

    def _reduce(self, x, axes: tuple, op: str = "sum") -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self._group(axes))
        return x

    def reduce_from(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axes`` (in place, as
        :meth:`all_reduce`, unless ``x`` requires grad); its gradient
        passes through unchanged (Megatron's "g": every rank uses the sum
        alike, so each holds its whole gradient)."""
        axes = self._axes(axes)
        if self.axis_size(axes) == 1:
            return x
        if _tracked(x):
            return _ReduceFrom.apply(x, self, axes)
        return self._reduce(x, axes)

    def copy_to(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``x`` itself, whose gradient is summed over the ranks along
        ``axes`` (Megatron's "f": a tensor every rank holds whole, feeding
        each rank's own part of a computation)."""
        axes = self._axes(axes)
        if self.axis_size(axes) == 1 or not _tracked(x):
            return x
        return _CopyTo.apply(x, self, axes)

    def barrier(self) -> None:
        """Wait until every rank of the mesh gets here."""
        if self.size > 1:
            dist.barrier()

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank={self.rank})"


def _tracked(x: torch.Tensor) -> bool:
    """Whether autograd records operations on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, grad):
        if grad not in ("sum", "slice"):
            raise ValueError(f"grad={grad!r}: 'sum' or 'slice'")
        ctx.mesh, ctx.axes, ctx.dim, ctx.grad = mesh, axes, dim, grad
        return mesh._gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.mesh, ctx.axes, ctx.dim
        if ctx.grad == "sum":
            out = mesh._scatter(g, axes, dim)
        else:
            n = g.shape[dim] // mesh.axis_size(axes)
            out = g.narrow(dim, mesh.axis_index(axes) * n, n)
        return out, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh._scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._gather(g, ctx.axes, ctx.dim), None, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh._reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._reduce(g.clone(), ctx.axes), None, None


def build_mesh(axis_names: Sequence[str], axis_sizes: Sequence[int],
               device=None) -> ProcessMesh:
    """A :class:`ProcessMesh` over the default group (see the class)."""
    return ProcessMesh(axis_names, axis_sizes, device)

