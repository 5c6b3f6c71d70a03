"""Logical-processors-over-devices blocking primitives (one device).

The same blocked-layout contract as the JAX package's
``runtime/blocking.py``: a logical (P, P, *rest) matrix, row q = data from
logical proc q, column r = data for logical proc r, is stored as an
(lp, P, *rest) block per device, and the transpose returns the same layout
of X.T. With one device -- the host topology, or ``Topology.flat(1)``,
one GPU that needs no torch.distributed -- lp == P: the blocked transpose
(reshape to (lp, 1, lp), an all_to_all over one rank, moveaxis) reduces
to the local swapaxes and the all-reduce is the identity. Topologies of
more than one device (torch.distributed) are a later slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.runtime.topology import Topology


def require_one_device(topo: Topology) -> None:
    """Raise for a topology of more than one device (not ported yet)."""
    if topo.num_devices != 1:
        raise NotImplementedError(
            f"topology {topo.label}: only one-device topologies (host, "
            "flat(1)) are ported; multi-GPU topologies are ROADMAP Queue 1 "
            "item 9")


def logical_ranks(lp: int, topo: Topology, device=None) -> torch.Tensor:
    """The (lp,) global logical ranks of this device's block: arange(lp)
    on a one-device topology."""
    require_one_device(topo)
    return torch.arange(lp, dtype=torch.int32, device=device)


def map_logical(fn: Callable, ranks: torch.Tensor, *args):
    """Run a per-logical-proc body over the block, one rank at a time.

    fn(rank: int, *slices) -> tensor or tuple of tensors; ``ranks`` is the
    (lp,) tensor of global rank ids and each of ``args`` has leading dim
    lp. Returns the outputs with a new leading lp axis, written row by row
    into preallocated tensors (a stack would hold every row twice).
    """
    out = None
    for i, rank in enumerate(ranks.tolist()):
        res = fn(rank, *(a[i] for a in args))
        parts = res if isinstance(res, tuple) else (res,)
        if out is None:
            out = tuple(torch.empty((len(ranks),) + p.shape, dtype=p.dtype,
                                    device=p.device) for p in parts)
        for o, p in zip(out, parts):
            o[i] = p
    return out if isinstance(res, tuple) else out[0]


def _transpose_blocked(x: torch.Tensor, topo: Topology) -> torch.Tensor:
    """(lp, P, *rest) -> (lp, P, *rest) transpose of the logical matrix."""
    require_one_device(topo)
    lp, p = x.shape[0], x.shape[1]
    if lp != p:
        raise ValueError(
            f"one-device transpose needs the full (P, P) block, got ({lp}, {p})")
    return x.transpose(0, 1).contiguous()


def transpose_counts(counts: torch.Tensor, topo: Topology) -> torch.Tensor:
    """counts[i, q] = "proc i sends this many to q" -> recv[i, q] = "q
    sends this many to proc i" (exchange 1)."""
    if counts.ndim != 2:
        raise ValueError(f"counts must be (lp, P), got {tuple(counts.shape)}")
    return _transpose_blocked(counts, topo)


def transpose_payload(buf: torch.Tensor, topo: Topology) -> torch.Tensor:
    """buf[i, q, ...] = payload proc i made for q -> recv[i, q, ...] =
    payload q made for proc i (exchange 2)."""
    if buf.ndim < 3:
        raise ValueError(
            f"payload must be (lp, P, *payload) with >=1 payload dim, got "
            f"{tuple(buf.shape)}")
    return _transpose_blocked(buf, topo)


def all_reduce_sum(x, topo: Topology):
    """Sum across every device of the topology: the identity on one."""
    require_one_device(topo)
    return x
