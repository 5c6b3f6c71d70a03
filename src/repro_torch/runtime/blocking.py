"""Logical-processors-over-devices blocking primitives (host topology).

The same blocked-layout contract as the JAX package's
``runtime/blocking.py``: a logical (P, P, *rest) matrix, row q = data from
logical proc q, column r = data for logical proc r, is stored as an
(lp, P, *rest) block per device, and the transpose returns the same layout
of X.T. On the host topology (P logical procs on one device, lp == P) the
transpose is a swapaxes and the all-reduce is the identity. The flat and
pods topologies (torch.distributed) are a later slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.runtime.topology import Topology


def _require_host(topo: Topology) -> None:
    if not topo.is_host:
        raise NotImplementedError(
            f"topology {topo.label}: only the host topology is ported; "
            "device topologies are ROADMAP Queue 1 item 9")


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
    _require_host(topo)
    lp, p = x.shape[0], x.shape[1]
    if lp != p:
        raise ValueError(
            f"host transpose needs the full (P, P) block, got ({lp}, {p})")
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
    """Sum across every device of the topology: the identity on host."""
    _require_host(topo)
    return x
