"""Logical-processors-over-devices blocking primitives.

The same blocked-layout contract as the JAX package's
``runtime/blocking.py``: a logical (P, P, *rest) matrix, row q = data from
logical proc q, column r = data for logical proc r, is stored as an
(lp, P, *rest) block per device, P = lp * D (``Topology.lp``), device d
holding rows [d*lp, (d+1)*lp), and the transpose returns the same layout
of X.T: out[i, q] == X[q, d*lp + i].

  device_index       this device's linear index (the process rank)
  logical_ranks      the global logical ids of this device's block
  map_logical        run a per-logical-proc body over the block
  transpose_counts   the blocked transpose of a (P, P) matrix (exchange 1)
  transpose_payload  the same with trailing payload dims (exchange 2)
  tail_mask / mask_tail   mask entries past a global total
  all_reduce_sum / all_reduce_max   across every device of the topology
  group_all_reduce_  in place over a process group (the DP gradient sync)
  gather_to_root / run_on_root   rank 0's part in the shard sinks

On the host topology, and on a one-device topology with no process
group, the whole block is local: the transpose is a swapaxes and the
reductions are the identity. Otherwise each device is one process of the
default ``torch.distributed`` group (``runtime/topology.py::resolve``
checks its world size), and the transpose is one ``all_to_all_single``
on a flat topology, or two on ``pods(r, c)``: intra-pod to the
destination chip, then cross-pod to the destination pod. Every route
computes the same permutation of the same values, so each topology gives
the host path's edges bit for bit.
"""
from __future__ import annotations

import json
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.runtime import spmd
from repro_torch.runtime.topology import Topology, pod_groups, resolve


#: Logical roles of the blocked-transpose entry points' axes (a copy of
#: the JAX package's ``runtime/blocking.py`` table): ``lp`` this device's
#: local proc, ``P`` the destination-rank axis, ``lp_dst`` / ``P_src``
#: their post-transpose duals (my local proc / the source rank), ``...``
#: trailing payload. ``analysis/flowcheck.py`` (FC002) pushes tagged
#: tensors through each entry point and checks that every all_to_all hop
#: moves exactly the ``dev_dst:<axis>`` role of its topology axis and that
#: the output carries the ``out`` roles.
AXIS_ROLES = {
    "transpose_counts": {"in": ("lp", "P"), "out": ("lp_dst", "P_src")},
    "transpose_payload": {"in": ("lp", "P", "..."),
                          "out": ("lp_dst", "P_src", "...")},
}


def collective(topo: Topology) -> bool:
    """Whether ``topo``'s exchanges run through the process group: a
    device topology under an initialised group. Host topologies, and a
    one-device topology with no group, stay local."""
    return not topo.is_host and spmd.group_active()


def device_index(topo: Topology) -> int:
    """This device's linear index in the topology, outer-major (pods(r,
    c): pod * c + chip): the process rank; 0 on a local topology."""
    return spmd.rank() if collective(topo) else 0


def logical_ranks(lp: int, topo: Topology, device=None) -> torch.Tensor:
    """The (lp,) int32 global logical ranks of this device's block:
    [d*lp, (d+1)*lp) for device d."""
    return device_index(topo) * lp + torch.arange(lp, dtype=torch.int32,
                                                  device=device)


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


def _all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_to_all_single`` of ``x``, split on its leading axis (one
    slab per group rank, in group-rank order); returns the received
    slabs stacked the same way."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _transpose_blocked(x: torch.Tensor, topo: Topology) -> torch.Tensor:
    """(lp, P, *rest) -> (lp, P, *rest) transpose of the logical matrix."""
    lp, p = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    if not collective(topo):
        if topo.num_devices != 1:
            resolve(topo)       # raises: D devices need a process group
        if lp != p:
            raise ValueError(
                f"one-device transpose needs the full (P, P) block, got "
                f"({lp}, {p})")
        return x.transpose(0, 1).contiguous()
    d = topo.num_devices
    if p != lp * d:
        raise ValueError(
            f"blocked shape ({lp}, {p}) inconsistent with topology "
            f"{topo.label} (expect P = lp * D = {lp * d})")
    if topo.ndim == 1:
        # [my_lp, dst_dev, dst_lp] -> slabs by destination device; the
        # received slabs are [src_dev, src_lp, my_lp].
        send = x.reshape((lp, d, lp) + rest).transpose(0, 1).contiguous()
        recv = _all_to_all(send)
        del send
        return recv.movedim(2, 0).reshape((lp, p) + rest)
    if topo.ndim == 2:
        r, c = topo.axis_sizes
        intra, cross = pod_groups(topo)
        # The column index is pod-major: q' = (r'*c + c')*lp + i'.
        # Hop 1, intra-pod, to the destination chip column:
        # [my_lp, r', c', i'] -> slabs by c'; received
        # [src_chip, src_lp, r', i'].
        send = x.reshape((lp, r, c, lp) + rest).permute(
            (2, 0, 1, 3) + tuple(range(4, 4 + len(rest)))).contiguous()
        hop1 = _all_to_all(send, intra)
        del send
        # Hop 2, cross-pod, to the destination pod: slabs by r';
        # received [src_pod, src_chip, src_lp, my_lp].
        send = hop1.movedim(2, 0).contiguous()
        del hop1
        hop2 = _all_to_all(send, cross)
        del send
        return hop2.movedim(3, 0).reshape((lp, p) + rest)
    raise NotImplementedError(
        f"distributed transpose supports 1-D and 2-D topologies, got "
        f"{topo.ndim}-D {topo.label}")


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


def tail_mask(rank, chunk: int, total: int, device=None) -> torch.Tensor:
    """Liveness mask (chunk,) for rank-contiguous ranges over ``total``
    items: rank r owns global indices [r*chunk, (r+1)*chunk); entries
    past ``total`` (the last rank's ragged tail) are False."""
    j = torch.arange(chunk, dtype=torch.int64, device=device)
    return int(rank) * chunk + j < total


def mask_tail(arrays, rank, chunk: int, total: int, fill=-1):
    """Each (chunk,) array of ``arrays`` with its entries past ``total``
    replaced by ``fill``; returns a tuple."""
    live = tail_mask(rank, chunk, total, arrays[0].device)
    return tuple(torch.where(live, a, fill) for a in arrays)


def _all_reduce(x, topo: Topology, op: str, device):
    if not collective(topo):
        return x
    op = getattr(dist.ReduceOp, op)
    if isinstance(x, torch.Tensor):
        out = x.clone()
        dist.all_reduce(out, op=op)
        return out
    out = torch.tensor([x], dtype=torch.int64, device=device)
    dist.all_reduce(out, op=op)
    return int(out)


def all_reduce_sum(x, topo: Topology, device=None):
    """Sum over every device of the topology: a tensor for a tensor (on
    its device), an int for a Python int (reduced on ``device``); the
    identity on a local topology."""
    return _all_reduce(x, topo, "SUM", device)


def all_reduce_max(x, topo: Topology, device=None):
    """:func:`all_reduce_sum` with the maximum."""
    return _all_reduce(x, topo, "MAX", device)


def group_all_reduce_(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """``x`` reduced in place by ``op`` ("SUM" or "MAX") over ``group``
    (a ``torch.distributed`` group, default the world); the identity with
    no process group. Returns ``x``."""
    if spmd.group_active():
        dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=group)
    return x


def gather_to_root(parts, topo: Topology) -> Optional[tuple]:
    """Rank 0's concatenation, in rank order, of every rank's 1-D tensors
    ``parts`` (one length per rank, the same for each part; the lengths
    may differ across ranks); None on the other ranks. The lengths go
    first, then the parts padded to the longest, in one gather. On a
    local topology, ``parts`` itself."""
    if not collective(topo):
        return tuple(parts)
    x = torch.stack(tuple(parts))
    k, n = x.shape
    sizes = [torch.zeros(1, dtype=torch.int64, device=x.device)
             for _ in range(spmd.world_size())]
    dist.all_gather(sizes, torch.tensor([n], dtype=torch.int64,
                                        device=x.device))
    sizes = [int(s) for s in sizes]
    width = max(max(sizes), 1)
    padded = torch.full((k, width), -1, dtype=x.dtype, device=x.device)
    padded[:, :n] = x
    del x
    root = spmd.rank() == 0
    slabs = [torch.empty_like(padded) for _ in sizes] if root else None
    dist.gather(padded, slabs, dst=0)
    if not root:
        return None
    out = torch.cat([s[:, :m] for s, m in zip(slabs, sizes)], dim=1)
    return tuple(out)


def run_on_root(fn: Callable, topo: Topology, device):
    """``fn()`` run on rank 0 alone, its JSON-serialisable result returned
    on every rank (the length, then the UTF-8 bytes, broadcast on
    ``device``). An ``OSError`` or ``ValueError`` that ``fn`` raises on
    rank 0 raises there and, as a ``ValueError``, on every other rank, so
    no rank is left waiting on a collective. On a local topology, ``fn()``.
    """
    if not collective(topo):
        return fn()
    root = spmd.rank() == 0
    error, data = None, b""
    if root:
        try:
            msg = {"value": fn()}
        except (OSError, ValueError) as e:
            error, msg = e, {"error": f"{type(e).__name__}: {e}"}
        data = json.dumps(msg).encode()
    size = torch.tensor([len(data)], dtype=torch.int64, device=device)
    dist.broadcast(size, src=0)
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device) \
        if root else torch.empty(int(size), dtype=torch.uint8,
                                 device=device)
    dist.broadcast(buf, src=0)
    if error is not None:
        raise error
    msg = json.loads(buf.cpu().numpy().tobytes())
    if "error" in msg:
        raise ValueError(f"rank 0 failed: {msg['error']}")
    return msg["value"]
