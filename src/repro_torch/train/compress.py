"""Int8 gradient compression with error feedback (the DP gradient sync).

The port of the JAX package's ``train/compress.py``: each gradient leaf
plus its error-feedback buffer is quantized to a per-tensor symmetric
int8 grid whose scale is the maximum over the data-parallel group, the
rounded values are summed over the group, and the mean is their sum times
the scale over the group's size; the quantization residual is carried to
the next step (EF-SGD), so the compression bias vanishes over steps.

The reference runs this under ``shard_map`` on stacked (D, ...) leaves;
here each rank of a ``torch.distributed`` group calls :func:`dp_sync` on
its own leaves. The rounded values are summed as float32 integers (exact,
as the reference's), so any order gives its values bit for bit. A call
makes three all-reduces whatever the number of leaves: the leaves' peaks
(max: the scale is monotone in the peak, so the maximum of the scales is
the scale of the maximum), the rounded values (sum), the group's size
(sum).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.runtime.blocking import group_all_reduce_


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale) with x ~ q * scale."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_buffers(grads):
    return tree_map(lambda _, g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads)


@torch.no_grad()
def compressed_psum(grads, error, group=None):
    """EF-int8 mean of a gradient tree over ``group`` (this rank's
    leaves). Returns (reduced grads in each leaf's dtype, new error
    buffers)."""
    gs = tree_leaves(grads)
    xs = [g.float() + e for g, e in zip(gs, tree_leaves(error))]
    peaks = torch.stack([torch.clamp(x.abs().max(), min=1e-12) for x in xs])
    group_all_reduce_(peaks, "MAX", group)
    # The scale as the reference's compiled program takes it: XLA rewrites
    # its division by 127 into a product with the float32 reciprocal.
    scales = peaks * torch.tensor(1 / 127.0, dtype=torch.float32,
                                  device=peaks.device)
    qs = [torch.clamp(torch.round(x / s), -127, 127)
          for x, s in zip(xs, scales)]
    # The residual rounded once: q * s is exact in float64 (q has 8 bits,
    # s 24), and so is x - q * s where q != 0 (|x - q s| <= s / 2). This is
    # what the reference's jitted x - q * scale computes: XLA contracts it
    # into a fused multiply-add.
    new_e = [(x.double() - q.double() * s.double()).float()
             for x, q, s in zip(xs, qs, scales)]
    total = torch.cat([q.reshape(-1) for q in qs])
    group_all_reduce_(total, "SUM", group)
    n = group_all_reduce_(torch.ones((), dtype=torch.float32,
                                     device=total.device), "SUM", group)
    red, at = [], 0
    for g, s in zip(gs, scales):
        part = total[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
        red.append(((part * s) / n).to(g.dtype))
    r, e = iter(red), iter(new_e)
    return (tree_map(lambda _, __: next(r), grads),
            tree_map(lambda _, __: next(e), grads))


def dp_sync(grads, error=None, group=None):
    """Data-parallel gradient sync: the EF-int8 mean of this rank's
    gradient tree over ``group`` (default the world; with no process
    group, a group of one). ``error``: this rank's buffers from the last
    call (None: zeros). Returns (reduced, new_error); every rank gets the
    same reduced mean."""
    if error is None:
        error = init_error_buffers(grads)
    return compressed_psum(grads, error, group)
