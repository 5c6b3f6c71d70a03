"""Plain PyTorch versions of every kernel (the correctness contracts).

These are the JAX package's ``repro.kernels.ref`` oracles in torch, over a
single row or a ``(rows, m)`` batch. The CPU path runs them, and the
kernels are held against them on the card.
"""
from __future__ import annotations

import torch


def resolve_step_ref(ptr: torch.Tensor) -> torch.Tensor:
    """One pointer-doubling pass along the last axis: ptr'[j] = ptr[ptr[j]].

    Returns a new tensor: the pass reads only the old pointers."""
    return torch.gather(ptr, -1, ptr.long())


def gather_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[..., k] = src[..., clip(idx[..., k], 0, m-1)] along the last axis.

    ``src`` and ``idx`` have the same rank: (m,) with (n,), or (rows, m)
    with (rows, n).
    """
    m = src.shape[-1]
    return torch.gather(src, -1, idx.clamp(0, m - 1).long())


def histogram_ref(values: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Bincount of int32 values in [0, num_bins), out-of-range ignored.

    ``values`` (n,) gives (num_bins,); (rows, n) gives (rows, num_bins).
    """
    rows = values.reshape(1, -1) if values.ndim == 1 else values
    ok = (rows >= 0) & (rows < num_bins)
    v = torch.where(ok, rows, num_bins).long()
    counts = torch.zeros((rows.shape[0], num_bins + 1), dtype=torch.int32,
                         device=values.device)
    counts.scatter_add_(1, v, torch.ones_like(v, dtype=torch.int32))
    return counts[0, :num_bins] if values.ndim == 1 \
        else counts[:, :num_bins]
