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


def band_compact_ref(u: torch.Tensor, v: torch.Tensor, band: torch.Tensor,
                     block_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable band compaction per row of (rows, e) int32 ``u``, ``v`` and
    bool ``band``: band entries move to the front in index order,
    everything else is -1, truncated to ``block_cap`` columns (fewer when
    e < block_cap). The key/argsort/take sequence of the JAX package's
    oracle; keys are unique, so the argsort needs no stability."""
    e = u.shape[-1]
    j = torch.arange(e, dtype=torch.int64, device=u.device)
    order = torch.argsort(torch.where(band, j, e + j), dim=-1)
    order = order[..., :block_cap]
    uu = torch.gather(torch.where(band, u, -1), -1, order)
    vv = torch.gather(torch.where(band, v, -1), -1, order)
    return uu, vv
