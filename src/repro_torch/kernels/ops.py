"""The kernel entry points the generators call.

Each routes by the tensor's device (``kernels/dispatch.py``): the CUDA
kernel on the card, the plain version on the CPU. Unlike the JAX
package's ``ops``, nothing here falls back past a size bound: the Hopper
gather serves any source length, so :data:`FALLBACK_EVENTS` stays empty
and :func:`fallback_counts` returns ``{}``. Both are kept so
``GenStats.fallback_counts`` means the same in both packages.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import band_compact as _band_compact
from repro_torch.kernels import edge_resolve
from repro_torch.kernels import histogram as _histogram

_COUNTERS = (edge_resolve.launches, _histogram.launches,
             _band_compact.launches)

#: Kernel-fallback counters, keyed like the JAX package's. Never written.
FALLBACK_EVENTS: dict[str, int] = {}


def fallback_counts() -> dict[str, int]:
    """Snapshot of the fallback counters (always empty here)."""
    return dict(FALLBACK_EVENTS)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: n for table in _COUNTERS for name, n in table.items()}


def reset_launch_counts() -> None:
    for table in _COUNTERS:
        for name in table:
            table[name] = 0


def resolve_step(ptr: torch.Tensor) -> torch.Tensor:
    """One ptr[ptr] pass along the last axis, (m,) or (rows, m)."""
    return edge_resolve.resolve_step(ptr)


def gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values = src[..., clip(idx)] along the last axis: a 1-D shared
    source with any-rank indices, or batched rows (r, m) with (r, n).
    Source rows of ``CHUNKED_MIN_ENTRIES`` or more go through the chunked
    entry point, as the JAX package's sources past its resident bound do
    (the same kernel here)."""
    if src.shape[-1] >= edge_resolve.CHUNKED_MIN_ENTRIES:
        return edge_resolve.gather_chunked(src, idx)
    return edge_resolve.gather(src, idx)


def histogram(values: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Bincount into [0, num_bins), out-of-range ignored, per row."""
    return _histogram.histogram(values, num_bins)


def band_compact(u: torch.Tensor, v: torch.Tensor, band: torch.Tensor,
                 block_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row, the band-selected (u, v) pairs stably at the front, -1
    elsewhere, truncated to ``block_cap`` columns."""
    return _band_compact.band_compact(u, v, band, block_cap)
