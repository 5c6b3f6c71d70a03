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

from repro_torch.kernels import edge_resolve
from repro_torch.kernels import histogram as _histogram

#: Kernel-fallback counters, keyed like the JAX package's. Never written.
FALLBACK_EVENTS: dict[str, int] = {}


def fallback_counts() -> dict[str, int]:
    """Snapshot of the fallback counters (always empty here)."""
    return dict(FALLBACK_EVENTS)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {**edge_resolve.launches, **_histogram.launches}


def reset_launch_counts() -> None:
    for table in (edge_resolve.launches, _histogram.launches):
        for name in table:
            table[name] = 0


def resolve_step(ptr: torch.Tensor) -> torch.Tensor:
    """One ptr[ptr] pass along the last axis, (m,) or (rows, m)."""
    return edge_resolve.resolve_step(ptr)


def gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values = src[..., clip(idx)] along the last axis: a 1-D shared
    source with any-rank indices, or batched rows (r, m) with (r, n)."""
    return edge_resolve.gather(src, idx)


def histogram(values: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Bincount into [0, num_bins), out-of-range ignored, per row."""
    return _histogram.histogram(values, num_bins)
