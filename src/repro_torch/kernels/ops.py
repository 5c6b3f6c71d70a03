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

from repro_torch.core import rng as rng_lib
from repro_torch.kernels import band_compact as _band_compact
from repro_torch.kernels import cfree_expand as _cfree_expand
from repro_torch.kernels import edge_resolve
from repro_torch.kernels import histogram as _histogram
from repro_torch.kernels import pk_expand as _pk_expand

_COUNTERS = (edge_resolve.launches, _histogram.launches,
             _band_compact.launches, _pk_expand.launches,
             _cfree_expand.launches)

#: Words per chunk of PK's noise draws: a (levels, m) draw is made
#: ``DRAW_CHUNK`` flat elements at a time (``rng.bits``'s ``offset``), so
#: its int64 temporaries stay ~0.5 GiB each whatever the edge count.
DRAW_CHUNK = 1 << 26

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


def resolve_roots(ptr: torch.Tensor) -> torch.Tensor:
    """Every slot of ptr (m,) or (rows, m) resolved to the root of its
    chain, in place (the doubling pass's fixpoint); returns ``ptr``."""
    return edge_resolve.resolve_roots(ptr)


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


def histogram(values: torch.Tensor, num_bins: int,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Bincount into [0, num_bins), out-of-range ignored, per row; with a
    bool ``mask`` of the values' shape, only where it is set."""
    return _histogram.histogram(values, num_bins, mask)


def band_compact(u: torch.Tensor, v: torch.Tensor, band: torch.Tensor,
                 block_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row, the band-selected (u, v) pairs stably at the front, -1
    elsewhere, truncated to ``block_cap`` columns."""
    return _band_compact.band_compact(u, v, band, block_cap)


def pk_expand(t_local: torch.Tensor, base_digits, seed_u: torch.Tensor,
              seed_v: torch.Tensor, n0: int, e0: int, levels: int,
              noise: float, delete_prob: float, seed: int, rank: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kronecker expansion with the JAX package's ``ops.pk_expand``
    contract: with ``noise``, each (level, edge) digit is redrawn with
    that probability (keys ``(seed, STREAM_PK_NOISE_*, rank)``); with
    ``delete_prob``, each edge becomes (-1, -1) with that probability
    (key ``(seed, STREAM_PK_XOR, rank)``). Draws are made on the tensor's
    device, the flat (levels, m) draws in chunks of ``DRAW_CHUNK``."""
    m = t_local.shape[0]
    dev = t_local.device
    flip = redraw = None
    if noise > 0.0:
        ckey = rng_lib.device_key(seed, rng_lib.STREAM_PK_NOISE_COIN, rank)
        dkey = rng_lib.device_key(seed, rng_lib.STREAM_PK_NOISE_DIGIT, rank)
        flip = torch.empty((levels, m), dtype=torch.bool, device=dev)
        redraw = torch.empty((levels, m), dtype=torch.int32, device=dev)
        flat_flip, flat_redraw = flip.view(-1), redraw.view(-1)
        for a in range(0, levels * m, DRAW_CHUNK):
            n = min(DRAW_CHUNK, levels * m - a)
            flat_flip[a:a + n] = rng_lib.coin(ckey, n, noise, dev, offset=a)
            flat_redraw[a:a + n] = (rng_lib.bits(dkey, n, dev, offset=a)
                                    % e0).to(torch.int32)
    u, v = _pk_expand.pk_expand(t_local, base_digits, seed_u, seed_v, n0,
                                e0, levels, flip, redraw)
    del flip, redraw
    if delete_prob > 0.0:
        delkey = rng_lib.device_key(seed, rng_lib.STREAM_PK_XOR, rank)
        for a in range(0, m, DRAW_CHUNK):
            n = min(DRAW_CHUNK, m - a)
            # deleted where uniform < delete_prob (kept where >=)
            gone = rng_lib.coin(delkey, n, delete_prob, dev, offset=a)
            u[a:a + n].masked_fill_(gone, -1)
            v[a:a + n].masked_fill_(gone, -1)
    return u, v


def cfree_expand(t: torch.Tensor, words, *, model: str, n: int,
                 ba_degree: int, thresholds) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Communication-free endpoints of (m,) int32 global edge indices, pure
    in (words, t): ``core.cfree.cfree_endpoints``'s contract."""
    return _cfree_expand.cfree_expand(t, words, model=model, n=n,
                                      ba_degree=ba_degree,
                                      thresholds=thresholds)
