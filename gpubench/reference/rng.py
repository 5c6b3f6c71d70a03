"""Counter-based RNG of the graph generators, in plain PyTorch.

A frozen copy of the program's draws, written again from their
definition so that the benchmark's reference shares no code with the
program under test: ``jax.random``'s threefry2x32 in its partitionable
layout,

  key(s)          = (0, s)
  fold_in(k, d)   = threefry2x32(k, (0, d))
  device_key      = fold_in(fold_in(key(seed), stream), rank)
  bits32(k, n)[i] = x0 ^ x1 of threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))
  uniform(k, n)   = bitcast_f32((bits >> 9) | 0x3F800000) - 1

Unsigned 32-bit words are held in int64 tensors and masked after every
add and shift.
"""
from __future__ import annotations

import torch

STREAM_PBA_URN = 0
STREAM_PBA_INTERFACTION_COIN = 1
STREAM_PBA_INTERFACTION_PROC = 2
STREAM_PBA_PHASE2_URN = 3
STREAM_CFREE_RMAT = 10

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key, x0, x1):
    """The 20-round threefry2x32 cipher on Python ints or int64 tensors
    of uint32 words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & MASK32
    return x0, x1


def device_key(seed: int, stream: int, rank: int):
    """The key of ``rank``'s draws in ``stream`` under ``seed``."""
    if not 0 <= int(seed) < 2**31:
        raise ValueError(f"seed must lie in [0, 2**31), got {seed}")
    k = threefry2x32((0, int(seed)), 0, int(stream) & MASK32)
    return threefry2x32(k, 0, int(rank) & MASK32)


def bits(key, n: int, device=None) -> torch.Tensor:
    """The first ``n`` words of the key's stream, int64 (n,)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key, i >> 32, i & MASK32)
    return x0 ^ x1


def uniform_slots(key, bounds: torch.Tensor) -> torch.Tensor:
    """``r_j ~ U[0, bounds_j)`` as int32, one word per entry."""
    b = bits(key, bounds.numel(), bounds.device)
    return (b % bounds.to(torch.int64)).to(torch.int32)


def coin(key, n: int, prob: float, device=None,
         threshold_dtype=torch.float32) -> torch.Tensor:
    """Bernoulli(prob) as bool (n,): a float32 uniform against ``prob``
    held in ``threshold_dtype`` (float32 is the generators' contract)."""
    b = (bits(key, n, device) >> 9) | 0x3F800000
    u = b.to(torch.int32).view(torch.float32) - 1.0
    p = torch.tensor(prob, dtype=threshold_dtype).to(torch.float32)
    return u < p.to(device)


def uniform_ints(key, n: int, upper: int, device=None) -> torch.Tensor:
    """Uniform int32 in [0, upper)."""
    return (bits(key, n, device) % int(upper)).to(torch.int32)
