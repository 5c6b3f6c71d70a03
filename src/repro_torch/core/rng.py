"""Counter-based parallel RNG for the graph generators (torch).

Every random draw is keyed by ``(seed, stream, rank)`` and reproduces the
JAX package's ``jax.random`` threefry2x32 stream bit for bit (partitionable
layout), so the same spec draws the same graph on either package:

  key(s)          = (0, s)
  fold_in(k, d)   = threefry2x32(k, (0, d))
  bits32(k, n)[i] = x0 ^ x1 of threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))
  uniform(k, n)   = bitcast_f32((bits >> 9) | 0x3F800000) - 1

Unsigned 32-bit words are held in int64 tensors and masked after every
add and shift, since torch's uint32 coverage is thin. A draw of n words
holds a few (n,) int64 temporaries, so callers draw per rank (or per chunk
of ranks), never a whole (P, n) block at once. Keys are pairs of Python
ints: keys are derived on the host, words on the tensor's device.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

# Stream ids (namespaces). Keep stable: the JAX package uses the same ids.
STREAM_PBA_URN = 0
STREAM_PBA_INTERFACTION_COIN = 1
STREAM_PBA_INTERFACTION_PROC = 2
STREAM_PBA_PHASE2_URN = 3
STREAM_PK_NOISE_COIN = 4
STREAM_PK_NOISE_DIGIT = 5
STREAM_PK_XOR = 6
STREAM_ANALYSIS = 7
STREAM_DATA_WALKS = 8
STREAM_CFREE_BA = 9
STREAM_CFREE_RMAT = 10
STREAM_CFREE_ER_U = 11
STREAM_CFREE_ER_V = 12

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """The 20-round threefry2x32 block cipher of ``jax.random``.

    ``x0``/``x1`` are Python ints or int64 tensors of uint32 words; the
    result has the same kind. Tensor inputs are not modified.
    """
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed in [0, 2**31)."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must lie in [0, 2**31), got {seed}")
    return (0, seed)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: a new key from ``k`` and a uint32 word."""
    return threefry2x32(k, 0, int(data) & MASK32)


def device_key(seed: Union[int, Key], stream: int, rank: int) -> Key:
    """Key for ``rank``'s draws in ``stream``."""
    k = key(seed) if isinstance(seed, int) else seed
    return fold_in(fold_in(k, stream), rank)


def bits(k: Key, shape: Union[int, Sequence[int]], device=None,
         offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as an int64 tensor of words.

    Element i (row-major flat index) is drawn on its own, so prefixes are
    stable across sizes. With ``offset``, the result holds the flat
    elements ``[offset, offset + n)`` of a larger draw of the same key,
    bit for bit: a draw too large for memory is made chunk by chunk.
    """
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for s in shape:
        n *= int(s)
    offset = int(offset)
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k, i >> 32, i & MASK32)
    return (x0 ^ x1).reshape(shape)


def uniform(k: Key, shape: Union[int, Sequence[int]], device=None,
            offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(k, shape)``: float32 in [0, 1); ``offset`` as
    in :func:`bits`."""
    b = (bits(k, shape, device, offset) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0


def uniform_slots(k: Key, n: int, bounds: torch.Tensor) -> torch.Tensor:
    """``r_j ~ U[0, bounds_j)`` for j in [0, n) as int32 (``bounds`` >= 1)."""
    b = bits(k, n, bounds.device)
    return (b % bounds.to(torch.int64)).to(torch.int32)


def coin(k: Key, n: int, prob: float, device=None,
         offset: int = 0) -> torch.Tensor:
    """Bernoulli(prob) coin flips as bool (n,), compared in float32;
    ``offset`` as in :func:`bits`."""
    p = torch.tensor(prob, dtype=torch.float32, device=device)
    return uniform(k, n, device, offset) < p


def uniform_ints(k: Key, n: int, upper: int, device=None) -> torch.Tensor:
    """Uniform int32 in [0, upper) for a scalar ``upper``."""
    return (bits(k, n, device) % (int(upper) & MASK32)).to(torch.int32)
