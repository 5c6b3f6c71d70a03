"""The comparison that decides ``correct``: the program's graphs against
the plain reference's.

A graph is compared as a multiset of edges by a digest that does not
depend on the order the edges come in: the edge count and two sums, mod
2^64, of a 64-bit mix (splitmix64's finalizer) of the edge's key
``u << 32 | v`` under two salts. Sums add, so the digest of a graph made
in blocks, or spread over ranks, is the sum of the blocks' digests. One
edge changed, dropped or added changes both sums but with probability
about 2^-64 each. Where edge t of the program's output is edge t of the
graph (the R-MAT host path), sampled positions are also compared one by
one.
"""
from __future__ import annotations

import torch

_M64 = (1 << 64) - 1
_SALTS = (0x243F6A8885A308D3, 0x13198A2E03707344)
_GAMMA = 0x9E3779B97F4A7C15
_MUL1 = 0xBF58476D1CE4E5B9
_MUL2 = 0x94D049BB133111EB
CHUNK = 1 << 25


def signed64(x: int) -> int:
    """A 64-bit word as the signed int64 that torch holds."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def unsigned64(x: int) -> int:
    return x & _M64


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    z = z + signed64(_GAMMA)
    z = (z ^ _shr(z, 30)) * signed64(_MUL1)
    z = (z ^ _shr(z, 27)) * signed64(_MUL2)
    return z ^ _shr(z, 31)


def digest(u: torch.Tensor, v: torch.Tensor) -> tuple[int, int, int]:
    """(edges, sum 1, sum 2) of the multiset of (u, v) pairs."""
    u, v = u.reshape(-1), v.reshape(-1)
    n, s1, s2 = u.numel(), 0, 0
    for a in range(0, n, CHUNK):
        key = (u[a:a + CHUNK].long() << 32) | (v[a:a + CHUNK].long()
                                               & 0xFFFFFFFF)
        s1 += int(_mix(key ^ signed64(_SALTS[0])).sum())
        s2 += int(_mix(key ^ signed64(_SALTS[1])).sum())
    return n, s1 & _M64, s2 & _M64


def blocks_digest(blocks) -> tuple[int, int, int]:
    """The digest of a graph given as (u, v) blocks: the sum of theirs."""
    n, s1, s2 = 0, 0, 0
    for u, v in blocks:
        dn, d1, d2 = digest(u, v)
        n, s1, s2 = n + dn, (s1 + d1) & _M64, (s2 + d2) & _M64
    return n, s1, s2


def sample_positions(seed: int, edges: int, count: int,
                     device) -> torch.Tensor:
    """``count`` sorted edge positions in [0, edges), drawn from ``seed``
    on the host (the same on any device)."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.randint(0, edges, (count,), generator=gen, dtype=torch.int64)
    return torch.sort(t).values.to(device)
