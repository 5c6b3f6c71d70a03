"""Plain reference of the communication-free R-MAT graph.

Edge t of the graph is a pure function of the seed and t: four stream
words come from one threefry draw under (seed, ``STREAM_CFREE_RMAT``,
rank 0); at each of log2 n levels a murmur-style uint32 hash of (words,
t, level) picks a quadrant against the cumulative probabilities a, a+b,
a+b+c held as uint32 thresholds (``int(s * 2^32)``, the last clamped to
2^32 - 1), and the quadrant's two bits are appended to u and v. Written
again here in plain PyTorch from that definition; uint32 words are held
in int64, and products by the 32-bit constants are split into 16-bit
halves so none passes 2^63.

``control=True`` compares only the top 16 bits of each level's draw with
the top 16 bits of the thresholds: the next precision below the 32-bit
draws the configuration states (and one hash would then serve two
levels).
"""
from __future__ import annotations

import torch

from gpubench.reference import rng

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B
BLOCK = 1 << 24


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x ^ (x >> 16), _MIX1)
    x = _mul32(x ^ (x >> 15), _MIX2)
    return x ^ (x >> 16)


def words(cfg: dict) -> list[int]:
    """The graph's four stream words."""
    key = rng.device_key(cfg["seed"], rng.STREAM_CFREE_RMAT, 0)
    return [int(w) for w in rng.bits(key, 4)]


def thresholds(cfg: dict) -> tuple[int, int, int]:
    a, b, c = cfg["rmat_a"], cfg["rmat_b"], cfg["rmat_c"]
    return tuple(min(int(s * 2**32), _M32) for s in (a, a + b, a + b + c))


def requested_edges(cfg: dict) -> int:
    return cfg["cfree_edges"]


def endpoints_at(cfgs: list, t: torch.Tensor, control: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(u, v) int32 (G, S) of the edges at positions ``t`` (int64 (S,))
    of the G graphs ``cfgs``, which differ in their seed alone."""
    w = torch.tensor([words(c)[:2] for c in cfgs], dtype=torch.int64,
                     device=t.device)
    w0, w1 = w[:, :1], w[:, 1:]
    ta, tb, tc = thresholds(cfgs[0])
    shift = 16 if control else 0
    ta, tb, tc = ta >> shift, tb >> shift, tc >> shift
    levels = cfgs[0]["cfree_vertices"].bit_length() - 1
    x0 = (t & _M32)[None] ^ w0
    u = torch.zeros(x0.shape, dtype=torch.int64, device=t.device)
    v = torch.zeros_like(u)
    for level in range(levels):
        x = _mix32((x0 + ((_GOLDEN * (level + 1)) & _M32)) & _M32)
        x = _mix32(x ^ w1) >> shift
        q = (x >= ta).long() + (x >= tb).long() + (x >= tc).long()
        u = (u << 1) + (q >> 1)
        v = (v << 1) + (q & 1)
    return u.to(torch.int32), v.to(torch.int32)


def edge_blocks(cfg: dict, device, control: bool = False):
    """The graph's (u, v) int32 edges in blocks of :data:`BLOCK`."""
    e = requested_edges(cfg)
    for a in range(0, e, BLOCK):
        t = torch.arange(a, min(a + BLOCK, e), dtype=torch.int64,
                         device=device)
        u, v = endpoints_at([cfg], t, control)
        yield u[0], v[0]
