"""The work a graph asks of the card, from its spec alone.

Integer operations per edge are counted from the communication-free
kernel's arithmetic (xor, add, shift, multiply, compare and select each
count one), as ``chip_smoke.py`` counts them: copies of its
``HASH_OPS`` and ``RMAT_LEVEL_OPS``. Bytes are what the graph must write:
its two int32 endpoint arrays. A share of the roofline divides the least
time these could take on the card by the device time the graph took, so
it reads the same work whatever implements it.
"""
from __future__ import annotations

HASH_OPS = 19                       # (t^w0)+c, mix (8), ^w1, mix (8)
RMAT_LEVEL_OPS = HASH_OPS - 1 + 11  # t^w0 is common to the levels; 3
                                    # compares + 2 adds, u and v updates


def rmat(graph: dict) -> tuple[int, int]:
    """(int32 operations, bytes written) of one R-MAT graph."""
    edges = graph["cfree_edges"]
    levels = graph["cfree_vertices"].bit_length() - 1
    return edges * (RMAT_LEVEL_OPS * levels + 1), 8 * edges


def bound_s(ops: int, nbytes: int, peaks: dict) -> tuple[float, str]:
    """The least time (seconds) and which of the two bounds it."""
    t_ops = ops / peaks["int32_ops_per_s"]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
