"""Faction construction for the PBA generator (a verbatim numpy copy of
the JAX package's ``core/factions.py``, so both packages build the same
tables from the same seed).

Factions are (possibly overlapping) sets of processors. Each processor's
phase-1 urn is seeded with one slot per member of each faction it belongs to
(counting multiplicity across factions, matching the paper's
``s = sum_i |F_i|``). Faction structure is the paper's knob for community
structure: processors sharing factions preferentially wire to each other.

Construction is host-side numpy (tiny: O(P) ids), deterministic from a seed,
and returns dense per-processor arrays so the shard_map body can consume its
own row.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class FactionSpec:
    """Configuration for random faction construction.

    num_factions: how many factions to draw.
    min_size/max_size: faction size range (inclusive), sizes vary per paper.
    seed: RNG seed for membership draws.
    """

    num_factions: int
    min_size: int
    max_size: int
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class FactionTable:
    """Dense per-processor faction data.

    procs: (P, max_s) int32 — for processor p, the concatenation of the member
      lists of every faction containing p (multiplicity preserved), padded
      with -1.
    s: (P,) int32 — number of valid entries per row (the paper's ``s``).
    factions: the raw faction membership lists (for tests / docs).
    """

    procs: np.ndarray
    s: np.ndarray
    factions: tuple[tuple[int, ...], ...]

    @property
    def num_procs(self) -> int:
        return self.procs.shape[0]

    @property
    def max_s(self) -> int:
        return self.procs.shape[1]


def _table_from_rows(rows: Sequence[np.ndarray],
                     factions: Sequence) -> FactionTable:
    """Assemble the dense padded FactionTable from per-processor rows."""
    s = np.array([len(r) for r in rows], np.int32)
    procs = np.full((len(rows), int(s.max())), -1, np.int32)
    for p, row in enumerate(rows):
        procs[p, : len(row)] = row
    return FactionTable(procs=procs, s=s,
                        factions=tuple(tuple(int(x) for x in f)
                                       for f in factions))


def make_factions(num_procs: int, spec: FactionSpec) -> FactionTable:
    """Draw random factions and build the per-processor tables.

    Every processor is guaranteed membership in at least one faction (isolated
    processors are appended to a random faction) so every urn has s >= 1.
    """
    rng = np.random.default_rng(spec.seed)
    if not (1 <= spec.min_size <= spec.max_size <= num_procs):
        raise ValueError(
            f"faction sizes must satisfy 1 <= min <= max <= P, got "
            f"[{spec.min_size}, {spec.max_size}] with P={num_procs}")
    factions: list[np.ndarray] = []
    for _ in range(spec.num_factions):
        size = int(rng.integers(spec.min_size, spec.max_size + 1))
        members = rng.choice(num_procs, size=size, replace=False)
        factions.append(np.sort(members))

    member_of = [[] for _ in range(num_procs)]
    for fi, members in enumerate(factions):
        for m in members:
            member_of[int(m)].append(fi)

    # Lonely processors join one random faction each.
    for p in range(num_procs):
        if not member_of[p]:
            fi = int(rng.integers(0, len(factions)))
            factions[fi] = np.sort(np.append(factions[fi], p))
            member_of[p].append(fi)

    rows = [np.concatenate([factions[fi] for fi in member_of[p]]).astype(np.int32)
            for p in range(num_procs)]
    return _table_from_rows(rows, factions)


def block_factions(num_procs: int, block_size: int) -> FactionTable:
    """Deterministic contiguous-block factions (hierarchical communities).

    Processors [i*b, (i+1)*b) form faction i. Produces clean block-diagonal
    community structure (Fig. 5 style) without randomness.
    """
    if num_procs % block_size != 0:
        raise ValueError("block_size must divide num_procs")
    factions = [tuple(range(i, i + block_size))
                for i in range(0, num_procs, block_size)]
    rows = [np.arange((p // block_size) * block_size,
                      (p // block_size + 1) * block_size, dtype=np.int32)
            for p in range(num_procs)]
    return _table_from_rows(rows, factions)


def hub_factions(num_procs: int) -> FactionTable:
    """Adversarial hub layout: processor 0 shares a faction with everyone.

    Factions {0, p} for every p > 0, so every urn is seeded half with
    processor 0 — per-pair load onto the hub concentrates like E instead of
    E/P, the worst case for a fixed per-pair exchange capacity. This is the
    stress table for the multi-round streaming exchange (and the layout
    family that silently clipped the hub tail under the single-shot
    exchange).
    """
    if num_procs < 2:
        raise ValueError("hub layout needs at least 2 processors")
    factions = [(0, p) for p in range(1, num_procs)]
    rows = [np.concatenate([np.array(f, np.int32)
                            for f in factions if p in f])
            for p in range(num_procs)]
    return _table_from_rows(rows, factions)


def validate_table(table: FactionTable) -> None:
    """Invariant checks used by tests and the generator entry point."""
    P, max_s = table.procs.shape
    if table.s.shape != (P,):
        raise ValueError("s shape mismatch")
    if (table.s < 1).any():
        raise ValueError("every processor needs at least one faction slot")
    if (table.s > max_s).any():
        raise ValueError("s exceeds row capacity")
    for p in range(P):
        row = table.procs[p, : table.s[p]]
        if (row < 0).any() or (row >= P).any():
            raise ValueError(f"invalid proc ids in row {p}")
