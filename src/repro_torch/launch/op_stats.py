"""Collective and FLOP statistics of a recorded run.

The counterpart of the JAX package's ``launch/hlo_stats.py``, which parses
optimised HLO text for its collectives (multiplying loop bodies by their
trip counts) and its FLOPs. The port has no HLO: the run itself is
observed. ``analysis/audit.py``'s recorder lists every c10d dispatcher op
a program issues (a :class:`Call`: its kind, its bytes in and out, its
group's ranks), in issue order, so a loop's body appears once per trip
and no trip count is inferred; FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` over the same run. Names
follow the reference where the meaning carries over:

  collect_collective_stats(calls)   bytes and counts by kind (the HLO
                                    kinds' names: "all-to-all",
                                    "all-reduce", "all-gather",
                                    "reduce-scatter", ...), and wire bytes
  all_to_all_span_bytes(calls)      the all_to_all bytes split by group
                                    span: contiguous ranks ("local", a
                                    pod's chips) against strided ranks
                                    ("cross", one chip of each pod)
  collect_opcode_stats(calls)       calls by dispatcher op name
                                    (``collect_opcode_stats``'s
                                    counterpart; the FLOPs by op that
                                    ``collect_hlo_costs`` adds are the
                                    flop counter's, saved beside the
                                    calls by :func:`save_calls`)

Byte accounting per kind (``bytes_in`` and ``bytes_out`` are each rank's
own buffers): all_to_all, all_gather and the rest count the result
bytes, as the reference counts result types; reduce_scatter counts its
input (the reference's result bytes x participants). Wire bytes are the
``(g-1)/g`` share of a g-rank collective that leaves the rank (twice that
for a ring all_reduce).
"""
from __future__ import annotations

import dataclasses
import gzip
import json
from collections import Counter, defaultdict
from typing import Iterable, Optional

#: c10d dispatcher op (without the ``c10d::`` prefix) -> the HLO kind.
KIND_OF_OP = {
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "broadcast_": "broadcast", "gather_": "gather", "scatter_": "scatter",
    "reduce_": "reduce", "send": "send", "recv_": "recv",
    "recv_any_source_": "recv", "barrier": "barrier",
    "monitored_barrier_": "barrier",
}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclasses.dataclass(frozen=True)
class Call:
    """One c10d op as one rank issued it."""

    op: str                  # dispatcher name without "c10d::"
    bytes_in: int
    bytes_out: int
    ranks: Optional[tuple]   # the group's global ranks (None: unknown)

    @property
    def kind(self) -> str:
        return KIND_OF_OP.get(self.op, self.op.strip("_"))

    @property
    def group_size(self) -> int:
        return len(self.ranks) if self.ranks else 1

    @property
    def span(self) -> str:
        """"local" when the group's ranks are contiguous, "cross" when
        they are strided (the reference's replica-group span)."""
        r = sorted(self.ranks or ())
        return "local" if not r or r[-1] - r[0] == len(r) - 1 else "cross"

    @property
    def result_bytes(self) -> int:
        return self.bytes_in if self.kind == "reduce-scatter" \
            else self.bytes_out

    @property
    def wire_bytes(self) -> float:
        g = self.group_size
        share = (g - 1) / g
        if self.kind == "all-reduce":
            return 2 * share * self.bytes_in
        if self.kind == "reduce-scatter":
            return share * self.bytes_in
        return share * self.bytes_out

    def signature(self) -> tuple:
        """What must match across ranks: kind, bytes, the group's size
        and span (its ranks differ from rank to rank by design)."""
        return (self.op, self.bytes_in, self.bytes_out, self.group_size,
                self.span)

    def to_json(self) -> dict:
        return {"op": self.op, "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
                "ranks": list(self.ranks) if self.ranks else None}

    @staticmethod
    def from_json(d: dict) -> "Call":
        return Call(d["op"], int(d["bytes_in"]), int(d["bytes_out"]),
                    tuple(d["ranks"]) if d.get("ranks") else None)


@dataclasses.dataclass
class CollectiveStats:
    """The reference's ``CollectiveStats``: bytes and counts by kind.
    ``ambiguous_loops`` is always 0: a recorded run has no loop to infer."""

    bytes_by_kind: dict
    count_by_kind: dict
    ambiguous_loops: int = 0
    wire_bytes_by_kind: dict = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.get(k, 0)
                         for k in COLLECTIVE_KINDS))


def collect_collective_stats(calls: Iterable[Call]) -> CollectiveStats:
    """Bytes (result bytes), wire bytes and counts by kind."""
    b: dict = defaultdict(float)
    w: dict = defaultdict(float)
    n: Counter = Counter()
    for c in calls:
        b[c.kind] += c.result_bytes
        w[c.kind] += c.wire_bytes
        n[c.kind] += 1
    return CollectiveStats(dict(b), dict(n), 0, dict(w))


def all_to_all_span_bytes(calls: Iterable[Call]) -> dict:
    """The all_to_all bytes split by group span, as the reference returns
    them: {"local", "cross", "local_wire", "cross_wire", "n_local",
    "n_cross"}."""
    out = {"local": 0.0, "cross": 0.0, "local_wire": 0.0,
           "cross_wire": 0.0, "n_local": 0, "n_cross": 0}
    for c in calls:
        if c.kind != "all-to-all":
            continue
        out[c.span] += c.bytes_out
        out[f"{c.span}_wire"] += c.wire_bytes
        out[f"n_{c.span}"] += 1
    return out


def collect_opcode_stats(calls: Iterable[Call]) -> dict:
    """Calls by c10d dispatcher op (``c10d::<op>``), sorted by name."""
    n = Counter(f"c10d::{c.op}" for c in calls)
    return dict(sorted(n.items()))


def save_calls(path: str, calls: Iterable[Call], flops: float = 0.0,
               flops_by_op: Optional[dict] = None) -> None:
    """The raw call list (and the FLOPs) gzipped as JSON at ``path``."""
    with gzip.open(path, "wt") as f:
        json.dump({"calls": [c.to_json() for c in calls], "flops": flops,
                   "flops_by_op": flops_by_op or {}}, f)


def load_calls(path: str) -> tuple[list, float, dict]:
    """(calls, flops, flops by op) saved by :func:`save_calls`."""
    with gzip.open(path, "rt") as f:
        d = json.load(f)
    return ([Call.from_json(c) for c in d["calls"]], float(d["flops"]),
            d.get("flops_by_op", {}))
