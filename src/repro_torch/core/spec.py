"""GraphSpec: the single declarative description of a generated graph.

The same value object as the JAX package's ``core/spec.py``. Class names,
field names, defaults and the canonicalisation rules match it exactly, so
:meth:`GraphSpec.digest` and :func:`spec_digest` give the same fingerprint
in both packages for the same request. The device a graph is generated on
is not part of the spec (it is a keyword of ``api.plan``/``api.generate``),
because every field here is hashed.

Also here: a copy of the PK seed-graph dataclass :class:`SeedGraph`, which
a spec may carry (``core/pk.py`` re-exports it).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Union

import numpy as np

from repro_torch.core.factions import FactionSpec, FactionTable
from repro_torch.runtime.topology import Topology

MODELS = ("pba", "pk", "ba_cfree", "rmat", "er")
CFREE_MODELS = ("ba_cfree", "rmat", "er")
EXECUTIONS = ("auto", "host", "sharded", "streamed")
SINKS = ("memory", "shards")

#: Declared determinism roots (``analysis/flowcheck.py``, pass FC001; a
#: copy of the JAX package's ``core/spec.py`` tuple): every draw of a
#: generation program derives from these alone: the config ``seed``, the
#: device/rank identity and static budget shapes. Runtime data (faction
#: tables, counts, demand, carried state) never reaches a key or a draw's
#: size: the phase-2 pool contract (pool = f(seed, rank, budget)).
DETERMINISM_ROOTS = ("seed", "rank", "static_budgets")


@dataclasses.dataclass(frozen=True)
class SeedGraph:
    """The Kronecker seed: e0 edges over n0 vertices (host-side, tiny)."""

    u: np.ndarray  # (e0,) int32
    v: np.ndarray  # (e0,) int32
    num_vertices: int

    @property
    def num_edges(self) -> int:
        return int(self.u.shape[0])

    @staticmethod
    def validate(seed: "SeedGraph") -> None:
        if seed.u.shape != seed.v.shape or seed.u.ndim != 1:
            raise ValueError("seed edge arrays must be 1-D and equal length")
        if seed.num_edges < 2:
            raise ValueError("seed needs >= 2 edges")
        for arr in (seed.u, seed.v):
            if (arr < 0).any() or (arr >= seed.num_vertices).any():
                raise ValueError("seed endpoints out of range")


def _canon(x):
    """Canonical JSON-able form: dataclasses by field, arrays by content
    hash (dtype/shape/sha256), containers recursively. Unrecognized types
    raise: a repr-based fallback would truncate large arrays and hand two
    different graphs the same fingerprint."""
    if x is None or isinstance(x, (str, bool, int, float)):
        return x
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {type(x).__name__:
                {f.name: _canon(getattr(x, f.name))
                 for f in dataclasses.fields(x)}}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _canon(v) for k, v in sorted(x.items())}
    if hasattr(x, "__array__"):  # numpy and other array-likes
        a = np.asarray(x)
        return {"__ndarray__": [str(a.dtype), list(a.shape),
                                hashlib.sha256(
                                    np.ascontiguousarray(a).tobytes()
                                ).hexdigest()]}
    raise TypeError(
        f"spec_digest cannot canonicalize {type(x).__name__}: add an "
        "explicit rule rather than fingerprinting its repr")


def spec_digest(*parts) -> str:
    """Stable 16-hex fingerprint of a generation config (dataclasses,
    arrays and plain JSON-able values)."""
    payload = json.dumps([_canon(p) for p in parts], sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True, eq=False)
class GraphSpec:
    """One declarative request = one graph. The front door's input.

    The fields mean what they mean in the JAX package's GraphSpec: model
    (``"pba"``, ``"pk"``, ``"ba_cfree"``, ``"rmat"``, ``"er"``); the PBA
    scale and knobs (procs, vertices_per_proc, edges_per_vertex, factions,
    interfaction_prob, pair_capacity, exchange_rounds,
    total_capacity_factor, auto_capacity); the PK knobs (levels,
    seed_graph, noise, delete_prob, slab_edges); the communication-free
    knobs (cfree_vertices, cfree_edges, ba_degree, rmat_a/b/c); and the
    common seed, topology, execution, sink, out_dir, num_shards, overlap.
    This package generates every model with ``execution="host"`` and
    ``"streamed"`` on one device; ``api.plan`` refuses sharded execution
    with the ROADMAP item that ports it.
    """

    model: str
    # --- PBA ---------------------------------------------------------------
    procs: int = 0
    vertices_per_proc: int = 0
    edges_per_vertex: int = 0
    factions: Union[FactionSpec, FactionTable, str, None] = None
    interfaction_prob: float = 0.05
    pair_capacity: Optional[int] = None
    exchange_rounds: Optional[int] = None
    total_capacity_factor: int = 2
    auto_capacity: bool = True
    # --- PK ----------------------------------------------------------------
    levels: int = 0
    seed_graph: Optional[SeedGraph] = None
    noise: float = 0.0
    delete_prob: float = 0.0
    slab_edges: int = 1 << 20
    # --- communication-free (ba_cfree / rmat / er) -------------------------
    cfree_vertices: int = 0
    cfree_edges: int = 0
    ba_degree: int = 2
    rmat_a: float = 0.57
    rmat_b: float = 0.19
    rmat_c: float = 0.19
    # --- common ------------------------------------------------------------
    seed: int = 0
    topology: Optional[Topology] = None
    execution: str = "auto"
    sink: str = "memory"
    out_dir: Optional[str] = None
    num_shards: int = 8
    overlap: bool = True

    # Execution details, not graph identity: they route the same bits.
    _NON_IDENTITY_FIELDS = ("out_dir", "execution", "sink", "num_shards",
                            "topology", "overlap")

    # The classes of the non-identity fields (``analysis/flowcheck.py``,
    # pass FC003; the JAX package's tables): a routing field may change
    # the program a plan runs but never the digest or the edges; a sink
    # field changes none of them. Together they partition
    # _NON_IDENTITY_FIELDS.
    _ROUTING_FIELDS = ("topology", "execution", "overlap")
    _SINK_FIELDS = ("sink", "out_dir", "num_shards")

    # Identity fields whose effect binds only at run time (demand-derived
    # sizing): the digest covers them, the edges of a given plan need not
    # move.
    _RUNTIME_ONLY_FIELDS = ("auto_capacity",)

    # Identity fields owned by one model: perturbing them moves the digest
    # and only that model's graphs.
    _MODEL_OWNED_FIELDS = {
        "pba": ("procs", "vertices_per_proc", "edges_per_vertex",
                "factions", "interfaction_prob", "pair_capacity",
                "exchange_rounds", "total_capacity_factor",
                "auto_capacity"),
        "pk": ("levels", "seed_graph", "noise", "delete_prob",
               "slab_edges"),
        "ba_cfree": ("cfree_vertices", "ba_degree", "slab_edges"),
        "rmat": ("cfree_vertices", "cfree_edges", "rmat_a", "rmat_b",
                 "rmat_c", "slab_edges"),
        "er": ("cfree_vertices", "cfree_edges", "slab_edges"),
    }

    def digest(self) -> str:
        """Fingerprint of every generation-relevant field (execution mode,
        topology and sink layout excluded)."""
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)
                  if f.name not in self._NON_IDENTITY_FIELDS}
        return spec_digest(fields)

    def replace(self, **changes) -> "GraphSpec":
        return dataclasses.replace(self, **changes)
