"""Data pipeline: random-walk corpora over the port's scale-free graphs,
and a synthetic Zipf fallback.

The port of the JAX package's ``train/data.py``. Random walks over a PBA
or PK graph give token streams whose unigram statistics inherit the
graph's power law: the generator is the data tier. The graph comes from
the port's ``api.generate`` on the corpus's device (host execution: the
PBA path launches the ``resolve_roots``, ``gather`` and ``histogram``
kernels on the card, PK ``pk_expand``), its CSR from
``core.graph.to_csr`` (a stable sort, the reference's row order), copied
to the host once. The walks run in numpy, draw for draw as the
reference's, so the tokens equal the JAX package's bit for bit.

A PBA graph's identity includes its ``pair_capacity``, whose default
depends on the device's memory; the corpus pins it to the value the
plan derives on the CPU (the JAX package's on a CPU host), so one config
gives one corpus on any device.

The iterator state (seed, cursor) is tiny and checkpointable; batch
``cursor`` is drawn from ``default_rng((seed, cursor))``, so a restored
corpus continues exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch import api
from repro_torch.core import FactionSpec, GraphSpec, to_csr


@dataclasses.dataclass
class WalkCorpusConfig:
    generator: str = "pba"            # pba | pk | zipf
    num_vertices: int = 32768         # pba: rounded to procs*vpp
    edges_per_vertex: int = 8
    pk_levels: int = 5
    walk_length: int = 512
    vocab_size: int = 32768
    seed: int = 0
    logical_procs: int = 8


def corpus_spec(c: WalkCorpusConfig) -> GraphSpec:
    """The GraphSpec of a corpus's graph (the JAX package's fields; a PBA
    spec's pair capacity pinned to the CPU plan's)."""
    if c.generator == "pba":
        vpp = max(c.num_vertices // c.logical_procs, 1)
        spec = GraphSpec(
            model="pba", procs=c.logical_procs, vertices_per_proc=vpp,
            edges_per_vertex=c.edges_per_vertex, seed=c.seed,
            factions=FactionSpec(max(c.logical_procs // 2, 1), 2,
                                 max(c.logical_procs // 2, 2), seed=c.seed),
            execution="host")
        cap = api.plan(spec, device="cpu").pair_capacity
        return dataclasses.replace(spec, pair_capacity=cap)
    if c.generator == "pk":
        return GraphSpec(model="pk", levels=c.pk_levels, noise=0.05,
                         seed=c.seed, execution="host")
    raise ValueError(f"generator {c.generator!r} has no graph")


class WalkCorpus:
    """Deterministic, checkpointable random-walk token stream; the graph
    is generated on ``device`` (default: the card)."""

    def __init__(self, cfg: WalkCorpusConfig, device=None):
        self.cfg = cfg
        self.stats = None
        self._build_graph(device)
        self.cursor = 0

    def _build_graph(self, device):
        c = self.cfg
        if c.generator not in ("pba", "pk"):
            self.indptr = self.indices = None
            self.n = c.vocab_size
            return
        res = api.generate(corpus_spec(c), device=device)
        self.stats = res.stats
        edges = res.edges
        self.n = int(edges.num_vertices)
        valid = edges.valid_mask()          # dropped slots hold -1
        indptr, indices = to_csr(edges.src[valid], edges.dst[valid], self.n)
        self.indptr = indptr.cpu().numpy()
        self.indices = indices.cpu().numpy()
        # vertices with no edges restart the walk
        self.deg = np.diff(self.indptr)

    def _tok(self, v: np.ndarray) -> np.ndarray:
        return (v % self.cfg.vocab_size).astype(np.int32)

    def state(self) -> dict:
        return {"cursor": int(self.cursor), "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"corpus seed mismatch: {state['seed']} vs "
                             f"{self.cfg.seed}")
        self.cursor = int(state["cursor"])

    def next_batch(self, batch_size: int, seq_len: int) -> dict:
        """(tokens, labels) int32 (batch, seq): windows of walks of length
        seq + 1."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, self.cursor))
        self.cursor += 1
        steps = seq_len + 1
        if self.indptr is None:  # zipf fallback
            ranks = rng.zipf(1.3, size=(batch_size, steps))
            walk = np.minimum(ranks, c.vocab_size - 1)
        else:
            walk = np.empty((batch_size, steps), np.int64)
            cur = rng.integers(0, self.n, batch_size)
            for t in range(steps):
                dead = self.deg[cur] == 0
                if dead.any():
                    cur[dead] = rng.integers(0, self.n, int(dead.sum()))
                walk[:, t] = cur
                lo = self.indptr[cur]
                hi = self.indptr[cur + 1]
                nxt = lo + (rng.random(batch_size)
                            * np.maximum(hi - lo, 1)).astype(np.int64)
                cur = self.indices[np.minimum(nxt, hi - 1)]
        toks = self._tok(walk)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batches(corpus: WalkCorpus, batch_size: int, seq_len: int,
            accum: int = 1) -> Iterator[dict]:
    """Endless (accum, batch_size // accum, seq_len) int32 numpy batches."""
    while True:
        parts = [corpus.next_batch(batch_size // accum, seq_len)
                 for _ in range(accum)]
        yield {k: np.stack([p[k] for p in parts]) for k in parts[0]}
