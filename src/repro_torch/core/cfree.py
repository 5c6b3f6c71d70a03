"""Communication-free generators: ba_cfree / rmat / er.

The JAX package's ``core/cfree.py`` in torch, bit-identical to it for the
same config. Edge ``t``'s endpoints are a pure function of the model's
four stream words and ``t`` (Sanders & Schulz's recomputation of the
Batagelj–Brandes chain for ba_cfree; a per-level quadrant descent for
R-MAT; two independent uniform draws for G(n, m)), so every executor just
slices the global index range ``[0, E)`` with zero exchange:

  * :func:`generate_cfree_host` expands the whole range on one device;
  * :func:`generate_cfree` spreads P = lp * D logical ranks' contiguous
    chunks over a topology of D devices (one process per device of a
    ``torch.distributed`` group when D > 1);
  * :class:`CFreeStream` expands slab ``i`` = ``[i*slab, (i+1)*slab)``
    per block, on one device, or over D devices, each expanding its
    contiguous span of every slab.

The words come from one clean-lineage threefry draw per (seed, stream)
(``rng.STREAM_CFREE_*``); the per-edge hash is a murmur-style uint32
finalizer, applied twice with the words folded in. Here the hash runs on
int64 tensors holding uint32 words, masked after every step, and
multiplications by the 32-bit mixing constants are split into 16-bit
halves so no product passes 2^63 (torch's CPU integer ops have no uint32
shifts). The CUDA kernel (``kernels/cfree_expand.py``) computes the same
function in native uint32.

ba_cfree chain: Batagelj–Brandes writes ``M[2t] = t // d`` and
``M[2t+1] = M[r]`` with ``r`` uniform on ``[0, 2t+1)``. An even ``r``
ends at source ``(r/2) // d``; an odd ``r`` recurses into edge
``(r-1)/2``'s draw. The reference runs ``CHAIN_BOUND`` = 64 masked hops;
an even ``r`` never changes again, so stopping a chain at its first even
draw gives the same values (a residual odd ``r`` after 64 hops maps to
``(r >> 1) // d`` in both).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.graph import EdgeList, GenStats
from repro_torch.kernels import ops
from repro_torch.runtime import blocking, spmd
from repro_torch.runtime import topology as topology_lib
from repro_torch.runtime.topology import Topology

CFREE_MODELS = ("ba_cfree", "rmat", "er")

#: Fixed recomputation depth of the ba_cfree dependency chain. Each hop is
#: odd w.p. ~1/2, so the residual probability is ~2^-64 per edge.
CHAIN_BOUND = 64

_GOLDEN = 0x9E3779B9
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CFreeConfig:
    """model: one of :data:`CFREE_MODELS`. vertices: global vertex count n
    (rmat requires a power of two). edges: global edge count E for rmat/er
    (ba_cfree derives E = n * ba_degree). ba_degree: edges issued per
    arriving BA vertex. rmat_a/b/c: R-MAT quadrant probabilities (d is the
    remainder). seed: RNG seed — with the config, the graph's identity.

    Class and field names equal the JAX package's: ``spec_digest`` hashes
    them."""

    model: str
    vertices: int
    edges: int = 0
    ba_degree: int = 2
    rmat_a: float = 0.57
    rmat_b: float = 0.19
    rmat_c: float = 0.19
    seed: int = 0

    @staticmethod
    def validate(cfg: "CFreeConfig") -> None:
        if cfg.model not in CFREE_MODELS:
            raise ValueError(
                f"model {cfg.model!r} not in {CFREE_MODELS}")
        if not 1 <= cfg.vertices <= 2**31 - 1:
            raise ValueError(
                f"vertices {cfg.vertices} out of int32 vertex-id space")
        if cfg.model == "ba_cfree":
            if cfg.ba_degree < 1:
                raise ValueError(f"ba_degree {cfg.ba_degree} must be >= 1")
            if cfg.vertices * cfg.ba_degree > 2**31 - 1:
                raise ValueError(
                    f"ba_cfree edge count {cfg.vertices * cfg.ba_degree} "
                    "exceeds int32 edge-index space")
        else:
            if not 1 <= cfg.edges <= 2**31 - 1:
                raise ValueError(
                    f"edges {cfg.edges} out of int32 edge-index space")
        if cfg.model == "rmat":
            if cfg.vertices & (cfg.vertices - 1):
                raise ValueError(
                    f"rmat vertices {cfg.vertices} must be a power of two")
            a, b, c = cfg.rmat_a, cfg.rmat_b, cfg.rmat_c
            if min(a, b, c) < 0.0 or a + b + c > 1.0:
                raise ValueError(
                    f"rmat quadrant probabilities a={a} b={b} c={c} must "
                    "be non-negative with a+b+c <= 1")


def cfree_sizes(cfg: CFreeConfig) -> tuple[int, int]:
    """(num_vertices, num_edges) of the generated graph, exact ints."""
    if cfg.model == "ba_cfree":
        return cfg.vertices, cfg.vertices * cfg.ba_degree
    return cfg.vertices, cfg.edges


def edge_slices(e: int, p: int) -> list:
    """Per-rank [start, stop) global edge-index slices.

    Rank r owns ``[r*chunk, min((r+1)*chunk, e))`` with chunk = ceil(e/P)
    — the slices exactly partition ``[0, e)`` for any (e, P); trailing
    ranks may own empty slices.
    """
    chunk = -(-e // p) if e else 0
    return [(min(r * chunk, e), min((r + 1) * chunk, e)) for r in range(p)]


# --- counter-based hash (uint32 words in int64 tensors) ----------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for words x < 2^32 and a 32-bit constant c, with
    every intermediate below 2^49 (no signed int64 overflow)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x ^ (x >> 16), _MIX1)
    x = _mul32(x ^ (x >> 15), _MIX2)
    return x ^ (x >> 16)


def cfree_hash(words, t: torch.Tensor, ctr: int) -> torch.Tensor:
    """uint32 draw (as int64) for edge counters ``t`` under draw counter
    ``ctr``; ``words[0]`` / ``words[1]`` are folded in, so callers select
    a word pair by slicing. ``t`` holds int32 or int64 values in
    [0, 2^32) (an int32 index is taken as its uint32 bits)."""
    w0, w1 = int(words[0]), int(words[1])
    x = (t.to(torch.int64) & _M32) ^ w0
    x = _mix32((x + ((_GOLDEN * (ctr + 1)) & _M32)) & _M32)
    return _mix32(x ^ w1)


def hash_int(w0: int, w1: int, t: int, ctr: int) -> int:
    """Exact python-int mirror of :func:`cfree_hash` (serial oracles)."""
    def mix(x: int) -> int:
        x = ((x ^ (x >> 16)) * _MIX1) & _M32
        x = ((x ^ (x >> 15)) * _MIX2) & _M32
        return x ^ (x >> 16)

    x = (t ^ w0) & _M32
    x = mix((x + _GOLDEN * (ctr + 1)) & _M32)
    return mix(x ^ w1)


def cfree_words(cfg: CFreeConfig) -> torch.Tensor:
    """(4,) stream words (uint32 values in an int64 CPU tensor).

    One draw per (seed, stream) with the rank-0 key, as the JAX package
    makes it: er uses two streams (word pairs [0:2] for u, [2:4] for v);
    ba_cfree and rmat draw all four from their one stream."""
    if cfg.model == "er":
        ku = rng_lib.device_key(cfg.seed, rng_lib.STREAM_CFREE_ER_U, 0)
        kv = rng_lib.device_key(cfg.seed, rng_lib.STREAM_CFREE_ER_V, 0)
        return torch.cat([rng_lib.bits(ku, 2), rng_lib.bits(kv, 2)])
    stream = (rng_lib.STREAM_CFREE_BA if cfg.model == "ba_cfree"
              else rng_lib.STREAM_CFREE_RMAT)
    return rng_lib.bits(rng_lib.device_key(cfg.seed, stream, 0), 4)


# --- per-model endpoint functions (the plain versions) -----------------------

def ba_draw(words, j: torch.Tensor) -> torch.Tensor:
    """Edge ``j``'s attachment draw ``r`` uniform on ``[0, 2j+1)`` (int64
    values of uint32 words; the bound stays in uint32)."""
    j = j.to(torch.int64) & _M32
    bound = ((j << 1) + 1) & _M32
    return cfree_hash(words, j, 0) % bound


def ba_chain(words, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The last draw of BA edge ``t``'s chain (module doc), and the draws
    each chain took (int32, 1 to CHAIN_BOUND + 1, ``t``'s shape).

    Only the chains whose draw is still odd are recomputed at each hop;
    an even draw is final, so this equals the reference's 64 masked hops
    over every edge."""
    r = ba_draw(words, t)
    draws = torch.ones(t.shape, dtype=torch.int32, device=t.device)
    live = torch.nonzero(r & 1).reshape(-1)
    for _ in range(CHAIN_BOUND):
        if live.numel() == 0:
            break
        draws[live] += 1
        rr = ba_draw(words, r[live] >> 1)
        r[live] = rr
        live = live[(rr & 1) == 1]
    return r, draws


def ba_dst(words, t: torch.Tensor, degree: int) -> torch.Tensor:
    """Destination of BA edge ``t`` by chain recomputation."""
    r, _ = ba_chain(words, t)
    return torch.div(r >> 1, degree, rounding_mode="floor").to(torch.int32)


def rmat_thresholds(cfg: CFreeConfig) -> tuple[int, int, int]:
    """Cumulative quadrant probabilities as uint32 comparison thresholds.

    a+b+c == 1 clamps the last threshold to 2^32-1 (bias 2^-32, ignored).
    """
    a, b, c = cfg.rmat_a, cfg.rmat_b, cfg.rmat_c
    return tuple(min(int(s * 2**32), _M32) for s in (a, a + b, a + b + c))


def rmat_endpoints(words, t: torch.Tensor, levels: int, ta: int, tb: int,
                   tc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """R-MAT quadrant descent: one hash per level, integer thresholds."""
    u = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    v = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    for level in range(levels):
        x = cfree_hash(words, t, level)
        q = ((x >= ta).to(torch.int32) + (x >= tb).to(torch.int32)
             + (x >= tc).to(torch.int32))
        u = (u << 1) + (q >> 1)
        v = (v << 1) + (q & 1)
    return u, v


def er_endpoints(words, t: torch.Tensor, n: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """G(n, m) edge ``t``: independent uniform endpoints, one word pair
    each."""
    u = (cfree_hash(words[0:2], t, 0) % n).to(torch.int32)
    v = (cfree_hash(words[2:4], t, 0) % n).to(torch.int32)
    return u, v


def cfree_endpoints(cfg: CFreeConfig, t: torch.Tensor, words
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(u, v) int32 endpoints of global int32 edge indices ``t``, pure in
    (words, t): the expansion kernel on the card, its plain version on the
    CPU. Every executor funnels through here."""
    n, _ = cfree_sizes(cfg)
    return ops.cfree_expand(t, words, model=cfg.model, n=n,
                            ba_degree=cfg.ba_degree,
                            thresholds=rmat_thresholds(cfg))


# --- serial oracle ------------------------------------------------------------

def serial_ba_cfree_reference(cfg: CFreeConfig) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Batagelj–Brandes serial M-array construction driven by the same
    hash — the oracle the chain recomputation must match bit for bit
    (small n only: python loop)."""
    n, e = cfree_sizes(cfg)
    w = [int(x) for x in cfree_words(cfg)]
    m_arr = np.zeros(2 * e, np.int32)
    u = np.zeros(e, np.int32)
    v = np.zeros(e, np.int32)
    for t in range(e):
        m_arr[2 * t] = t // cfg.ba_degree
        r = hash_int(w[0], w[1], t, 0) % (2 * t + 1)
        m_arr[2 * t + 1] = m_arr[r]
        u[t] = m_arr[2 * t]
        v[t] = m_arr[2 * t + 1]
    return u, v


# --- executors ----------------------------------------------------------------

def _cfree_stats(e: int, n: int) -> GenStats:
    # exchange_rounds=0 is the zero-exchange contract signal.
    return GenStats(requested_edges=e, emitted_edges=e, dropped_edges=0,
                    num_vertices=n, exchange_rounds=0, pair_capacity=0,
                    fallback_counts=ops.fallback_counts())


def generate_cfree_host(cfg: CFreeConfig, *, device=None
                        ) -> tuple[EdgeList, GenStats]:
    """Single-device expansion of the full index range.

    ``device`` defaults to the current CUDA device and raises when there
    is none; ``device="cpu"`` runs the plain path."""
    CFreeConfig.validate(cfg)
    device = spmd.resolve_device(device)
    n, e = cfree_sizes(cfg)
    t = torch.arange(e, dtype=torch.int32, device=device)
    u, v = cfree_endpoints(cfg, t, cfree_words(cfg))
    return EdgeList(src=u, dst=v, num_vertices=n), _cfree_stats(e, n)


def generate_cfree(cfg: CFreeConfig, topology: Optional[Topology] = None,
                   num_procs: Optional[int] = None, *, device=None
                   ) -> tuple[EdgeList, GenStats]:
    """P = lp * D logical ranks over a topology of D devices (``topology``
    None: flat over the process group's world size; ``num_procs`` None:
    P = D). Rank q owns the global indices [q*chunk, (q+1)*chunk), chunk
    = ceil(e / P), -1 past e; a device expands its lp ranks' contiguous
    range in one launch. Returns this rank's (lp, chunk) rows of the JAX
    package's ``generate_cfree`` arrays (their concatenation in rank
    order, compacted, is the host path's edge list) and the stats. No
    collective of any kind."""
    CFreeConfig.validate(cfg)
    device = spmd.resolve_device(device)
    topo = topology_lib.resolve(topology, device=device)
    p = num_procs or topo.num_devices
    lp = topo.lp(p)
    n, e = cfree_sizes(cfg)
    chunk = -(-e // p)
    if chunk > 2**31 - 1:
        raise ValueError(f"per-rank chunk {chunk} exceeds int32")
    start = blocking.device_index(topo) * lp * chunk
    t = start + torch.arange(lp * chunk, dtype=torch.int32, device=device)
    u, v = cfree_endpoints(cfg, t, cfree_words(cfg))
    del t
    if chunk * p > e:       # the global indices past e
        u, v = blocking.mask_tail((u, v), 0, lp * chunk, e - start)
    return (EdgeList(src=u.reshape(lp, chunk), dst=v.reshape(lp, chunk),
                     num_vertices=n), _cfree_stats(e, n))


class CFreeStream:
    """Out-of-core communication-free stream: block i covers global edge
    indices ``[i*slab, (i+1)*slab)``.

    Any slab size yields the same edge sequence, and a restart regenerates
    exactly the missing blocks. ``topology`` None, ``Topology.host()`` or
    a one-device topology runs every slab on one device; over D > 1
    devices (one process per device of a ``torch.distributed`` group)
    device d expands the span [d*per_dev, (d+1)*per_dev) of each slab,
    per_dev = ceil(slab / D), cut back to the slab's true length, and
    block i on rank d is that span. Blocks stay on the device
    (:meth:`block_on_device`); :meth:`block` copies one to the host.
    """

    def __init__(self, cfg: CFreeConfig, slab_edges: int,
                 topology: Optional[Topology] = None, *, device=None):
        CFreeConfig.validate(cfg)
        n, e = cfree_sizes(cfg)
        if not 1 <= slab_edges <= 2**31 - 1:
            raise ValueError(f"slab_edges {slab_edges} out of range")
        self.cfg = cfg
        self.device = spmd.resolve_device(device)
        self.topology = topology_lib.resolve(topology, device=self.device) \
            if topology is not None and not topology.is_host \
            else Topology.host()
        self.num_vertices = n
        self.requested_edges = e
        self.slab_edges = int(slab_edges)
        self.num_blocks = -(-e // self.slab_edges)
        self.exchange_rounds = 0
        self._words = cfree_words(cfg)
        self._per_dev = -(-self.slab_edges // self.topology.num_devices)
        self._offset = blocking.device_index(self.topology) * self._per_dev
        self._t_rel = torch.arange(min(self._per_dev, e),
                                   dtype=torch.int32, device=self.device)

    def meta(self) -> dict:
        """Generator identity for the shard manifest's resume check."""
        from repro_torch.core.spec import spec_digest
        return {"generator": "cfree", "model": self.cfg.model,
                "seed": self.cfg.seed, "spec_digest": spec_digest(self.cfg)}

    def block_on_device(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Block ``i``'s (src, dst) int32 tensors on the stream's device:
        this rank's span of the slab."""
        if not 0 <= i < self.num_blocks:
            raise ValueError(f"block {i} out of range "
                             f"[0, {self.num_blocks})")
        t0 = i * self.slab_edges
        m = min(self.slab_edges, self.requested_edges - t0)
        k = min(max(m - self._offset, 0), self._per_dev)
        return cfree_endpoints(self.cfg, self._t_rel[:k] + (t0 + self._offset),
                               self._words)

    def block(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        u, v = self.block_on_device(i)
        return u.cpu().numpy(), v.cpu().numpy()

    def iter_blocks(self) -> Iterator:
        from repro_torch.core.stream import EdgeBlock
        for i in range(self.num_blocks):
            src, dst = self.block(i)
            yield EdgeBlock(i, src, dst)
