"""Logical-axis -> mesh-axis sharding rules.

The port of the JAX package's ``sharding/rules.py``, entry for entry. One
rule set serves every arch and shape:

  params:      vocab/heads/kv/mlp/experts/inner -> "model" (TP/EP),
               embed -> "data" (ZeRO/FSDP: each rank holds its block, and
               the layer gathers it over "data" at each use), the rest
               replicated.
  activations: batch -> ("pod", "data") where divisible; sequence
               parallelism (seq -> "model") on the residual stream in
               train/prefill; decode KV caches shard the *sequence* dim
               over "model" when the KV heads can't (the partial attention
               of each rank's positions is then combined across "model").

:class:`PartitionSpec` stands in for ``jax.sharding.PartitionSpec``: one
entry per dimension, ``None``, an axis name, or a tuple of names (major
first); as JAX's, it keeps a one-name tuple as the name and an empty
tuple as ``None``. A mesh is anything with ``shape`` (a dict of axis
sizes) and ``axis_names``: a ``runtime.mesh.ProcessMesh``, or a stand-in
for tables of specs.

The ``REPRO_MOE_BECD`` / ``REPRO_MOE_BECF`` / ``REPRO_MOE_BTKD``
overrides of :meth:`Rules.activation_spec` are carried over so it answers
as the reference does; the port's MoE has one layout (expert parallelism
over "model", ``models/moe.py``) and does not read them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, Any, Optional

if TYPE_CHECKING:
    from repro_torch.models.layers import ParamSpec

TP_AXES = ("vocab", "heads", "mlp", "experts", "inner")


def _entry(part):
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else part[0] if len(part) == 1 else part
    return part


class PartitionSpec(tuple):
    """A tuple of per-dimension mesh-axis entries (see the module)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_entry(p) for p in parts))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    def axes_of(self, dim: int) -> tuple:
        """The mesh axes dimension ``dim`` is split over (major first)."""
        part = self[dim]
        return () if part is None else (part,) if isinstance(part, str) \
            else tuple(part)


P = PartitionSpec


def _env_spec(var: str, default: P, b) -> P:
    """Override an activation spec via env var, e.g.
    REPRO_MOE_BECD="b,none,none,none". 'b' maps to the batch axes."""
    raw = os.environ.get(var)
    if not raw:
        return default
    parts = []
    for tok in raw.split(","):
        tok = tok.strip().lower()
        parts.append(b if tok == "b" else None if tok in ("none", "")
                     else tok)
    return P(*parts)


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: Any
    mode: str                   # train | prefill | decode
    batch_axes: tuple           # axes usable for the global batch dim
    kv_sharded: bool = True
    seq_parallel: bool = True   # residual-stream sequence parallelism
    seq_shard_cache: bool = True
    no_tp: bool = False         # 'model' axis used as extra DP

    # ------------------------------------------------------------ params

    def param_pspec(self, spec: "ParamSpec") -> P:
        used: set[str] = set()
        out = []
        dsz = mesh_axis_size(self.mesh, "data")
        msz = mesh_axis_size(self.mesh, "model")
        for i, ax in enumerate(spec.axes):
            tgt = None
            if self.no_tp:
                # ZeRO over both axes: with TP off, the idle 'model' axis
                # still shards master and optimizer state.
                if ax == "embed":
                    dim = spec.shape[i]
                    if dim % (dsz * msz) == 0:
                        tgt = ("data", "model")
                    elif dim % dsz == 0:
                        tgt = "data"
            elif ax in TP_AXES:
                tgt = "model"
            elif ax == "kv" and self.kv_sharded:
                tgt = "model"
            elif ax == "embed":
                tgt = "data"
            names = (tgt if isinstance(tgt, tuple) else (tgt,)) \
                if tgt is not None else ()
            if tgt is not None and not (set(names) & used):
                used.update(names)
                out.append(tgt)
            else:
                out.append(None)
        return P(*out)

    def param_pspecs(self, specs) -> Any:
        """:meth:`param_pspec` of every leaf of a ParamSpec tree."""
        from repro_torch.models.layers import tree_map
        return tree_map(lambda _, s: self.param_pspec(s), specs)

    # --------------------------------------------------------- activations

    @property
    def _b(self):
        return self.batch_axes if self.batch_axes else None

    def activation_spec(self, role: str, ndim: int) -> Optional[P]:
        b = self._b
        if self.no_tp:
            # model axis is part of b; nothing else is model-sharded
            table_nt = {
                "act_btd": P(b, None, None),
                "act_bti": P(b, None, None),
                "act_bshd": P(b, None, None, None),
                "act_bskd": P(b, None, None, None),
                "cache_bskd": P(b, None, None, None),
                "cache_bsr": P(b, None, None),
                "logits_btv": P(b, None, None),
            }
            spec = table_nt.get(role)
            return spec if spec is not None and ndim == len(spec) else None
        seq_tp = "model" if (self.seq_parallel
                             and self.mode in ("train", "prefill")) else None
        kv_tp = "model" if self.kv_sharded else None
        cache_seq = None if self.kv_sharded else (
            "model" if self.seq_shard_cache else None)
        table = {
            "act_btd": P(b, seq_tp, None),
            "act_bti": P(b, None, "model"),
            "act_bshd": P(b, None, "model", None),
            "act_bskd": P(b, None, kv_tp, None),
            "cache_bskd": (P(b, cache_seq, kv_tp, None)
                           if self.mode == "decode"
                           else P(b, None, kv_tp, None)),
            "cache_bsr": P(b, "model" if self.seq_shard_cache else None,
                           None),
            "logits_btv": P(b, None, "model"),
            "moe_ecd": P("model", "data", None),
            "moe_ecf": P("model", "data", None),
            "moe_becd": _env_spec("REPRO_MOE_BECD",
                                  P(b, "model", None, None), b),
            "moe_becf": _env_spec("REPRO_MOE_BECF",
                                  P(b, "model", None, None), b),
            "moe_btkd": _env_spec("REPRO_MOE_BTKD", P(b, "model", None), b),
        }
        spec = table.get(role)
        if spec is None or ndim != len(spec):
            return None
        return spec

    def batch_pspec(self, extra_dims: int = 1) -> P:
        return P(self._b, *([None] * extra_dims))


def mesh_axis_size(mesh, name: str) -> int:
    return int(mesh.shape.get(name, 1))


def make_rules(mesh, mode: str, global_batch: int,
               kv_sharded: bool = True, seq_parallel: bool = True,
               seq_shard_cache: bool = True,
               no_tp: bool = False) -> Rules:
    """Pick the largest batch-axis prefix that divides global_batch.

    no_tp: treat the 'model' axis as extra data parallelism: replicate
    weights (except FSDP dims) and shard the batch over it too.
    """
    if no_tp:
        candidates = [ax for ax in ("pod", "data", "model")
                      if ax in mesh.axis_names]
        chosen_nt: list[str] = []
        size = 1
        for ax in candidates:
            s = mesh_axis_size(mesh, ax)
            if global_batch % (size * s) == 0:
                chosen_nt.append(ax)
                size *= s
        return Rules(mesh=mesh, mode=mode, batch_axes=tuple(chosen_nt),
                     kv_sharded=False, seq_parallel=False,
                     seq_shard_cache=False, no_tp=True)
    candidates = [ax for ax in ("pod", "data") if ax in mesh.axis_names]
    chosen: list[str] = []
    size = 1
    # greedily take axes while divisibility holds (pod first, then data)
    for ax in candidates:
        s = mesh_axis_size(mesh, ax)
        if global_batch % (size * s) == 0:
            chosen.append(ax)
            size *= s
    # fall back: try data alone if pod+data failed but data divides
    if not chosen and "data" in mesh.axis_names:
        s = mesh_axis_size(mesh, "data")
        if global_batch % s == 0:
            chosen = ["data"]
    return Rules(mesh=mesh, mode=mode, batch_axes=tuple(chosen),
                 kv_sharded=kv_sharded, seq_parallel=seq_parallel,
                 seq_shard_cache=seq_shard_cache)


# ------------------------------------------------------------ local blocks

def block_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of block ``index`` of a dimension of ``n`` split in
    ``parts``: blocks of ceil(n / parts), the last ones short or empty (how
    XLA pads an uneven shard)."""
    size = -(-n // parts)
    return min(n, index * size), min(n, (index + 1) * size)


def local_slices(pspec: P, shape, mesh) -> tuple:
    """The slices of a tensor of global ``shape`` laid out by ``pspec``
    that this rank of ``mesh`` (a ``ProcessMesh``) holds."""
    out = []
    for dim, n in enumerate(shape):
        axes = pspec.axes_of(dim)
        lo, hi = block_range(n, mesh.axis_size(axes), mesh.axis_index(axes)) \
            if axes else (0, n)
        out.append(slice(lo, hi))
    return tuple(out)


def kv_cache_split(rules: Rules, kv_heads: int, length: int,
                   tp: int) -> Optional[str]:
    """Which dimension of a KV cache (``length`` positions of ``kv_heads``
    heads) ``serve_step.cache_shardings`` splits over "model": "heads"
    where the rules shard the KV heads and ``tp`` divides them, else
    "seq" where it divides the length, else None (held whole)."""
    if rules.kv_sharded and kv_heads % tp == 0:
        return "heads"
    if rules.seq_shard_cache and length % tp == 0:
        return "seq"
    return None


def channel_split_dim(dims, tp: int) -> Optional[int]:
    """Which of a recurrent or conv state's channel dimensions ``dims``
    (the batch and any layer axis left out) its cache splits over "model"
    (``serve_step.cache_shardings``): the widest, the first of equals,
    where ``tp`` divides it; None when that one does not divide (the state
    is held whole)."""
    wide = max(range(len(dims)), key=lambda i: dims[i])
    return wide if dims[wide] % tp == 0 and dims[wide] >= tp else None


def local_shape(pspec: P, shape, mesh) -> tuple:
    """The shape of this rank's block of ``shape`` under ``pspec``."""
    return tuple(s.stop - s.start for s in local_slices(pspec, shape, mesh))
