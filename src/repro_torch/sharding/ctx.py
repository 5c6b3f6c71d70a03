"""Activation-sharding context.

The port of the JAX package's ``sharding/ctx.py``. Model code runs under
``sharding_ctx(rules, mesh, d_model)`` to run sharded: each rank holds
the blocks of the parameters, caches and activations that the rules give
it (``rules.py``), computes on them, and changes layout through the mesh's
collectives (``runtime/mesh.py``) where the reference's roles say the
layout changes. Outside a context the model runs unsharded and every
helper here is the identity.

``constrain(x, role, full_shape)`` checks, inside a context, that ``x``
is this rank's block of a tensor of ``full_shape`` laid out as the rules
map ``role``, and raises ``ValueError`` if not, so a wrong layout fails
loudly instead of computing on the wrong slice. (The reference's
``constrain`` asks XLA for the layout; here the code makes it, and this
checks it.) :func:`gather_weight` is the FSDP gather of a parameter's
data-sharded dimensions at its use (under ``no_tp`` its "embed"
dimension's ZeRO block over ("data", "model")). :func:`model_block` is
this rank's block of a tensor every rank holds whole (a replicated bias
sliced to the rank's channels), and :func:`combine_seq_split` the
attention over positions split over "model" that GQA, MLA and the
cross-attention share.

The layout changes are differentiable (``runtime/mesh.py``'s adjoints),
so the training path runs through the same helpers: the sequence gather
and the row-parallel reduce-scatter are each other's adjoints; without
sequence parallelism the residual entering a layer's own heads is
Megatron's "f" and the partial sums leaving it its "g". Under ``no_tp``
the "model" axis carries batch rows, not tensor parallelism:
:func:`model_axis` is (1, 0), and no helper reduces over it.
"""
from __future__ import annotations

import contextlib
import threading
import types
from typing import Optional

import torch

from repro_torch.sharding.rules import block_range, local_shape

_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


def current_embed_dim() -> Optional[int]:
    """The model's "embed" size the context was entered with (None
    outside a context)."""
    return getattr(_state, "embed_dim", None)


@contextlib.contextmanager
def sharding_ctx(rules, mesh, embed_dim: int):
    """Run the enclosed model code sharded by ``rules`` over ``mesh``.
    ``embed_dim`` is the model's "embed" size (``d_model``), the global
    size of every parameter dimension with the logical axis "embed":
    :func:`gather_weight` hands it to ``rules.param_pspec``, because a
    block's own size does not say how the rules split that dimension
    (under ``no_tp`` over ("data", "model") or over "data" alone)."""
    prev = (current_rules(), current_mesh(), current_embed_dim())
    _state.rules, _state.mesh, _state.embed_dim = rules, mesh, embed_dim
    try:
        yield
    finally:
        _state.rules, _state.mesh, _state.embed_dim = prev


def active() -> bool:
    """Whether the code runs inside a sharding context."""
    return current_rules() is not None and current_mesh() is not None


def constrain(x, role: str, full_shape=None):
    """``x``, checked (inside a context) to be this rank's block of a
    tensor of ``full_shape`` (default: ``x``'s own shape) laid out as the
    rules map ``role``; raises ``ValueError`` otherwise. The identity
    outside a context, and for a role the rules leave unconstrained."""
    if not active():
        return x
    spec = current_rules().activation_spec(role, x.dim())
    if spec is None:
        return x
    return constrain_spec(x, spec, full_shape, role)


def constrain_spec(x, spec, full_shape=None, name: str = "tensor"):
    """``x``, checked (inside a context) to be this rank's block of a
    tensor of ``full_shape`` laid out by the ``PartitionSpec`` ``spec``
    (a cache's, from ``serve_step.cache_shardings``); raises
    ``ValueError`` naming ``name`` otherwise."""
    if not active():
        return x
    full = tuple(x.shape if full_shape is None else full_shape)
    want = local_shape(spec, full, current_mesh())
    if tuple(x.shape) != want:
        raise ValueError(f"{name}: this rank's block of {full} under "
                         f"{spec} is {want}, the tensor is "
                         f"{tuple(x.shape)}")
    return x


def model_axis() -> tuple[int, int]:
    """(size, this rank's index) of the mesh's "model" axis as a tensor-
    parallel axis; (1, 0) outside a context and under the ``no_tp`` rules
    (where "model" carries batch rows)."""
    if not active() or current_rules().no_tp:
        return 1, 0
    mesh = current_mesh()
    return mesh.axis_size("model"), mesh.axis_index("model")


def model_block(x, dim: int):
    """This rank's block along ``dim`` over "model" of ``x``, a tensor
    every rank holds whole (``block_range``'s blocks, as a split cache's);
    ``x`` itself on one rank or outside a context."""
    tp, t = model_axis()
    if tp == 1:
        return x
    lo, hi = block_range(x.shape[dim], tp, t)
    return x.narrow(dim, lo, hi - lo)


def combine_seq_split(scores, values, contract: str, dtype):
    """Attention over positions split by sequence over "model":
    ``scores`` (float32, masked, the positions last) and ``values`` are
    this rank's positions'. The global max of the scores, the softmax's
    sum, and the weighted values (``torch.einsum(contract, weights,
    values)`` in float32) are each combined over "model"; returns the
    last in ``dtype``. Every rank gets every row's result. It serves the
    split decode cache only: its all-reduces have no adjoint, and it
    raises ``RuntimeError`` on inputs that require grad."""
    if torch.is_grad_enabled() and (scores.requires_grad
                                    or values.requires_grad):
        raise RuntimeError("combine_seq_split serves the split decode "
                           "cache; training never reads a cache")
    mesh = current_mesh()
    m = mesh.all_reduce(scores.amax(dim=-1), "model", "max")
    e = torch.exp(scores - m[..., None])
    l = mesh.all_reduce(e.sum(dim=-1), "model")
    w = (e / l[..., None]).to(dtype)
    o = torch.einsum(contract, w.float(), values.float())
    return mesh.all_reduce(o, "model").to(dtype)


def gather_weight(w, axes: tuple):
    """Parameter ``w`` (this rank's block; ``axes`` its logical axes, the
    unstacked ParamSpec's) with every dimension the rules shard over an
    axis other than the tensor-parallel "model" gathered over that axis:
    the "embed" dimension's ZeRO/FSDP block over "data" (under ``no_tp``
    over ("data", "model")), as XLA gathers it at each use. The "model"
    blocks of the TP rules stay local (tensor and expert parallelism).
    Under autograd the gradient is reduce-scattered over the axes that
    carry batch rows (each rank's rows add their part) and sliced over the
    others (the ranks along them computed the same)."""
    if not active():
        return w
    mesh, rules = current_mesh(), current_rules()
    # The rules choose the "embed" split from the global size, and a
    # block's size can fit another choice too (1024 over 16 x 16 ranks
    # under no_tp: a block of 4).
    shape = tuple(current_embed_dim() if ax == "embed" else n
                  for ax, n in zip(axes, w.shape))
    pspec = rules.param_pspec(types.SimpleNamespace(
        axes=tuple(axes), shape=shape))
    batch = set(rules.batch_axes)
    for dim in range(w.dim()):
        other = tuple(a for a in pspec.axes_of(dim)
                      if a != "model" or rules.no_tp)
        if not other or mesh.axis_size(other) == 1:
            continue
        kinds = {a in batch for a in other}
        if len(kinds) == 1:
            w = mesh.all_gather(w, other, dim,
                                "sum" if kinds.pop() else "slice")
            continue
        for a in reversed(other):       # minor first: the same blocks
            w = mesh.all_gather(w, a, dim, "sum" if a in batch else "slice")
    return w


def gathered(p: dict, axes: dict) -> dict:
    """:func:`gather_weight` of each leaf of ``p`` present in ``axes``
    (leaf name -> logical axes); the other leaves as they are."""
    return {k: gather_weight(v, axes[k]) if k in axes else v
            for k, v in p.items()}


def batch_axes() -> Optional[tuple]:
    """The rules' batch axes (None outside a context or when the batch is
    not sharded)."""
    rules = current_rules()
    return (rules.batch_axes or None) if rules is not None else None


def seq_sharded() -> bool:
    """Whether the residual stream is split by sequence over "model" (the
    rules' ``act_btd``); False outside a sharding context."""
    if not active():
        return False
    spec = current_rules().activation_spec("act_btd", 3)
    return spec is not None and "model" in spec.axes_of(1)


def padded_len(s: int) -> int:
    """The residual's sequence length for ``s`` positions: a multiple of
    the "model" axis when the residual is split by sequence."""
    tp, _ = model_axis()
    return -(-s // tp) * tp if seq_sharded() else s


def gather_seq(x, s: int):
    """The whole sequence (its ``s`` real positions) of a residual-layout
    tensor: all-gathered over "model" when split by sequence. Held whole
    on a tensor-parallel mesh, it is Megatron's "f" under autograd (each
    rank's heads add their part of its gradient)."""
    if not seq_sharded():
        tp, _ = model_axis()
        return current_mesh().copy_to(x, "model") if tp > 1 else x
    return current_mesh().all_gather(x, "model", 1)[:, :s]


def split_seq(x):
    """A (B, S, D) tensor every rank holds whole, in the residual's layout:
    padded to :func:`padded_len` and this rank's block of positions when
    the residual is split by sequence (the inverse of :func:`gather_seq`)."""
    if not seq_sharded():
        return x
    s = x.shape[1]
    pad = padded_len(s) - s
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad, x.shape[2]))], 1)
    return model_block(x, 1)


def reduce_seq(y):
    """A row-parallel partial output (B, S, D) summed over "model" into the
    residual's layout: reduce-scattered by sequence (padded to
    :func:`padded_len`) or all-reduced (Megatron's "g" under autograd);
    ``y`` itself with no tensor-parallel axis."""
    tp, _ = model_axis()
    if tp == 1:
        return y
    mesh = current_mesh()
    if not seq_sharded():
        return mesh.reduce_from(y, "model")
    s = y.shape[1]
    pad = padded_len(s) - s
    if pad:
        y = torch.cat([y, y.new_zeros((y.shape[0], pad, y.shape[2]))], 1)
    return mesh.reduce_scatter(y, "model", 1)
