"""Shared model building blocks: param specs, norms, RoPE, MLPs, embeddings.

The port of the JAX package's ``models/layers.py``. Parameters are nested
dicts (and lists) of tensors in the JAX package's layout; each model
provides a parallel tree of ``ParamSpec`` (shape + logical axis names). The
axes stay as data for tensor parallelism, which is not ported yet. Trees
are walked in the order ``jax.tree_util.tree_flatten`` walks them: dict
keys sorted, lists in order, so one seed draws the same leaves in both
packages (``repro_torch.convert.numpy_params``).

Every function computes what its JAX counterpart computes, in the same
precision: norms in float32, RoPE angles in float32, tanh-approximated
GELU (``jax.nn.gelu``'s default), weights cast to the activations' dtype
at use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "fan_in"             # fan_in | zeros | ones | normal | small
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


class TensorStruct(NamedTuple):
    """Shape and dtype of a tensor not yet allocated (the JAX package's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def tree_map(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested dict / list / tuple tree (a named
    tuple is a leaf: ``TensorStruct`` is one), leaves visited in
    ``jax.tree_util.tree_flatten``'s order; returns the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not hasattr(tree, "_fields")):
        return type(tree)(tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_flatten``'s order."""
    out: list = []
    tree_map(lambda _, leaf: out.append(leaf), tree)
    return out


def tree_paths(tree) -> list:
    """The path (a tuple of keys and indices) of each leaf of ``tree``, in
    ``tree_flatten``'s order."""
    out: list = []
    tree_map(lambda path, _: out.append(path), tree)
    return out


def init_scale(spec: ParamSpec) -> float:
    """The standard deviation a "small", "normal" or "fan_in" leaf is drawn
    with. ``fan_in`` is the spec's leading dimension, as in the JAX package
    (for a stacked leaf, axis "layers", that is the stack's depth)."""
    if spec.init == "small":
        return 0.01
    if spec.init == "normal":
        return 1.0
    if spec.init == "fan_in":
        fan_in = spec.shape[0] if len(spec.shape) >= 2 \
            else max(spec.shape[0], 1)
        return 1.0 / math.sqrt(fan_in)
    raise ValueError(f"unknown init kind {spec.init!r}")


def init_param(generator: torch.Generator, spec: ParamSpec,
               device=None, dtype=None) -> torch.Tensor:
    """One parameter drawn by ``spec.init`` from ``generator`` (on
    ``device``), stored as ``dtype`` (default ``spec.dtype``). The draw is
    float32 whatever ``dtype`` is; a stacked leaf is drawn one layer at a
    time, so one stored in bf16 never exists whole in float32."""
    dtype = dtype or spec.dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    scale = init_scale(spec)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    stacked = spec.axes[:1] == ("layers",)
    for row in (out if stacked else [out]):
        draw = torch.randn(row.shape, generator=generator,
                           dtype=torch.float32, device=device)
        row.copy_(draw.mul_(scale))
    return out


def init_tree(generator: torch.Generator, specs, device=None,
              dtype_of: Optional[Callable] = None):
    """Every leaf of ``specs`` drawn in turn from ``generator``;
    ``dtype_of(path, spec)`` gives each leaf's stored dtype."""
    return tree_map(lambda path, s: init_param(
        generator, s, device, dtype_of(path, s) if dtype_of else None), specs)


# ---------------------------------------------------------------- norms

def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def norm_specs(cfg) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones"),
                "bias": ParamSpec((cfg.d_model,), ("embed",), "zeros")}
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), "zeros")}


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ---------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, positions):
    """cos/sin tables for ``positions`` (any shape) -> (*pos, head_dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., seq, heads, head_dim); cos/sin: (seq, head_dim//2). The two
    halves of the head rotate together (not interleaved pairs)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------- mlp

def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"wi": ParamSpec((d, f), ("embed", "mlp")),
                "wg": ParamSpec((d, f), ("embed", "mlp")),
                "wo": ParamSpec((f, d), ("mlp", "embed"))}
    return {"wi": ParamSpec((d, f), ("embed", "mlp")),
            "wo": ParamSpec((f, d), ("mlp", "embed"))}


def apply_mlp(cfg, p, x):
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wi"].to(x.dtype)) * (x @ p["wg"].to(x.dtype))
    else:
        h = F.gelu(x @ p["wi"].to(x.dtype), approximate="tanh")
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------- embeddings

def embed_specs(cfg) -> dict:
    specs = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed"), "small")}
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                  ("vocab", "embed"), "small")
    return specs


def embed_tokens(p, tokens, dtype):
    return p["tok"].to(dtype)[tokens]


def logits_out(cfg, p, x):
    w = p["head"] if "head" in p else p["tok"]
    return x @ w.to(x.dtype).T


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv. x: (B, S, C), w: (K, C).

    state: (B, K-1, C) trailing context from the previous segment (decode).
    Returns (y, new_state): y the sum of the K shifted products in x's
    dtype, in the reference's order; new_state the last K-1 rows of
    ``[pad, x]``."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1) + tuple(x.shape[2:]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    s = x.shape[1]
    w = w.to(x.dtype)
    y = xp[:, :s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return y, new_state
