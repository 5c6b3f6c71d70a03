"""AdamW over float32 master parameters.

The port of the JAX package's ``train/optimizer.py``, with its arithmetic
in its order: the gradients are clipped to a global norm, the learning
rate warms up linearly from the int32 step, the bias corrections are
float32, and the weight decay is added to the Adam direction before the
step (``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``). Not
``torch.optim.AdamW``, which decays the parameters by a separate multiply
before its step. Each stage runs as ``torch._foreach_*`` calls over a
group of leaves of at most UPDATE_CHUNK values (a larger leaf cut into
pieces along its leading axes), so the float32 temporaries are a group's
(three of them at most), not the tree's.

The update runs in place: the parameter and moment tensors passed in are
the ones returned (the reference donates them to its jitted step).

Under sharding rules each rank holds its blocks of the parameters, the
gradients and the moments (the reference's ZeRO: ``m`` and ``v`` laid
out as the parameters), and :func:`global_norm` is the norm of the
global tree: each leaf's sum of squares summed over the axes it is split
over, a leaf held whole counted once. The update is elementwise, so it
needs nothing else from the other ranks.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import TensorStruct, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params) -> dict:
    """Zero moments shaped as ``params`` (float32) and an int32 step 0 on
    their device."""
    def zeros():
        return tree_map(lambda _, p: torch.zeros_like(
            p, dtype=torch.float32, requires_grad=False), params)
    device = tree_leaves(params)[0].device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_struct(param_struct) -> dict:
    """The optimizer state's TensorStructs for a parameter struct tree."""
    def z():
        return tree_map(lambda _, s: TensorStruct(tuple(s.shape), s.dtype),
                        param_struct)
    return {"m": z(), "v": z(), "step": TensorStruct((), torch.int32)}


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return warm * cfg.lr


def global_norm(tree, rules=None, specs=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` taken together, float32:
    the square root of the sum, in leaf order, of each leaf's squared
    norm. With ``rules`` the leaves are this rank's blocks of the leaves
    of ``specs`` (the ParamSpec tree): each squared norm is summed over
    the mesh axes its leaf is split over (one all-reduce per set of axes),
    so every rank gets the same norm of the global tree."""
    leaves = [x.float() for x in tree_leaves(tree)]
    sq = torch.stack(torch._foreach_norm(leaves)).square()
    if rules is not None:
        mesh = rules.mesh
        groups: dict = {}
        for i, spec in enumerate(tree_leaves(specs)):
            pspec = rules.param_pspec(spec)
            axes = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1 and
                         any(a in pspec.axes_of(d)
                             for d in range(len(spec.shape))))
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            at = torch.tensor(idx, device=sq.device)
            sq[at] = mesh.all_reduce(sq[at], axes)
    return sq.sum().sqrt()


#: Values updated at once: a group of leaves, or a piece of a larger one
#: (whole leading-axis slices where one holds that many).
UPDATE_CHUNK = 1 << 26


def _pieces(t: torch.Tensor) -> list:
    """``t`` as views of at most UPDATE_CHUNK elements (whole leading-axis
    slices where one holds that many), covering it once."""
    if t.numel() <= UPDATE_CHUNK or t.dim() == 0:
        return [t]
    if t[0].numel() <= UPDATE_CHUNK:
        step = max(1, UPDATE_CHUNK // t[0].numel())
        return list(t.split(step))
    return [p for row in t for p in _pieces(row)]


def _groups(pieces):
    """Consecutive runs of ``pieces`` (tuples whose first tensor sizes
    them) of at most UPDATE_CHUNK values each."""
    group, n = [], 0
    for q in pieces:
        if group and n + q[0].numel() > UPDATE_CHUNK:
            yield group
            group, n = [], 0
        group.append(q)
        n += q[0].numel()
    if group:
        yield group


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params, rules=None,
                 specs=None):
    """Returns (params, opt_state, metrics), the tensors of ``params`` and
    ``opt_state`` updated in place; metrics: grad_norm (before clipping)
    and lr, float32 scalars. With ``rules``, every tree holds this rank's
    blocks of the leaves of ``specs`` (:func:`global_norm`)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, rules, specs)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]))
    for group in _groups(q for leaf in leaves
                         for q in zip(*map(_pieces, leaf))):
        ps, gs, ms, vs = map(list, zip(*group))
        g = torch._foreach_mul([x.float() for x in gs], scale)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(g, g)
        torch._foreach_mul_(g, 1 - b2)
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, g)
        del g
        delta = torch._foreach_div(ms, bc1)             # mhat
        den = torch._foreach_div(vs, bc2)               # vhat
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_div_(delta, den)
        del den
        torch._foreach_add_(delta, torch._foreach_mul(ps, cfg.weight_decay))
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(ps, delta)
        del delta
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
