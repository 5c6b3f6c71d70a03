"""AdamW over float32 master parameters.

The port of the JAX package's ``train/optimizer.py``, with its arithmetic
in its order: the gradients are clipped to a global norm, the learning
rate warms up linearly from the int32 step, the bias corrections are
float32, and the weight decay is added to the Adam direction before the
step (``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``). Not
``torch.optim.AdamW``, which decays the parameters by a separate multiply
before its step. Each stage runs as ``torch._foreach_*`` calls over all
the leaves at once.

The update runs in place: the parameter and moment tensors passed in are
the ones returned (the reference donates them to its jitted step).
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


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` taken together, float32."""
    norms = torch._foreach_norm([x.float() for x in tree_leaves(tree)])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """Returns (params, opt_state, metrics), the tensors of ``params`` and
    ``opt_state`` updated in place; metrics: grad_norm (before clipping)
    and lr, float32 scalars."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    ps = tree_leaves(params)
    ms = tree_leaves(opt_state["m"])
    vs = tree_leaves(opt_state["v"])
    g = torch._foreach_mul([x.float() for x in tree_leaves(grads)], scale)
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(g, g)
    torch._foreach_mul_(g, 1 - b2)
    torch._foreach_mul_(vs, b2)
    torch._foreach_add_(vs, g)
    del g
    delta = torch._foreach_div(ms, bc1)                 # mhat
    den = torch._foreach_div(vs, bc2)                   # vhat
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(delta, den)
    del den
    torch._foreach_add_(delta, torch._foreach_mul(ps, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(ps, delta)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
