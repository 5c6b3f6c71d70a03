"""Checkpoint / restart in the JAX package's on-disk format.

The port of the JAX package's ``train/checkpoint.py``: a checkpoint is a
directory ``step_%08d/`` holding ``params.npz``, ``opt_m.npz`` and
``opt_v.npz`` (each leaf a float array keyed by its tree path joined by
``/``, list indexes as integers), ``manifest.json`` (``step``,
``opt_step`` and the caller's extras, such as the data iterator's state)
and a ``DONE`` marker written last. Either package restores the other's
checkpoints.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.layers import tree_map


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}

    def put(path, leaf):
        flat[_key(path)] = leaf.detach().cpu().numpy() \
            if torch.is_tensor(leaf) else np.asarray(leaf)
    tree_map(put, tree)
    return flat


def _unflatten_like(tree, flat, device):
    def take(path, like):
        key = _key(path)
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        return torch.from_numpy(arr).to(device)
    return tree_map(take, tree)


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state,
                    manifest_extra: Optional[dict] = None) -> str:
    """Write ``step_%08d/`` under ``ckpt_dir`` (the DONE marker last);
    returns its path."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "params.npz"), **_flatten(params))
    np.savez(os.path.join(d, "opt_m.npz"), **_flatten(opt_state["m"]))
    np.savez(os.path.join(d, "opt_v.npz"), **_flatten(opt_state["v"]))
    manifest = {"step": step, "opt_step": int(opt_state["step"]),
                **(manifest_extra or {})}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    with open(os.path.join(d, "DONE"), "w") as f:
        f.write("ok")
    return d


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest complete (DONE) checkpoint under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    done = [d for d in sorted(os.listdir(ckpt_dir))
            if d.startswith("step_")
            and os.path.exists(os.path.join(ckpt_dir, d, "DONE"))]
    return os.path.join(ckpt_dir, done[-1]) if done else None


def load_checkpoint(path: str, params_like, opt_like,
                    device=None) -> tuple[Any, Any, dict]:
    """(params, opt_state, manifest) from ``path``, shaped and keyed as
    ``params_like`` and ``opt_like`` (trees of tensors or TensorStructs;
    a shape that differs raises), as tensors on ``device`` (default the
    CPU). ``Model.master_params(params)`` makes trainable leaves of the
    parameters."""
    device = torch.device(device or "cpu")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def load(name, like):
        with np.load(os.path.join(path, name)) as z:
            return _unflatten_like(like, dict(z), device)
    params = load("params.npz", params_like)
    opt_state = {"m": load("opt_m.npz", opt_like["m"]),
                 "v": load("opt_v.npz", opt_like["v"]),
                 "step": torch.tensor(manifest["opt_step"],
                                      dtype=torch.int32, device=device)}
    return params, opt_state, manifest
