"""Checkpoint / restart in the JAX package's on-disk format.

The port of the JAX package's ``train/checkpoint.py``: a checkpoint is a
directory ``step_%08d/`` holding ``params.npz``, ``opt_m.npz`` and
``opt_v.npz`` (each leaf a float array keyed by its tree path joined by
``/``, list indexes as integers), ``manifest.json`` (``step``,
``opt_step`` and the caller's extras, such as the data iterator's state)
and a ``DONE`` marker written last. Either package restores the other's
checkpoints. Each ``.npz`` is written one leaf at a time (the archive
``np.savez`` writes, member by member), so the host holds one leaf, not
the tree.

A sharded state (``rules``: each rank holds its blocks, as
``Rules.param_pspec`` lays them out) is written whole, the reference's
mesh-flexible layout: every rank takes part in gathering each leaf (a
stacked leaf one layer at a time) and the rank at the mesh's origin
writes it. Restored with ``rules``, each rank reads its blocks of the
leaves (``launch.elastic.reshard_plan``), on any mesh.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.launch.elastic import reshard_plan
from repro_torch.models.layers import tree_leaves, tree_map, tree_paths
from repro_torch.sharding.rules import local_slices


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@torch.no_grad()
def whole_leaf(t: torch.Tensor, spec, rules) -> np.ndarray:
    """The whole leaf (on the host) of which ``t`` is this rank's block
    under ``rules`` (``spec`` its ParamSpec): gathered over each split
    dimension's axes, a leaf whose leading dimension is not split one
    index of it at a time. A dimension its axes do not divide (MoE
    experts over "model": ``block_range``'s short or empty last blocks)
    is padded to the full block before the gather and cut after it. Every
    rank of the mesh must call it, in the same order."""
    pspec, mesh = rules.param_pspec(spec), rules.mesh

    def gather(x, dims):
        for d in dims:
            axes = pspec.axes_of(d)
            n = mesh.axis_size(axes)
            if n > 1:
                at = d - (len(pspec) - x.dim())
                size = -(-spec.shape[d] // n)
                if x.shape[at] < size:
                    pad = list(x.shape)
                    pad[at] = size - x.shape[at]
                    x = torch.cat([x, x.new_zeros(pad)], at)
                x = mesh.all_gather(x, axes, at).narrow(
                    at, 0, spec.shape[d])
        return x
    split = [d for d in range(len(pspec)) if pspec.axes_of(d)]
    if t.dim() > 1 and split and 0 not in split:
        out = None
        for j in range(t.shape[0]):
            row = _host(gather(t[j], split))
            if out is None:
                out = np.empty((t.shape[0],) + row.shape, row.dtype)
            out[j] = row
        return out
    return _host(gather(t, split))


@torch.no_grad()
def _write_npz(path: str, tree, layout=None) -> None:
    """``tree``'s leaves into the ``.npz`` archive ``path``, one member
    at a time; ``layout`` = (rules, specs) gathers each whole first (only
    the writing rank holds the archive open)."""
    writer = layout is None or layout[0].mesh.rank == 0
    zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) \
        if writer else None
    try:
        specs = tree_leaves(layout[1]) if layout is not None else None
        for i, (p, leaf) in enumerate(zip(tree_paths(tree),
                                          tree_leaves(tree))):
            arr = _host(leaf) if layout is None else whole_leaf(
                leaf, specs[i], layout[0])
            if zf is not None:
                with zf.open(_key(p) + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.ascontiguousarray(arr),
                                              allow_pickle=False)
            del arr
    finally:
        if zf is not None:
            zf.close()


def _unflatten_like(tree, flat, device, slices_of=None):
    def take(path, like):
        key = _key(path)
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        if slices_of is not None:
            arr = arr[slices_of(path)]
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return tree_map(take, tree)


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state,
                    manifest_extra: Optional[dict] = None, rules=None,
                    specs=None) -> str:
    """Write ``step_%08d/`` under ``ckpt_dir`` (the DONE marker last);
    returns its path. With ``rules`` (and ``specs``, the model's
    ParamSpec tree) the trees hold this rank's blocks: every rank calls
    this, each leaf is gathered whole, the mesh's rank 0 writes, and every
    rank returns once the checkpoint is complete."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    layout = None if rules is None else (rules, specs)
    writer = rules is None or rules.mesh.rank == 0
    if writer:
        os.makedirs(d, exist_ok=True)
    _write_npz(os.path.join(d, "params.npz"), params, layout)
    _write_npz(os.path.join(d, "opt_m.npz"), opt_state["m"], layout)
    _write_npz(os.path.join(d, "opt_v.npz"), opt_state["v"], layout)
    if writer:
        manifest = {"step": step, "opt_step": int(opt_state["step"]),
                    **(manifest_extra or {})}
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        with open(os.path.join(d, "DONE"), "w") as f:
            f.write("ok")
    if rules is not None:
        rules.mesh.barrier()
    return d


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest complete (DONE) checkpoint under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    done = [d for d in sorted(os.listdir(ckpt_dir))
            if d.startswith("step_")
            and os.path.exists(os.path.join(ckpt_dir, d, "DONE"))]
    return os.path.join(ckpt_dir, done[-1]) if done else None


def load_checkpoint(path: str, params_like, opt_like, device=None,
                    rules=None) -> tuple[Any, Any, dict]:
    """(params, opt_state, manifest) from ``path``, shaped and keyed as
    ``params_like`` and ``opt_like`` (trees of tensors or TensorStructs;
    a shape that differs raises), as tensors on ``device`` (default the
    CPU). ``Model.master_params(params)`` makes trainable leaves of the
    parameters. With ``rules``, ``params_like`` is the model's ParamSpec
    tree (``opt_like`` may be None) and each tree holds this rank's blocks
    of the leaves, laid out by ``launch.elastic.reshard_plan`` on the
    rules' mesh, whatever mesh wrote them."""
    device = torch.device(device or "cpu")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    slices_of = None
    if rules is not None:
        plan = reshard_plan(params_like, rules)

        def slices_of(p):
            spec = params_like
            pspec = plan
            for k in p:
                spec, pspec = spec[k], pspec[k]
            return local_slices(pspec, spec.shape, rules.mesh)
        opt_like = {"m": params_like, "v": params_like}

    def load(name, like):
        with np.load(os.path.join(path, name)) as z:
            return _unflatten_like(like, z, device, slices_of)
    params = load("params.npz", params_like)
    opt_state = {"m": load("opt_m.npz", opt_like["m"]),
                 "v": load("opt_v.npz", opt_like["v"]),
                 "step": torch.tensor(manifest["opt_step"],
                                      dtype=torch.int32, device=device)}
    return params, opt_state, manifest
