"""Train step: microbatch-accumulated gradients, then AdamW.

The port of the JAX package's ``train/train_step.py``. The global batch
arrives as (accum, micro_batch, ...); each microbatch's loss and float32
gradients (autograd through ``Model.loss``, whose stack recomputes its
group bodies per ``REPRO_REMAT``) are summed, divided by ``accum``, and
handed to :func:`adamw_update`, so peak activation memory is one
microbatch's. The step updates the parameters and the optimizer state in
place and returns them with the metrics ``loss``, ``grad_norm`` and
``lr`` (float32 scalars on the device).

The gradients accumulate into one float32 buffer per leaf. Each layer's
block of a stacked leaf is an autograd leaf of its own whose ``.grad`` is
its block of the buffer, so autograd adds a layer's gradient into it in
place as soon as it is made (a stacked leaf read by slicing would make a
stacked-size gradient per layer). A buffer is made, by a hook, at its
leaf's first gradient in the first microbatch's backward pass, so the
forward pass before it holds none; after the last microbatch the step
checks that every ``.grad`` is still its block of the buffer. Peak
memory is the masters, the moments, the gradient buffers made so far
and one microbatch's activations.

Under ``rules`` (every family; ``Model.loss``) the step runs inside
``sharding_ctx(rules, rules.mesh, d_model)`` on this rank's blocks of
the masters and moments (``Rules.param_pspec``; the reference's
``o_sh = {"m": p_sh, "v": p_sh}``) and its rows of the batch
(:func:`batch_shardings`).
Autograd sums each leaf's gradient over the axes its FSDP gather runs
over (the gather's adjoint is a reduce-scatter); after the last
microbatch :func:`reduce_grads` sums, per
:func:`grad_reduce_axes`, the rest: the batch axes a leaf is not split
over, and "model" for a leaf held whole on a tensor-parallel mesh whose
uses there are each rank's own (the norms on a residual split by
sequence, KV projections held whole and used by each rank's heads, the
MoE router, MLA's latent projections and norms, the SSD's B/C path and
the RG-LRU's gate biases and decay). The metrics come out the same on
every rank, and so do the leaves every rank holds whole.

:func:`batch_shardings` is the reference's batch layout (a
``PartitionSpec`` per leaf: the tokens, the labels and the
encoder-decoder's frames or a vision config's image embeddings split
by rows alike).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.layers import (TensorStruct, tree_leaves, tree_map,
                                       tree_paths)
from repro_torch.models.transformer import Layers
from repro_torch.sharding import ctx as shard
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def _on(device, x):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device)


def grad_reduce_axes(spec, rules) -> tuple:
    """The mesh axes, in mesh order, over which the train step sums the
    gradient of the leaf of ``spec`` (its ParamSpec) after autograd: the
    batch axes the leaf is not split over (a split axis is summed by its
    gather's adjoint), and, on a tensor-parallel "model" axis the leaf is
    held whole on, "model" where each rank's use of it is its own: a KV
    projection held whole (each rank's heads read their KV heads), a leaf
    its mixer marks ``partial_grad`` (the MoE router, which each rank's
    experts' gates and positions read; MLA's latent projections and norms
    and the SSD's B and C projections and convs, which each rank's heads
    read; the RG-LRU's gate biases and decay, sliced to each rank's
    channels), and any leaf of a residual split by
    sequence (the norms run on each rank's positions). Without sequence
    parallelism a norm runs on the whole residual on every rank, the same
    on each, and is not summed."""
    mesh = rules.mesh
    pspec = rules.param_pspec(spec)
    split = {a for d in range(len(spec.shape)) for a in pspec.axes_of(d)}
    out = {a for a in rules.batch_axes if a not in split}
    if not rules.no_tp and mesh.shape.get("model", 1) > 1 and \
            "model" not in split:
        seq = rules.activation_spec("act_btd", 3)
        if "kv" in spec.axes or spec.partial_grad or (
                seq is not None and "model" in seq.axes_of(1)):
            out.add("model")
    return tuple(a for a in mesh.axis_names
                 if a in out and mesh.shape[a] > 1)


def reduce_grads(grads: list, specs: list, rules) -> None:
    """Sum each gradient of ``grads`` (this rank's, float32) in place over
    its :func:`grad_reduce_axes`, one all-reduce per distinct set of axes
    over the leaves' values laid end to end."""
    groups: dict = {}
    for g, spec in zip(grads, specs):
        axes = grad_reduce_axes(spec, rules)
        if axes:
            groups.setdefault(axes, []).append(g)
    for axes, gs in groups.items():
        flat = torch.cat([g.reshape(-1) for g in gs])
        rules.mesh.all_reduce(flat, axes)
        torch._foreach_copy_(gs, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in gs]), gs)])


def _grad_leaves(params, specs, buffers: list):
    """(the tree ``Model.loss`` reads, its autograd leaves and their
    blocks of the buffers, by leaf of ``params``): each leaf of ``params``
    detached as an autograd leaf, a stacked leaf (first axis "layers") as
    :class:`Layers`, one autograd leaf per layer. A hook on each makes
    ``buffers[i]`` (the float32 gradient of the i-th leaf, zero) at the
    leaf's first gradient and sets the ``.grad`` of each of the leaf's
    autograd leaves to its block of the buffer, so that autograd adds
    that gradient and every later one into the buffer in place."""
    stacked = [spec.axes[:1] == ("layers",) for spec in tree_leaves(specs)]
    leaves: list = []
    blocks: list = [None] * len(stacked)

    def first(i, shape, g):
        if buffers[i] is None:
            buffers[i] = torch.zeros(shape, dtype=torch.float32,
                                     device=g.device)
            blocks[i] = list(buffers[i].unbind(0)) if stacked[i] \
                else [buffers[i]]
            for v, b in zip(leaves[i], blocks[i]):
                v.grad = b

    def hooked(t, i, shape):
        v = t.requires_grad_(True)
        v.register_hook(functools.partial(first, i, shape))
        return v

    def leaf(_, t):
        i = len(leaves)
        if stacked[i]:
            leaves.append([hooked(t.detach()[j], i, t.shape)
                           for j in range(t.shape[0])])
            return Layers(leaves[i])
        leaves.append([hooked(t.detach(), i, t.shape)])
        return leaves[i][0]
    return tree_map(leaf, params), leaves, blocks


def train_grads(model, params, batch, rules=None):
    """(loss, grads) of one train step before its update: the mean over
    the ``accum`` microbatches of ``batch`` (leaves (accum, micro_batch,
    ...), moved to the model's device) of ``Model.loss`` and of its
    float32 gradients (a tree like ``params``). With ``rules`` the
    gradients are this rank's blocks of the global step's (each summed
    over the ranks as :func:`reduce_grads` says), and the loss is the
    global batch's on every rank."""
    specs = model.param_specs()
    if tree_paths(params) != tree_paths(specs):
        raise ValueError("parameter tree paths differ from the specs'")
    ctx = shard.sharding_ctx(rules, rules.mesh, model.cfg.d_model) \
        if rules is not None \
        else contextlib.nullcontext()
    batch = {k: _on(model.device, v) for k, v in batch.items()}
    accum = next(iter(batch.values())).shape[0]
    masters = tree_leaves(params)
    buffers = [None] * len(masters)
    tree, leaves, blocks = _grad_leaves(params, specs, buffers)
    loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
    try:
        with ctx:
            for i in range(accum):
                loss = model.loss({k: v[i] for k, v in batch.items()}, tree)
                loss.backward()
                loss_sum = loss_sum + loss.detach()
                del loss
        replaced = any(v.grad is None or v.grad.data_ptr() != b.data_ptr()
                       for vs, bs in zip(leaves, blocks)
                       for v, b in zip(vs, bs or ()))
    finally:
        # the hooks reach these lists: emptied, no reference cycle keeps
        # the autograd leaves and the buffers alive past the step
        leaves.clear()
        blocks.clear()
    if replaced:
        raise RuntimeError("autograd replaced a gradient buffer instead of "
                           "adding into it")
    del tree
    grads = [g if g is not None else torch.zeros_like(t, dtype=torch.float32)
             for g, t in zip(buffers, masters)]
    if rules is not None:
        reduce_grads(grads, tree_leaves(specs), rules)
    torch._foreach_div_(grads, float(accum))
    it = iter(grads)
    return loss_sum / accum, tree_map(lambda _, __: next(it), params)


def make_train_step(model, opt_cfg: AdamWConfig, rules: Optional[Any] = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    for ``model`` (a ``repro_torch.models.Model``) with float32 master
    ``params`` (``Model.master_params``); ``batch`` leaves are
    (accum, micro_batch, ...) tensors or arrays, moved to the model's
    device. With ``rules`` (``sharding.make_rules(mesh, "train", ...)``):
    ``params`` and ``opt_state``'s moments are this rank's blocks
    (``Model.master_params(..., rules=rules)``) and ``batch`` this rank's
    rows (:func:`batch_shardings`); the metrics are the global step's, on
    every rank."""
    if rules is not None:
        model.check_rules(rules)
    specs = model.param_specs()

    def train_step(params, opt_state, batch):
        loss, grads = train_grads(model, params, batch, rules)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params, rules, specs)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def batch_struct(model, global_batch: int, seq_len: int,
                 accum: int = 1) -> dict:
    """TensorStructs of a train step's batch: tokens and labels, with the
    encoder-decoder's frames and a vision config's image embeddings."""
    cfg = model.cfg
    mb = global_batch // accum
    s: dict[str, Any] = {
        "tokens": TensorStruct((accum, mb, seq_len), torch.int32),
        "labels": TensorStruct((accum, mb, seq_len), torch.int32),
    }
    if cfg.family == "audio":
        s["frames"] = TensorStruct(
            (accum, mb, cfg.encoder_len, cfg.d_model), model.compute_dtype)
    if cfg.num_patches:
        s["image_embeds"] = TensorStruct(
            (accum, mb, cfg.num_patches, cfg.d_model), model.compute_dtype)
    return s


def batch_shardings(rules, batch_s) -> dict:
    """Microbatch dims: (accum None, batch over the rules' batch axes, the
    rest None), a ``PartitionSpec`` per leaf of ``batch_s``."""
    return tree_map(lambda _, s: P(None, rules.batch_axes or None,
                                   *([None] * (len(s.shape) - 2))), batch_s)
