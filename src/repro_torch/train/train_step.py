"""Train step: microbatch-accumulated gradients, then AdamW.

The port of the JAX package's ``train/train_step.py``. The global batch
arrives as (accum, micro_batch, ...); each microbatch's loss and float32
gradients (autograd through ``Model.loss``, whose stack recomputes its
group bodies per ``REPRO_REMAT``) are summed, divided by ``accum``, and
handed to :func:`adamw_update`, so peak activation memory is one
microbatch's. The step updates the parameters and the optimizer state in
place and returns them with the metrics ``loss``, ``grad_norm`` and
``lr`` (float32 scalars on the device).

:func:`batch_shardings` is the reference's batch layout (a
``PartitionSpec`` per leaf); a train step under rules is ROADMAP item 15e.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.layers import TensorStruct, tree_leaves, tree_map
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def _on(device, x):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device)


def make_train_step(model, opt_cfg: AdamWConfig, rules: Optional[Any] = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    for ``model`` (a ``repro_torch.models.Model``) with float32 master
    ``params`` (``Model.master_params``); ``batch`` leaves are
    (accum, micro_batch, ...) tensors or arrays, moved to the model's
    device."""
    if rules is not None:
        raise NotImplementedError(
            "training under sharding rules is not ported yet (ROADMAP item "
            "15e)")

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        batch = {k: _on(model.device, v) for k, v in batch.items()}
        accum = next(iter(batch.values())).shape[0]
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        grads = None
        for i in range(accum):
            loss = model.loss({k: v[i] for k, v in batch.items()}, params)
            g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
            loss_sum = loss_sum + loss.detach()
            if grads is None:
                grads = [x.float() for x in g]
            else:
                torch._foreach_add_(grads, [x.float() for x in g])
            del loss, g
        torch._foreach_div_(grads, float(accum))
        it = iter(grads)
        grads = tree_map(lambda _, __: next(it), params)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        metrics["loss"] = loss_sum / accum
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
