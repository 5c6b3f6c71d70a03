"""The train-cell choices of the JAX package's ``launch/dryrun.py``.

The reference's ``lower_cell`` lowers every (arch x shape) cell on the
production mesh; before it lowers a train cell it picks the cell's
layout, and this module ports that choice (the lowering and its HLO
statistics are ROADMAP item 14):

* :func:`no_tp_default`: the ``no_tp`` rules (the "model" axis used as
  extra data parallelism, ZeRO over both axes) for small dense models: not
  MoE, not the encoder-decoder, not the SSD, under 2B parameters, the
  global batch divisible by the devices.
* :func:`accum_steps`: the microbatches of a train step, keyed by the
  config's scale: the largest microbatch that fits, so the FSDP gathers,
  which run once a microbatch, stay few.
* :func:`train_layout`: both, with the model's ``tp`` (1 under ``no_tp``,
  else the mesh's "model" size) and the data-parallel degree.
  ``scripts/torch_distributed_check.py --only lm_train_tp`` lays its runs
  out by it. The reference's ``REPRO_NO_TP`` and ``REPRO_ACCUM``
  overrides belong to its lowering (item 14) and are not read here.

Importing it touches no device and sets no environment variable (the
reference's module forces 512 host devices at import).
"""
from __future__ import annotations

import dataclasses

#: The reference's parameter bound for the no_tp default.
NO_TP_MAX_PARAMS = 2_000_000_000


def accum_steps(cfg, global_batch: int, dp: int) -> int:
    """Microbatches per train step for ``cfg`` at ``global_batch`` over
    ``dp`` data-parallel devices: a target of sequences per device a
    microbatch (MoE 4 once 16 or more sequences fall to a device, else 2;
    the SSD 4; a model of d_model 4096 or more 2; the rest 8), then the
    largest count at or below ``per device / target`` that divides the
    batch over the devices."""
    per_dev = max(global_batch // dp, 1)
    if cfg.moe:
        target = 4 if per_dev >= 16 else 2
    elif cfg.ssm_state:
        target = 4
    elif cfg.d_model >= 4096:
        target = 2
    else:
        target = 8
    accum = max(per_dev // target, 1)
    while global_batch % (accum * dp) and accum > 1:
        accum -= 1
    return accum


def no_tp_default(cfg, kind: str, global_batch: int, chips: int) -> bool:
    """Whether the reference trains ``cfg`` under the ``no_tp`` rules by
    default on ``chips`` devices (see the module)."""
    return (kind == "train" and not cfg.moe and cfg.family != "audio"
            and not cfg.ssm_state
            and cfg.num_params() < NO_TP_MAX_PARAMS
            and global_batch % chips == 0)


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    no_tp: bool
    tp: int          # the tp build_model pads for
    dp: int          # the data-parallel degree accum_steps divides by
    accum: int


def train_layout(cfg, mesh_shape: dict, global_batch: int,
                 kind: str = "train") -> TrainLayout:
    """The layout ``lower_cell`` gives a train cell of ``cfg`` on a mesh
    of ``mesh_shape`` (axis name -> size: a ``ProcessMesh``'s or a
    ``Topology``'s ``shape``)."""
    chips = 1
    for size in mesh_shape.values():
        chips *= int(size)
    no_tp = no_tp_default(cfg, kind, global_batch, chips)
    model = int(mesh_shape.get("model", 1))
    dp = int(mesh_shape.get("pod", 1)) * int(mesh_shape.get("data", 1))
    if no_tp:
        dp *= model
    return TrainLayout(no_tp=no_tp, tp=1 if no_tp else model, dp=dp,
                       accum=accum_steps(cfg, global_batch, dp))
