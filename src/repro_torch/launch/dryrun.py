"""The multi-pod dry run: one step of every (arch x shape) cell as one
rank of the production meshes, on the CPU, holding no memory.

The port of the JAX package's ``launch/dryrun.py``. For every
(architecture x ``applicable_shapes``) cell, on the single-pod 16 x 16
mesh and the 2 x 16 x 16 multi-pod mesh (``launch/mesh.py``'s
``make_production_mesh``), :func:`lower_cell` runs one step of the cell
as rank 0 of a process group on torch's ``fake`` backend (world 256 or
512: every collective returns at once) under ``FakeTensorMode`` (every
tensor has a shape and a dtype and no storage; a data-dependent shape
stays symbolic in its shape environment): the AdamW train step
laid out by :func:`train_layout` for a train cell, the prefill or one
decode step under the serving rules and the production cache shardings
for a serving cell. Where the reference lowers and compiles the step and
reads XLA's memory and cost analyses and the HLO's collectives, the port
observes the step: ``analysis/audit.Recorder`` lists its c10d calls and
``torch.utils.flop_counter.FlopCounterMode`` counts its FLOPs;
``launch/op_stats.py`` turns the call list into the reference's
``collective_bytes``, ``collective_bytes_by_kind`` and
``collective_count_by_kind``. Parameter, optimizer and cache bytes a
card come from ``Rules.param_pspec`` and ``cache_shardings``. Fake
tensors hold no allocator, so ``temp_bytes`` is null. The raw call list
is saved gzipped beside the record (the reference saves the HLO), and
``launch/restat.py`` recomputes the statistics from it. A cell that
cannot run under fake tensors is written to ``<tag>.json.err``, and
:func:`main` exits 1 on any failure, as the reference's does.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod {0,1,both}] [--out results/torch_dryrun]

Before it lowers a train cell the reference picks the cell's layout; this
module ports that choice too:

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
  overrides are not read: the layout is the default choice.

Importing it touches no device and sets no environment variable (the
reference's module forces 512 host devices at import).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

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


#: Mesh sizes of the production meshes (single-pod, multi-pod).
WORLD = {False: 256, True: 512}
TEMP_BYTES_NOTE = ("null: fake tensors hold no allocator, so the step's "
                   "transient memory is not observed")


def cell_tag(arch_id: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch_id}__{shape_name}__{'mp' if multi_pod else 'sp'}"


def _nbytes(shape, dtype) -> int:
    import torch
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def prepare_cell(cfg, shape, mesh, layout_cfg=None) -> tuple:
    """Build one step of ``cfg`` at ``shape`` (a ``configs.ShapeConfig``)
    as this rank of ``mesh`` (a ``runtime.mesh.ProcessMesh`` over the
    current group): (run, model, facts), ``run()`` the step, ``facts``
    the per-device state bytes and the train cell's layout (chosen for
    ``layout_cfg``, default ``cfg``: a config cut in depth keeps its
    deployment's layout). Under
    ``FakeTensorMode`` when called inside one (the dry run), on real
    tensors otherwise (the tests' gloo runs of the same step)."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve.serve_step import (cache_shardings,
                                              make_serve_fns,
                                              prefill_input_structs)
    from repro_torch.sharding import make_rules
    from repro_torch.sharding.ctx import sharding_ctx
    from repro_torch.sharding.rules import block_range, local_shape
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import batch_struct, make_train_step

    gb = shape.global_batch
    facts: dict = {}
    if shape.kind == "train":
        layout = train_layout(layout_cfg or cfg, dict(mesh.shape), gb)
        model = build_model(cfg, tp=layout.tp, compute_dtype=torch.bfloat16,
                            device="cpu")
        rules = make_rules(mesh, "train", gb, kv_sharded=model.kv_sharded,
                           no_tp=layout.no_tp)
        params = model.master_params(rules=rules)
        state = init_opt_state(params)
        structs = batch_struct(model, gb, shape.seq_len, layout.accum)
        bax = rules.batch_axes
        mb = gb // layout.accum
        lo, hi = block_range(mb, mesh.axis_size(bax),
                             mesh.axis_index(bax)) if bax else (0, mb)
        batch = {k: torch.zeros((st.shape[0], hi - lo) + st.shape[2:],
                                dtype=st.dtype)
                 for k, st in structs.items()}
        step = make_train_step(model, AdamWConfig(), rules)
        param_bytes = sum(t.numel() * 4 for t in tree_leaves(params))
        facts.update(accum_steps=layout.accum, no_tp=layout.no_tp,
                     param_bytes=param_bytes, optimizer_bytes=2 * param_bytes,
                     cache_bytes=0)
        return (lambda: step(params, state, batch)), model, facts
    tp = int(mesh.shape.get("model", 1))
    model = build_model(cfg, tp=tp, compute_dtype=torch.bfloat16,
                        device="cpu")
    rules = make_rules(mesh, shape.kind, gb, kv_sharded=model.kv_sharded)
    model.init(rules=rules)
    bax = rules.batch_axes
    lo, hi = block_range(gb, mesh.axis_size(bax),
                         mesh.axis_index(bax)) if bax else (0, gb)
    c_structs = tree_leaves(model.cache_structs(gb, shape.seq_len))
    c_specs = tree_leaves(cache_shardings(
        rules, model.cache_structs(gb, shape.seq_len)))
    facts.update(param_bytes=sum(t.numel() * t.element_size()
                                 for t in tree_leaves(model.tree)),
                 optimizer_bytes=0,
                 cache_bytes=sum(_nbytes(local_shape(p, st.shape, mesh),
                                         st.dtype)
                                 for p, st in zip(c_specs, c_structs)))
    if shape.kind == "prefill":
        prefill, _ = make_serve_fns(model, rules, max_len=shape.seq_len)
        batch = {k: torch.zeros((hi - lo,) + st.shape[1:], dtype=st.dtype)
                 for k, st in prefill_input_structs(model, gb,
                                                    shape.seq_len).items()}
        return (lambda: prefill(batch)), model, facts
    _, decode = make_serve_fns(model, rules)
    with sharding_ctx(rules, mesh, model.cfg.d_model):
        caches = model.init_cache(gb, shape.seq_len)
    tok = torch.zeros((hi - lo, 1), dtype=torch.int32)
    return (lambda: decode(tok, caches, shape.seq_len - 1)), model, facts


def run_cell(cfg, shape, mesh, layout_cfg=None) -> tuple:
    """:func:`prepare_cell` and the step, under ``FakeTensorMode``, its
    c10d calls recorded and its FLOPs counted: (the per-device part of
    the record, extras: the calls, the FLOPs by op, the model and the
    train layout)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.audit import Recorder

    # A shape environment lets a data-dependent shape (a masked cache
    # write's positions) stay symbolic instead of stopping the step.
    with FakeTensorMode(shape_env=ShapeEnv()):
        run, model, facts = prepare_cell(cfg, shape, mesh, layout_cfg)
        rec = Recorder()
        flops = FlopCounterMode(display=False)
        with flops, rec:
            run()
    extra = {k: facts.pop(k) for k in ("accum_steps", "no_tp")
             if k in facts}
    extra["calls"] = rec.calls
    extra["flops_by_op"] = {str(k): int(v) for k, v in sorted(
        flops.get_flop_counts().get("Global", {}).items(), key=str)}
    extra["model"] = model
    return {"flops": float(flops.get_total_flops()), **facts,
            "temp_bytes": None}, extra


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool,
               calls_dir: str = "results/torch_dryrun_calls") -> dict:
    """The record of one (arch x shape) cell on the single-pod (or the
    multi-pod) production mesh; the process group must be the fake
    backend's at that mesh's world (:func:`main` sets it up)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import op_stats
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.mesh import ProcessMesh

    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    topo = make_production_mesh(multi_pod=multi_pod,
                                num_devices=WORLD[multi_pod],
                                device_kind="tpu")
    mesh = ProcessMesh.build(topo, "cpu")
    t0 = time.perf_counter()
    per_device, extra = run_cell(cfg, shape, mesh)
    seconds = time.perf_counter() - t0
    calls = extra.pop("calls")
    flops_by_op = extra.pop("flops_by_op")
    model = extra.pop("model")
    coll = op_stats.collect_collective_stats(calls)
    per_device.update({
        "collective_bytes": coll.total_bytes,
        "collective_bytes_by_kind": coll.bytes_by_kind,
        "collective_count_by_kind": coll.count_by_kind,
        "collective_wire_bytes_by_kind": coll.wire_bytes_by_kind,
        "all_to_all_span": op_stats.all_to_all_span_bytes(calls),
        "ambiguous_loops": coll.ambiguous_loops,
    })
    tag = cell_tag(arch_id, shape_name, multi_pod)
    if calls_dir:
        os.makedirs(calls_dir, exist_ok=True)
        op_stats.save_calls(os.path.join(calls_dir, tag + ".calls.json.gz"),
                            calls, per_device["flops"], flops_by_op)
    return {
        "arch": arch_id, "shape": shape_name,
        "mesh": "x".join(str(s) for s in topo.axis_sizes),
        "kind": shape.kind, "run_seconds": round(seconds, 2),
        "num_params": model.count_params(),
        "num_params_raw": model.raw_cfg.num_params(),
        "num_params_active": model.raw_cfg.num_active_params(),
        "per_device": per_device,
        "notes": {"temp_bytes": TEMP_BYTES_NOTE,
                  "flops": "FlopCounterMode over the step (the matmuls, "
                           "convolutions and attention it registers)"},
        **extra,
    }


def main(argv=None) -> None:
    from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
    from repro_torch.runtime import spmd

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="one step of every (arch x shape) cell as rank 0 of "
                    "the production meshes, under fake tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", default="both", choices=["0", "1", "both"])
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--calls", default="results/torch_dryrun_calls",
                    help="directory of the gzipped call lists")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    pods = {"0": [False], "1": [True], "both": [False, True]}[args.multi_pod]
    failures = []
    for mp in pods:
        spmd.destroy_group()
        spmd.init_fake_group(WORLD[mp], 0)
        for arch_id in archs:
            shapes = ([args.shape] if args.shape
                      else applicable_shapes(get_config(arch_id)))
            for shape_name in shapes:
                tag = cell_tag(arch_id, shape_name, mp)
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                print(f"[run] {tag} ...", flush=True)
                try:
                    rec = lower_cell(arch_id, shape_name, mp, args.calls)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=2)
                    pd = rec["per_device"]
                    print(f"[ok] {tag}: {rec['run_seconds']}s "
                          f"flops/dev={pd['flops']:.3e} "
                          f"params/dev={pd['param_bytes'] / 2**30:.2f}GiB "
                          f"coll/dev={pd['collective_bytes'] / 2**30:.3f}GiB",
                          flush=True)
                except Exception as e:  # noqa: BLE001 - record and go on
                    failures.append(tag)
                    with open(path + ".err", "w") as f:
                        f.write(traceback.format_exc())
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
    spmd.destroy_group()
    print(f"\ndone. failures: {failures if failures else 'none'}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
