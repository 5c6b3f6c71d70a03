#!/usr/bin/env python3
"""Reruns the MoE comparisons of ``torch_distributed_check.py --only
lm_train_tp`` routed as their references routed, to tell a failure that
routing flips cause from one of the expert-parallel arithmetic:

    torchrun --nproc_per_node=4 scripts/lm_train_tp_pinned.py --only lm_train_tp \\
        --runs llama4_bf16_1_layer,qwen3_moe_bf16_1_layer
    torchrun --nproc_per_node=4 scripts/lm_train_tp_pinned.py --only lm_train_tp --cpu

It takes the check's arguments and runs the check as it is. After each
float32 run held to one card, and each bf16 run held to its float32 run,
of an MoE config, every rank takes the same steps again from the same
draws with the MoE's route pinned to the expert ids the reference's
forward pass chose (each gate the probability of its pinned expert,
normalised over k) and remat off (``REPRO_REMAT=none``: the recompute
would route the groups again in the backward pass's order). Rank 0 prints
one more line a run: the pinned steps' metrics against the reference and
the check's bounds for it (``chip_smoke.train_mismatches`` for a float32
run; the loss and grad norm's relative gaps against
``LM_TRAIN_TP_BF16_RTOL`` for a bf16 one). Nothing here gates: the exit
code is the check's.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_distributed_check as check  # noqa: E402

CHECK_CASE = check.lm_train_tp_case


@contextlib.contextmanager
def pinned_routing(torch, pinned: list):
    """The MoE's route sends each call's tokens to the next record of
    ``pinned`` (expert ids of the reference's forward calls, in order)."""
    from repro_torch.models import moe
    plain = moe.route
    at = iter(pinned)

    def route(cfg, p, x):
        probs, _, ids = plain(cfg, p, x)
        if torch._C._current_graph_task_id() != -1:
            raise RuntimeError("pinned routing under remat")
        ids = next(at).to(ids.device)
        gates = probs.gather(-1, ids)
        return probs, gates / torch.clamp(gates.sum(-1, keepdim=True),
                                          min=1e-9), ids
    moe.route = route
    before = os.environ.get("REPRO_REMAT")
    os.environ["REPRO_REMAT"] = "none"
    try:
        yield
    finally:
        moe.route = plain
        if before is None:
            del os.environ["REPRO_REMAT"]
        else:
            os.environ["REPRO_REMAT"] = before


def pinned_case(torch, np, chip_smoke, run, shape, refs, rank: int,
                device, cpu: bool, gathered, corpora: dict, kept: dict,
                failed: list) -> bool:
    """check.lm_train_tp_case, then (an MoE run with a reference) its
    steps again routed as the reference routed."""
    import torch.distributed as dist
    from repro_torch.runtime.mesh import ProcessMesh
    from repro_torch.sharding import make_rules
    from repro_torch.sharding.rules import block_range
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    good = CHECK_CASE(torch, np, chip_smoke, run, shape, refs, rank, device,
                      cpu, gathered, corpora, kept, failed)
    name, arch, layers, dtype, _, steps, ref_kind = run
    one_card = ref_kind == "one_card"
    gate = (ref_kind or "").startswith("float32:")
    layout = check.lm_train_tp_layout(arch, shape, cpu)
    model = check.lm_train_tp_model(torch, chip_smoke, device, arch, layers,
                                    layout.tp, dtype, cpu)
    if not model.cfg.moe or not (one_card or gate):
        return good
    cell = check.LM_TRAIN_TP_CPU_CELL if cpu else check.LM_TRAIN_TP_CELL
    mesh = ProcessMesh(("data", "model"), shape, device)
    rules = make_rules(mesh, "train", cell["batch"],
                       kv_sharded=model.kv_sharded, no_tp=layout.no_tp)
    bax = rules.batch_axes
    mb = cell["batch"] // layout.accum
    lo, hi = block_range(mb, mesh.axis_size(bax), mesh.axis_index(bax)) \
        if bax else (0, mb)
    batches = check.lm_train_tp_batches(np, chip_smoke, corpora, model,
                                        device, steps, layout.accum, cpu)
    mine = [{k: v[:, lo:hi] for k, v in b.items()} for b in batches]
    key = (name, layout.tp, layout.accum)
    if one_card:
        objs = [refs[key]["routes"] if rank == 0 else None]
        dist.broadcast_object_list(objs, src=0)
        pin = [torch.from_numpy(r[lo:hi]) for r in objs[0]]
        want = refs[key] if rank == 0 else None
    else:
        want = kept[(ref_kind.split(":", 1)[1], shape)]
        pin = want["routes"]
    params = check.lm_train_tp_params(torch, chip_smoke, model, rules)
    state = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(**check.LM_TRAIN_TP_OPT),
                           rules)
    got = {"loss": [], "grad_norm": [], "lr": []}
    with pinned_routing(torch, pin):
        for b in mine[:1 if gate else steps]:
            params, state, m = step(params, state, b)
            for k in got:
                got[k].append(float(m[k]))
    if one_card:
        got["checksums"] = check.lm_train_tp_checksums(np, chip_smoke, model,
                                                       params, rules)
    del params, state, step, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        out = {"phase": "distributed_cards", "case": "lm_train_tp_pinned",
               "run": name, "mesh": {"data": shape[0], "model": shape[1]},
               "pinned": got}
        if one_card:
            out["mismatches"] = chip_smoke.train_mismatches(
                got, want, check.LM_TRAIN_TP_RTOL,
                check.LM_TRAIN_TP_LATER_RTOL,
                check.LM_TRAIN_TP_CHECKSUM_RTOL)
        else:
            out["rel"] = {k: abs(got[k][0] - want[k]) / abs(want[k])
                          for k in ("loss", "grad_norm")}
            out["bound"] = check.LM_TRAIN_TP_BF16_RTOL
        print(json.dumps(out), flush=True)
    return good


if __name__ == "__main__":
    check.lm_train_tp_case = pinned_case
    sys.exit(check.main())
