#!/usr/bin/env python3
"""Reruns the bf16 SSD comparisons of ``torch_distributed_check.py --only
lm_train_tp`` with the SSD's chunked scan in float32, to tell a failure
that the bf16 scan causes from one of the sharded arithmetic:

    torchrun --nproc_per_node=4 scripts/lm_train_tp_ssd_scan.py --only lm_train_tp \\
        --runs mamba2_bf16_2_layers
    torchrun --nproc_per_node=4 scripts/lm_train_tp_ssd_scan.py --only lm_train_tp \\
        --runs mamba2_bf16_2_layers --cpu

It takes the check's arguments and runs the check as it is. After each
bf16 run of an SSD config held to its float32 run, every rank takes step
1 again from the same draws twice: as the check ran it, recording the
inputs of the first call of ``models/ssm.py::_ssd_chunked`` (layer 0,
microbatch 0, this rank's heads), and with ``_ssd_chunked`` computed in
float32 (its bf16 inputs cast up, its output and final state cast back).
Rank 0 prints one more line a run: both reruns' loss and grad norm
against the float32 run's step 1 and ``LM_TRAIN_TP_BF16_RTOL``, and, for
the recorded call, the bf16 scan's output against the float32 scan of
the same bf16 inputs at each position (relative L2 over the batch, the
heads and the head dimension), the first position past 2^-6 and the
largest within-chunk cumulative decay |cumsum(dt * a)| of the call.
Nothing here gates: the exit code is the check's.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_distributed_check as check  # noqa: E402

CHECK_CASE = check.lm_train_tp_case
FIRST_PAST = 2.0 ** -6      # the position profile's reported threshold


@contextlib.contextmanager
def scan_patched(torch, record: list, float32: bool):
    """``ssm._ssd_chunked`` recording its first call's inputs into
    ``record``, and run in float32 when ``float32``."""
    from repro_torch.models import ssm
    plain = ssm._ssd_chunked

    def scan(x, dt, a, b_in, c_in, chunk, h0=None):
        if not record:
            record.append([t.detach().clone() for t in (x, dt, a, b_in,
                                                        c_in)])
        if not float32:
            return plain(x, dt, a, b_in, c_in, chunk, h0)
        y, h = plain(x.float(), dt.float(), a.float(), b_in.float(),
                     c_in.float(), chunk, None if h0 is None else h0.float())
        return y.to(x.dtype), h.to(x.dtype)
    ssm._ssd_chunked = scan
    try:
        yield
    finally:
        ssm._ssd_chunked = plain


def position_profile(torch, cfg, recorded) -> dict:
    """The recorded call's bf16 scan against the float32 scan of the same
    inputs, position by position."""
    from repro_torch.models import ssm
    x, dt, a, b_in, c_in = recorded
    chunk = cfg.ssm_chunk
    with torch.no_grad():
        got, _ = ssm._ssd_chunked(x, dt, a, b_in, c_in, chunk)
        want, _ = ssm._ssd_chunked(x.float(), dt.float(), a.float(),
                                   b_in.float(), c_in.float(), chunk)
        diff = (got.float() - want).square().sum(dim=(0, 2, 3))
        rel = (diff / want.square().sum(dim=(0, 2, 3))).sqrt()
        s = dt.shape[1]
        nc = -(-s // chunk)
        da = torch.nn.functional.pad(dt.float() * a.float(),
                                     (0, 0, 0, nc * chunk - s))
        cum = torch.cumsum(da.reshape(dt.shape[0], nc, chunk, -1), dim=2)
    past = (rel > FIRST_PAST).nonzero()
    return {"positions": s, "chunk": chunk,
            "rel_l2_first_16": rel[:16].tolist(),
            "rel_l2_max": float(rel.max()),
            "rel_l2_argmax": int(rel.argmax()),
            "first_position_past": int(past[0]) if len(past) else None,
            "threshold": FIRST_PAST,
            "cum_decay_abs_max": float(cum.abs().max())}


def scan_case(torch, np, chip_smoke, run, shape, refs, rank: int, device,
              cpu: bool, gathered, corpora: dict, kept: dict,
              failed: list) -> bool:
    """check.lm_train_tp_case, then (a bf16 SSD run held to its float32
    run) its step 1 again as run and with the scan in float32."""
    from repro_torch.runtime.mesh import ProcessMesh
    from repro_torch.sharding import make_rules
    from repro_torch.sharding.rules import block_range
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    good = CHECK_CASE(torch, np, chip_smoke, run, shape, refs, rank, device,
                      cpu, gathered, corpora, kept, failed)
    name, arch, layers, dtype, _, _, ref_kind = run
    layout = check.lm_train_tp_layout(arch, shape, cpu)
    model = check.lm_train_tp_model(torch, chip_smoke, device, arch, layers,
                                    layout.tp, dtype, cpu)
    if not model.cfg.ssm_state or not (ref_kind or "").startswith(
            "float32:"):
        return good
    cell = check.LM_TRAIN_TP_CPU_CELL if cpu else check.LM_TRAIN_TP_CELL
    mesh = ProcessMesh(("data", "model"), shape, device)
    rules = make_rules(mesh, "train", cell["batch"],
                       kv_sharded=model.kv_sharded, no_tp=layout.no_tp)
    bax = rules.batch_axes
    mb = cell["batch"] // layout.accum
    lo, hi = block_range(mb, mesh.axis_size(bax), mesh.axis_index(bax)) \
        if bax else (0, mb)
    batch = check.lm_train_tp_batches(np, chip_smoke, corpora, model,
                                      device, 1, layout.accum, cpu)[0]
    mine = {k: v[:, lo:hi] for k, v in batch.items()}
    want = kept[(ref_kind.split(":", 1)[1], shape)]
    out = {"phase": "distributed_cards", "case": "lm_train_tp_ssd_scan",
           "run": name, "mesh": {"data": shape[0], "model": shape[1]},
           "float32_step1": {k: want[k] for k in ("loss", "grad_norm")},
           "bound": check.LM_TRAIN_TP_BF16_RTOL}
    for label, float32 in (("as_run", False), ("float32_scan", True)):
        params = check.lm_train_tp_params(torch, chip_smoke, model, rules)
        state = init_opt_state(params)
        step = make_train_step(model, AdamWConfig(**check.LM_TRAIN_TP_OPT),
                               rules)
        record: list = []
        with scan_patched(torch, record, float32):
            _, _, m = step(params, state, mine)
        got = {k: float(m[k]) for k in ("loss", "grad_norm")}
        out[label] = {"step1": got, "rel": {
            k: abs(got[k] - want[k]) / abs(want[k]) for k in got}}
        if not float32:
            out["layer0_call"] = position_profile(torch, model.cfg,
                                                  record[0])
        del params, state, step
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        print(json.dumps(out), flush=True)
    return good


if __name__ == "__main__":
    check.lm_train_tp_case = scan_case
    sys.exit(check.main())
