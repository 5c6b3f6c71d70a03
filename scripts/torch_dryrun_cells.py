#!/usr/bin/env python
"""The dry run of the four-card LM cells, on the CPU: state and c10d
traffic a card, without the cards.

Runs one step of each four-card cell that ``scripts/
torch_distributed_check.py --only lm_tp,lm_train_tp`` runs on four H100s
(``PERF.md`` section 4), as rank 0 of a world-4 group on torch's
``fake`` backend under ``FakeTensorMode``
(``repro_torch.launch.dryrun.run_cell``): the same configs cut to the
same depths, the same (1, 4) mesh, 8 x 512 tokens, bf16, each train
cell laid out by ``train_layout`` of its full-depth config. Prints one
JSON line a cell: parameters a card, state a card (16 B a parameter:
float32 masters, gradients, m and v), weights a card for the serving
cell, and the step's c10d calls and bytes by kind, beside which the
cards' own counts can be read (``PERF.md``). No card and no memory is
needed:

    PYTHONPATH=src python scripts/torch_dryrun_cells.py [--only a,b]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

CELLS = (
    # (label, arch, layers (0: full depth), kind, seq, note)
    ("qwen_no_tp", "qwen1.5-0.5b", 0, "train", 512),
    ("phi3_40_layers", "phi3-medium-14b", 0, "train", 512),
    ("llama4_4_layers", "llama4-scout-17b-a16e", 4, "train", 512),
    ("qwen3_moe_4_layers", "qwen3-moe-235b-a22b", 4, "train", 512),
    ("minicpm3_62_layers", "minicpm3-4b", 0, "train", 512),
    ("mamba2_24_layers", "mamba2-130m", 0, "train", 512),
    ("recurrentgemma_26_layers", "recurrentgemma-2b", 0, "train", 512),
    ("whisper_24_24_layers", "whisper-medium", 0, "train", 512),
    ("llama4_48_layers_prefill", "llama4-scout-17b-a16e", 0, "prefill",
     512 + 32),
    ("llama4_48_layers_decode", "llama4-scout-17b-a16e", 0, "decode",
     512 + 32),
)
BATCH = 8
MESH = (1, 4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/torch_dryrun_cells.py")
    ap.add_argument("--only", default=None,
                    help="comma-separated cell labels")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, op_stats
    from repro_torch.runtime import spmd
    from repro_torch.runtime.mesh import ProcessMesh

    spmd.init_fake_group(MESH[0] * MESH[1], 0)
    failed = 0
    try:
        mesh = ProcessMesh(("data", "model"), MESH, "cpu")
        for label, arch, layers, kind, seq in CELLS:
            if only and label not in only:
                continue
            full = get_config(arch)
            cfg = full if not layers else dataclasses.replace(
                full, num_layers=layers, encoder_layers=(
                    layers if full.encoder_layers else 0))
            t0 = time.perf_counter()
            try:
                pd, extra = dryrun.run_cell(
                    cfg, ShapeConfig(label, seq, BATCH, kind), mesh, full)
            except Exception as e:  # noqa: BLE001 - report and go on
                failed += 1
                print(json.dumps({"cell": label, "error": repr(e)}),
                      flush=True)
                continue
            calls = extra.pop("calls")
            model = extra.pop("model")
            coll = op_stats.collect_collective_stats(calls)
            line = {"cell": label, "arch": arch,
                    "layers": cfg.num_layers, "kind": kind,
                    "mesh": list(MESH), "batch": BATCH, "seq": seq,
                    "seconds": round(time.perf_counter() - t0, 2),
                    "count_params": model.count_params(),
                    "flops": pd["flops"],
                    "collective_count_by_kind": coll.count_by_kind,
                    "collective_bytes_by_kind": coll.bytes_by_kind,
                    "collective_bytes": coll.total_bytes}
            if kind == "train":
                line.update(accum=extra.get("accum_steps"),
                            no_tp=extra.get("no_tp"),
                            params_a_card=pd["param_bytes"] // 4,
                            state_bytes_a_card=4 * pd["param_bytes"])
            else:
                line.update(weight_bytes_a_card=pd["param_bytes"],
                            cache_bytes_a_card=pd["cache_bytes"])
            print(json.dumps(line), flush=True)
    finally:
        spmd.destroy_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
