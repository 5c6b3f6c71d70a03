"""Times phase 9's train step of ``chip_smoke.py`` for several source
trees in turn, on one card, so two versions of the port compare within
one call:

    python3 scripts/train_step_ab.py OLD_TREE . . OLD_TREE

Each tree (a checkout of the repo, or a directory holding its ``src``)
runs in a process of its own with its ``src`` first on the path:
qwen1.5-0.5b at full width and depth, 8 x 512 tokens a step, bf16 compute
over float32 masters, ``REPRO_REMAT`` and the optimizer as
``chip_smoke.TRAIN_CELL`` / ``TRAIN_CELL_OPT``, weights drawn as phase 9
draws them (the port's init seeded ``LM_SEED``, stacked matrices at one
layer's fan-in) and tokens drawn uniformly from a seed (a step's time
does not depend on their values). One step warms up, then STEPS are
timed one by one. Prints the card's name and power limit, then one JSON
line a run: the tree, every step's ms, their median, tokens/s, the peak
allocated bytes from the optimizer state's creation on, and step 1's
loss and grad norm (equal across trees that compute the same step).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10
SEED = 0


def worker(tree: str) -> dict:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    c = chip_smoke.TRAIN_CELL
    dev = torch.device("cuda", 0)
    cfg = get_config(c["arch"])
    model = build_model(cfg, compute_dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        params = chip_smoke.lm_layer_fan_in(model, model.master_params(
            generator=torch.Generator(dev).manual_seed(chip_smoke.LM_SEED)))
    rng = np.random.default_rng(SEED)
    batches = [{k: rng.integers(0, cfg.vocab_size, (1, c["batch"], c["seq"]),
                                dtype=np.int32) for k in ("tokens", "labels")}
               for _ in range(STEPS + 1)]
    step = make_train_step(model, AdamWConfig(**chip_smoke.TRAIN_CELL_OPT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_opt_state(params)
    ms, first = [], None
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = {k: float(m[k]) for k in ("loss", "grad_norm")}
    med = statistics.median(ms[1:])
    return {"tree": tree, "package": os.path.dirname(repro_torch.__file__),
            "arch": c["arch"], "batch": c["batch"],
            "seq": c["seq"], "remat": c["remat"], "step_ms": ms[1:],
            "warmup_ms": ms[0], "step_ms_median": med,
            "tokens_per_s": c["batch"] * c["seq"] / med * 1e3,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
            "step1": first}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="source trees, run in order")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.trees[0])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    sys.path.insert(0, ROOT)
    import chip_smoke
    ok = True
    for tree in args.trees:
        src = os.path.join(os.path.abspath(tree), "src")
        env = {**os.environ, "REPRO_REMAT": chip_smoke.TRAIN_CELL["remat"],
               "PYTHONPATH": os.pathsep.join([src] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p])}
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", tree], env=env)
        ok = ok and run.returncode == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
