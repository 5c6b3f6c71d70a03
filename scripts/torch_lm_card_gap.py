#!/usr/bin/env python
"""Where a reduced LM config's serving logits differ between the card and
the CPU, and how the gap moves with the initialisation and the dtype.

``tests/test_torch_cuda.py::test_lm_serving_on_the_card_equals_the_cpu``
holds the card's float32 serving path (``chip_smoke.lm_port_outputs``:
the Engine, then a prefill and decode steps' last-position logits) to
the same port on the host CPU at rtol = atol = 1e-4. This script runs
that case and prints one JSON line:

* ``mismatches``: the test's own check (``chip_smoke.lm_mismatches``);
* ``completions_equal``: whether every completion token is equal;
* ``steps``: per logit step, the largest gap, the number of logits
  outside the bound and the first of them (row, vocabulary id, both
  values), and the first top-8 value outside it;
* ``precision``: per step, the largest gap between each pair of the
  card in float32, the CPU in float32 and each in float64, at the
  reference init (``convert.numpy_params``) and at one layer's fan-in
  (``chip_smoke.lm_reference_params``). A float64 run keeps the parts a
  model computes in float32 by design (the RG-LRU's gate and scan, the
  float32 leaves) in float32.

Run it from the repository's root on a machine with one CUDA card:

    python3 scripts/torch_lm_card_gap.py [--arch recurrentgemma-2b]

``--device cpu`` compares the CPU with itself (every card gap 0).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = ATOL = 1e-4            # the test's bound


def _outputs(torch, np, chip_smoke, cfg, tree, device, dtype):
    from repro_torch import convert
    from repro_torch.models import build_model
    model = convert.params_from_numpy(
        build_model(cfg, compute_dtype=dtype, device=device), tree)
    return chip_smoke.lm_port_outputs(torch, np, model,
                                      chip_smoke.LM_REDUCED_WORKLOAD,
                                      chip_smoke.LM_SEED)


def _first(np, bad):
    return [int(x) for x in np.argwhere(bad)[0]] if bad.any() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/torch_lm_card_gap.py")
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import numpy as np
    import torch
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA card: pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = get_config(args.arch).reduced()
    base = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    trees = {"reference_init": convert.numpy_params(base, seed=0),
             "layer_fan_in": chip_smoke.lm_reference_params(convert, base)}

    tree = trees["reference_init"]
    c_comps, c_margins, c_logits, _ = _outputs(
        torch, np, chip_smoke, cfg, tree, "cpu", torch.float32)
    want = chip_smoke.lm_record(np, c_comps, c_margins, c_logits)
    g_comps, _, g_logits, _ = _outputs(torch, np, chip_smoke, cfg, tree,
                                       dev, torch.float32)
    out = {"arch": args.arch, "device": str(dev), "rtol": RTOL,
           "atol": ATOL,
           "mismatches": chip_smoke.lm_mismatches(np, g_comps, g_logits,
                                                  want, RTOL, ATOL),
           "completions_equal": [[int(r), [int(t) for t in k]]
                                 for r, k in g_comps]
           == [[int(r), [int(t) for t in k]] for r, k in c_comps],
           "steps": []}
    for i, (g, c) in enumerate(zip(g_logits, c_logits)):
        g, c = np.asarray(g, np.float32), np.asarray(c, np.float32)
        bad = ~np.isclose(g, c, rtol=RTOL, atol=ATOL)
        rec = {"step": i, "max_abs_diff": float(np.abs(g - c).max()),
               "max_abs_logit": float(np.abs(c).max()),
               "n_outside": int(bad.sum()), "of": int(bad.size)}
        first = _first(np, bad)
        if first:
            rec["first"] = {"row": first[0], "vocab_id": first[1],
                            "card": float(g[tuple(first)]),
                            "cpu": float(c[tuple(first)])}
        ids = np.asarray(want["logits"][i]["top_ids"])
        vals = np.take_along_axis(g, ids, axis=-1)
        top = np.asarray(want["logits"][i]["top_values"], np.float32)
        first = _first(np, ~np.isclose(vals, top, rtol=RTOL, atol=ATOL))
        if first:
            rec["first_top_value"] = {"row": first[0], "rank": first[1],
                                      "vocab_id": int(ids[tuple(first)]),
                                      "card": float(vals[tuple(first)]),
                                      "cpu": float(top[tuple(first)])}
        out["steps"].append(rec)

    out["precision"] = {}
    for init, tree in trees.items():
        runs = {f"{where}{bits}": [np.asarray(x, np.float64) for x in
                                   _outputs(torch, np, chip_smoke, cfg, tree,
                                            d, dtype)[2]]
                for where, d in (("cpu", "cpu"), ("card", dev))
                for bits, dtype in ((32, torch.float32),
                                    (64, torch.float64))}
        out["precision"][init] = {
            f"{a}-{b}": [float(np.abs(x - y).max())
                         for x, y in zip(runs[a], runs[b])]
            for a, b in (("card32", "cpu32"), ("cpu32", "cpu64"),
                         ("card32", "cpu64"), ("card64", "cpu64"))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
