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
  float32 leaves) in float32;
* ``ops`` (configs with RG-LRU layers): the logit record's prefill and
  decode steps run on the CPU and on the card at the reference init with
  every ``models/rglru.py::apply_rglru`` call recorded (its input, its
  conv output, its cache before and its output). Each op of each call
  after the conv (the GeLU gate, the two gate GEMMs and sigmoids,
  softplus, ``log_a``, both ``exp``, the sqrt factor, ``b``,
  ``linear_scan`` on a prefill or the one-step update on a decode step,
  the output GEMM) is run on the CPU run's own inputs to that op: on the
  card in float32, and on the CPU in float32 and in float64; each gap
  gives the largest absolute difference, the largest reference value,
  that gap in float32 spacings at the largest value (``ulp_of_max``) and
  the largest elementwise ULP distance. ``first_op_gap`` names the first
  op, in the model's call order, whose card output differs from the
  CPU's on equal inputs; ``natural`` gives, per call, the gap of the
  block's input and output between the two unaided runs, and
  ``first_input_gap`` the first call whose input already differs.

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


def _ulps(torch, x, y) -> int:
    """The largest distance in float32 units in the last place between
    ``x`` and ``y`` (same shape, any device)."""
    def key(t):
        i = t.detach().float().cpu().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(x) - key(y)).abs().max()) if x.numel() else 0


def _gap(torch, x, y) -> dict:
    """``x`` against the reference ``y``: the largest absolute gap, the
    largest |y|, that gap in units of the float32 spacing at the largest
    |y| (``ulp_of_max``) and the largest elementwise ULP distance."""
    import numpy as np
    x, y = x.detach().float().cpu(), y.detach().float().cpu()
    if not x.numel():
        return {"max_abs": 0.0, "max_ref": 0.0, "ulp_of_max": 0.0,
                "max_ulp": 0}
    gap = float((x - y).abs().max())
    top = float(y.abs().max())
    spacing = float(np.spacing(np.float32(top))) if top else 2.0 ** -149
    return {"max_abs": gap, "max_ref": top, "ulp_of_max": gap / spacing,
            "max_ulp": _ulps(torch, x, y)}


def _rglru_ops_list(torch):
    """``apply_rglru``'s ops after the conv, in its order, as (name,
    function of the named values before it), computed as
    ``models/rglru.py`` computes them (no sharding context); ``f`` is the
    dtype its float32-by-design parts run in."""
    import torch.nn.functional as F
    from repro_torch.models import rglru

    def h(v, f):
        a, b, cache = v["a"], v["b"], v["cache"]
        if cache is not None and v["xs"].shape[1] == 1:
            return (a[:, 0] * cache["h"].to(f) + b[:, 0].to(f))[:, None]
        bf = b.to(f).clone()
        if cache is not None:
            bf[:, 0] += a[:, 0] * cache["h"].to(f)
        return rglru.linear_scan(a, bf)

    return (
        ("gate", lambda v, f: F.gelu(v["x"] @ v["p"]["in_gate"],
                                     approximate="tanh")),
        ("xs@wa", lambda v, f: v["xs"] @ v["p"]["wa"]),
        ("r", lambda v, f: torch.sigmoid(v["xs@wa"] + v["p"]["ba"])),
        ("xs@wx", lambda v, f: v["xs"] @ v["p"]["wx"]),
        ("i", lambda v, f: torch.sigmoid(v["xs@wx"] + v["p"]["bx"])),
        ("softplus(lam)", lambda v, f: F.softplus(v["p"]["lam"].to(f))),
        ("log_a", lambda v, f: -rglru.C_FACTOR * v["softplus(lam)"]
         * v["r"].to(f)),
        ("a", lambda v, f: torch.exp(v["log_a"])),
        ("exp(2 log_a)", lambda v, f: torch.exp(2.0 * v["log_a"])),
        ("mult", lambda v, f: torch.sqrt(torch.clamp(
            1.0 - v["exp(2 log_a)"], min=1e-12))),
        ("b", lambda v, f: v["mult"].to(v["xs"].dtype)
         * (v["i"] * v["xs"])),
        ("h", h),
        ("y", lambda v, f: (v["h"].to(v["xs"].dtype) * v["gate"])
         @ v["p"]["out"]),
    )


def _recorded_logit_run(torch, np, chip_smoke, model):
    """The logit record's prefill and decode steps on ``model`` with every
    ``apply_rglru`` call recorded on the host: (name, params, x, conv
    output, cache before, y)."""
    from repro_torch.models import rglru
    calls = []
    orig, conv = rglru.apply_rglru, rglru.causal_conv1d

    def conv_rec(xs, w, state):
        out = conv(xs, w, state)
        calls[-1]["xs_conv"] = out[0].detach().cpu().clone()
        return out

    def rec(cfg, p, x, cache=None):
        calls.append({
            "p": {k: v.detach().cpu().clone() for k, v in p.items()},
            "x": x.detach().cpu().clone(),
            "cache": None if cache is None else
            {k: v.detach().cpu().clone() for k, v in cache.items()}})
        y, c = orig(cfg, p, x, cache)
        calls[-1]["y"] = y.detach().cpu().clone()
        return y, c

    rglru.apply_rglru, rglru.causal_conv1d = rec, conv_rec
    try:
        cfg, dev = model.cfg, model.device
        tokens, extras = chip_smoke.lm_logit_inputs(np, cfg,
                                                    chip_smoke.LM_SEED)
        s = chip_smoke.LM_LOGIT_BATCH[1]
        toks = torch.from_numpy(tokens).to(dev)
        batch = {"tokens": toks[:, :s],
                 **{k: torch.from_numpy(v).to(dev)
                    for k, v in extras.items()}}
        per = []
        _, caches = model.prefill(batch,
                                  max_len=s + chip_smoke.LM_DECODE_STEPS)
        per.append(len(calls))
        for i in range(chip_smoke.LM_DECODE_STEPS):
            _, caches = model.decode_step(toks[:, s + i:s + i + 1], caches,
                                          s + i)
            per.append(len(calls))
    finally:
        rglru.apply_rglru, rglru.causal_conv1d = orig, conv
    layers = per[0]
    for k, c in enumerate(calls):
        c["step"] = "prefill" if k < layers else f"decode {k // layers}"
        c["layer"] = k % layers
    return calls


def _rglru_ops(torch, np, chip_smoke, cfg, tree, dev) -> dict:
    """The ``ops`` record (module docstring). Each op of each recorded
    call runs three times on the CPU run's own inputs to that op: on the
    CPU in float32 (the CPU run's value), on the card in float32, and on
    the CPU in float64 (the inputs cast up)."""
    from repro_torch import convert
    from repro_torch.models import build_model
    runs = {}
    for where, d in (("cpu", "cpu"), ("card", dev)):
        model = convert.params_from_numpy(
            build_model(cfg, compute_dtype=torch.float32, device=d), tree)
        runs[where] = _recorded_logit_run(torch, np, chip_smoke, model)
    ops = _rglru_ops_list(torch)

    def moved(v, d, dt=None):
        if isinstance(v, dict):
            return {k: moved(x, d, dt) for k, x in v.items()}
        if v is None:
            return None
        return v.to(d) if dt is None else v.to(d, dt)

    replay, natural = [], []
    for c, g in zip(runs["cpu"], runs["card"]):
        tag = {"step": c["step"], "layer": c["layer"]}
        natural.append({**tag, "input": _gap(torch, g["x"], c["x"]),
                        "output": _gap(torch, g["y"], c["y"])})
        cpu = {"p": c["p"], "x": c["x"], "cache": c["cache"],
               "xs": c["xs_conv"] + c["p"]["conv_b"]}
        for name, fn in ops:
            cpu[name] = fn(cpu, torch.float32)
        rec = {}
        for name, fn in ops:
            card = fn(moved(cpu, dev), torch.float32)
            f64 = fn(moved(cpu, "cpu", torch.float64), torch.float64)
            rec[name] = {"card32-cpu32": _gap(torch, card, cpu[name]),
                         "cpu32-f64": _gap(torch, cpu[name], f64),
                         "card32-f64": _gap(torch, card, f64)}
        replay.append({**tag, "ops": rec})
    first = next(({**r, "op": k, **v["card32-cpu32"]} for r in replay
                  for k, v in r["ops"].items()
                  if v["card32-cpu32"]["max_ulp"]), None)
    if first is not None:
        del first["ops"]
    widest = {}
    for r in replay:
        for k, v in r["ops"].items():
            g = v["card32-cpu32"]
            if g["max_ulp"] >= widest.get(k, {"max_ulp": -1})["max_ulp"]:
                widest[k] = {**g, "step": r["step"], "layer": r["layer"],
                             "cpu32-f64": v["cpu32-f64"],
                             "card32-f64": v["card32-f64"]}
    return {"calls": len(replay), "first_op_gap": first,
            "largest_gap_per_op": widest,
            "first_input_gap": next((n for n in natural
                                     if n["input"]["max_ulp"]), None),
            "natural": natural, "replay": replay}


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
    if "rec" in cfg.layer_kinds():
        out["ops"] = _rglru_ops(torch, np, chip_smoke, cfg,
                                trees["reference_init"], dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
