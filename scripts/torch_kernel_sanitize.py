#!/usr/bin/env python
"""The kernel checker's sanitizer pass on one card: KC001 and KC003.

Reruns the kernel registry's executable cases through their CUDA kernels
under the CUDA toolkit's ``compute-sanitizer``, ``--tool memcheck`` and
then ``--tool racecheck``, one subprocess each
(``repro_torch.analysis.kernelcheck.sanitize``), within ``--timeout``
seconds in all, and prints one JSON line: each tool's error count,
exit code and seconds, and the findings. Run it from the repository's
root on a machine with one CUDA card:

    python3 scripts/torch_kernel_sanitize.py [--timeout 180] [--out FILE]

Exit codes: 0 no error reported, 1 an error reported (a finding) or a
tool that did not finish, 2 no card, 3 the sanitizer refused the device
("Device not supported": the kernels were not checked).

It runs apart from ``chip_smoke.py`` because the sanitizer may refuse a
card, as it refuses the sandboxed H100 this port is measured on
(``PERF.md``); ``chip_smoke.py`` phase 11 keeps the in-process sweep.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/torch_kernel_sanitize.py")
    ap.add_argument("--timeout", type=float, default=180.0)
    ap.add_argument("--out", default=None, help="write the report here")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "src")
    sys.path.insert(0, src)
    os.environ["PYTHONPATH"] = src + os.pathsep + os.environ.get(
        "PYTHONPATH", "")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the sanitizer pass needs one", file=sys.stderr)
        return 2
    from repro_torch.analysis import kernelcheck
    from repro_torch.kernels import _build
    _build.build()                      # once, outside the sanitizer
    findings, report = kernelcheck.sanitize(args.timeout)
    unsupported = any(r.get("unsupported") for r in report.values())
    line = {"device": torch.cuda.get_device_name(0),
            "tools": {k: {x: v[x] for x in v if x != "tail"}
                      for k, v in report.items()},
            "unsupported": unsupported,
            "findings": [f.to_json() for f in findings]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**line, "tails": {k: v.get("tail", "")
                                         for k, v in report.items()}}, f,
                      indent=2)
    print(json.dumps(line), flush=True)
    if unsupported:
        return 3
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
