"""Post-pass: recompute the dry-run records' statistics from the saved call
lists, without running the cells again.

The port of the JAX package's ``launch/restat.py``, which reparses each
record's gzipped HLO. Here each ``<tag>.calls.json.gz`` that
``launch/dryrun.py`` wrote beside its record holds the step's c10d calls
and FLOPs; ``launch/op_stats.py`` recomputes ``flops``,
``collective_bytes``, ``collective_bytes_by_kind``,
``collective_count_by_kind`` and the rest into the record.

    PYTHONPATH=src python -m repro_torch.launch.restat
        [--dryrun results/torch_dryrun] [--calls results/torch_dryrun_calls]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import op_stats


def restat(record: dict, calls: list, flops: float) -> dict:
    """``record`` with its per-device statistics recomputed."""
    coll = op_stats.collect_collective_stats(calls)
    pd = record["per_device"]
    pd["flops"] = flops
    pd["collective_bytes"] = coll.total_bytes
    pd["collective_bytes_by_kind"] = coll.bytes_by_kind
    pd["collective_count_by_kind"] = coll.count_by_kind
    pd["collective_wire_bytes_by_kind"] = coll.wire_bytes_by_kind
    pd["all_to_all_span"] = op_stats.all_to_all_span_bytes(calls)
    pd["ambiguous_loops"] = coll.ambiguous_loops
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.restat")
    ap.add_argument("--dryrun", default="results/torch_dryrun")
    ap.add_argument("--calls", default="results/torch_dryrun_calls")
    args = ap.parse_args(argv)
    for jpath in sorted(glob.glob(os.path.join(args.dryrun, "*.json"))):
        tag = os.path.basename(jpath)[:-5]
        cpath = os.path.join(args.calls, tag + ".calls.json.gz")
        if not os.path.exists(cpath):
            print(f"[skip] {tag}: no call list")
            continue
        calls, flops, _ = op_stats.load_calls(cpath)
        with open(jpath) as f:
            rec = restat(json.load(f), calls, flops)
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=2)
        pd = rec["per_device"]
        print(f"[restat] {tag}: flops={pd['flops']:.3e} "
              f"coll={pd['collective_bytes'] / 2**30:.3f}GiB")


if __name__ == "__main__":
    main()
