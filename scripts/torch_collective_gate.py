#!/usr/bin/env python3
"""Collective-bytes regression gate of the PyTorch port, per topology.

The port of ``scripts/collective_gate.py``'s byte legs. The reference
compiles the sharded exchange on forced host devices and reads the
compiled program's bytes; the port runs the same front-door programs on
gloo ranks on the CPU under the c10d recorder (``analysis/audit.py``'s
``record``) and reads the collective bytes the run moved
(``launch/op_stats.py``: result bytes by kind, wire bytes, the
all_to_all bytes split by group span). Legs:

  1. Capacity scaling (flat): a 4x smaller ``pair_capacity`` must move
     fewer collective bytes in the sharded exchange (C = 256 against
     C = 64 at 200 vertices x k=3 a rank); and one round of the device
     stream must move fewer at R = 8 than at R = 2 (its buffers are
     (lp, P, C_r) with C_r = ceil(C / R)). A full-size buffer that stops
     depending on the knob breaks the inequality.
  2. Hierarchical locality at the paper's 1000 ranks (preset
     pod_1000rank: P = 1000, 40 vertices x k=2, C = 8): on every pods
     topology the cross-pod (strided-group) all_to_all wire bytes must
     stay at most the flat all_to_all's total wire bytes, and the cross
     hop must exist.
  2b. Communication-free head-to-head at matched (P, E) = (1000, 80,000):
     ba_cfree (40,000 vertices, degree 2) must issue no all_to_all and
     move no wire bytes on any topology, while the PBA exchange moves
     some.
  3. Baseline drift, per topology: the collective bytes of the reference
     configs must stay within TOLERANCE (1.25x) of the committed
     ``results/torch_collective_bytes_baseline.json`` for this rank count
     (a rank count the file lacks is written and reported).

Every leg runs and reports; the exit code is 1 if any failed.
``--legs`` runs some legs alone (leg 3 needs legs 1 and 2's readings).

    PYTHONPATH=src python scripts/torch_collective_gate.py [--ranks 4]
        [--legs 1,2,2b,3]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(HERE, "results",
                        "torch_collective_bytes_baseline.json")
TOLERANCE = 0.25                    # fractional drift before the gate trips
POD_SCALE_P = 1000                  # the paper's 1000 ranks


def _pba_spec(api, n_dev: int, pair_capacity: int, topo):
    from repro_torch.core import FactionSpec
    return api.GraphSpec(
        model="pba", procs=n_dev, vertices_per_proc=200, edges_per_vertex=3,
        seed=7, pair_capacity=pair_capacity,
        factions=FactionSpec(max(n_dev // 2, 1), 2, max(n_dev // 2, 2),
                             seed=1),
        topology=topo, execution="sharded")


def _recorded(fn, args):
    from repro_torch.analysis.audit import record
    return record(fn, *args)[1]


def _exchange_calls(api, spec):
    from repro_torch.launch.bench import sharded_pba
    return _recorded(*sharded_pba(api.plan(spec, device="cpu")))


def gate_topologies(api, n_dev: int) -> list:
    topos = [api.Topology.flat(n_dev)]
    if n_dev >= 4 and n_dev % 2 == 0:
        topos.append(api.Topology.pods(2, n_dev // 2))
        if n_dev // 2 != 2:
            topos.append(api.Topology.pods(n_dev // 2, 2))
    return topos


LEGS = ("1", "2", "2b", "3")


def measure(n_dev: int, legs=LEGS) -> dict:
    """The legs' readings on the current group (every rank calls it; the
    readings are this rank's calls)."""
    from repro_torch import api
    from repro_torch.launch.bench import sharded_cfree, sharded_stream_round
    from repro_torch.launch.op_stats import (all_to_all_span_bytes,
                                             collect_collective_stats)
    flat = api.Topology.flat(n_dev)

    def total(calls):
        return collect_collective_stats(calls).total_bytes

    out = {"ranks": n_dev, "legs": list(legs)}
    if "1" in legs or "3" in legs:
        for c in (256, 64):
            out[f"flat_c{c}"] = total(_exchange_calls(api, _pba_spec(
                api, n_dev, c, flat)))
        for rounds in (2, 8):
            pl = api.plan(_pba_spec(api, n_dev, 256, flat).replace(
                execution="streamed", exchange_rounds=rounds), device="cpu")
            out[f"flat_stream_round_r{rounds}"] = total(_recorded(
                *sharded_stream_round(pl)))
    pod_scale = POD_SCALE_P % n_dev == 0
    if ("2" in legs or "3" in legs) and pod_scale:
        out["pod_scale"] = {}
        for topo in gate_topologies(api, n_dev):
            calls = _exchange_calls(api, api.preset(
                "pod_1000rank", topology=topo, execution="sharded"))
            out["pod_scale"][topo.label] = {
                "bytes": total(calls), **all_to_all_span_bytes(calls)}
    if "2b" in legs:
        p_match = POD_SCALE_P if pod_scale else n_dev
        out["matched_p"] = p_match
        calls = _exchange_calls(api, api.preset(
            "pod_1000rank", procs=p_match, topology=flat,
            execution="sharded"))
        out["matched_pba"] = all_to_all_span_bytes(calls)
        out["matched_cfree"] = {}
        for topo in gate_topologies(api, n_dev):
            pl = api.plan(api.GraphSpec(
                model="ba_cfree", cfree_vertices=40 * p_match, ba_degree=2,
                procs=p_match, seed=7, topology=topo, execution="sharded"),
                device="cpu")
            calls = _recorded(*sharded_cfree(pl))
            out["matched_cfree"][topo.label] = {
                **all_to_all_span_bytes(calls), "calls": len(calls),
                "requested_edges": pl.requested_edges}
    return out


def check(m: dict, baseline: dict) -> tuple[list, list, dict]:
    """(failures, notes, record) of the measured legs on rank 0's
    readings; ``baseline`` is the committed file's entry for the rank
    count (None: none yet)."""
    fail, note, record = [], [], {}
    if "flat_c256" in m:
        note.append(f"C=256 -> {m['flat_c256']:.0f} collective bytes, "
                    f"C=64 -> {m['flat_c64']:.0f}")
        if m["flat_c64"] >= m["flat_c256"]:
            fail.append(f"leg 1: exchange bytes do not scale with "
                        f"pair_capacity (C=64: {m['flat_c64']:.0f} >= "
                        f"C=256: {m['flat_c256']:.0f}): a full-size buffer "
                        "is being moved somewhere")
        r2, r8 = m["flat_stream_round_r2"], m["flat_stream_round_r8"]
        note.append(f"stream round bytes R=2 -> {r2:.0f}, R=8 -> {r8:.0f}")
        if r8 >= r2:
            fail.append(f"leg 1b: stream round bytes do not scale with "
                        f"rounds (R=8: {r8:.0f} >= R=2: {r2:.0f}): a round "
                        "moves a full-capacity buffer")
        record.update(flat_c256=m["flat_c256"], flat_stream_round_r8=r8)

    pods = m.get("pod_scale")
    if pods:
        flat_label = next(k for k in pods if k.startswith("flat"))
        flat_wire = pods[flat_label]["local_wire"] + \
            pods[flat_label]["cross_wire"]
        note.append(f"P={POD_SCALE_P} flat all_to_all wire bytes "
                    f"{flat_wire:.0f}")
        for label, span in pods.items():
            record[label] = span["bytes"]
            if label == flat_label or "2" not in m["legs"]:
                continue
            note.append(f"P={POD_SCALE_P} {label} cross-pod wire bytes "
                        f"{span['cross_wire']:.0f}")
            if span["cross_wire"] > flat_wire:
                fail.append(f"leg 2: {label} cross-pod wire bytes "
                            f"{span['cross_wire']:.0f} exceed the flat "
                            f"all_to_all's {flat_wire:.0f} at equal (P, C)")
            if span["n_cross"] == 0:
                fail.append(f"leg 2: {label} issued no strided-group "
                            "all_to_all: the cross-pod hop is missing")
    elif "2" in m["legs"]:
        note.append(f"{POD_SCALE_P} ranks do not divide over {m['ranks']} "
                    "ranks: the pod-scale leg is skipped")

    if "matched_pba" in m:
        pba = m["matched_pba"]
        pba_wire = pba["local_wire"] + pba["cross_wire"]
        if m["ranks"] > 1 and pba_wire <= 0:
            fail.append("leg 2b: the matched PBA exchange moved no "
                        "all_to_all wire bytes")
        for label, span in m["matched_cfree"].items():
            wire = span["local_wire"] + span["cross_wire"]
            n = span["n_local"] + span["n_cross"]
            note.append(f"head-to-head P={m['matched_p']} "
                        f"E={span['requested_edges']} {label}: cfree wire "
                        f"bytes {wire:.0f} ({n} all_to_alls, "
                        f"{span['calls']} c10d calls) vs pba exchange "
                        f"{pba_wire:.0f}")
            if wire != 0 or n != 0:
                fail.append(f"leg 2b: {label} cfree program issued {n} "
                            f"all_to_alls / {wire:.0f} wire bytes: the "
                            "communication-free contract is zero of both")

    if "3" not in m["legs"]:
        return fail, note, None
    if baseline is None:
        note.append(f"no baseline for {m['ranks']} ranks: written "
                    f"({sorted(record)})")
        return fail, note, record
    for label, got in record.items():
        if label not in baseline:
            note.append(f"{label}: not in the baseline")
            continue
        limit = baseline[label] * (1 + TOLERANCE)
        if got > limit:
            fail.append(f"leg 3: {label} collective bytes {got:.0f} exceed "
                        f"the baseline {baseline[label]:.0f} (+"
                        f"{TOLERANCE:.0%}: {limit:.0f}); if the increase is "
                        f"intended, rewrite {BASELINE}")
        else:
            note.append(f"{label} {got:.0f} <= {limit:.0f} (baseline "
                        f"{baseline[label]:.0f} +{TOLERANCE:.0%})")
    return fail, note, None


def _worker(rank: int, n_dev: int, legs: tuple, init: str,
            out: str) -> None:
    import torch
    from repro_torch.runtime import spmd
    torch.set_num_threads(1)
    spmd.init_group("gloo", init, n_dev, rank)
    try:
        m = measure(n_dev, legs)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(m, f)
    finally:
        spmd.destroy_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4,
                    help="gloo ranks on the CPU (default 4: flat and "
                    "pods(2, 2))")
    ap.add_argument("--legs", default=",".join(LEGS),
                    help="the legs to run, comma-separated (default all)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    legs = tuple(args.legs.split(","))
    if set(legs) - set(LEGS):
        ap.error(f"--legs: one of {LEGS}")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.analysis.audit import spawn_ranks
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gate.json")
        spawn_ranks(_worker, (args.ranks, legs, "file://" + os.path.join(
            tmp, "rdv"), out), args.ranks, args.timeout)
        with open(out) as f:
            m = json.load(f)
    baseline = {}
    if os.path.exists(BASELINE):
        with open(BASELINE) as f:
            baseline = json.load(f)
    fail, note, record = check(m, baseline.get("ranks", {}).get(
        str(args.ranks)))
    for line in note:
        print(f"torch collective gate: {line}")
    for line in fail:
        print(f"torch collective gate FAILED: {line}", file=sys.stderr)
    if record is not None and not fail:
        baseline.setdefault("ranks", {})[str(args.ranks)] = record
        baseline["tolerance"] = TOLERANCE
        os.makedirs(os.path.dirname(BASELINE), exist_ok=True)
        with open(BASELINE, "w") as f:
            json.dump(baseline, f, indent=2, sort_keys=True)
            f.write("\n")
    if fail:
        return 1
    print("torch collective gate OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
