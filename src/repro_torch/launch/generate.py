"""Graph generation launcher: the paper's scenario as a command.

    PYTHONPATH=src python -m repro_torch.launch.generate --preset paper_smoke
    PYTHONPATH=src python -m repro_torch.launch.generate --device cpu \\
        --procs 8 --vertices-per-proc 2000 --ckpt /tmp/gen_ckpt.json
    torchrun --nproc_per_node=4 -m repro_torch.launch.generate \\
        --preset paper_1b_5b                       # 1000 ranks on 4 cards
    PYTHONPATH=src python -m repro_torch.launch.generate \\
        --preset paper_1b_5b --dry-run              # the plan, no work

The port of the JAX package's ``examples/generate_massive.py``, with its
flags, their meanings and defaults, its specs (:func:`build_specs`), its
checkpoint JSON and restart, and its printed lines, plus ``--device``:
the run is on the card unless ``--device cpu``, and raises before any
work when CUDA is absent and the CPU was not asked for.

D, the device count, is the world size of the process group. With
``WORLD_SIZE`` in the environment (``torchrun``) the launcher initialises
the group itself, NCCL on ``cuda:LOCAL_RANK`` or gloo with ``--device
cpu``, and destroys it at the end; with none there is no group and
D = 1. Rank 0 reads or writes the checkpoint and sends its state to
every rank, and rank 0 alone prints. Over D > 1 devices the degree
summary (``gamma_mle`` at kmin 5, ``max_degree``) comes from the sharded
degree count (``core/distributed_analysis.py``), each rank counting its
own edges and rank 0 alone fitting the power law.

:func:`run_spec` runs one spec and returns the ``GenResult`` and its
wall; ``chip_smoke.py`` and ``scripts/torch_distributed_check.py`` call
it, and :func:`degree_summary`, rather than copies.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional

import torch

from repro_torch import api
from repro_torch.core.analysis import fit_power_law
from repro_torch.core.distributed_analysis import degree_counts_sharded
from repro_torch.core.graph import degree_counts
from repro_torch.runtime import blocking, spmd
from repro_torch.runtime.topology import Topology

#: The group's collective timeout: a full-size stream's slowest rank may
#: run its degree fit while the others wait.
GROUP_TIMEOUT_S = 900.0


def build_specs(args, state, n_dev):
    """(pba_spec, pk_spec) for the CLI flags + checkpoint state."""
    out_of_core = args.out_dir is not None
    topology = None
    if args.pods:
        # Works in memory (the two-hop transpose of the single-shot
        # exchange) and out of core (the device stream drives the same
        # transpose every round).
        rows, cols = (int(x) for x in args.pods.lower().split("x"))
        if rows * cols != n_dev:
            raise SystemExit(f"--pods {args.pods} needs {rows * cols} "
                             f"devices, have {n_dev}")
        topology = Topology.pods(rows, cols)

    pba = api.GraphSpec(
        model="pba", procs=state["procs"],
        vertices_per_proc=state["vpp"], edges_per_vertex=state["k"],
        interfaction_prob=0.05, pair_capacity=args.pair_capacity,
        exchange_rounds=args.exchange_rounds, seed=state["seed"],
        topology=topology, overlap=args.overlap,
        execution="streamed" if out_of_core else "auto",
        sink="shards" if out_of_core else "memory",
        out_dir=os.path.join(args.out_dir, "pba") if out_of_core else None)
    pk = api.GraphSpec(
        model="pk", levels=args.pk_levels, noise=0.05, seed=3,
        slab_edges=args.pk_slab_edges,
        execution="streamed" if out_of_core else "auto",
        sink="shards" if out_of_core else "memory",
        out_dir=os.path.join(args.out_dir, "pk") if out_of_core else None)
    return pba, pk


def world_from_env() -> int:
    """D before the group exists: ``WORLD_SIZE`` (torchrun's), else the
    running group's world size, else 1."""
    return int(os.environ.get("WORLD_SIZE", spmd.world_size()))


def parser(n_dev: int) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.generate",
        description="Generate a scale-free graph (the paper's scenario).")
    ap.add_argument("--preset", default=None, choices=sorted(api.PRESETS),
                    help="run a named scenario (overrides the scale flags)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the resolved plan(s) and exit without "
                         "generating")
    ap.add_argument("--procs", type=int, default=n_dev,
                    help="logical processors; may exceed device count "
                         "(paper: 1000 ranks) as long as it divides evenly")
    ap.add_argument("--vertices-per-proc", type=int, default=100_000)
    ap.add_argument("--edges-per-vertex", type=int, default=5)
    ap.add_argument("--pair-capacity", type=int, default=None,
                    help="per-(sender,receiver) exchange budget C; default "
                         "heuristic from faction sizes")
    ap.add_argument("--exchange-rounds", type=int, default=None,
                    help="stream exchange 2 over R rounds of capacity "
                         "ceil(C/R) — zero dropped edges, 1/R exchange "
                         "memory; default: legacy single-shot exchange")
    ap.add_argument("--pods", default=None, metavar="RxC",
                    help="run the exchange over a hierarchical RxC pod "
                         "topology (e.g. 2x2: two-hop intra-pod/cross-pod "
                         "all_to_all; bit-identical output); default: flat")
    ap.add_argument("--pk-levels", type=int, default=4)
    ap.add_argument("--out-dir", default=None,
                    help="out-of-core mode: stream per-round PBA blocks and "
                         "per-slab PK blocks to resumable shards here "
                         "instead of materializing edge lists")
    ap.add_argument("--pk-slab-edges", type=int, default=1 << 20)
    ap.add_argument("--overlap", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="device-stream out-of-core mode: double-buffer "
                         "rounds (dispatch round r+1 while round r's block "
                         "is written back); --no-overlap serializes them")
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_gen_ckpt.json"))
    ap.add_argument("--device", default=None,
                    help="cuda (default: cuda:LOCAL_RANK under torchrun; "
                         "raises without a card) or cpu")
    return ap


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_spec(spec_or_plan, device=None):
    """Plan (unless given a plan) and generate one spec on ``device``;
    returns (GenResult, wall seconds). Under a process group every rank
    calls it; the wall runs from a barrier to a barrier, so it is the
    group's."""
    pl = spec_or_plan if isinstance(spec_or_plan, api.GenPlan) \
        else api.plan(spec_or_plan, device=device)
    spmd.barrier()
    _sync(pl.device)
    t0 = time.perf_counter()
    res = api.generate(pl)
    _sync(pl.device)
    spmd.barrier()
    return res, time.perf_counter() - t0


def degree_summary(res, kmin: int = 5) -> tuple[Optional[float], int]:
    """(gamma_mle at ``kmin``, max degree) of a generated graph: over a
    process group from the sharded degree count of every rank's edges,
    else from this device's edges. Every rank gets the max degree (taken
    on the device); only rank 0 copies the counts to the host and fits,
    and the other ranks get None for gamma_mle."""
    topo = res.plan.topology
    if blocking.collective(topo):
        deg = degree_counts_sharded(res.edges, topology=topo)
    else:
        deg = degree_counts(res.edges)
    top = int(deg.max())
    if spmd.rank() != 0:
        return None, top
    return fit_power_law(deg.cpu().numpy(), kmin=kmin).gamma_mle, top


def _say(*args, **kwargs) -> None:
    if spmd.rank() == 0:
        print(*args, **kwargs, flush=True)


def _checkpoint_state(args, procs: int, n_dev: int, device) -> dict:
    """Rank 0 reads the checkpoint (or writes a new one unless this is a
    dry run); every rank gets its state. Refuses a checkpoint whose
    logical procs do not divide over the devices present."""
    state = {"seed": 7, "procs": procs,
             "vpp": args.vertices_per_proc, "k": args.edges_per_vertex}

    def on_root():
        if os.path.exists(args.ckpt):
            with open(args.ckpt) as f:
                return {"restarted": True, "state": json.load(f)}
        if not args.dry_run:
            # a dry run is pure inspection: it must not seed restart state
            with open(args.ckpt, "w") as f:
                json.dump(state, f)
        return {"restarted": False, "state": state}

    got = blocking.run_on_root(on_root, Topology.flat(n_dev), device) \
        if spmd.group_active() else on_root()
    state = got["state"]
    if got["restarted"]:
        _say(f"restarted from {args.ckpt}: {state}")
        # The checkpointed logical-proc count defines the graph; it cannot
        # be re-derived without generating a *different* graph, so a
        # restart on devices that cannot host it fails loudly. Out of core
        # without an explicit topology is exempt: the planner falls back
        # to the host-driven stream, which handles any logical-proc count
        # (and emits the identical blocks). An explicit --pods topology
        # has no fallback, so it keeps the error.
        if state["procs"] % n_dev and (args.pods or not args.out_dir):
            raise SystemExit(
                f"checkpoint {args.ckpt} was written for "
                f"{state['procs']} logical processors, which does not "
                f"divide over the {n_dev} devices present. Restart on a "
                f"device count that divides {state['procs']}, delete the "
                "checkpoint to start a new generation, or resume "
                "out-of-core with --out-dir.")
    return state


def _run(args, n_dev: int, device) -> int:
    if args.preset:
        spec = api.preset(args.preset)
        if args.out_dir:
            spec = spec.replace(execution="streamed", sink="shards",
                                overlap=args.overlap,
                                out_dir=os.path.join(args.out_dir,
                                                     spec.model))
        pl = api.plan(spec, device=device)
        _say(f"preset {args.preset}:")
        _say(pl.describe())
        if args.dry_run:
            return 0
        res, t = run_spec(pl)
        tag = "PBA" if spec.model == "pba" else "PK"
        where = f" -> {res.out_dir}" if res.out_dir else ""
        _say(f"{tag}: {res.stats.emitted_edges:,} edges{where} in {t:.2f}s "
             f"({res.stats.emitted_edges / t:.3e} edges/s) "
             f"drops={res.stats.dropped_edges} "
             f"rounds={res.stats.exchange_rounds}")
        return 0

    procs = args.procs
    if procs % n_dev:
        procs = max((procs // n_dev) * n_dev, n_dev)
    _say(f"devices: {n_dev}, logical processors: {procs}")

    # checkpoint = the generation spec; restart resumes deterministically
    state = _checkpoint_state(args, procs, n_dev, device)
    pba_spec, pk_spec = build_specs(args, state, n_dev)
    pba_plan = api.plan(pba_spec, device=device)
    pk_plan = api.plan(pk_spec, device=device)
    if args.dry_run:
        _say(pba_plan.describe())
        _say(pk_plan.describe())
        return 0

    res, t = run_spec(pba_plan)
    stats = res.stats
    where = f" -> {res.out_dir}" if res.out_dir else ""
    rounds = (f" rounds={stats.exchange_rounds}"
              if args.exchange_rounds or args.out_dir else "")
    _say(f"PBA: {stats.emitted_edges:,} edges{where}, {state['procs']} "
         f"logical procs on {n_dev} devices in {t:.2f}s "
         f"({stats.emitted_edges / t:.3e} edges/s) "
         f"drops={stats.dropped_edges}{rounds}")

    if res.edges is not None:
        gamma, top = degree_summary(res)
        if gamma is not None:
            _say(f"     gamma_mle={gamma:.2f}, max_degree={top}")
    del res

    pk_res, t = run_spec(pk_plan)
    where = f" -> {pk_res.out_dir}" if pk_res.out_dir else ""
    _say(f"PK:  {pk_res.stats.emitted_edges:,} edges{where} in {t:.2f}s "
         f"({pk_res.stats.emitted_edges / t:.3e} edges/s, "
         f"zero communication)")
    return 0


def main(argv: Optional[list] = None) -> int:
    """Run the launcher with ``argv`` (default: the command line)."""
    n_dev = world_from_env()
    args = parser(n_dev).parse_args(argv)
    # No fallback: without a card and without --device cpu this raises
    # before any work.
    device = spmd.resolve_device(args.device)
    started = False
    if "WORLD_SIZE" in os.environ and not spmd.group_active():
        rank = int(os.environ["RANK"])
        if device.type == "cpu":
            spmd.init_group("gloo", "env://", n_dev, rank,
                            timeout_s=GROUP_TIMEOUT_S)
        else:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
            spmd.init_group("nccl", "env://", n_dev, rank, device_id=device,
                            timeout_s=GROUP_TIMEOUT_S)
        started = True
    try:
        return _run(args, n_dev, device)
    finally:
        if started:
            spmd.destroy_group()


if __name__ == "__main__":
    sys.exit(main())
