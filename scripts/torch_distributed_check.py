#!/usr/bin/env python3
"""Run the PyTorch port's multi-device paths on N processes and hold each
rank's edges to the one-device paths.

    torchrun --nproc_per_node=4 scripts/torch_distributed_check.py        # N GPUs, NCCL
    torchrun --nproc_per_node=4 scripts/torch_distributed_check.py --cpu  # gloo, small sizes
    torchrun --nproc_per_node=4 scripts/torch_distributed_check.py --only lm_tp

Before the process group exists, rank 0 runs the one-device paths (no
group: host execution, the flat(1) device stream, the pk_3b stream, the
shard sink's memory run) and derives, for every rank, the digest of the
share that rank must return: its rows of the sharded (P, E) arrays, its
chunk of the PK and R-MAT index ranges (-1 past the end), its rows' edges
of the stream. Then every rank joins the group (NCCL on the cards, gloo
with --cpu) and runs, through the front door with no device given:

  pba_sharded_flat / pba_sharded_pods   the 64-rank x 1M-vertex x k=5 R=8
      cut of paper_1b_5b (pair_capacity 262144), execution="sharded" on
      flat(N) and on pods(2, N/2)
  pba_streamed_flat   the same preset streamed on flat(N)
  pk_3b_sharded       PK at L=10 (3,486,784,401 edges: one device's int32
      index range cannot hold it, N ranks' chunks can)
  rmat_scale26_sharded   Graph500 scale 26, edge factor 16
  shard_sink          preset hub_stress streamed into shards on flat(N),
      read back by rank 0
  lm_tp               sharded LM serving (repro_torch.sharding) on four
      processes, batch 8, 512-token prompts, 32 decode steps
      teacher-forced, each model at the mesh's "model" size (its
      padding), drawn as phase 8 of chip_smoke.py draws it: qwen1.5-0.5b
      in float32 on (data, model) = (1, 4) and (2, 2) against the same
      model on one card (rtol = atol = 1e-3); phi3-medium-14b in bf16 at
      tp 4 (KV heads padded to 20) on (1, 4) against one card
      (chip_smoke.lm_near, the control one position off past its bound);
      llama4-scout-17b-a16e in float32 cut to 4 layers on (1, 4) and
      (2, 2) against one card (1e-3), and in bf16 cut to 8 layers on
      (1, 4) against one card; llama4-scout-17b-a16e at full depth (48
      layers, 215.6 GB in bf16, more than one card holds) on (1, 4) and
      (2, 2), each against its own teacher-forced pass, and the two
      layouts against each other (reported). A bf16 MoE bound applies
      where no assignment was dropped, as phase 8 holds it (the dropped
      counts and the least router margin printed). minicpm3-4b (MLA),
      mamba2-130m (the SSD), recurrentgemma-2b (RG-LRU and local MQA)
      and whisper-medium (the encoder-decoder, 1500 frames) at full
      depth, drawn at one layer's fan-in as phase 8 draws them: float32
      on (1, 4) and (2, 2) against one card (1e-3), bf16 on (1, 4)
      against one card by chip_smoke.lm_near (their logits move little
      from one position to the next at this init, so lm_near's share of
      the control binds, not its absolute value; mamba2's bf16 gap is
      printed, not bound: chip_smoke.LM_BF16_UNFAITHFUL).
      Each run prints every rank's init, prefill and decode walls, weight
      bytes and peak device memory, and the c10d calls of one decode
      step (rank 0's host trace). ``--only lm_tp`` runs this case alone.
  lm_train_tp         training under the sharding rules
      (train.make_train_step(model, opt, rules)) on four processes, the
      runs of LM_TRAIN_TP_RUNS (qwen1.5-0.5b, phi3-medium-14b, the MoE
      llama4-scout-17b-a16e and qwen3-moe-235b-a22b, the MLA minicpm3-4b,
      the SSD mamba2-130m, the RG-LRU recurrentgemma-2b and the
      encoder-decoder whisper-medium with its 1500 frames drawn as
      launch/train.py draws them) laid out by
      launch/dryrun.train_layout, batch 8 x 512 of each
      card's walk corpus: float32 runs against rank 0's one-card run of
      the same model, bf16 runs' step 1 against the float32 run's on the
      same mesh (phase 9's bounds; the MoE routing assignments whose
      expert differs counted), timed bf16 runs (ms a step, tokens/s, state
      and peak a card, c10d calls a step, rank 0's idle share). A last
      line names the failures: those of LM_TRAIN_TP_KNOWN_FLIP_FAILURES
      (the value bounds alone, with flips) apart from any new one.
      ``--only lm_train_tp`` runs this case alone, ``--runs a,b`` those
      runs of it (with the float32 runs their bf16 runs are held to).
  dp_sync             the training path's int8 data-parallel gradient
      sync (repro_torch.train.compress.dp_sync) on a gradient tree of
      qwen1.5-0.5b's full-width shapes (463,987,712 float32 values per
      rank, drawn per rank from a seeded generator), two steps, the
      second carrying the first's error buffers; every rank's mean and
      error buffers must equal, bit for bit, the EF-int8 arithmetic done
      by every rank alone on all ranks' gradients, and the mean lie
      within one quantization step of the exact mean. ``--only dp_sync``
      runs this case alone.

  paper_full          the paper's own graph, preset paper_1b_5b not cut:
      1000 ranks x 1,000,000 vertices x k=5 (5,000,000,000 edges), R=8,
      seed 7, streamed into memory, pair_capacity pinned to
      PAPER_FULL_PAIR_CAPACITY (what the launcher's --dry-run prints for
      the preset), run through repro_torch.launch.generate.run_spec on
      flat(N) and then pods(2, N/2), each twice (cold, then warm). Gates:
      0 dropped edges; the edges kept, summed over the group as an int64,
      equal to the 5,000,000,000 requested on every rank; every rank's
      digest equal between the two topologies; and, when rank 0 could
      hold it before the group existed, every rank's digest equal to the
      one-device host-driven stream's edges whose u falls in that rank's
      vertex range, in the same order (paper_full_reference; a line says
      why when the host could not hold it, with the RSS reached).
      Readings, one line each: the walls, edges/s, rounds, peak device
      memory a card, peak host RSS a rank, rank 0's device idle share (a
      profiled run on flat), gamma_mle at kmin 5 and the max degree of the
      whole graph (launch.generate.degree_summary: the sharded degree
      count, fitted on rank 0 alone). ``--only paper_full`` runs this case alone (``--cpu``: the
      1000 ranks with vertices_per_proc cut to 40).

The sharded PBA cases then run the sharded analytics on every rank's
share (degree_counts_sharded, edge_count_sharded, max_degree_sharded),
which must give every rank the one-device host path's degree counts,
valid-edge count and max degree.

Each case prints one JSON line from rank 0: the ranks' digests against
the references (the last of --repeats runs), the global stats (equal on
every rank), the walls of every run (rank 0's and the slowest rank's:
the first run of a topology includes NCCL's setup of its
communicators), each rank's peak device memory, and for the
sharded PBA cases the c10d::alltoall_base_ calls of one more run traced
on rank 0's host ops (1 + exchange rounds on a flat topology, twice that
on pods). The setup line carries nvidia-smi's name and power limit of every card.
The last line is {"ok": true|false, ...}; the exit code is 0 only if
every case matched on every rank.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP_ARCH = "qwen1.5-0.5b"


def dp_grad(torch, spec, rank: int, step: int, leaf: int, device):
    """Rank ``rank``'s gradient of leaf ``leaf`` at ``step``: standard
    normal draws from a generator seeded by the three, scaled by
    10^-(leaf % 4) so the leaves' scales differ."""
    gen = torch.Generator(device).manual_seed(
        (step * 1000 + rank) * 100_000 + leaf)
    return torch.randn(spec.shape, generator=gen, device=device) * \
        10.0 ** -(leaf % 4)


def dp_sync_case(torch, rank: int, world: int, device, gpu: bool,
                 repeats: int, cpu: bool) -> dict:
    """The dp_sync case (module docstring); returns this rank's results."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.compress import dp_sync

    cfg = get_config(DP_ARCH)
    if cpu:
        cfg = cfg.reduced()
    specs = tree_leaves(build_model(cfg, device="cpu").param_specs())
    if gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    error, outs, walls = None, [], []
    for step in range(2):
        grads = [dp_grad(torch, sp, rank, step, i, device)
                 for i, sp in enumerate(specs)]
        steps = []
        for _ in range(repeats):
            dist.barrier()
            if gpu:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            red, new_error = dp_sync(grads, error)
            if gpu:
                torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        walls.append(steps)
        outs.append((red, new_error))
        error = new_error
        del grads
    peak = torch.cuda.max_memory_allocated(device) if gpu else None

    # Every rank alone: the EF-int8 arithmetic on all ranks' leaves.
    inv = torch.tensor(1 / 127.0, dtype=torch.float32, device=device)
    equal, worst = True, 0.0
    for i, sp in enumerate(specs):
        errs = [torch.zeros(sp.shape, device=device)] * world
        for step in range(2):
            xs = [dp_grad(torch, sp, r, step, i, device) + errs[r]
                  for r in range(world)]
            peak_x = torch.stack([torch.clamp(x.abs().max(), min=1e-12)
                                  for x in xs]).max()
            scale = peak_x * inv
            qs = [torch.clamp(torch.round(x / scale), -127, 127) for x in xs]
            total = qs[0].clone()
            for q in qs[1:]:
                total += q
            mean = (total * scale) / torch.tensor(float(world),
                                                  device=device)
            errs = [(x.double() - q.double() * scale.double()).float()
                    for x, q in zip(xs, qs)]
            red, new_error = outs[step]
            equal = equal and torch.equal(red[i], mean) and \
                torch.equal(new_error[i], errs[rank])
            exact = torch.stack(xs).mean(0)
            worst = max(worst, float((red[i] - exact).abs().max() / scale))
    return {"bit_equal": equal, "worst_over_scale": worst, "walls": walls,
            "peak_allocated_bytes": peak,
            "values": sum(math.prod(sp.shape) for sp in specs)}


def shares(torch, edge_digest, src, dst, bounds) -> list:
    """Digests of (src, dst)[lo:hi] for each (lo, hi, pad) in ``bounds``,
    padded with ``pad`` -1 entries (a rank's chunk past the end)."""
    out = []
    for lo, hi, pad in bounds:
        s, d = src[lo:hi], dst[lo:hi]
        if pad:
            fill = torch.full((pad,), -1, dtype=s.dtype, device=s.device)
            s, d = torch.cat([s, fill]), torch.cat([d, fill])
        out.append(edge_digest(s, d))
    return out


def references(torch, np, api, edge_digest, specs: dict, world: int,
               device) -> dict:
    """Rank 0, before the group exists: each case's expected digest per
    rank, from the one-device paths, and the host path's degree counts
    (sha256, valid edges, max)."""
    import chip_smoke
    from repro_torch.core.graph import degree_counts
    ref = {}
    pba = specs["pba"]
    res = api.generate(pba.replace(execution="host"), device=device)
    deg = degree_counts(res.edges)
    ref["analytics"] = {
        "degree_counts_sha256": chip_smoke.array_sha256(
            np, "<i4", deg.cpu().numpy()),
        "edge_count": int(res.edges.num_valid()), "max_degree": int(deg.max())}
    del deg
    p, e_local = res.edges.src.shape
    per = (p // world) * e_local
    rows = [(d * per, (d + 1) * per, 0) for d in range(world)]
    flat_src, flat_dst = res.edges.src.reshape(-1), res.edges.dst.reshape(-1)
    ref["pba_sharded_flat"] = ref["pba_sharded_pods"] = shares(
        torch, edge_digest, flat_src, flat_dst, rows)
    del res, flat_src, flat_dst
    res = api.generate(pba.replace(topology=api.Topology.flat(1)),
                       device=device)
    owner = res.edges.src // ((p // world) * pba.vertices_per_proc)
    ref["pba_streamed_flat"] = [
        edge_digest(res.edges.src[owner == d], res.edges.dst[owner == d])
        for d in range(world)]
    del res, owner
    for name, spec in (("pk_3b_sharded", specs["pk"]),
                       ("rmat_scale26_sharded", specs["rmat"])):
        res = api.generate(spec, device=device)
        e = res.stats.requested_edges
        chunk = -(-e // world)
        bounds = [(min(d * chunk, e), min((d + 1) * chunk, e),
                   (d + 1) * chunk - min((d + 1) * chunk, e))
                  for d in range(world)]
        ref[name] = shares(torch, edge_digest, res.edges.src.reshape(-1),
                           res.edges.dst.reshape(-1), bounds)
        del res
    res = api.generate(specs["hub"].replace(topology=api.Topology.flat(1)),
                       device=device)
    ref["shard_sink"] = edge_digest(res.edges.src, res.edges.dst)
    del res
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return ref


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU at small sizes (a rehearsal)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs of each case (the first includes "
                    "NCCL's setup of the case's communicators)")
    ap.add_argument("--only", choices=("dp_sync", "lm_tp", "lm_train_tp",
                                       "paper_full"),
                    default=None,
                    help="run this case alone")
    ap.add_argument("--runs", default=None,
                    help="lm_train_tp: these runs of LM_TRAIN_TP_RUNS "
                    "alone (names, comma-separated)")
    args = ap.parse_args()
    train_runs = lm_train_tp_runs(args.runs)
    # rank 0's one-card float32 llama4 reference holds 68.3 GB of state;
    # the caching allocator's fixed segments strand 6.5 GiB beside it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    import chip_smoke
    from repro_torch import api
    from repro_torch.core import distributed_analysis
    from repro_torch.core import storage
    from repro_torch.core.graph import edge_digest

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if world < 2 or world % 2:
        raise SystemExit(f"run on an even number of processes, not {world}")
    if args.cpu:
        device, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(1)
        pba = api.preset("paper_1b_5b", procs=8, vertices_per_proc=300,
                         pair_capacity=64)
        pk = api.preset("pk_3b", levels=5)
        rmat = api.GraphSpec(model="rmat", cfree_vertices=1 << 10,
                             cfree_edges=16 << 10, seed=7)
    else:
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: pass --cpu")
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        backend = "nccl"
        from repro_torch.kernels import _build
        _build.build()     # every rank at once: each output is atomic
        pba = api.preset("paper_1b_5b", procs=chip_smoke.PROCS,
                         vertices_per_proc=chip_smoke.VERTICES_PER_PROC,
                         pair_capacity=chip_smoke.PAIR_CAPACITY)
        pk = api.preset("pk_3b")
        rmat = api.GraphSpec(model="rmat",
                             cfree_vertices=1 << chip_smoke.RMAT_SCALE,
                             cfree_edges=16 << chip_smoke.RMAT_SCALE,
                             seed=7)
    if args.only == "paper_full":
        return paper_full(torch, np, api, chip_smoke, edge_digest, args, rank,
                          world, device, backend)
    hub = api.preset("hub_stress", execution="streamed")
    specs = {"pba": pba, "pk": pk, "rmat": rmat, "hub": hub}
    gpu = device.type == "cuda"

    t0 = time.perf_counter()
    graphs = args.only is None
    lm = args.only in (None, "lm_tp")
    ref = references(torch, np, api, edge_digest, specs, world, device) \
        if rank == 0 and graphs else None
    lm_refs = lm_tp_references(torch, np, chip_smoke, device, args.cpu) \
        if rank == 0 and lm else None
    lm_train = args.only in (None, "lm_train_tp")
    corpora: dict = {}          # this card's walk corpora, by vocabulary
    train_refs = lm_train_tp_references(torch, np, chip_smoke, device,
                                        args.cpu, corpora, train_runs) \
        if rank == 0 and lm_train else None
    ref_s = time.perf_counter() - t0
    if gpu:
        dist.init_process_group(backend, device_id=device,
                                timeout=datetime.timedelta(seconds=900))
    else:
        dist.init_process_group(backend,
                                timeout=datetime.timedelta(seconds=900))
    objs = [ref]
    dist.broadcast_object_list(objs, src=0)
    ref = objs[0]

    def sync():
        if gpu:
            torch.cuda.synchronize()

    def gathered(obj):
        out = [None] * world
        dist.all_gather_object(out, obj)
        return out

    r, c = 2, world // 2
    cases = (
        ("pba_sharded_flat", pba.replace(execution="sharded",
                                         topology=api.Topology.flat(world))),
        ("pba_sharded_pods", pba.replace(execution="sharded",
                                         topology=api.Topology.pods(r, c))),
        ("pba_streamed_flat", pba.replace(topology=api.Topology.flat(world))),
        ("pk_3b_sharded", pk.replace(execution="sharded")),
        ("rmat_scale26_sharded", rmat.replace(execution="sharded"))) \
        if graphs else ()
    ok = True
    if rank == 0:
        print(json.dumps({"phase": "setup", "world_size": world,
                          "backend": backend, "references_s": ref_s,
                          "device": torch.cuda.get_device_name(device)
                          if gpu else "cpu",
                          "nvidia_smi": subprocess.run(
                              ["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.strip().splitlines()
                          if gpu else None}), flush=True)
    for name, spec in cases:
        if gpu:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        walls = []
        for _ in range(args.repeats):
            res = None            # the previous run's edges, freed first
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            res = api.generate(spec, device=None if gpu else device)
            sync()
            walls.append(time.perf_counter() - t0)
        got = edge_digest(res.edges.src, res.edges.dst)
        stats = res.stats.__dict__
        peak = torch.cuda.max_memory_allocated(device) if gpu else None
        row = {"phase": "distributed_cards", "case": name,
               "executor": res.plan.executor,
               "topology": res.plan.topology.label, "lp": res.plan.lp,
               "world_size": world}
        analytics = None
        if name.startswith("pba_sharded"):
            topo = res.plan.topology
            sync()
            t0 = time.perf_counter()
            deg = distributed_analysis.degree_counts_sharded(
                res.edges, topology=topo)
            analytics = {
                "degree_counts_sha256": chip_smoke.array_sha256(
                    np, "<i4", deg.cpu().numpy()),
                "edge_count": distributed_analysis.edge_count_sharded(
                    res.edges, topology=topo),
                "max_degree": distributed_analysis.max_degree_sharded(
                    res.edges, topology=topo)}
            sync()
            analytics["wall_s"] = time.perf_counter() - t0
            del deg
        del res
        everyone = gathered({"digest": got, "stats": stats, "walls": walls,
                             "peak_allocated_bytes": peak,
                             "analytics": analytics})
        calls = None
        if name.startswith("pba_sharded"):
            if rank == 0:
                from repro_torch.analysis import audit
                _, recorded = audit.record(lambda: api.generate(
                    spec, device=None if gpu else device))
                sync()
                calls = sum(c.kind == "all-to-all" for c in recorded)
            else:
                api.generate(spec, device=None if gpu else device)
                sync()
        if rank == 0:
            st = everyone[0]["stats"]
            hops = 2 if name.endswith("pods") else 1
            row.update({
                "matches": [g["digest"] == w for g, w in
                            zip(everyone, ref[name])],
                "stats_equal_on_every_rank": all(
                    g["stats"] == st for g in everyone),
                "requested_edges": st["requested_edges"],
                "emitted_edges": st["emitted_edges"],
                "dropped_edges": st["dropped_edges"],
                "exchange_rounds": st["exchange_rounds"],
                "fallback_counts": st["fallback_counts"],
                "walls_s_rank0": everyone[0]["walls"],
                "walls_s_slowest": [max(w) for w in zip(
                    *(g["walls"] for g in everyone))],
                "peak_allocated_bytes": [g["peak_allocated_bytes"]
                                         for g in everyone]})
            if analytics is not None:
                row["analytics_match"] = [
                    {k: g["analytics"][k] for k in ref["analytics"]}
                    == ref["analytics"] for g in everyone]
                row["analytics_walls_s"] = [g["analytics"]["wall_s"]
                                            for g in everyone]
            if calls is not None:
                row["all_to_all_calls"] = calls
                row["expected_all_to_all_calls"] = hops * (
                    1 + st["exchange_rounds"])
            good = all(row["matches"]) and \
                all(row.get("analytics_match", [True])) and \
                row["stats_equal_on_every_rank"] and \
                st["fallback_counts"] == {} and \
                (name.startswith("pk") or st["dropped_edges"] == 0) and \
                row.get("all_to_all_calls") == row.get(
                    "expected_all_to_all_calls")
            row["ok"] = good
            ok = ok and good
            print(json.dumps(row), flush=True)

    if graphs:
        ok = shard_sink_case(api, storage, edge_digest, hub, ref, rank, world,
                             gpu, device, gathered) and ok

    # Sharded LM serving.
    if lm:
        if world != 4:
            raise SystemExit(f"lm_tp runs on 4 processes, not {world}")
        kept: dict = {}
        for run in LM_TP_RUNS:
            for shape in run[4]:
                ok = lm_tp_case(torch, np, chip_smoke, run, shape, lm_refs,
                                rank, device, args.cpu, gathered, kept) \
                    and ok
        del lm_refs, kept

    # Training under the sharding rules.
    if lm_train:
        if world != 4:
            raise SystemExit(f"lm_train_tp runs on 4 processes, not {world}")
        kept: dict = {}
        failed: list = []       # rank 0: (run, mesh, known flip failure)
        for run in train_runs:
            for shape in run[4]:
                ok = lm_train_tp_case(torch, np, chip_smoke, run, shape,
                                      train_refs, rank, device, args.cpu,
                                      gathered, corpora, kept, failed) \
                    and ok
        if rank == 0:
            print(json.dumps({
                "phase": "distributed_cards", "case": "lm_train_tp_failures",
                "known_routing_flip_failures": [
                    [n, list(m)] for n, m, known in failed if known],
                "new_failures": [[n, list(m)] for n, m, known in failed
                                 if not known]}), flush=True)
        del train_refs, corpora, kept

    # The training path's DP gradient sync.
    mine = dp_sync_case(torch, rank, world, device, gpu, args.repeats,
                        args.cpu) if args.only in (None, "dp_sync") else None
    everyone = gathered(mine) if mine is not None else None
    if rank == 0 and mine is not None:
        good = all(g["bit_equal"] for g in everyone) and \
            max(g["worst_over_scale"] for g in everyone) <= 1.0
        ok = ok and good
        print(json.dumps({
            "phase": "distributed_cards", "case": "dp_sync",
            "arch": DP_ARCH + (" reduced" if args.cpu else ""),
            "world_size": world, "values_per_rank": mine["values"],
            "bit_equal": [g["bit_equal"] for g in everyone],
            "worst_error_over_scale": max(g["worst_over_scale"]
                                          for g in everyone),
            "walls_s_rank0": mine["walls"],
            "walls_s_slowest": [[max(w) for w in zip(*(g["walls"][k]
                                                       for g in everyone))]
                                for k in range(2)],
            "peak_allocated_bytes": [g["peak_allocated_bytes"]
                                     for g in everyone], "ok": good}),
            flush=True)
    verdict = [ok]
    dist.broadcast_object_list(verdict, src=0)
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"ok": bool(verdict[0]), "world_size": world,
                          "backend": backend}), flush=True)
    return 0 if verdict[0] else 1


# --- lm_tp: sharded LM serving -------------------------------------------------------

# (name, arch, layers, dtype, meshes, reference); the weights drawn as
# phase 8 of chip_smoke.py draws them (the MoE config's stacked matrices
# at one layer's fan-in, LM_TP_FAN_IN); --cpu: reduced() configs with the
# depths of LM_TP_CPU_LAYERS and the cell LM_TP_CPU_CELL.
LLAMA4 = "llama4-scout-17b-a16e"
LM_TP_RUNS = (
    ("qwen_float32", "qwen1.5-0.5b", 0, "float32", ((1, 4), (2, 2)),
     "one_card"),
    ("phi3_tp4", "phi3-medium-14b", 0, "bfloat16", ((1, 4),), "one_card"),
    # top-1 routing in bf16 flips at near ties and a 512-token prompt
    # overflows the busiest experts, so the bf16 runs bind only where no
    # assignment was dropped (phase 8's rule); float32 at a depth one card
    # holds is the check of the expert-parallel path that always binds
    ("llama4_float32_4_layers", LLAMA4, 4, "float32", ((1, 4), (2, 2)),
     "one_card"),
    ("llama4_8_layers", LLAMA4, 8, "bfloat16", ((1, 4),), "one_card"),
    ("llama4_48_layers", LLAMA4, 0, "bfloat16", ((1, 4), (2, 2)),
     "teacher_forced"),
    ("minicpm3_float32", "minicpm3-4b", 0, "float32", ((1, 4), (2, 2)),
     "one_card"),
    ("minicpm3_tp4", "minicpm3-4b", 0, "bfloat16", ((1, 4),), "one_card"),
    ("mamba2_float32", "mamba2-130m", 0, "float32", ((1, 4), (2, 2)),
     "one_card"),
    ("mamba2_tp4", "mamba2-130m", 0, "bfloat16", ((1, 4),), "one_card"),
    ("recurrentgemma_float32", "recurrentgemma-2b", 0, "float32",
     ((1, 4), (2, 2)), "one_card"),
    ("recurrentgemma_tp4", "recurrentgemma-2b", 0, "bfloat16", ((1, 4),),
     "one_card"),
    ("whisper_float32", "whisper-medium", 0, "float32", ((1, 4), (2, 2)),
     "one_card"),
    ("whisper_tp4", "whisper-medium", 0, "bfloat16", ((1, 4),), "one_card"),
)
# phase 8 draws the MoE and the four mixer configs at one layer's fan-in
LM_TP_FAN_IN = (LLAMA4, "minicpm3-4b", "mamba2-130m", "recurrentgemma-2b",
                "whisper-medium")
LM_TP_CPU_LAYERS = {"llama4_8_layers": 4, "llama4_float32_4_layers": 2}
LM_TP_CPU_CELL = {"batch": 4, "prompt": 32, "new_tokens": 4}


def lm_tp_references(torch, np, chip_smoke, device, cpu: bool) -> dict:
    """Rank 0, before the group exists: each one-card run's logits (B,
    new_tokens + 1, V) on the host, keyed by the run and the padded
    model's tp (the model at each mesh's "model" size)."""
    from repro_torch.models import moe
    cell = LM_TP_CPU_CELL if cpu else chip_smoke.LM_TP_CELL
    s, n = cell["prompt"], cell["new_tokens"]
    out = {}
    for name, arch, layers, dtype, meshes, ref in LM_TP_RUNS:
        if ref != "one_card":
            continue
        layers = LM_TP_CPU_LAYERS.get(name, 0) if cpu else layers
        for tp in sorted({m[1] for m in meshes}):
            model = chip_smoke.lm_tp_load(torch, chip_smoke.lm_tp_model(
                torch, device, arch, layers, tp, getattr(torch, dtype), cpu),
                fan_in=arch in LM_TP_FAN_IN)
            tokens = chip_smoke.lm_tp_tokens(
                torch, np, model.raw_cfg.vocab_size, device, cell)
            extras = chip_smoke.lm_tp_extras(torch, np, model.cfg, device,
                                             cell)
            res = chip_smoke.lm_tp_serve(
                torch, lambda b: model.prefill(b, s + n), model.decode_step,
                tokens, s, n, extras=extras)
            with chip_smoke.lm_moe_calls(moe.dropped_assignments) as drops:
                model.prefill({"tokens": tokens[:, :s], **extras}, s + n)
            out[(name, tp)] = {"logits": res["logits"].cpu(),
                               "prefill_s": res["prefill_s"],
                               "decode_ms_per_step":
                                   res["decode_ms_per_step"],
                               "prefill_dropped": sum(drops)}
            del model, res, extras
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return out


def lm_tp_case(torch, np, chip_smoke, run, shape, refs, rank: int,
               device, cpu: bool, gathered, kept: dict) -> bool:
    """One sharded run of LM_TP_RUNS on ``shape`` = (data, model): every
    rank builds the model at the mesh's tp and draws its blocks, prefills
    its batch rows and decodes teacher-forced, and is held to the one-card
    run (``refs``, broadcast from rank 0) or to its own teacher-forced
    pass; beside it each rank's peak memory, the prefill wall, ms per
    decode step and the c10d calls of one decode step (rank 0's host
    trace). ``kept``: the 48-layer runs' gathered logits, so the two
    layouts are held to each other. Returns the verdict (rank 0)."""
    import torch.distributed as dist
    from repro_torch.models import moe
    from repro_torch.runtime.mesh import ProcessMesh
    from repro_torch.serve import make_serve_fns
    from repro_torch.sharding import make_rules, sharding_ctx
    from repro_torch.sharding.rules import block_range

    name, arch, layers, dtype, _, ref_kind = run
    cell = LM_TP_CPU_CELL if cpu else chip_smoke.LM_TP_CELL
    b, s, n = cell["batch"], cell["prompt"], cell["new_tokens"]
    layers = LM_TP_CPU_LAYERS.get(name, 0) if cpu else layers
    gpu = device.type == "cuda"
    sync = torch.cuda.synchronize if gpu else (lambda: None)
    if gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    mesh = ProcessMesh(("data", "model"), shape, device)
    tp = shape[1]
    t0 = time.perf_counter()
    model = chip_smoke.lm_tp_model(torch, device, arch, layers, tp,
                                   getattr(torch, dtype), cpu)
    prules = make_rules(mesh, "prefill", b, kv_sharded=model.kv_sharded)
    drules = make_rules(mesh, "decode", b, kv_sharded=model.kv_sharded)
    chip_smoke.lm_tp_load(torch, model, prules, fan_in=arch in LM_TP_FAN_IN)
    sync()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in model.parameters())
    tokens = chip_smoke.lm_tp_tokens(torch, np, model.raw_cfg.vocab_size,
                                     device, cell)
    bax = prules.batch_axes
    lo, hi = block_range(b, mesh.axis_size(bax), mesh.axis_index(bax)) \
        if bax else (0, b)
    v = model.cfg.vocab_size // tp
    v0 = mesh.axis_index("model") * v
    mine = tokens[lo:hi]
    extras = {k: v[lo:hi] for k, v in chip_smoke.lm_tp_extras(
        torch, np, model.cfg, device, cell).items()}
    prefill, _ = make_serve_fns(model, rules=prules, max_len=s + n)
    _, decode = make_serve_fns(model, rules=drules)
    dist.barrier()
    res = chip_smoke.lm_tp_serve(torch, prefill, decode, mine, s, n,
                                 extras=extras)
    # the prefill again, its MoE calls measured (host syncs: untimed)
    with chip_smoke.lm_moe_calls(moe.dropped_assignments) as drops, \
            chip_smoke.lm_moe_calls(chip_smoke.lm_router_margin) as margins:
        prefill({"tokens": mine[:, :s], **extras})
    # the c10d calls of one decode step (the last step again)
    step = lambda: decode(mine[:, s + n - 1:s + n], res["caches"],
                          s + n - 1)
    if rank == 0:
        calls = chip_smoke.c10d_calls(torch, step)
    else:
        step()
        sync()
        calls = None
    got = res["logits"]
    row = {"init_s": init_s, "weight_bytes": weight_bytes,
           "prefill_s": res["prefill_s"],
           "decode_ms_per_step": res["decode_ms_per_step"]}
    if ref_kind == "one_card":
        want = refs[(name, tp)]["logits"] if rank == 0 else None
        box = [None if want is None else tuple(want.shape)]
        dist.broadcast_object_list(box, src=0)
        full = want.to(device) if rank == 0 else torch.empty(
            box[0], dtype=got.dtype, device=device)
        dist.broadcast(full, src=0)
        want = full[lo:hi, :, v0:v0 + v]
        row["max_abs_diff"] = float((got.float() - want.float()).abs().max())
        if dtype == "float32":
            row["allclose"] = bool(torch.allclose(
                got, want, rtol=chip_smoke.LM_CARD_RTOL,
                atol=chip_smoke.LM_CARD_ATOL))
        row["parts"] = chip_smoke.lm_gap_parts(torch, got, want)
        del full, want
    else:
        with sharding_ctx(prules, mesh, model.cfg.d_model), \
                chip_smoke.lm_moe_calls(
                moe.dropped_assignments) as tdrops:
            full = model({"tokens": mine, **extras})
        row["teacher_dropped"] = sum(tdrops)
        row["parts"] = chip_smoke.lm_gap_parts(torch, got, full[:, s - 1:])
        del full
    row["prefill_dropped"] = sum(drops)
    row["least_router_margin"] = min(margins) if margins else None
    row["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(device) \
        if gpu else None
    blocks = gathered({"rows": (lo, hi), "vocab": (v0, v0 + v),
                       "logits": got.float().cpu()}) \
        if ref_kind == "teacher_forced" else None
    del res, model, got
    if gpu:
        torch.cuda.empty_cache()
    everyone = gathered(row)
    if rank != 0:
        return True
    gap = chip_smoke.lm_gap_from_parts([r.pop("parts") for r in everyone])
    out = {"phase": "distributed_cards", "case": "lm_tp", "run": name,
           "arch": arch, "layers": layers or "all", "dtype": dtype,
           "mesh": {"data": shape[0], "model": shape[1]},
           "tp": tp, "batch_axes": list(bax), **cell,
           "reference": ref_kind, "gap": gap,
           "tolerance_rel_l2": chip_smoke.LM_BF16_REL_L2,
           "tolerance_share": chip_smoke.LM_NEAR_SHARE,
           "c10d_calls_one_decode_step": calls,
           "ranks": everyone}
    if ref_kind == "one_card":
        one = refs[(name, tp)]
        out["one_card"] = {k: one[k] for k in (
            "prefill_s", "decode_ms_per_step", "prefill_dropped")}
    good = math.isfinite(gap["rel_l2_max"])
    if dtype == "float32":
        out["tolerance"] = [chip_smoke.LM_CARD_RTOL, chip_smoke.LM_CARD_ATOL]
        good = good and all(r["allclose"] for r in everyone)
    else:
        # the control: logits one position off lie past the bound, except
        # where the init moves them little from one position to the next
        # (LM_PRECISION_ARCHS; lm_near's share binds there)
        out["control_past_bound"] = \
            gap["unrelated_rel_l2_min"] > chip_smoke.LM_BF16_REL_L2
        control_binds = arch not in chip_smoke.LM_PRECISION_ARCHS
        # phase 8's rules: the bound applies where no assignment was
        # dropped, and not to a bf16 path unfaithful by design
        applies = all(r["prefill_dropped"] == 0 and
                      r.get("teacher_dropped", 0) == 0 for r in everyone) \
            and out.get("one_card", {}).get("prefill_dropped", 0) == 0 \
            and arch not in chip_smoke.LM_BF16_UNFAITHFUL
        out["bound_applies"] = applies
        good = good and (out["control_past_bound"] or not control_binds) \
            and (not applies or chip_smoke.lm_near(gap))
    if blocks is not None:
        full = torch.empty((b, n + 1, blocks[0]["logits"].shape[-1] * tp))
        for blk in blocks:
            (r0, r1), (c0, c1) = blk["rows"], blk["vocab"]
            full[r0:r1, :, c0:c1] = blk["logits"]
        if name in kept:
            # reported, not gated: top-1 routing in bf16 flips at near
            # ties, and another layout rounds otherwise (the reduced
            # llama4 on the CPU: bf16 against float32 unsharded reads 0.91)
            other_shape, other = kept[name]
            out["against_" + "x".join(map(str, other_shape))] = \
                chip_smoke.lm_gap_from_parts(
                    [chip_smoke.lm_gap_parts(torch, full, other)])
        else:
            kept[name] = (shape, full)
    out["ok"] = good
    print(json.dumps(out), flush=True)
    return good


# --- lm_train_tp: training under the sharding rules -------------------------------

# (name, arch, layers, dtype, meshes, steps, reference): the walk corpus's
# batches of LM_TRAIN_TP_CELL on every card, weights drawn as phase 9 of
# chip_smoke.py draws its cell (the port's init seeded LM_SEED, each
# stacked matrix at one layer's fan-in), laid out on each mesh as
# lm_train_tp_layout says (qwen: no_tp, accum 1; phi3: the TP rules, accum
# 4 on (1, 4) and 2 on (2, 2); the MoE configs: the TP rules with expert
# parallelism, accum 4 and 2; minicpm3: the TP rules, accum 1). "one_card":
# float32, every step's metrics and parameter checksums against the same
# model on one card (rank 0, before the group); "float32:<run>": bf16,
# step 1's loss and grad norm against that float32 run's step 1 on the
# same mesh in this call (LM_TRAIN_TP_BF16_RTOL), with the routing
# assignments whose expert differs counted; None: timed (bf16 over
# float32 masters).
QWEN3_MOE, MINICPM3 = "qwen3-moe-235b-a22b", "minicpm3-4b"
MAMBA2, RGEMMA, WHISPER = ("mamba2-130m", "recurrentgemma-2b",
                           "whisper-medium")
LM_TRAIN_TP_RUNS = (
    ("qwen_no_tp_float32", "qwen1.5-0.5b", 0, "float32", ((1, 4), (2, 2)),
     3, "one_card"),
    ("qwen_no_tp", "qwen1.5-0.5b", 0, "bfloat16", ((1, 4), (2, 2)), 10,
     None),
    ("phi3_float32_2_layers", "phi3-medium-14b", 2, "float32",
     ((1, 4), (2, 2)), 3, "one_card"),
    ("phi3_bf16_2_layers", "phi3-medium-14b", 2, "bfloat16",
     ((1, 4), (2, 2)), 1, "float32:phi3_float32_2_layers"),
    ("phi3_40_layers", "phi3-medium-14b", 0, "bfloat16", ((1, 4),), 5,
     None),
    ("llama4_float32_1_layer", LLAMA4, 1, "float32", ((1, 4), (2, 2)), 3,
     "one_card"),
    ("llama4_bf16_1_layer", LLAMA4, 1, "bfloat16", ((1, 4), (2, 2)), 1,
     "float32:llama4_float32_1_layer"),
    ("qwen3_moe_float32_1_layer", QWEN3_MOE, 1, "float32", ((1, 4), (2, 2)),
     3, "one_card"),
    ("qwen3_moe_bf16_1_layer", QWEN3_MOE, 1, "bfloat16", ((1, 4), (2, 2)),
     1, "float32:qwen3_moe_float32_1_layer"),
    ("minicpm3_float32_2_layers", MINICPM3, 2, "float32", ((1, 4), (2, 2)),
     3, "one_card"),
    ("minicpm3_bf16_2_layers", MINICPM3, 2, "bfloat16", ((1, 4), (2, 2)), 1,
     "float32:minicpm3_float32_2_layers"),
    # one iRoPE period of llama4 (3 chunked layers, 1 global), 4 layers of
    # qwen3-moe: neither trains at full depth on four cards (1.72 TB and
    # 3.76 TB of state); minicpm3 at its full 62 layers (68.2 GB)
    ("llama4_4_layers", LLAMA4, 4, "bfloat16", ((1, 4),), 5, None),
    ("qwen3_moe_4_layers", QWEN3_MOE, 4, "bfloat16", ((1, 4),), 5, None),
    ("minicpm3_62_layers", MINICPM3, 0, "bfloat16", ((1, 4),), 10, None),
    # the SSD, the RG-LRU and the encoder-decoder: mamba2 at 2 layers,
    # recurrentgemma at one (rec, rec, local) period, whisper at 2 encoder
    # and 2 decoder layers over its 1500 frames against one card, then
    # each at its full depth (24, 26, 24 + 24), which one card holds too
    ("mamba2_float32_2_layers", MAMBA2, 2, "float32", ((1, 4), (2, 2)), 3,
     "one_card"),
    ("mamba2_bf16_2_layers", MAMBA2, 2, "bfloat16", ((1, 4), (2, 2)), 1,
     "float32:mamba2_float32_2_layers"),
    ("recurrentgemma_float32_3_layers", RGEMMA, 3, "float32",
     ((1, 4), (2, 2)), 3, "one_card"),
    ("recurrentgemma_bf16_3_layers", RGEMMA, 3, "bfloat16",
     ((1, 4), (2, 2)), 1, "float32:recurrentgemma_float32_3_layers"),
    ("whisper_float32_2_layers", WHISPER, 2, "float32", ((1, 4), (2, 2)), 3,
     "one_card"),
    ("whisper_bf16_2_layers", WHISPER, 2, "bfloat16", ((1, 4), (2, 2)), 1,
     "float32:whisper_float32_2_layers"),
    ("mamba2_24_layers", MAMBA2, 0, "bfloat16", ((1, 4),), 10, None),
    ("recurrentgemma_26_layers", RGEMMA, 0, "bfloat16", ((1, 4),), 5, None),
    ("whisper_24_layers", WHISPER, 0, "bfloat16", ((1, 4),), 5, None),
)
# timed runs whose model one card holds: rank 0 times the unsharded step
# too, before the group (the other timed runs' training state does not fit)
LM_TRAIN_TP_ONE_CARD_TIMED = ("qwen_no_tp", "mamba2_24_layers",
                              "recurrentgemma_26_layers", "whisper_24_layers")
LM_TRAIN_TP_CELL = {"batch": 8, "seq": 512}
LM_TRAIN_TP_CPU_CELL = {"batch": 4, "seq": 32}
LM_TRAIN_TP_OPT = {"lr": 1e-3, "warmup_steps": 2}
# chip_smoke.train_mismatches' bounds against the one-card run: step 1's
# loss and grad norm, the later steps', the checksums after the last step
LM_TRAIN_TP_RTOL = 1e-5
LM_TRAIN_TP_LATER_RTOL = {"loss": 1e-4, "grad_norm": 1e-3}
LM_TRAIN_TP_CHECKSUM_RTOL = 1e-3
# bf16 against float32 at step 1 on the same cards: phase 9's bounds
# (chip_smoke.TRAIN_BF16_LOSS_RTOL and TRAIN_BF16_GRAD_NORM_RTOL)
LM_TRAIN_TP_BF16_RTOL = {"loss": 2.0 ** -14, "grad_norm": 2.0 ** -8}
# (run, mesh) whose failure on four H100s routing flips were shown to
# cause: routed as its reference routed (scripts/lm_train_tp_pinned.py),
# each passed its bounds. Such a failure with flips is still a failure
# (the bounds stay, and the exit code is 1); the summary line names it
# apart from any other, which is new.
LM_TRAIN_TP_KNOWN_FLIP_FAILURES = frozenset({
    ("llama4_float32_1_layer", (2, 2)),
    ("llama4_bf16_1_layer", (1, 4)), ("llama4_bf16_1_layer", (2, 2)),
    ("qwen3_moe_bf16_1_layer", (1, 4)),
})


def lm_train_tp_runs(names):
    """The runs of LM_TRAIN_TP_RUNS named in ``names`` (comma-separated;
    None: all), each bf16 gate with its float32 run."""
    if names is None:
        return LM_TRAIN_TP_RUNS
    want = set(names.split(","))
    unknown = want - {r[0] for r in LM_TRAIN_TP_RUNS}
    if unknown:
        raise SystemExit(f"no lm_train_tp run {sorted(unknown)}")
    want |= {r[6].split(":", 1)[1] for r in LM_TRAIN_TP_RUNS
             if r[0] in want and (r[6] or "").startswith("float32:")}
    return tuple(r for r in LM_TRAIN_TP_RUNS if r[0] in want)


@contextlib.contextmanager
def routing_recorded(torch, out: list):
    """A context in which the MoE's route records the expert ids (on the
    host) of each call of the forward pass, not those of remat's
    recompute in the backward pass (run by autograd's engine)."""
    from repro_torch.models import moe
    plain = moe.route

    def route(cfg, p, x):
        probs, gates, ids = plain(cfg, p, x)
        if torch._C._current_graph_task_id() == -1:
            out.append(ids.detach().cpu())
        return probs, gates, ids
    moe.route = route
    try:
        yield out
    finally:
        moe.route = plain


def flips_by_step(routes: list, want: list, steps: int) -> list:
    """[assignments whose expert differs, assignments] of each step, from
    two runs' routing records (the same calls in the same order)."""
    per = len(routes) // steps
    return [[sum(int((a != w).sum()) for a, w in zip(
        routes[i * per:(i + 1) * per], want[i * per:(i + 1) * per])),
             sum(a.numel() for a in routes[i * per:(i + 1) * per])]
            for i in range(steps)]


def lm_train_tp_layout(arch, shape, cpu):
    """launch.dryrun.train_layout of the run's deployment: the config at
    its full depth (a run's cut depth keeps its layout) on the mesh
    ``shape`` = (data, model), at the cell's global batch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import train_layout
    cell = LM_TRAIN_TP_CPU_CELL if cpu else LM_TRAIN_TP_CELL
    return train_layout(get_config(arch), {"data": shape[0],
                                           "model": shape[1]}, cell["batch"])


def lm_train_tp_model(torch, chip_smoke, device, arch, layers, tp, dtype,
                      cpu):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    cfg = cfg.reduced() if cpu else cfg
    if layers and not cpu:
        cfg = dataclasses.replace(cfg, num_layers=layers, encoder_layers=(
            layers if cfg.encoder_layers else 0))
    return build_model(cfg, tp=tp, compute_dtype=getattr(torch, dtype),
                       device=device)


def lm_train_tp_batches(np, chip_smoke, corpora, model, device, steps,
                        accum, cpu):
    """``steps`` batches of the cell from this card's walk corpus for the
    model's vocabulary (built once per card, its kernel launches
    counted)."""
    from repro_torch.kernels import ops
    cell = LM_TRAIN_TP_CPU_CELL if cpu else LM_TRAIN_TP_CELL
    vocab = model.cfg.vocab_size
    if vocab not in corpora:
        ops.reset_launch_counts()
        corpus = chip_smoke.train_corpus(device, vocab)
        corpora[vocab] = (corpus, ops.launch_counts())
    corpus, _ = corpora[vocab]
    corpus.restore({"cursor": 0, "seed": chip_smoke.TRAIN_CORPUS["seed"]})
    return chip_smoke.train_batches(np, corpus, model.cfg, steps,
                                    cell["batch"], cell["seq"], accum)


def lm_train_tp_params(torch, chip_smoke, model, rules=None):
    with torch.no_grad():
        return chip_smoke.lm_layer_fan_in(model, model.master_params(
            generator=torch.Generator(model.device).manual_seed(
                chip_smoke.LM_SEED), rules=rules))


def lm_train_tp_checksums(np, chip_smoke, model, params, rules=None):
    """chip_smoke.train_checksums of ``params`` (this rank's blocks under
    ``rules``: the three leaves gathered whole, every rank taking part)."""
    from repro_torch.models.layers import tree_leaves, tree_paths
    from repro_torch.train.checkpoint import whole_leaf
    paths = ["/".join(map(str, p)) for p in tree_paths(params)]
    keep = {"embed/tok", "final_norm/scale", sorted(paths)[-1]}
    named = {}
    for p, spec, t in zip(paths, tree_leaves(model.param_specs()),
                          tree_leaves(params)):
        if p in keep:
            named[p] = whole_leaf(t, spec, rules) if rules is not None \
                else t.detach().cpu().numpy()
    return chip_smoke.train_checksums(np, named)


def lm_train_tp_references(torch, np, chip_smoke, device, cpu: bool,
                           corpora: dict, runs=LM_TRAIN_TP_RUNS) -> dict:
    """Rank 0, before the group exists: each "one_card" run and each run
    of LM_TRAIN_TP_ONE_CARD_TIMED unsharded on this card, keyed by the
    run, the padded model's tp (1 under no_tp) and the accum of its
    meshes' layouts (lm_train_tp_layout): every step's metrics and
    wall, the checksums after the last, the corpus digest, and an MoE
    run's routing (routing_recorded, every step)."""
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    out = {}
    sync = torch.cuda.synchronize if device.type == "cuda" \
        else (lambda: None)
    for name, arch, layers, dtype, meshes, steps, ref in runs:
        if ref != "one_card" and name not in LM_TRAIN_TP_ONE_CARD_TIMED:
            continue
        for tp, accum in sorted({(lay.tp, lay.accum) for lay in (
                lm_train_tp_layout(arch, m, cpu) for m in meshes)}):
            model = lm_train_tp_model(torch, chip_smoke, device, arch,
                                      layers, tp, dtype, cpu)
            batches = lm_train_tp_batches(np, chip_smoke, corpora, model,
                                          device, steps, accum, cpu)
            params = lm_train_tp_params(torch, chip_smoke, model)
            state = init_opt_state(params)
            step = make_train_step(model, AdamWConfig(**LM_TRAIN_TP_OPT))
            rec = {"loss": [], "grad_norm": [], "lr": [], "step_ms": [],
                   "corpus_sha256": chip_smoke.corpus_sha256(np, batches)}
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            routes: list = []
            for b in batches:
                sync()
                t0 = time.perf_counter()
                with routing_recorded(torch, routes) if model.cfg.moe \
                        and ref == "one_card" else contextlib.nullcontext():
                    params, state, m = step(params, state, b)
                sync()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                for k in ("loss", "grad_norm", "lr"):
                    rec[k].append(float(m[k]))
            rec["routes"] = [r.numpy() for r in routes]
            rec["checksums"] = lm_train_tp_checksums(np, chip_smoke, model,
                                                     params)
            rec["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(
                device) if device.type == "cuda" else None
            out[(name, tp, accum)] = rec
            del model, params, state, step
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return out


def device_idle_share(torch, chip_smoke, fn) -> dict:
    """fn() once under torch.profiler's trace of the card: the union of
    its device intervals against the wall (chip_smoke.profile_fn's
    reading, one call and no retry, so every rank runs fn() once)."""
    from torch.autograd import DeviceType
    prof, wall = chip_smoke.profiled(torch, fn, 1)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and e.name != "Command Buffer Full")
    if not spans:
        return {"wall_s": wall, "kernels_busy_s": None,
                "device_idle_share_of_wall": None}
    busy = chip_smoke.union_us(spans) / 1e6
    top = sorted((e for e in prof.key_averages()
                  if chip_smoke.device_us(e) > 0),
                 key=chip_smoke.device_us, reverse=True)[:8]
    return {"wall_s": wall, "kernels_busy_s": busy,
            "device_idle_share_of_wall": 1 - busy / wall,
            "top_device_ops": [{"name": e.key[:90], "calls": e.count,
                                "device_ms": chip_smoke.device_us(e) / 1e3}
                               for e in top]}


def lm_train_tp_case(torch, np, chip_smoke, run, shape, refs, rank: int,
                     device, cpu: bool, gathered, corpora: dict,
                     kept: dict, failed: list) -> bool:
    """One run of LM_TRAIN_TP_RUNS on ``shape`` = (data, model): every rank
    lays the run out by lm_train_tp_layout and builds the model (tp 1
    under no_tp, else the mesh's "model" size),
    draws its blocks of the float32 masters, takes its rows of each batch
    of its own card's corpus and runs make_train_step(model, opt, rules);
    held to the one-card run, or (bf16) its step 1 to the float32 run's
    on this mesh (``kept``: each float32 run's step 1 and each rank's
    routing), or timed: ms per step, tokens/s, each card's peak, the c10d
    calls of one more step (rank 0's host trace) and rank 0's idle share
    over one more (its device trace). Returns the verdict (rank 0), and
    appends a failure to ``failed`` with whether it is one of
    LM_TRAIN_TP_KNOWN_FLIP_FAILURES with flips."""
    import statistics
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models.layers import tree_leaves
    from repro_torch.runtime.mesh import ProcessMesh
    from repro_torch.sharding import make_rules
    from repro_torch.sharding.rules import block_range
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    name, arch, layers, dtype, _, steps, ref_kind = run
    layout = lm_train_tp_layout(arch, shape, cpu)
    no_tp, tp, accum = layout.no_tp, layout.tp, layout.accum
    cell = LM_TRAIN_TP_CPU_CELL if cpu else LM_TRAIN_TP_CELL
    gpu = device.type == "cuda"
    sync = torch.cuda.synchronize if gpu else (lambda: None)
    mesh = ProcessMesh(("data", "model"), shape, device)
    model = lm_train_tp_model(torch, chip_smoke, device, arch, layers, tp,
                              dtype, cpu)
    timed = ref_kind is None
    gate = (ref_kind or "").startswith("float32:")
    one_card = ref_kind == "one_card"
    referenced = any(r[6] == f"float32:{name}" for r in LM_TRAIN_TP_RUNS)
    record = model.cfg.moe and (gate or referenced or one_card)
    routes: list = []
    batches = lm_train_tp_batches(np, chip_smoke, corpora, model, device,
                                  steps + 2 * timed, accum, cpu)
    digest = chip_smoke.corpus_sha256(np, batches[:steps])
    if gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    rules = make_rules(mesh, "train", cell["batch"],
                       kv_sharded=model.kv_sharded, no_tp=no_tp)
    bax = rules.batch_axes
    mb = cell["batch"] // accum
    lo, hi = block_range(mb, mesh.axis_size(bax), mesh.axis_index(bax)) \
        if bax else (0, mb)
    mine = [{k: v[:, lo:hi] for k, v in b.items()} for b in batches]
    counting = mesh.coords["model"] == 0 or no_tp    # ranks of other rows
    ref_routes = None
    if one_card and model.cfg.moe:
        objs = [refs[(name, tp, accum)]["routes"] if rank == 0 else None]
        dist.broadcast_object_list(objs, src=0)
        ref_routes = [torch.from_numpy(r[lo:hi]) for r in objs[0]]
    sync()
    t0 = time.perf_counter()
    params = lm_train_tp_params(torch, chip_smoke, model, rules)
    state = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(**LM_TRAIN_TP_OPT), rules)
    sync()
    init_s = time.perf_counter() - t0
    master_bytes = sum(t.numel() * 4 for t in tree_leaves(params))
    n_params, raw = model.count_params(), model.raw_cfg
    rec = {"loss": [], "grad_norm": [], "lr": []}
    ms = []
    dist.barrier()
    for i, b in enumerate(mine[:steps]):
        sync()
        t1 = time.perf_counter()
        with routing_recorded(torch, routes) if record and (
                i == 0 or one_card) else contextlib.nullcontext():
            params, state, m = step(params, state, b)
        sync()
        ms.append((time.perf_counter() - t1) * 1e3)
        for k in ("loss", "grad_norm", "lr"):
            rec[k].append(float(m[k]))
    peak = torch.cuda.max_memory_allocated(device) if gpu else None
    calls = idle = None
    if timed:
        more = iter(mine[steps:])

        def one():
            nonlocal params, state
            params, state, _ = step(params, state, next(more))
        if rank == 0:
            calls = chip_smoke.c10d_calls(torch, one)
        else:
            one()
            sync()
        if rank == 0 and gpu:
            idle = device_idle_share(torch, chip_smoke, one)
        else:
            one()
            sync()
    row = {"init_s": init_s, "master_bytes": master_bytes,
           "step_ms": ms, "peak_allocated_bytes": peak,
           "corpus_sha256": digest,
           "corpus_launches": corpora[model.cfg.vocab_size][1],
           "metrics": {k: rec[k] for k in ("loss", "grad_norm", "lr")}}
    if one_card:
        rec["checksums"] = lm_train_tp_checksums(np, chip_smoke, model,
                                                 params, rules)
        row["mismatches"] = chip_smoke.train_mismatches(
            rec, refs[(name, tp, accum)], LM_TRAIN_TP_RTOL,
            LM_TRAIN_TP_LATER_RTOL, LM_TRAIN_TP_CHECKSUM_RTOL) \
            if rank == 0 else None
    want = kept[(ref_kind.split(":", 1)[1], shape)] if gate else None
    if referenced:
        kept[(name, shape)] = {"loss": rec["loss"][0],
                               "grad_norm": rec["grad_norm"][0],
                               "routes": routes[:len(routes) // steps]}
    if ref_routes is not None or (gate and model.cfg.moe):
        # assignments routed to another expert than the run held against
        # (the one card; the float32 run) routed them
        pin = ref_routes if ref_routes is not None else want["routes"]
        row["flips"] = flips_by_step(routes, pin, 1 if gate else steps) \
            if counting else None
    del params, state, step, model
    if gpu:
        torch.cuda.empty_cache()
    everyone = gathered(row)
    if rank != 0:
        return True
    tokens = cell["batch"] * cell["seq"]
    step_ms = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    out = {"phase": "distributed_cards", "case": "lm_train_tp", "run": name,
           "arch": arch, "layers": layers or "all",
           "reduced": "reduced()" if cpu else f"num_layers "
           f"{get_config(arch).num_layers} -> {layers}" + (
               f", encoder_layers {get_config(arch).encoder_layers} -> "
               f"{layers}" if get_config(arch).encoder_layers else "")
           if layers else None,
           "dtype": dtype,
           "master_dtype": "float32", "no_tp": no_tp, "tp": tp,
           "mesh": {"data": shape[0], "model": shape[1]},
           "batch_axes": list(bax), **cell, "accum": accum, "steps": steps,
           "params": n_params, "params_unpadded": raw.num_params(),
           "state_bytes_unpadded": 16 * raw.num_params(),
           "state_bytes_a_card": [4 * r["master_bytes"] for r in everyone],
           "step_ms_median": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "c10d_calls_one_step": calls, "rank0_profile": idle,
           "reference": ref_kind or "timed", "ranks": everyone}
    metrics_equal = all(r["metrics"] == everyone[0]["metrics"]
                        for r in everyone)
    corpus_equal = len({r["corpus_sha256"] for r in everyone}) == 1
    kernels = all(min(r["corpus_launches"].get(k, 0) for k in
                      chip_smoke.TRAIN_CORPUS_KERNELS) >= 1
                  for r in everyone) if gpu else True
    finite = all(math.isfinite(x) for k in ("loss", "grad_norm")
                 for x in everyone[0]["metrics"][k])
    good = metrics_equal and corpus_equal and kernels and finite
    out.update({"metrics_equal_on_every_rank": metrics_equal,
                "corpus_equal_on_every_rank": corpus_equal,
                "corpus_kernels_launched": kernels})
    if timed and name in LM_TRAIN_TP_ONE_CARD_TIMED:
        one = refs[(name, tp, accum)]
        out["one_card"] = {"step_ms": one["step_ms"],
                           "step_ms_median": statistics.median(
                               one["step_ms"][1:])}
    if gate:
        rel = {k: abs(everyone[0]["metrics"][k][0] - want[k]) / abs(want[k])
               for k in ("loss", "grad_norm")}
        out["against_float32"] = {
            "run": ref_kind.split(":", 1)[1],
            "float32_step1": {k: want[k] for k in ("loss", "grad_norm")},
            "rel": rel, "bound": LM_TRAIN_TP_BF16_RTOL}
        if "flips" in everyone[0]:
            out["against_float32"]["flipped_assignments"] = \
                routing_flips(everyone)[0]
        within = all(rel[k] <= LM_TRAIN_TP_BF16_RTOL[k] for k in rel)
        flipped = out["against_float32"].get("flipped_assignments", [0])[0]
    elif not timed:
        one = refs[(name, tp, accum)]
        out["one_card"] = {k: one[k] for k in ("loss", "grad_norm")}
        out["one_card_peak_allocated_bytes"] = one["peak_allocated_bytes"]
        out["corpus_equal_to_one_card"] = \
            everyone[0]["corpus_sha256"] == one["corpus_sha256"]
        out["tolerance"] = {"step1_rtol": LM_TRAIN_TP_RTOL,
                            "later_rtol": LM_TRAIN_TP_LATER_RTOL,
                            "checksum_rtol": LM_TRAIN_TP_CHECKSUM_RTOL}
        if "flips" in everyone[0]:
            out["flipped_assignments_by_step"] = routing_flips(everyone)
        good = good and out["corpus_equal_to_one_card"]
        within = not everyone[0]["mismatches"]
        flipped = sum(f[0] for f in out.get("flipped_assignments_by_step",
                                            []))
    if not timed:
        # a failure of the value bounds alone, of a known (run, mesh), with
        # assignments flipped, is the known one; any other failure is new
        if good and not within:
            out["known_routing_flip_failure"] = bool(
                (name, tuple(shape)) in LM_TRAIN_TP_KNOWN_FLIP_FAILURES
                and flipped)
        good = good and within
    out["ok"] = good
    if not good:
        failed.append((name, tuple(shape),
                       out.get("known_routing_flip_failure", False)))
    print(json.dumps(out), flush=True)
    return good


def routing_flips(everyone: list) -> list:
    """[flipped, assignments] of each step, summed over the ranks that
    route rows of their own (the rows' first "model" rank)."""
    counted = [r["flips"] for r in everyone if r["flips"] is not None]
    return [[sum(f[i][j] for f in counted) for j in (0, 1)]
            for i in range(len(counted[0]))]


# --- paper_full: the paper's 1000-rank, 1B-vertex, 5B-edge graph -----------------

PAPER_FULL_PAIR_CAPACITY = 1308   # --dry-run's for paper_1b_5b (the CPU's
                                  # and an H100's plans agree: 8E / min s)
PAPER_FULL_CPU_VPP = 40           # --cpu: the 1000 ranks, few vertices
PAPER_FULL_HOST_BYTES_PER_EDGE = 40   # the host-driven stream's peak host
                                      # memory per requested edge (its (P,
                                      # E) tags, ranks, pools, v, the sort's
                                      # int64 order and the sorted u, v)
PAPER_FULL_GROUP_TIMEOUT_S = 1200     # rank 0's reference runs first


def paper_full_spec(api, cpu: bool):
    """The case's spec: preset paper_1b_5b, memory sink, pair capacity
    pinned (--cpu: vertices_per_proc cut, the CPU plan's capacity)."""
    spec = api.preset("paper_1b_5b", sink="memory",
                      pair_capacity=PAPER_FULL_PAIR_CAPACITY)
    if cpu:
        spec = spec.replace(vertices_per_proc=PAPER_FULL_CPU_VPP,
                            pair_capacity=None)
        spec = spec.replace(pair_capacity=api.plan(
            spec, device="cpu").pair_capacity)
    return spec


def _mem_available() -> int:
    """The host's available memory in bytes (/proc/meminfo), or -1."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return -1


def _peak_rss() -> int:
    """This process's peak resident set, bytes."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def paper_full_reference(torch, np, api, spec, world: int, device) -> dict:
    """Rank 0, before the group exists: each rank's expected digest, from
    the one-device host-driven stream (PBAStream) of ``spec``: the stream's
    edges whose u falls in rank d's vertex range, in the stream's order.
    Within a block the edges run in (proc, slot) order, so u is sorted
    and each rank's share of a block is one slice. Returns the digests,
    or why the host or the card could not hold the stream."""
    import hashlib
    from repro_torch.core.stream import PBAStream
    pl = api.plan(spec.replace(topology=api.Topology.host()), device=device)
    need = PAPER_FULL_HOST_BYTES_PER_EDGE * pl.requested_edges
    out = {"executor": pl.executor, "host_bytes_needed_estimate": need,
           "host_bytes_available": _mem_available()}
    if 0 <= out["host_bytes_available"] < need:
        out.update(held=False, reason="the host's available memory is "
                   "below the host-driven stream's estimated peak",
                   peak_rss_bytes=_peak_rss())
        return out
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        stream = PBAStream(pl.config, pl.table,
                           auto_capacity=spec.auto_capacity, device=device)
    except (torch.cuda.OutOfMemoryError, MemoryError) as e:
        out.update(held=False, reason=f"{type(e).__name__}: {e}"[:400],
                   peak_rss_bytes=_peak_rss(),
                   peak_device_bytes=torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else None,
                   wall_s=time.perf_counter() - t0)
        return out
    setup = time.perf_counter() - t0
    span = (pl.num_procs // world) * spec.vertices_per_proc
    hashes = [hashlib.sha256() for _ in range(world)]
    kept = 0
    for part in (0, 1):
        for i in range(stream.num_blocks):
            u, v = stream.block(i)
            kept += u.size if part == 0 else 0
            cuts = np.searchsorted(u, np.arange(1, world) * span)
            for d, piece in enumerate(np.split((u, v)[part], cuts)):
                hashes[d].update(np.ascontiguousarray(
                    piece, dtype="<i4").tobytes())
    out.update(held=True, digests=[h.hexdigest() for h in hashes],
               emitted_edges=int(kept), rounds=stream.num_blocks,
               setup_s=setup, wall_s=time.perf_counter() - t0,
               peak_rss_bytes=_peak_rss(),
               peak_device_bytes=torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else None)
    del stream
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def paper_full(torch, np, api, chip_smoke, edge_digest, args, rank: int,
               world: int, device, backend: str) -> int:
    """The paper_full case (module docstring); returns the exit code."""
    import gc
    import torch.distributed as dist
    from repro_torch.launch import generate
    gpu = device.type == "cuda"
    spec = paper_full_spec(api, args.cpu)
    ref = None
    if rank == 0:
        ref = paper_full_reference(torch, np, api, spec, world, device)
        gc.collect()
    timeout = datetime.timedelta(seconds=PAPER_FULL_GROUP_TIMEOUT_S)
    if gpu:
        dist.init_process_group(backend, device_id=device, timeout=timeout)
    else:
        dist.init_process_group(backend, timeout=timeout)
    objs = [ref]
    dist.broadcast_object_list(objs, src=0)
    ref = objs[0]

    def gathered(obj):
        got = [None] * world
        dist.all_gather_object(got, obj)
        return got

    def say(obj):
        if rank == 0:
            print(json.dumps({"phase": "distributed_cards",
                              "case": "paper_full", **obj}), flush=True)

    run_dev = None if gpu else device
    say({"reading": "setup", "world_size": world, "backend": backend,
         "spec": {"preset": "paper_1b_5b", "procs": spec.procs,
                  "vertices_per_proc": spec.vertices_per_proc,
                  "edges_per_vertex": spec.edges_per_vertex,
                  "exchange_rounds": spec.exchange_rounds,
                  "seed": spec.seed, "pair_capacity": spec.pair_capacity,
                  "sink": spec.sink},
         "reduced": "vertices_per_proc 1,000,000 -> %d" % PAPER_FULL_CPU_VPP
         if args.cpu else None,
         "device": torch.cuda.get_device_name(device) if gpu else "cpu",
         "nvidia_smi": subprocess.run(
             ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"], capture_output=True, text=True,
             check=True, timeout=60).stdout.strip().splitlines()
         if gpu else None})
    say({"reading": "reference", **{k: v for k, v in ref.items()
                                    if k != "digests"}})
    ok = True
    digests = {}
    for label, topo in (("flat", api.Topology.flat(world)),
                        ("pods", api.Topology.pods(2, world // 2))):
        runs = []
        for attempt in ("cold", "warm"):
            res = None
            gc.collect()
            if gpu:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            res, wall = generate.run_spec(spec.replace(topology=topo),
                                          device=run_dev)
            runs.append({"wall_s": wall,
                         "peak_device_bytes":
                         torch.cuda.max_memory_allocated(device)
                         if gpu else None,
                         "peak_rss_bytes": _peak_rss()})
        kept = torch.tensor([res.edges.src.numel()], dtype=torch.int64,
                            device=res.edges.src.device)
        dist.all_reduce(kept)
        mine = {"digest": edge_digest(res.edges.src, res.edges.dst),
                "stats": res.stats.__dict__, "kept_sum": int(kept),
                "kept_sum_dtype": str(kept.dtype), "runs": runs,
                "lp": res.plan.lp, "executor": res.plan.executor}
        summary = None
        if label == "flat":
            t0 = time.perf_counter()
            gamma, top = generate.degree_summary(res, kmin=5)
            summary = {"gamma_mle": gamma, "max_degree": top,
                       "wall_s": time.perf_counter() - t0}
        del res, kept
        everyone = gathered(mine)
        digests[label] = [g["digest"] for g in everyone]
        st = everyone[0]["stats"]
        requested = st["requested_edges"]
        checks = {
            "dropped_edges_0": all(g["stats"]["dropped_edges"] == 0
                                   for g in everyone),
            "stats_equal_on_every_rank": all(g["stats"] == st
                                             for g in everyone),
            "kept_sum_int64_equals_requested_on_every_rank": all(
                g["kept_sum"] == requested == g["stats"]["emitted_edges"]
                and g["kept_sum_dtype"] == "torch.int64" for g in everyone),
            "requested_edges": requested}
        if ref["held"]:
            checks["matches_one_device_stream"] = [
                g == w for g, w in zip(digests[label], ref["digests"])]
        good = checks["dropped_edges_0"] and \
            checks["stats_equal_on_every_rank"] and \
            checks["kept_sum_int64_equals_requested_on_every_rank"] and \
            all(checks.get("matches_one_device_stream", [True])) and \
            st["fallback_counts"] == {}
        if label == "pods":
            checks["flat_equals_pods_rank_by_rank"] = [
                a == b for a, b in zip(digests["flat"], digests["pods"])]
            good = good and all(checks["flat_equals_pods_rank_by_rank"])
        ok = ok and good
        walls = [[r["wall_s"] for r in g["runs"]] for g in everyone]
        say({"reading": "run", "topology": topo.label,
             "executor": mine["executor"], "lp": mine["lp"],
             "exchange_rounds": st["exchange_rounds"],
             "pair_capacity": st["pair_capacity"], **checks,
             "walls_s_rank0_cold_warm": walls[0],
             "ok": good})
        say({"reading": "wall_s", "topology": topo.label,
             "cold": walls[0][0], "warm": walls[0][1]})
        say({"reading": "edges_per_s", "topology": topo.label,
             "cold": requested / walls[0][0],
             "warm": requested / walls[0][1]})
        say({"reading": "rounds", "topology": topo.label,
             "exchange_rounds": st["exchange_rounds"]})
        say({"reading": "peak_device_bytes_per_card",
             "topology": topo.label,
             "by_rank": [max(r["peak_device_bytes"] or 0
                             for r in g["runs"]) for g in everyone]})
        say({"reading": "peak_host_rss_bytes_per_rank",
             "topology": topo.label,
             "by_rank": [g["runs"][-1]["peak_rss_bytes"]
                         for g in everyone]})
        if summary is not None:
            say({"reading": "gamma_mle_kmin_5", "value":
                 summary["gamma_mle"]})
            say({"reading": "max_degree", "value": summary["max_degree"],
                 "degree_summary_wall_s": summary["wall_s"]})

    # rank 0's idle share: one more run on flat, profiled there
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()
    pl = api.plan(spec.replace(topology=api.Topology.flat(world)),
                  device=run_dev)
    dist.barrier()
    if rank == 0 and gpu:
        idle = device_idle_share(torch, chip_smoke,
                                 lambda: api.generate(pl))
    else:
        api.generate(pl)
        idle = None
    dist.barrier()
    say({"reading": "device_idle_share_rank0", **(idle or {})})
    verdict = [ok]
    dist.broadcast_object_list(verdict, src=0)
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"ok": bool(verdict[0]), "world_size": world,
                          "backend": backend}), flush=True)
    return 0 if verdict[0] else 1


def shard_sink_case(api, storage, edge_digest, hub, ref, rank, world, gpu,
                    device, gathered) -> bool:
    """The shard sink: rank 0 gathers and writes; read back there."""
    import torch.distributed as dist
    out_dir = tempfile.mkdtemp(prefix="torch_dist_shards_") \
        if rank == 0 else None
    objs = [out_dir]
    dist.broadcast_object_list(objs, src=0)
    out_dir = objs[0]
    dist.barrier()
    t0 = time.perf_counter()
    sres = api.generate(hub.replace(topology=api.Topology.flat(world),
                                    sink="shards", out_dir=out_dir),
                        device=None if gpu else device)
    wall = time.perf_counter() - t0
    manifests = gathered(sres.manifest)
    if rank == 0:
        src, dst, _ = storage.read_shards(out_dir)
        got = edge_digest(src, dst)
        good = got == ref["shard_sink"] and \
            all(m == manifests[0] for m in manifests)
        print(json.dumps({"phase": "distributed_cards",
                          "case": "shard_sink", "world_size": world,
                          "num_shards": sres.manifest["num_shards"],
                          "wall_s": wall, "read_back_matches":
                          got == ref["shard_sink"], "ok": good}),
              flush=True)
        return good
    return True


if __name__ == "__main__":
    sys.exit(main())
