#!/usr/bin/env python3
"""Run the PyTorch port's multi-device paths on N processes and hold each
rank's edges to the one-device paths.

    torchrun --nproc_per_node=4 scripts/torch_distributed_check.py        # N GPUs, NCCL
    torchrun --nproc_per_node=4 scripts/torch_distributed_check.py --cpu  # gloo, small sizes

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
  dp_sync             the training path's int8 data-parallel gradient
      sync (repro_torch.train.compress.dp_sync) on a gradient tree of
      qwen1.5-0.5b's full-width shapes (463,987,712 float32 values per
      rank, drawn per rank from a seeded generator), two steps, the
      second carrying the first's error buffers; every rank's mean and
      error buffers must equal, bit for bit, the EF-int8 arithmetic done
      by every rank alone on all ranks' gradients, and the mean lie
      within one quantization step of the exact mean. ``--only dp_sync``
      runs this case alone.

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
    ap.add_argument("--only", choices=("dp_sync",), default=None,
                    help="run this case alone")
    args = ap.parse_args()
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
    hub = api.preset("hub_stress", execution="streamed")
    specs = {"pba": pba, "pk": pk, "rmat": rmat, "hub": hub}
    gpu = device.type == "cuda"

    t0 = time.perf_counter()
    graphs = args.only is None
    ref = references(torch, np, api, edge_digest, specs, world, device) \
        if rank == 0 and graphs else None
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
                calls = chip_smoke.host_op_calls(
                    torch, lambda: api.generate(
                        spec, device=None if gpu else device),
                    (chip_smoke.A2A_OP,))[chip_smoke.A2A_OP]
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

    # The training path's DP gradient sync.
    mine = dp_sync_case(torch, rank, world, device, gpu, args.repeats,
                        args.cpu)
    everyone = gathered(mine)
    if rank == 0:
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
