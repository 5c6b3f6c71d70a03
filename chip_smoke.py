#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line (any failure raises, exit code != 0):

 1. toolchain: nvidia-smi's name and power limit, nvcc and torch versions;
    build every CUDA kernel from kernels/csrc/ (one nvcc per source, all
    started together) and report the build seconds.
 2. kernels: each kernel wrapper against its plain PyTorch version on the
    card, at the main paths' shapes, on inputs drawn from
    numpy.random.default_rng(SEED) (the PK noise inputs from a torch
    generator seeded with SEED; resolve_roots on the main path's own
    phase-1 urns and phase-2 pools, beside the doubling passes it
    replaced); exact equality is required (integer kernels, tolerance
    0). The gathers run both at uniform indices and at the PBA main path's
    own grant and receive indices (rounds 0 and 5, built by the port's
    pba functions); band_compact at uniform bands and at every round of
    the device stream, on the (u, v, band) that pba.round_compact_inputs
    builds for it, with the sum over the rounds (what one streamed run
    pays); histogram at uniform values (64 and 70,000 bins), on phase 1's
    tags and on every round's census (pba.round_census: the tags counted
    where the round's band is set, beside the torch.where(band, a, -1)
    plus unmasked count it replaced), with the per-run sum of phase 1 and
    the censuses; the path cases of round 0 (histogram: phase 1) are the
    kernels line's headline cases. The PK and ba_cfree slabs add the wall
    per call of back-to-back calls (the wrapper's host work plus the
    launch, which bound the streams' per-slab loop).
    Kernel, plain and library-call times are CUDA event medians of 7
    runs after 2 warm-ups (the plain versions over 2^30 edges: their one
    comparison run; resolve_roots: each run on a fresh copy of the urn,
    the plain version and the replaced design 3 runs); the PK and
    communication-free cases and histogram's path cases add the kernel's
    profiled device time per launch, which leaves out the host's launch
    overhead. Bounds: bytes over the memory rate, or
    32-bit integer operations over the INT32 rate, the larger.
 3. reference digests: generate() on the card for the specs in
    src/repro_torch/reference_digests.json (made by the JAX package: PBA
    with host execution, the device stream and the host-driven stream;
    PK, rmat, er and ba_cfree with host execution and their streams) must
    reproduce their sha256; on the card's edges of each host-execution
    case, every analytics function (analytics_record) must give the JAX
    package's results in src/repro_torch/reference_analytics.json
    (exactly; the degree assortativity to rel 1e-9, abs 1e-12), and
    degree_counts_device on the histogram kernel must equal degree_counts;
    serial_ba_reference(4000, 4, seed=0) must give the file's digest.
 4. host main path: generate(preset("paper_1b_5b", procs=64,
    execution="host", pair_capacity=262144)), the paper's per-rank scale
    (1M vertices x k=5 per rank, R=8) with procs cut from 1000 to 64 to
    fit one card; zero dropped edges, no kernel fallbacks, every kernel of
    the path launched; then the same spec under forced_mode("ref") must
    give identical edges; histogram at degree counting's shape on this
    run's edges (both endpoints into num_vertices + 1 bins, as the JAX
    package's core/analysis.py::degree_counts_device builds it) and at
    as many uniform values (device-memory atomics saturated); the
    analytics step on its graph, with the launch counts set to 0 just
    before it and read just after: degree_counts_device on the histogram
    kernel (exactly 1 launch, equal to degree_counts), fit_power_law
    (kmin 5, gamma_mle in (1.5, 3.5)), sampled_path_stats (16 sources),
    community_contrast (16 blocks), sampled_clustering_coefficient (200
    samples), degree_assortativity and rich_club_coefficient (k = 10),
    each with its value, wall and peak device memory, then profiles of
    to_csr and of one BFS; self_similarity_score (n0 = 5) on PK at L=9
    (pk_3b cut to L=9: its L=10 edges and their int64 block ids would not
    fit beside each other); histogram at the block densities' cells
    (community_contrast's B = 16 on this graph, B = 5 and 25 on PK L=9)
    held to its plain version and to torch.bincount; then 4 + 4 timed
    runs of the kernel and plain paths in turns, a per-stage timing run
    and a profiled run.
 5. streamed main path: the same preset at its own execution="streamed"
    on Topology.flat(1) (the device stream), same single cut: into memory
    (every kernel launched, band_compact once per block); under
    forced_mode("ref") (identical edges); parity mode (auto_capacity=False:
    the host path's edge multiset); the host-driven stream (the device
    stream's digest); a profiled run; and the shard sink at reduced depth
    (procs 64 -> 8: zlib's rate) with overlap on, read back, then resumed
    after two blocks are dropped from the manifest (only those two shards
    rewritten; both reads equal to the 8-proc spec's in-memory digest),
    then with overlap off.
 6. PK and the communication-free family, each path with its launch
    counts set to 0 just before it and read just after, then rerun under
    forced_mode("ref") and compared on the card, then profiled: R-MAT
    and ER at Graph500 scale 26, edge factor 16 (2^26 vertices, 2^30
    edges), host execution; preset("pk_3b") at the repo's size
    (star-clique-5 seed, L=10, 3,486,784,401 edges, slab 2^20) streamed
    into memory; the noise path, preset("pk_3b", levels=9,
    execution="host", noise=0.05, delete_prob=0.01); preset("ba_cfree_1b")
    (10^9 edges) on both stream executors (Topology.host() and flat(1),
    which must agree; then 9 timed runs of each); and the shard sink at reduced depth (pk_3b at L=7,
    ba_cfree at 2M vertices: zlib writes ~10 MB/s) with a two-shard resume.
 7. distributed: the torch.distributed code path through a world-size-1
    NCCL group over the card (file:// rendezvous in a temp dir,
    device_id the card; the runs pass no device, so each takes the
    rank's): the 64-rank paper_1b_5b cut with execution="sharded" on
    flat(1) and on pods(1, 1) (the two-hop transpose over size-1
    subgroups), both equal to phase 4's host-path digest; the same preset
    streamed on flat(1), equal to phase 5's device-stream digest; PK at
    L=9 and R-MAT at scale 26 sharded, equal to their host digests (run
    here); the shard sink at reduced depth (preset hub_stress on flat(1):
    rank 0 gathers and writes each block), read back and resumed. Each
    run has its launch counts set to 0 just before it and read just
    after, then a profiled run (the card's idle share) and a run with its
    host ops traced, which must show c10d::alltoall_base_ once for
    exchange 1 plus once per exchange round (twice that on pods(1, 1);
    none for PK and R-MAT); each prints its wall, peak device memory (and
    its excess over phase 4's) and idle share. The sharded analytics
    (degree_counts_sharded, edge_count_sharded, max_degree_sharded) of a
    flat(1) run must equal phase 4's degree counts, the run's emitted
    edges and their max. The group is destroyed at the end of the phase.
 8. lm_serve: the LM serving path (repro_torch.configs / models / serve)
    of all ten configs, which launches none of the port's kernels (their
    counts must stay 0). Every case of src/repro_torch/reference_lm.json
    (made by the JAX package on the CPU in float32: each config's
    reduced(), and each at its published widths with its depth cut
    (LM_FULL_LAYERS), params from lm_reference_params: numpy_params at
    seed 0, each stacked matrix rescaled to one layer's fan-in) runs on
    the card in float32: the Engine's
    completions token for token (not the encoder-decoder: its Engine
    passes tokens only), and the last-position logits of a prefill (with
    frames for the encoder-decoder) and three decode steps within rtol
    1e-3, atol 1e-3 (at the file's top-8 ids, their sum, the top-1 id
    where its margin is clear); the MoE cases print the card's least
    router margin beside the file's. qwen1.5-0.5b at full config (24
    layers, float32, launch/serve.py's workload) on the card against the
    port on the host's CPU, same tolerance. Then the serving runs at full
    width in bf16, weights from the port's seeded init on the card (the
    six other configs' stacked leaves at one layer's fan-in), each
    a prefill of 8 x 512 tokens and its decode steps teacher-forced (each
    step's logits within relative L2 2^-2 of the teacher-forced pass at
    the same position, and at most 0.85 of their distance to it one
    position on; for MoE only where neither the prefill nor the
    teacher-forced pass dropped an assignment, the counts printed; not for
    mamba2-130m, whose bf16 SSD is not faithful to its float32 one by the
    reference's design), with its wall, peak device memory and a profiled
    run's device idle share:
    qwen1.5-0.5b (count_params 463,987,712) and phi3-medium-14b at 128 new
    tokens, each then the same contract in float32 at full width (batch
    2, 64-token prompt, 16 steps, rtol = atol = 2e-3 per logit);
    llama4-scout and qwen3-moe (8 layers), minicpm3-4b, mamba2-130m,
    recurrentgemma-2b and whisper-medium (1500 frames, its encoder also
    timed apart) at 32; and the Engine on 16 requests over 8 slots for
    qwen and the new configs but whisper. minicpm3, recurrentgemma and
    whisper also run the same weights in float32: the bf16 prefill and
    decode steps, and the bf16 teacher-forced pass, within relative L2
    2^-2 of the float32 ones and nearer them than the float32 logits one
    position on (at most 0.85 of that reading, as the bf16 teacher gap
    also is), then the float32 contract above (mamba2 too, its bf16
    readings printed).
 9. lm_train: the LM training path (repro_torch.train, launch/train.py).
    The walk corpus (launch/train.py's: PBA, 8192 vertices, 8 logical
    procs, k = 8) generated on the card with its launch counts set to 0
    just before and read just after: resolve_roots, gather and histogram
    launched, no fallback. Every case of
    src/repro_torch/reference_train.json (made by the JAX package on the
    CPU in float32: each config's reduced() and qwen1.5-0.5b at its
    published widths with 2 layers, params from lm_reference_params, three
    AdamW steps on the corpus's batches) runs on the card in float32 (TF32
    off): the corpus digest equal, step 1's loss and grad norm within rtol
    1e-4, steps 2-3 within TRAIN_LATER_RTOL, three parameter checksums
    within 1e-3; the MoE cases print the card's least router margin beside
    the file's. Then the training cell at full width: qwen1.5-0.5b (24
    layers, 463,987,712 parameters), float32 masters, bf16 compute, remat
    "nothing", 8 x 512 tokens per step from the card's corpus, 10 steps
    timed one by one (ms/step, tokens/s, peak device memory, the model
    FLOPs' share of the bf16 peak), then a profiled step (the card's idle
    share, device ops per step); gates: the loss descends and every loss
    and grad norm is finite, accum=2 gives step 1's loss and grad norm
    within TRAIN_ACCUM_RTOL of accum=1, bf16 against float32 on step 1's
    weights and batch (the loss, the grad norm and every leaf's gradient,
    each within its TRAIN_BF16_* bound and each control past it), and
    the trained state's checkpoint (~5.6 GB: parameters, m and v in
    float32) saves and loads back bit for bit (seconds and bytes printed;
    deleted after). Last, restart-exactness at reduced() for qwen1.5-0.5b
    and qwen3-moe (2 steps, a checkpoint, a fresh model, optimizer and
    corpus restored from it, 2 more steps, against 4 straight), bit for
    bit under torch.use_deterministic_algorithms.
10. the seconds from the start to each phase's end; the kernels line
    (with each kernel's launches in the distributed runs and in the
    training corpus's build; histogram's also in the analytics runs), then
    {"ok": true, "device": {...}} as the last line.

Exits with a non-zero code and prints no result when CUDA is not
available or the repository's src/ is not beside this file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# 32-bit integer instructions per second: 132 SMs x 128 lanes x 1.98 GHz
# boost clock (H100 SXM data sheet; the rate behind its 67 TFLOP/s float32,
# which counts a multiply-add as two). Each SM's four schedulers issue at
# most one instruction per lane per clock, so no mix of integer
# instructions (the 64 INT32 lanes per SM plus the multiply-adds on the
# float pipes) runs faster. The operation bound of the PK and
# communication-free kernels is their integer work over this rate.
INT32_OPS_PER_S = 132 * 128 * 1.98e9
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor cores (data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
PROCS = 64                  # the paper's 1000 ranks, cut to fit one card
VERTICES_PER_PROC = 1_000_000   # the paper's per-rank scale, not cut
PAIR_CAPACITY = 262144      # pinned: C_r = 32768 per pair at R=8
BLOCK_CAP = 2_097_152       # min(E, P * C_r): a streamed round's block
# The procs of the PBA shard sink's writes (overlap on, its resume, overlap
# off): np.savez_compressed writes 4-10 MB/s, so a write of the 64-rank
# cut's 1.39 GB takes 130-180 s of the script's 1200 s.
SHARD_SINK_PROCS = 8
SEED = 0                    # numpy seed of the kernel-case inputs
M32 = 0xFFFFFFFF


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 2


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[0].strip() if lines else out.strip().splitlines()[-1]


# --- timing -------------------------------------------------------------------

def profiled(torch, fn, calls: int):
    """torch.profiler's trace of the card over ``calls`` back-to-back calls
    of fn() (warm fn up first), and the wall seconds per call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls
    return prof, wall


def device_us(e, calls: int = 1) -> float:
    """An event's (or an average's) own device time in us, per call."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0)) / calls


def device_ms_per_launch(torch, fn, kernel: str, launches: int = 20,
                         attempts: int = 3) -> tuple[float, int]:
    """Mean device time of the ``kernel`` (a substring of the CUDA kernel's
    name) per launch over ``launches`` back-to-back calls of fn() after a
    warm-up call, and the launches the profiler saw. Unlike CUDA events
    around a call, it leaves out the host's launch overhead, which
    dominates a kernel of a few microseconds. The profiler now and then
    records no device event at all; such a trace is taken again, up to
    ``attempts`` traces."""
    fn()
    for _ in range(attempts):
        prof, _ = profiled(torch, fn, launches)
        rows = [e for e in prof.key_averages() if kernel in e.key]
        calls = sum(e.count for e in rows)
        if calls:
            return sum(device_us(e) for e in rows) / 1e3 / calls, calls
    raise AssertionError(f"the profiler saw no launch of {kernel} in "
                         f"{attempts} traces")


def back_to_back_ms(torch, fn, calls: int = 200) -> float:
    """Wall ms per call of ``calls`` back-to-back calls of fn() (after a
    warm-up call), to the card's finish. For a kernel of a few
    microseconds it is the host's cost per call: the wrapper's work and
    the launch, which a stream pays once per slab."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def time_ms(torch, fn, reps: int = 7, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_diff(torch, got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_diff(torch, g, w) for g, w in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    if torch.equal(got, want):
        return 0
    g, w = got.reshape(-1), want.reshape(-1)
    step = 1 << 26
    return max(int((g[i:i + step].long() - w[i:i + step].long())
                   .abs().max()) for i in range(0, g.numel(), step))


# --- phase 2: kernels against their plain versions ------------------------------

def run_case(torch, results, name, wrapper, plain, library, args, nbytes,
             shape, ops: int = 0, plain_reps: int = 7,
             device_kernel: str = "", back_to_back: bool = False) -> dict:
    """Hold one kernel call against its plain version (exact equality) and
    time both, and the library call where there is one. ``bound_ms`` is
    the larger of the byte bound (``nbytes`` over the memory rate) and
    the operation bound (``ops`` 32-bit integer operations over the INT32
    rate). ``plain_reps=1`` times the comparison run of the plain version
    itself (the plain versions of the largest shapes take seconds).
    ``device_kernel`` adds the kernel's profiled device time per launch
    (``kernel_device_ms``), ``back_to_back`` the wall per call of
    back-to-back calls (``back_to_back_ms``)."""
    got = wrapper(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*args)
    end.record()
    end.synchronize()
    plain_once_ms = start.elapsed_time(end)
    diff = max_abs_diff(torch, got, want)
    del got, want
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    row = {"case": name, "kernel": wrapper.__name__, "shape": shape,
           "max_abs_diff": diff,
           "kernel_ms": time_ms(torch, lambda: wrapper(*args)),
           "plain_ms": plain_once_ms if plain_reps == 1 else
           time_ms(torch, lambda: plain(*args), reps=plain_reps),
           "library_ms": time_ms(torch, library) if library else None,
           "bytes": nbytes, "int_ops": ops, "bytes_bound_ms": bytes_ms,
           "ops_bound_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}
    if device_kernel:
        row["kernel_device_ms"], row["profiled_launches"] = \
            device_ms_per_launch(torch, lambda: wrapper(*args),
                                 device_kernel)
    if back_to_back:
        row["back_to_back_ms"] = back_to_back_ms(torch,
                                                 lambda: wrapper(*args))
    results.append(row)
    emit({"phase": "kernel_case", **row})
    if diff:
        raise AssertionError(f"{name}: kernel differs from plain "
                             f"(max abs diff {diff})")
    torch.cuda.empty_cache()
    return row


def draw_ints(torch, np, gen, dev, rows: int, n: int, high):
    """(rows, n) int32 uniform in [0, high) from the numpy generator's
    words (``high`` an int or a tensor broadcast against a row)."""
    out = torch.empty((rows, n), dtype=torch.int32, device=dev)
    for r in range(rows):
        w = gen.integers(0, 2**32, n, dtype=np.uint32).view(np.int32)
        out[r] = ((torch.from_numpy(w).to(dev).long() & M32)
                  % high).to(torch.int32)
    return out


def gather_bytes(torch, idx, rows: int, m: int) -> int:
    """Bytes a gather of ``rows`` sources of ``m`` entries must move: idx
    read and out written once each, and each distinct source entry that
    this idx touches read once."""
    flat = idx.reshape(rows, -1).clamp(0, m - 1).long()
    flat += torch.arange(rows, device=idx.device)[:, None] * m
    seen = torch.zeros(rows * m, dtype=torch.bool, device=idx.device)
    seen[flat.view(-1)] = True
    return 4 * (2 * idx.numel() + int(seen.sum()))


GATHER_PATH_ROUNDS = (0, 5)     # the first round and a middle one


def pba_path_setup(torch, pl) -> dict:
    """The PBA main path's setup for the plan ``pl``, built once by the
    port's own pba_stream_setup_block and shared by the gather and
    band_compact path cases: the ranks and (a, occ, recv_counts)."""
    from repro_torch.core import pba
    from repro_torch.runtime.topology import Topology

    table, dev = pl.table, pl.device
    p = table.num_procs
    ranks = torch.arange(p, dtype=torch.int32, device=dev)
    a, occ, recv_counts = pba.pba_stream_setup_block(
        ranks, torch.from_numpy(table.procs).to(dev),
        torch.from_numpy(table.s).to(dev), pl.config, p, Topology.host())
    return {"ranks": ranks, "a": a, "occ": occ, "recv_counts": recv_counts}


def gather_cases(torch, np, pl, seed: int, setup: dict) -> list[dict]:
    """gather and gather_chunked against their plain version, with
    torch.gather (torch.take for the 1-D form) as the library call.

    Uniform cases: indices drawn uniform (a few past both ends) at the
    main path's shapes. Path cases: the indices the PBA main path itself
    gathers with, for the plan ``pl``, built by the port's own functions:
    ``setup`` (:func:`pba_path_setup`), _phase2_pool's pools, and for
    each round of GATHER_PATH_ROUNDS the grant lookup (pba.grant_indices,
    into the pools: gather_chunked) and the receive lookup
    (pba.receive_indices, into that round's grants transposed by
    blocking.transpose_payload: gather). The headline cases of the
    kernels line are the path cases of round 0."""
    from repro_torch.core import pba
    from repro_torch.kernels import edge_resolve, ref
    from repro_torch.runtime import blocking
    from repro_torch.runtime.topology import Topology

    cfg, table, dev = pl.config, pl.table, pl.device
    p = table.num_procs
    e_local = cfg.edges_per_proc
    t_cap = cfg.total_capacity_factor * e_local
    pool_n = e_local + t_cap
    c_r = pl.round_capacity
    recv_n = p * c_r                 # one round's (P, C_r) buffer per rank
    gen = np.random.default_rng(seed)
    results = []

    def draw(rows, n, high):
        return draw_ints(torch, np, gen, dev, rows, n, high)

    def poke(idx, m):
        """A few indices past both ends exercise the clip contract."""
        flat = idx.view(-1)
        flat[:4] = torch.tensor([-1, -7, m, m + 100], dtype=torch.int32,
                                device=dev)

    def run(name, wrapper, src, idx, library, shape):
        return run_case(torch, results, name, wrapper, ref.gather_ref,
                        library, (src, idx),
                        gather_bytes(torch, idx, src.shape[0], src.shape[-1]),
                        shape)

    # Grants: each rank's pool (P, E + t_cap) gathered at one round's
    # (P, P*C_r) slots -- the port's batched form of the grant lookup.
    src = draw(p, pool_n, 2**31)
    gidx = draw(p, recv_n, pool_n)
    poke(gidx, pool_n)
    g64 = gidx.clamp(0, pool_n - 1).long()
    run(f"gather_chunked rows {p}x{pool_n} <- {p}x{recv_n}",
        edge_resolve.gather_chunked, src, gidx,
        lambda: torch.gather(src, 1, g64), [p, pool_n, recv_n])
    del g64

    # The 1-D form: one shared source, indices of any rank.
    src1 = src[0].contiguous()
    idx3 = gidx.view(p, p, c_r)
    i64 = idx3.reshape(-1).clamp(0, pool_n - 1).long()
    run_case(torch, results, f"gather 1-D {pool_n} <- {p}x{p}x{c_r}",
             edge_resolve.gather,
             lambda s, i: ref.gather_ref(s, i.reshape(-1)).reshape(i.shape),
             lambda: torch.take(src1, i64), (src1, idx3),
             gather_bytes(torch, idx3, 1, pool_n), [pool_n, p, p, c_r])
    del src, src1, idx3, i64, gidx
    torch.cuda.empty_cache()

    # Receives: each rank's (P*C_r) received buffer at its E edges.
    rsrc = draw(p, recv_n, 2**31)
    ridx = draw(p, e_local, recv_n)
    poke(ridx, recv_n)
    r64 = ridx.clamp(0, recv_n - 1).long()
    run(f"gather rows {p}x{recv_n} <- {p}x{e_local}", edge_resolve.gather,
        rsrc, ridx, lambda: torch.gather(rsrc, 1, r64), [p, recv_n, e_local])
    del rsrc, ridx, r64
    torch.cuda.empty_cache()

    # The main path's own indices.
    ranks, a, occ, recv_counts = (setup[k] for k in (
        "ranks", "a", "occ", "recv_counts"))
    topo = Topology.host()
    pool = pba._phase2_pool(ranks, cfg)
    for r in GATHER_PATH_ROUNDS:
        gidx, valid = pba.grant_indices(recv_counts, r, c_r, e_local, t_cap)
        gidx = gidx.reshape(p, recv_n)
        g64 = gidx.long()
        row = run(f"gather_chunked path grants r{r} {p}x{pool_n} <- "
                  f"{p}x{recv_n}", edge_resolve.gather_chunked, pool, gidx,
                  lambda: torch.gather(pool, 1, g64), [p, pool_n, recv_n])
        row["granted"] = int(valid.sum())
        out = torch.where(valid, ref.gather_ref(pool, gidx).view(valid.shape),
                          -1)
        del gidx, g64, valid
        recv = blocking.transpose_payload(out, topo).reshape(p, recv_n)
        del out
        band, ridx = pba.receive_indices(a, occ, r, c_r)
        r64 = ridx.long()
        row = run(f"gather path receives r{r} {p}x{recv_n} <- {p}x{e_local}",
                  edge_resolve.gather, recv, ridx,
                  lambda: torch.gather(recv, 1, r64), [p, recv_n, e_local])
        row["band_entries"] = int(band.sum())
        del recv, band, ridx, r64
        torch.cuda.empty_cache()
    del a, occ, recv_counts, pool
    torch.cuda.empty_cache()
    return results


def band_bytes(band, cap: int) -> int:
    """Bytes a band compaction must move: band read once, u and v read
    where band is set and kept, both outputs written in full."""
    cap = min(cap, band.shape[1])
    kept = int(band.sum(1).clamp(max=cap).sum())
    return band.numel() + 8 * kept + 8 * band.shape[0] * cap


def touched_sectors(flags) -> int:
    """32-byte sectors of an int32 array of ``flags``'s shape that its set
    entries touch, as the card reads them (rows laid end to end, the
    array 32-byte aligned)."""
    flat = flags.reshape(-1)
    whole = flat.numel() // 8 * 8
    return int(flat[:whole].view(-1, 8).any(1).sum()) + \
        int(flat[whole:].any())


def band_sector_bytes(torch, band, cap: int) -> int:
    """The same bytes with u and v counted by the 32-byte sectors that
    the kept band entries touch."""
    cap = min(cap, band.shape[1])
    kept = band & (torch.cumsum(band, 1, dtype=torch.int32) <= cap)
    return band.numel() + 2 * 32 * touched_sectors(kept) + \
        8 * band.shape[0] * cap


def row_bincount(torch, values, num_bins: int):
    """The library call for a row-batched histogram: one torch.bincount
    over the values offset by row (out-of-range values to a spill bin of
    their row), on int64 indices built beforehand."""
    rows = values.shape[0]
    ok = (values >= 0) & (values < num_bins)
    off = torch.arange(rows, device=values.device)[:, None] * (num_bins + 1)
    flat = (torch.where(ok, values, num_bins).long() + off).reshape(-1)
    return lambda: torch.bincount(flat, minlength=rows * (num_bins + 1))


def round_path_cases(torch, pl, setup: dict) -> list[dict]:
    """The PBA main path's own inputs to histogram and band_compact,
    for plan ``pl``'s spec: phase 1's count of the tags ``a`` (``setup``,
    :func:`pba_path_setup`), then every round of the device stream, on
    what the round hands the kernels, built once per round by the port's
    own pba.round_compact_inputs from ``setup`` and the stream's pool
    (drawn at the stream's urn budget, as PBAShardedStream draws it):
    band_compact on (u, v, band) and the census pba.round_census(a, band)
    (histogram with ``mask=band``), beside the torch.where(band, a, -1)
    plus unmasked count it replaced, each timed on its own. Each round's
    rows carry the band size; the phase-1 histogram row and round 0's
    band_compact row (the kernels line's headlines) carry the per-run
    totals."""
    from repro_torch.core import pba, stream
    from repro_torch.kernels import band_compact, histogram, ref
    from repro_torch.runtime import streaming
    from repro_torch.runtime.topology import Topology

    cfg = pl.config
    p, e_local, c_r = pl.table.num_procs, cfg.edges_per_proc, \
        pl.round_capacity
    ranks, a, occ, recv_counts = (setup[k] for k in (
        "ranks", "a", "occ", "recv_counts"))
    rounds = streaming.rounds_needed(max(int(recv_counts.max()), 1), c_r)
    urn_budget = stream.stream_urn_budget(
        cfg, int(recv_counts.sum(1, dtype=torch.int64).max()), True)
    block_cap = pba.stream_block_capacity(e_local, p, c_r)
    hist, compact = [], []
    phase1 = run_case(torch, hist, f"histogram path phase1 {p}x{e_local} "
                      f"bins {p}", histogram.histogram, ref.histogram_ref,
                      row_bincount(torch, a, p), (a, p),
                      4 * (a.numel() + p * p), [p, e_local, p],
                      device_kernel="histogram")
    phase1["zeros_ms"] = time_ms(torch, lambda: torch.zeros(
        (p, p), dtype=torch.int32, device=a.device))
    pool = pba._phase2_pool(ranks, cfg, urn_budget)
    for r in range(rounds):
        u, v, band = pba.round_compact_inputs(
            r, a, occ, recv_counts, pool, ranks, cfg, p, c_r, urn_budget,
            Topology.flat(1))
        entries = int(band.sum())
        row = run_case(torch, compact,
                       f"band_compact path r{r} {p}x{e_local} cap "
                       f"{block_cap}", band_compact.band_compact,
                       ref.band_compact_ref, None, (u, v, band, block_cap),
                       band_bytes(band, block_cap), [p, e_local, block_cap])
        sector_bytes = band_sector_bytes(torch, band, block_cap)
        row.update(round=r, band_entries=entries,
                   band_share=entries / band.numel(),
                   sector_bytes=sector_bytes, computed_sector_floor_ms=(
                       sector_bytes / HBM_BYTES_PER_S * 1e3))
        del u, v
        torch.cuda.empty_cache()
        # The census. The library call counts the where's output.
        where = torch.where(band, a, -1)
        row = run_case(torch, hist, f"histogram census r{r} {p}x{e_local} "
                       f"bins {p}", histogram.histogram, ref.histogram_ref,
                       row_bincount(torch, where, p), (a, p, band),
                       band.numel() + 4 * entries + 4 * p * p,
                       [p, e_local, p], device_kernel="histogram")
        # The mask once, the tags by the sectors the band touches.
        sector_bytes = band.numel() + 32 * touched_sectors(band) + 4 * p * p
        row.update(
            round=r, band_entries=entries, band_share=entries / band.numel(),
            where_ms=time_ms(torch, lambda: torch.where(band, a, -1)),
            unmasked_kernel_ms=time_ms(
                torch, lambda: histogram.histogram(where, p)),
            sector_bytes=sector_bytes,
            computed_sector_floor_ms=sector_bytes / HBM_BYTES_PER_S * 1e3)
        row["where_plus_unmasked_ms"] = row["where_ms"] + \
            row["unmasked_kernel_ms"]
        del band, where
        torch.cuda.empty_cache()
    del pool
    torch.cuda.empty_cache()
    per_run = {"rounds": rounds, "urn_budget": urn_budget,
               **{k: sum(c[k] for c in compact) for k in (
                   "kernel_ms", "plain_ms", "bound_ms")}}
    compact[0]["per_run"] = per_run
    emit({"phase": "band_compact_path_run", **per_run,
          "computed_sector_floor_ms": sum(
              c["computed_sector_floor_ms"] for c in compact),
          **{f"{k}_per_round": [c[k] for c in compact] for k in (
              "band_entries", "kernel_ms", "bound_ms",
              "computed_sector_floor_ms")}})
    census = hist[1:]
    totals = {k: phase1[k] + sum(c[k] for c in census) for k in (
        "kernel_ms", "kernel_device_ms", "plain_ms", "bound_ms",
        "library_ms")}
    phase1["per_run"] = {
        **totals, "where_plus_unmasked_ms": phase1["kernel_ms"] + sum(
            c["where_plus_unmasked_ms"] for c in census)}
    emit({"phase": "histogram_path_run", "rounds": rounds,
          **phase1["per_run"], "computed_floor_ms": phase1["bound_ms"] + sum(
              c["computed_sector_floor_ms"] for c in census),
          "zeros_ms": phase1["zeros_ms"],
          "phase1_kernel_device_ms": phase1["kernel_device_ms"],
          **{f"{k}_per_round": [c[k] for c in census] for k in (
              "band_entries", "kernel_ms", "kernel_device_ms", "where_ms",
              "unmasked_kernel_ms", "bound_ms", "computed_sector_floor_ms",
              "library_ms")}})
    return hist + compact


def degree_count_cases(torch, src, dst, num_vertices: int) -> list[dict]:
    """histogram at the shape degree counting gives it (the JAX package's
    core/analysis.py::degree_counts_device, :258-270): both endpoints of
    the host path's edges, an endpoint of an invalid edge mapped to n,
    concatenated and counted into n + 1 bins (n = num_vertices); then the
    same number of values drawn uniform over those bins (torch generator
    seeded with SEED), where almost every value is an atomic into a line
    the 50 MB L2 does not hold: the rate at which device-memory atomics
    into the (n + 1)-entry counts saturate."""
    from repro_torch.kernels import histogram, ref

    n = num_vertices
    src, dst = src.reshape(-1), dst.reshape(-1)
    valid = (src >= 0) & (dst >= 0)
    both = torch.cat([torch.where(valid, src, n), torch.where(valid, dst, n)])
    del valid
    results = []
    gen = torch.Generator(device=src.device)
    gen.manual_seed(SEED)
    for label in ("degree count", "uniform"):
        if label == "uniform":
            both = torch.randint(0, n + 1, both.shape, generator=gen,
                                 dtype=torch.int32, device=src.device)
        flat = both.long()
        run_case(torch, results, f"histogram {label} {both.numel()} bins "
                 f"{n + 1}", histogram.histogram, ref.histogram_ref,
                 lambda: torch.bincount(flat, minlength=n + 1),
                 (both, n + 1), 4 * (both.numel() + n + 1),
                 [both.numel(), n + 1])
        del flat
        torch.cuda.empty_cache()
    del both
    torch.cuda.empty_cache()
    return results


def block_cell_cases(torch, analysis, edges, label: str,
                     blocks: tuple) -> list[dict]:
    """histogram at the shapes the block densities give it: the int32
    cells ``b * B + c`` of ``edges``' valid edges (analysis.block_cells,
    as block_density counts them) into B * B bins, for each B of
    ``blocks``; held to the plain version and, with torch.equal, to
    torch.bincount."""
    from repro_torch.kernels import histogram, ref

    results = []
    for nb in blocks:
        cells = analysis.block_cells(edges, nb)
        bins = nb * nb
        flat = cells.long()
        run_case(torch, results, f"histogram block cells {label} B={nb} "
                 f"{cells.numel()} bins {bins}", histogram.histogram,
                 ref.histogram_ref,
                 lambda: torch.bincount(flat, minlength=bins),
                 (cells, bins), 4 * (cells.numel() + bins),
                 [cells.numel(), bins], plain_reps=1)
        same = torch.equal(histogram.histogram(cells, bins),
                           torch.bincount(flat, minlength=bins).int())
        results[-1]["equals_bincount"] = same
        del cells, flat
        torch.cuda.empty_cache()
        if not same:
            raise AssertionError(f"{results[-1]['case']}: kernel differs "
                                 "from torch.bincount")
    return results


def kernel_cases(torch, np, dev, seed: int, procs: int, vpp: int, k: int,
                 block_cap: int) -> list[dict]:
    from repro_torch.kernels import band_compact, edge_resolve, ref

    gen = np.random.default_rng(seed)
    e_local = vpp * k
    pool_n = 3 * e_local                 # E + t_cap at total_capacity_factor 2

    def draw(rows: int, n: int, high) -> "torch.Tensor":
        return draw_ints(torch, np, gen, dev, rows, n, high)

    results = []

    def run(*args):
        run_case(torch, results, *args)

    # Downward pointers ptr[r, j] in [0, j]: the urns' pointer layout.
    ptr = draw(procs, pool_n, torch.arange(1, pool_n + 1, device=dev))
    for m in (e_local, pool_n):
        p = ptr[:, :m].contiguous()
        p64 = p.long()
        run(f"resolve_step {procs}x{m}", edge_resolve.resolve_step,
            ref.resolve_step_ref, lambda: torch.gather(p, 1, p64), (p,),
            8 * p.numel(), [procs, m])
        del p, p64
    del ptr
    torch.cuda.empty_cache()

    # Band compaction off the path (the path's own rounds are
    # round_path_cases): a uniform ~1/12 band (a round of 12), an
    # overflowing band (truncation at block_cap), and small rows that are
    # empty, all band, or narrower than block_cap.
    bu = draw(procs, e_local, 2**31)
    bv = draw(procs, e_local, 2**31)
    for label, share in (("uniform", 12), ("overflow", 2)):
        band = draw(procs, e_local, share) == 0
        run(f"band_compact {label} {procs}x{e_local} cap {block_cap}",
            band_compact.band_compact, ref.band_compact_ref, None,
            (bu, bv, band, block_cap), band_bytes(band, block_cap),
            [procs, e_local, block_cap])
        del band
    del bu, bv
    small = 1_000_000
    su, sv = draw(4, small, 2**31), draw(4, small, 2**31)
    band = draw(4, small, 12) == 0
    band[0] = False
    band[1] = True
    for cap in (600_000, block_cap):
        run(f"band_compact edges 4x{small} cap {cap}",
            band_compact.band_compact, ref.band_compact_ref, None,
            (su, sv, band, cap), band_bytes(band, cap), [4, small, cap])
    del su, sv, band
    torch.cuda.empty_cache()

    return results


def histogram_uniform_cases(torch, np, dev, seed: int, procs: int,
                            e_local: int) -> list[dict]:
    """histogram off the path (the path's own inputs are
    round_path_cases): values drawn uniform at phase 1's shape into P
    bins, and into 70,000 bins (past one block's shared memory); -1 and
    past-the-end values must be ignored."""
    from repro_torch.kernels import histogram, ref

    gen = np.random.default_rng(seed)
    results = []
    for nb in (procs, 70_000):
        vals = draw_ints(torch, np, gen, dev, procs, e_local, nb + 2) - 1
        run_case(torch, results, f"histogram uniform {procs}x{e_local} "
                 f"bins {nb}", histogram.histogram, ref.histogram_ref,
                 row_bincount(torch, vals, nb), (vals, nb),
                 4 * (vals.numel() + procs * nb), [procs, e_local, nb])
        del vals
        torch.cuda.empty_cache()
    return results


def doubling_resolve(torch, ops, ptr, terminal):
    """The urn resolve that resolve_roots replaced (the JAX package's
    resolve_pointers, and the port's earlier design): one ops.resolve_step
    pass per doubling round while any entry of any row misses a terminal
    slot, checked row by row on the host before every round. Returns
    (ptr, rounds)."""
    def all_terminal(p):
        for i in range(p.shape[0]):
            t = terminal[i] if terminal.ndim == 2 else terminal
            if not bool(t[p[i].long()].all()):
                return False
        return True

    rounds = 0
    while rounds < 64 and not all_terminal(ptr):
        ptr = ops.resolve_step(ptr)
        rounds += 1
    return ptr, rounds


def resolve_cases(torch, pl) -> list[dict]:
    """resolve_roots against its plain version on the main path's own
    urns, built by the port's _phase1_urn / _phase2_pool_urn for every
    rank of the plan: the phase-1 urns (P, E) and the phase-2 pools
    (P, E + t_cap). The kernel works in place, so every timed run starts
    from a fresh copy of the unresolved urn (the copy is not timed).
    Beside it, the design it replaced (:func:`doubling_resolve`), timed
    the same way, with its doubling rounds; its result must be the same.
    Bound: bytes, the pointer array read once and written once."""
    from repro_torch.core import pba
    from repro_torch.kernels import edge_resolve, ops, ref
    from repro_torch.runtime import blocking

    cfg, table, dev = pl.config, pl.table, pl.device
    p = table.num_procs
    ranks = torch.arange(p, dtype=torch.int32, device=dev)
    e_local = cfg.edges_per_proc
    t_cap = cfg.total_capacity_factor * e_local

    def phase1_urns():
        ptr, terminal, _ = blocking.map_logical(
            lambda r, fr, ss: pba._phase1_urn(r, fr, ss, cfg, p), ranks,
            torch.from_numpy(table.procs).to(dev),
            torch.from_numpy(table.s).to(dev))
        return ptr, terminal

    def pool_urns():
        ptr = blocking.map_logical(
            lambda r: pba._phase2_pool_urn(r, cfg, t_cap, dev), ranks)
        return ptr, torch.arange(e_local + t_cap, device=dev) < e_local

    def timed(fn, urn, reps):
        """Median CUDA-event ms of fn(work) with work a fresh copy of urn
        (the first of reps + 1 runs is a warm-up), and the last result."""
        times = []
        for _ in range(reps + 1):
            work = urn.clone()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(work)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            del work
        return statistics.median(times[1:]), out

    results = []
    for label, make in (("phase-1 urns", phase1_urns),
                        ("phase-2 pools", pool_urns)):
        urn, terminal = make()
        plain_ms, want = timed(ref.resolve_roots_ref, urn, 3)
        kernel_ms, got = timed(edge_resolve.resolve_roots, urn, 7)
        diff = max_abs_diff(torch, got, want)
        del got
        old_ms, (old, rounds) = timed(
            lambda w: doubling_resolve(torch, ops, w, terminal), urn, 3)
        old_diff = max_abs_diff(torch, old, want)
        del old, want, urn, terminal
        nbytes = 8 * p * (e_local if label.startswith("phase-1")
                          else e_local + t_cap)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"case": f"resolve_roots {label}", "kernel": "resolve_roots",
               "shape": [p, nbytes // (8 * p)], "max_abs_diff": diff,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": None, "bytes": nbytes, "int_ops": 0,
               "bytes_bound_ms": bytes_ms, "ops_bound_ms": 0.0,
               "bound_ms": bytes_ms, "bound_by": "bytes",
               "previous_design_ms": old_ms,
               "previous_design_rounds": rounds,
               "previous_design_max_abs_diff": old_diff}
        results.append(row)
        emit({"phase": "kernel_case", **row})
        if diff or old_diff:
            raise AssertionError(f"resolve_roots {label}: kernel differs "
                                 f"from plain ({diff}) or from the "
                                 f"doubling passes ({old_diff})")
        torch.cuda.empty_cache()
    return results


# --- phase 4: the main path -----------------------------------------------------

def stage_times(torch, api, pl) -> dict:
    """Per-stage seconds of the main path, synchronised between stages."""
    from repro_torch.core import pba
    from repro_torch.runtime import blocking
    from repro_torch.runtime.topology import Topology

    cfg, table, dev = pl.config, pl.table, pl.device
    p = table.num_procs
    procs = torch.from_numpy(table.procs).to(dev)
    s = torch.from_numpy(table.s).to(dev)
    ranks = torch.arange(p, dtype=torch.int32, device=dev)
    topo = Topology.host()
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return res

    a, counts = timed("phase1_s", lambda: pba._phase1(ranks, procs, s, cfg,
                                                      p))
    recv = timed("exchange1_s", lambda: blocking.transpose_counts(counts,
                                                                  topo))
    occ = timed("occurrence_rank_s", lambda: pba.occurrence_rank(a))
    pool = timed("phase2_pool_s", lambda: pba._phase2_pool(ranks, cfg))
    del pool
    timed("exchange2_with_pool_s", lambda: pba._streamed_exchange2(
        a, occ, counts, recv, ranks, cfg, pl.pair_capacity, p, topo))
    return out


def host_op_calls(torch, fn, names: tuple) -> dict:
    """Calls of each host-side op in ``names`` (e.g. a collective's
    dispatcher op, ``c10d::alltoall_base_``) during one fn(), from
    torch.profiler's trace of the host's ops. The trace's raw events are
    scanned: building its event tree would take ~0.3 ms per event, and
    a PBA run records hundreds of thousands."""
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)       # a gloo rehearsal on the CPU
    sync()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        sync()
    calls = dict.fromkeys(names, 0)
    for e in prof.profiler.kineto_results.events():
        if e.name() in calls:
            calls[e.name()] += 1
    return calls


def profile_run(torch, api, spec, dev, kernel: str = "",
                expect_calls=None, attempts: int = 3) -> dict:
    """:func:`profile_fn` of one ``api.generate(spec)`` run."""
    return profile_fn(torch, lambda: api.generate(spec, device=dev), kernel,
                      expect_calls, attempts)


def profile_fn(torch, run, kernel: str = "", expect_calls=None,
               attempts: int = 3) -> dict:
    """Device-time share and the top device ops of run(), a main-path run
    or step, profiled after one warm-up run; a path shorter than half a
    second is profiled over as many runs as fill half a second, and times
    are per run. ``kernel`` (a substring of a CUDA kernel's name) adds its device
    time and calls per run. The tracer has returned no device event, or
    too few, for a 20-45 ms path late in a long process: a trace with no
    device event, or with other than ``expect_calls`` calls of ``kernel``
    per run, is taken again, up to ``attempts`` times; if none is
    complete, the busy and idle figures are None ("not measured"), never
    a number from a partial trace."""
    from torch.autograd import DeviceType

    # CUPTI marks the spans where the launch queue was full (the host
    # waited on the device) as device events; they are not kernels.
    def on_device(e):
        name = getattr(e, "name", None) or e.key    # an event, or an average
        return getattr(e, "device_type", None) == DeviceType.CUDA and \
            name != "Command Buffer Full"

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    runs = max(1, int(0.5 / max(time.perf_counter() - t0, 1e-3)))
    for attempt in range(1, attempts + 1):
        prof, wall = profiled(torch, run, runs)
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events() if on_device(e))
        kernels = [e for e in prof.key_averages()
                   if on_device(e) and device_us(e) > 0]
        mine = [e for e in kernels if kernel and kernel in e.key]
        calls = sum(e.count for e in mine) / runs
        complete = bool(spans) and expect_calls in (None, calls)
        if complete:
            break
    head = {"wall_s": wall, "profiled_runs": runs, "attempts": attempt,
            "device_events": len(spans), "complete": complete}
    if kernel:
        head["kernel_calls"] = calls
    if not complete:
        return {**head, "kernels_busy_s": None, "kernel_device_s": None,
                "first_to_last_kernel_s": None,
                "device_idle_share_of_wall": None, "top_device_ops": []}
    busy_us, cur = 0.0, None
    for start, end in spans:          # union of kernel intervals
        if cur is None or start > cur[1]:
            busy_us += (cur[1] - cur[0]) if cur else 0.0
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy_us += cur[1] - cur[0]
    top = sorted(kernels, key=device_us, reverse=True)[:14]
    busy_s = busy_us / 1e6 / runs
    if kernel:
        head["kernel_device_s"] = sum(device_us(e, runs) for e in mine) / 1e6
    return {**head, "kernels_busy_s": busy_s,
            "first_to_last_kernel_s": (spans[-1][1] - spans[0][0]) / 1e6
            / runs,
            "device_idle_share_of_wall": 1 - busy_s / wall,
            "top_device_ops": [{"name": e.key[:90], "calls": e.count / runs,
                                "device_ms": device_us(e, runs) / 1e3}
                               for e in top]}


# --- phase 5: the streamed main path ---------------------------------------------

HOST_PATH_KERNELS = ("resolve_roots", "gather", "gather_chunked",
                     "histogram")
STREAM_PATH_KERNELS = HOST_PATH_KERNELS + ("band_compact",)
URNS_PER_PBA_RUN = 2        # resolve_roots: the phase-1 urns and the pools


def multiset_digest(torch, src, dst, num_vertices: int) -> str:
    """sha256 of the sorted (src, dst) pairs with -1 slots removed: the
    edge multiset, whatever the order the edges come in."""
    import hashlib
    s, d = src.reshape(-1), dst.reshape(-1)
    keep = (s >= 0) & (d >= 0)
    key = s[keep].long() * num_vertices + d[keep].long()
    del keep
    key = torch.sort(key).values.cpu().numpy()
    return hashlib.sha256(key.tobytes()).hexdigest()


class PeakRss:
    """The process's peak resident set size while the scope runs, sampled
    from /proc/self/status every 20 ms."""

    def __enter__(self):
        self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self._rss())

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())


def stream_stage_times(torch, api, pl) -> dict:
    """Seconds of the device stream's setup (phase 1, ranks, pools) and
    of its rounds drained on the device, synchronised between the two."""
    from repro_torch.runtime import streaming
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = api._make_stream(pl)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kept = []
    streaming.drive_rounds(
        range(stream.num_blocks), stream.dispatch_block,
        lambda i, h: kept.append(stream.gather_block_on_device(h)[0].numel()))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del stream
    return {"setup_s": t1 - t0, "rounds_s": t2 - t1,
            "round_mean_s": (t2 - t1) / max(len(kept), 1),
            "kept_per_round": kept}


def streamed_phases(torch, api, dispatch, ops, edge_digest, dev,
                    host_multiset: str) -> tuple[dict, str]:
    """The streamed main path at full width; returns its launch counts
    and the device stream's digest."""
    spec = api.preset("paper_1b_5b", procs=PROCS,
                      vertices_per_proc=VERTICES_PER_PROC,
                      pair_capacity=PAIR_CAPACITY,
                      topology=api.Topology.flat(1))
    pl = api.plan(spec, device=dev)
    if pl.executor != "pba_stream_sharded" or pl.execution != "streamed":
        raise AssertionError(f"streamed spec planned as {pl.executor}")
    overrides = {"procs": PROCS, "pair_capacity": PAIR_CAPACITY,
                 "topology": "flat_1x1"}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # Memory sink, the device stream.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    with PeakRss() as rss:
        res, wall = timed(lambda: api.generate(pl))
    launches = ops.launch_counts()
    st = res.stats
    num_blocks = st.exchange_rounds
    row = {"phase": "stream_main_path", "spec": "paper_1b_5b",
           "overrides": overrides, "reduced": "procs 1000 -> %d" % PROCS,
           "executor": pl.executor, "num_vertices": st.num_vertices,
           "requested_edges": st.requested_edges,
           "emitted_edges": st.emitted_edges,
           "dropped_edges": st.dropped_edges, "num_blocks": num_blocks,
           "urn_budget": res.stream_meta["urn_budget"],
           "round_capacity": res.stream_meta["round_capacity"],
           "fallback_counts": st.fallback_counts, "launches": launches,
           "wall_s": wall, "edges_per_s": st.requested_edges / wall,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "peak_host_rss_bytes": rss.peak}
    emit(row)
    if st.dropped_edges != 0 or st.fallback_counts != {}:
        raise AssertionError("streamed path dropped edges or fell back")
    if min(launches[k] for k in STREAM_PATH_KERNELS) < 1:
        raise AssertionError(f"a kernel of the streamed path never "
                             f"launched: {launches}")
    if launches["band_compact"] != num_blocks:
        raise AssertionError(f"band_compact launched "
                             f"{launches['band_compact']} times for "
                             f"{num_blocks} blocks")
    if launches["resolve_roots"] != URNS_PER_PBA_RUN:
        raise AssertionError(f"resolve_roots launched "
                             f"{launches['resolve_roots']} times in the "
                             f"device stream's setup")
    digest = edge_digest(res.edges.src, res.edges.dst)
    kernel_src, kernel_dst = res.edges.src, res.edges.dst
    del res
    torch.cuda.empty_cache()

    # The same spec on the plain versions.
    torch.cuda.reset_peak_memory_stats(dev)
    with dispatch.forced_mode("ref"):
        plain, plain_wall = timed(lambda: api.generate(pl))
    same = torch.equal(plain.edges.src, kernel_src) and \
        torch.equal(plain.edges.dst, kernel_dst)
    emit({"phase": "stream_main_path_plain", "wall_s": plain_wall,
          "edges_per_s": plain.stats.requested_edges / plain_wall,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "identical_to_kernel_path": same, "sha256": digest})
    if not same:
        raise AssertionError("streamed kernel and plain paths disagree")
    del plain, kernel_src, kernel_dst
    torch.cuda.empty_cache()

    # Parity mode: the host path's edge multiset.
    torch.cuda.reset_peak_memory_stats(dev)
    parity, parity_wall = timed(lambda: api.generate(
        spec.replace(auto_capacity=False), device=dev))
    got = multiset_digest(torch, parity.edges.src, parity.edges.dst,
                          parity.stats.num_vertices)
    emit({"phase": "stream_parity_mode", "wall_s": parity_wall,
          "num_blocks": parity.stats.exchange_rounds,
          "urn_budget": parity.stream_meta["urn_budget"],
          "dropped_edges": parity.stats.dropped_edges,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "multiset_sha256": got,
          "equals_host_path_multiset": got == host_multiset})
    if got != host_multiset:
        raise AssertionError("parity-mode stream differs from the host "
                             "path's edge multiset")
    del parity
    torch.cuda.empty_cache()

    # The host-driven stream of the same spec.
    host_spec = spec.replace(topology=api.Topology.host())
    torch.cuda.reset_peak_memory_stats(dev)
    with PeakRss() as rss:
        hres, host_wall = timed(lambda: api.generate(host_spec, device=dev))
    got = edge_digest(hres.edges.src, hres.edges.dst)
    emit({"phase": "stream_host_driven", "executor": hres.plan.executor,
          "wall_s": host_wall,
          "edges_per_s": hres.stats.requested_edges / host_wall,
          "num_blocks": hres.stats.exchange_rounds,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "peak_host_rss_bytes": rss.peak, "sha256": got,
          "equals_device_stream": got == digest})
    if hres.plan.executor != "pba_stream" or got != digest:
        raise AssertionError("host-driven stream differs from the device "
                             "stream")
    del hres
    torch.cuda.empty_cache()

    emit({"phase": "stream_main_path_stages",
          **stream_stage_times(torch, api, pl)})
    torch.cuda.empty_cache()
    emit({"phase": "stream_main_path_profile",
          **profile_run(torch, api, spec, dev)})
    torch.cuda.empty_cache()

    # Shard sink at reduced depth (procs cut to SHARD_SINK_PROCS: zlib
    # writes ~10 MB/s, so the full width's 1.39 GB took ~150 s): overlap
    # on, read back and resume two blocks against the same spec's
    # in-memory digest, then overlap off; the two writes of one size in
    # one run.
    shard_spec = spec.replace(procs=SHARD_SINK_PROCS)
    reduced = f"procs {PROCS} -> {SHARD_SINK_PROCS}"
    small = api.generate(shard_spec, device=dev)
    shard_digest = edge_digest(small.edges.src, small.edges.dst)
    del small
    torch.cuda.empty_cache()
    out_root = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_root, exist_ok=True)

    def write_shards(shard_spec, overlap, reduced=None):
        shutil.rmtree(out_dir)
        with PeakRss() as rss:
            sres, wall = timed(lambda: api.generate(
                shard_spec.replace(sink="shards", out_dir=out_dir,
                                   overlap=overlap), device=dev))
        emit({"phase": "stream_shards", "overlap": overlap,
              **({"reduced": reduced} if reduced else {}),
              "wall_s": wall,
              "edges_per_s": sres.stats.requested_edges / wall,
              "num_shards": sres.manifest["num_shards"],
              "dropped_edges": sres.stats.dropped_edges,
              "peak_host_rss_bytes": rss.peak,
              "disk_bytes": sum(os.path.getsize(os.path.join(out_dir, f))
                                for f in os.listdir(out_dir))})
        return wall

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_shards_", dir=out_root)
    try:
        walls = {True: write_shards(shard_spec, True, reduced)}
        emit({"phase": "stream_shards_resume", "reduced": reduced,
              **resume_check(torch, api, edge_digest, shard_spec, dev,
                             out_dir, shard_digest),
              "in_memory_sha256": shard_digest,
              "overlap_on_s": walls[True]})
        walls[False] = write_shards(shard_spec, False, reduced)
        emit({"phase": "stream_shards_overlap", "reduced": reduced,
              "overlap_on_s": walls[True], "overlap_off_s": walls[False]})
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches, digest


# --- phase 6: PK and the communication-free family ---------------------------------

PK_LEVELS = 10              # preset pk_3b: star-clique-5 seed, L = 10
PK_NOISE_LEVELS = 9         # the largest host execution the int32 check admits
SLAB = 1 << 20              # GraphSpec.slab_edges default (pk_3b, ba_cfree_1b)
RMAT_SCALE = 26             # Graph500 scale 26, edge factor 16
# 32-bit integer operations per edge, counted from the kernels' source
# (xor, add, shift, multiply, compare, select each count one; a table
# lookup is a load). The card has no integer divider: a division by a
# divisor known only at run time costs at least a multiply-high and a
# shift, and its remainder a multiply-subtract, which is what pk_expand
# and cfree_expand's division by the degree spend. The chain's % (2j + 1)
# and er's % n (divisors that change per draw, or numerators past 2^31)
# run the hardware sequence; they count those three ops too, a lower
# bound.
HASH_OPS = 19               # (t^w0)+c, mix (8), ^w1, mix (8)
REM_OPS = 3                 # multiply-high, shift, multiply-subtract
BA_DRAW_OPS = HASH_OPS + 4 + REM_OPS  # bound 2j+1 (2), odd test (2)
BA_EDGE_OPS = 5             # r>>1; u = t/d, v = (r>>1)/d by multiply-high
RMAT_LEVEL_OPS = HASH_OPS - 1 + 11  # t^w0 is common to the levels; 3
                                    # compares + 2 adds, u and v updates
ER_EDGE_OPS = 2 * (HASH_OPS + REM_OPS)
PK_LEVEL_OPS = 9            # multiply-high, shift, multiply-subtract (the
                            # / and % by e0), base add, carry add, compare,
                            # subtract, two multiply-adds; the powers of n0
                            # come precomputed (the earlier design's count:
                            # / and % one each and a running power, also 9)
PK_NOISE_LEVEL_OPS = 2      # flip test and select


def pk_noise_bytes(flip) -> int:
    """Bytes the noise body must move for (L, m) ``flip``: t read and u, v
    written (12 B per edge), flip read in full (1 B per entry), and only
    the 32-byte sectors of the int32 redraw plane that a set flip entry
    touches (the kernel reads ``redraw`` only where ``flip`` is set)."""
    levels, m = flip.shape
    flat = flip.reshape(-1)
    whole = flat.numel() // 8 * 8
    sectors = int(flat[:whole].view(-1, 8).any(1).sum()) + \
        int(flat[whole:].any())
    return 12 * m + levels * m + 32 * sectors


def cfree_pair(model: str, n: int, degree: int, thresholds):
    """(kernel, plain) callables of (t, words) for one model's constants;
    the kernel's is named as its wrapper."""
    from repro_torch.kernels import cfree_expand as wrapper, ref
    kw = dict(model=model, n=n, ba_degree=degree, thresholds=thresholds)

    def cfree_expand(t, words):
        return wrapper.cfree_expand(t, words, **kw)

    return cfree_expand, lambda t, words: ref.cfree_expand_ref(t, words,
                                                               **kw)


def pk_cfree_kernel_cases(torch, dev) -> list[dict]:
    """pk_expand and cfree_expand against their plain versions at the main
    paths' shapes: a pk_3b slab (no noise) and the noise path's host
    shape; a ba_cfree_1b slab; rmat and er over the host range of 2^30
    edges. Noise inputs come from a torch generator seeded with SEED."""
    from repro_torch.core import cfree, pk
    from repro_torch.kernels import pk_expand, ref

    results = []
    seed = pk.star_clique_seed(5)
    n0, e0 = seed.num_vertices, seed.num_edges
    su, sv = pk.seed_tables(seed, dev)
    blocks = -(-e0 ** PK_LEVELS // SLAB)
    base = pk.decompose_base((blocks // 2) * SLAB, e0, PK_LEVELS)
    t = torch.arange(SLAB, dtype=torch.int32, device=dev)
    run_case(torch, results, f"pk_expand slab {SLAB} L{PK_LEVELS}",
             pk_expand.pk_expand, ref.pk_expand_ref, None,
             (t, base, su, sv, n0, e0, PK_LEVELS), 12 * SLAB,
             [SLAB, PK_LEVELS], ops=PK_LEVEL_OPS * PK_LEVELS * SLAB,
             device_kernel="pk_expand_kernel", back_to_back=True)

    m = e0 ** PK_NOISE_LEVELS
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flip = torch.empty((PK_NOISE_LEVELS, m), dtype=torch.bool, device=dev)
    redraw = torch.empty((PK_NOISE_LEVELS, m), dtype=torch.int32,
                         device=dev)
    for level in range(PK_NOISE_LEVELS):
        flip[level] = torch.rand(m, generator=gen, device=dev) < 0.05
        redraw[level] = torch.randint(0, e0, (m,), generator=gen,
                                      device=dev, dtype=torch.int32)
    t = torch.arange(m, dtype=torch.int32, device=dev)
    run_case(torch, results, f"pk_expand noise host {m} L{PK_NOISE_LEVELS}",
             pk_expand.pk_expand, ref.pk_expand_ref, None,
             (t, [0] * PK_NOISE_LEVELS, su, sv, n0, e0, PK_NOISE_LEVELS,
              flip, redraw), pk_noise_bytes(flip), [PK_NOISE_LEVELS, m],
             ops=(PK_LEVEL_OPS + PK_NOISE_LEVEL_OPS) * PK_NOISE_LEVELS * m,
             device_kernel="pk_expand_kernel")
    del flip, redraw, t
    torch.cuda.empty_cache()

    # ba_cfree_1b: a slab from the middle of its 10^9 edges.
    cfg = cfree.CFreeConfig(model="ba_cfree", vertices=250_000_000,
                            ba_degree=4, seed=7)
    words = cfree.cfree_words(cfg)
    t0 = (cfree.cfree_sizes(cfg)[1] // SLAB // 2) * SLAB
    t = torch.arange(t0, t0 + SLAB, dtype=torch.int32, device=dev)
    per_edge = cfree.ba_chain(words, t)[1]
    draws = int(per_edge.sum())
    emit({"phase": "ba_chain_draws", "edges": SLAB, "draws": draws,
          "draws_per_edge": draws / SLAB,
          "longest_chain": int(per_edge.max())})
    del per_edge
    run_case(torch, results, f"cfree_expand ba_cfree slab {SLAB} at {t0}",
             *cfree_pair("ba_cfree", cfg.vertices, 4, (0, 0, 0)), None,
             (t, words), 12 * SLAB, [SLAB],
             ops=BA_DRAW_OPS * draws + BA_EDGE_OPS * SLAB,
             device_kernel="cfree_expand_kernel", back_to_back=True)

    # Graph500 scale 26: rmat and er over the host range [0, 2^30).
    e = 16 << RMAT_SCALE
    t = torch.arange(e, dtype=torch.int32, device=dev)
    for model in ("rmat", "er"):
        cfg = cfree.CFreeConfig(model=model, vertices=1 << RMAT_SCALE,
                                edges=e, seed=7)
        words, th = cfree.cfree_words(cfg), cfree.rmat_thresholds(cfg)
        ops = (RMAT_LEVEL_OPS * RMAT_SCALE + 1 if model == "rmat"
               else ER_EDGE_OPS) * e
        run_case(torch, results, f"cfree_expand {model} host {e}",
                 *cfree_pair(model, 1 << RMAT_SCALE, 2, th), None,
                 (t, words), 12 * e, [e], ops=ops, plain_reps=1,
                 device_kernel="cfree_expand_kernel")
    del t
    torch.cuda.empty_cache()
    return results


def run_and_check(torch, api, dispatch, ops, dev, label: str, spec,
                  kernel: str, expect_launches=None, expect_dropped=0,
                  profile: bool = True) -> dict:
    """One main path of the slice: the spec through the front door with
    the launch counts set to 0 just before and read just after, then a
    profiled run, then the same spec under forced_mode("ref") (identical
    edges, compared on the card). Returns the phase's row, with the
    kernel path's (src, dst) under "edges" when not profiled."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.generate(spec, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    st = res.stats
    row = {"phase": label, "executor": res.plan.executor,
           "num_vertices": st.num_vertices,
           "requested_edges": st.requested_edges,
           "emitted_edges": st.emitted_edges,
           "dropped_edges": st.dropped_edges,
           "exchange_rounds": st.exchange_rounds,
           "fallback_counts": st.fallback_counts, "launches": launches,
           "wall_s": wall, "edges_per_s": st.requested_edges / wall,
           "peak_allocated_bytes": peak}
    if res.plan.execution == "streamed":
        stream = api._make_stream(res.plan)
        row["num_blocks"] = stream.num_blocks
        del stream
    if st.fallback_counts != {} or launches[kernel] < 1:
        emit(row)
        raise AssertionError(f"{label}: fell back or never launched "
                             f"{kernel}: {launches}")
    if expect_launches is not None and launches[kernel] != expect_launches:
        emit(row)
        raise AssertionError(f"{label}: {kernel} launched "
                             f"{launches[kernel]} times, expected "
                             f"{expect_launches}")
    if expect_dropped is not None and st.dropped_edges != expect_dropped:
        emit(row)
        raise AssertionError(f"{label}: {st.dropped_edges} dropped edges")
    ksrc, kdst = res.edges.src, res.edges.dst
    del res
    if profile:
        prof = profile_run(torch, api, spec, dev, kernel + "_kernel",
                           expect_calls=launches[kernel])
        busy = prof["kernels_busy_s"]
        row["profile"] = {
            **{k: prof[k] for k in (
                "wall_s", "profiled_runs", "attempts", "device_events",
                "complete", "kernel_calls", "kernels_busy_s",
                "device_idle_share_of_wall", "kernel_device_s")},
            "kernel_share_of_busy": prof["kernel_device_s"] / busy
            if busy else None,
            "top_device_ops": prof["top_device_ops"][:6]}
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dispatch.forced_mode("ref"):
        plain = api.generate(spec, device=dev)
    torch.cuda.synchronize()
    row["plain_wall_s"] = time.perf_counter() - t0
    row["plain_peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    same = torch.equal(plain.edges.src, ksrc) and \
        torch.equal(plain.edges.dst, kdst)
    row["identical_to_plain_path"] = same
    row["plain_dropped_edges"] = plain.stats.dropped_edges
    del plain
    if not same:
        emit(row)
        raise AssertionError(f"{label}: kernel and plain paths disagree")
    emit(row)
    if not profile:
        row["edges"] = (ksrc, kdst)
    return row


def resume_check(torch, api, edge_digest, spec, dev, out_dir: str,
                 digest: str) -> dict:
    """Read the shards of ``spec`` under ``out_dir`` back, drop the last
    two from the manifest, resume, and check that only those two were
    rewritten and that both reads give ``digest``."""
    from repro_torch.core import storage
    src, dst, man = storage.read_shards(out_dir)
    read_digest = edge_digest(src, dst)
    del src, dst
    n = man["num_shards"]
    man["complete"] = [i for i in man["complete"] if i < n - 2]
    for i in (n - 2, n - 1):
        del man["counts"][str(i)]
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(man, f)

    def shard(i):
        return os.path.join(out_dir, f"shard_{i:05d}.npz")

    for i in (n - 2, n - 1):
        os.utime(shard(i), ns=(0, 0))
    stamps = {i: os.stat(shard(i)).st_mtime_ns for i in range(n)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.generate(spec.replace(sink="shards", out_dir=out_dir), device=dev)
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - t0
    rewritten = [i for i in range(n)
                 if os.stat(shard(i)).st_mtime_ns != stamps[i]]
    src, dst, _ = storage.read_shards(out_dir)
    resumed_digest = edge_digest(src, dst)
    del src, dst
    row = {"read_back_sha256": read_digest,
           "read_back_matches": read_digest == digest,
           "resume_wall_s": resume_wall, "rewritten": rewritten,
           "resumed_matches": resumed_digest == digest}
    if read_digest != digest or resumed_digest != digest \
            or rewritten != [n - 2, n - 1]:
        emit(row)
        raise AssertionError("shard sink read back or resumed wrong")
    return row


def cfree_stream_walls(torch, api, dev, runs: int = 9) -> dict:
    """Walls (s) of ``runs`` runs of preset("ba_cfree_1b") into memory on
    each stream executor (Topology.host(): cfree_stream; flat(1):
    cfree_stream_sharded), after one warm-up run of each, and their
    medians. The stream is host-bound per slab, so this is where the
    wrapper's host work per launch shows."""
    spec = api.preset("ba_cfree_1b")
    walls = {}
    for name, topology in (("host", api.Topology.host()),
                           ("flat1", api.Topology.flat(1))):
        run = spec.replace(topology=topology)
        times = []
        for _ in range(runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = api.generate(run, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del res
        walls[f"{name}_wall_s"] = times[1:]
        walls[f"{name}_median_s"] = statistics.median(times[1:])
        torch.cuda.empty_cache()
    return walls


def pk_cfree_phases(torch, api, dispatch, ops, edge_digest, dev) -> dict:
    """R-MAT and ER at Graph500 scale 26, PK at the paper's scale, the PK
    noise path, ba_cfree at full width, and the shard sink at reduced
    depth. Returns each path's launch counts."""
    launches = {}

    # R-MAT and ER at Graph500 scale 26, edge factor 16, host execution;
    # first, as the profiler has lost these short paths' traces late in
    # the process.
    for model in ("rmat", "er"):
        spec = api.GraphSpec(model=model, cfree_vertices=1 << RMAT_SCALE,
                             cfree_edges=16 << RMAT_SCALE, seed=7)
        row = run_and_check(torch, api, dispatch, ops, dev,
                            f"{model}_scale{RMAT_SCALE}_host", spec,
                            "cfree_expand", expect_launches=1)
        launches[f"{model}_scale{RMAT_SCALE}_host"] = row["launches"]
        torch.cuda.empty_cache()

    # PK: preset pk_3b as the repo defines it, streamed into memory.
    spec = api.preset("pk_3b")
    row = run_and_check(torch, api, dispatch, ops, dev, "pk_3b_stream",
                        spec, "pk_expand",
                        expect_launches=-(-9 ** PK_LEVELS // SLAB))
    launches["pk_3b_stream"] = row["launches"]
    torch.cuda.empty_cache()

    # The noise body, chunked threefry draws and deletion, host execution.
    spec = api.preset("pk_3b", levels=PK_NOISE_LEVELS, execution="host",
                      noise=0.05, delete_prob=0.01)
    row = run_and_check(torch, api, dispatch, ops, dev, "pk_noise_host",
                        spec, "pk_expand", expect_launches=1,
                        expect_dropped=None)
    if row["dropped_edges"] != row["plain_dropped_edges"] or not \
            0 < row["dropped_edges"] < row["requested_edges"]:
        raise AssertionError("pk noise path: deletion count off")
    launches["pk_noise_host"] = row["launches"]
    torch.cuda.empty_cache()

    # Communication-free BA, 10^9 edges, on both stream executors.
    spec = api.preset("ba_cfree_1b")
    row = run_and_check(torch, api, dispatch, ops, dev,
                        "ba_cfree_1b_stream_host", spec, "cfree_expand",
                        profile=False)
    launches["ba_cfree_1b_stream_host"] = row["launches"]
    host_edges = row.pop("edges")
    flat = run_and_check(torch, api, dispatch, ops, dev,
                         "ba_cfree_1b_stream_flat1",
                         spec.replace(topology=api.Topology.flat(1)),
                         "cfree_expand", expect_launches=row["launches"]
                         ["cfree_expand"], profile=False)
    same = torch.equal(flat["edges"][0], host_edges[0]) and \
        torch.equal(flat["edges"][1], host_edges[1])
    emit({"phase": "ba_cfree_1b_executors_agree", "host_executor":
          row["executor"], "flat1_executor": flat["executor"],
          "identical": same})
    if not same or row["executor"] != "cfree_stream" or \
            flat["executor"] != "cfree_stream_sharded":
        raise AssertionError("ba_cfree_1b: the two stream executors differ")
    del host_edges, flat
    torch.cuda.empty_cache()
    emit({"phase": "ba_cfree_1b_stream_walls",
          **cfree_stream_walls(torch, api, dev)})
    prof = profile_run(torch, api, spec, dev, "cfree_expand_kernel",
                       expect_calls=row["launches"]["cfree_expand"])
    emit({"phase": "ba_cfree_1b_profile",
          **{k: prof[k] for k in ("wall_s", "profiled_runs", "attempts",
                                  "device_events", "complete",
                                  "kernel_calls", "kernel_device_s",
                                  "kernels_busy_s",
                                  "device_idle_share_of_wall")},
          "top_device_ops": prof["top_device_ops"][:6]})
    torch.cuda.empty_cache()

    # Shard sink at reduced depth: np.savez_compressed writes ~10 MB/s, so
    # a full-width write of pk_3b (28 GB) or ba_cfree_1b (8 GB) would take
    # far past the time limit.
    out_root = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_root, exist_ok=True)
    for label, spec in (
            ("pk_shards_L7", api.preset("pk_3b", levels=7)),
            ("ba_cfree_shards_2m", api.preset("ba_cfree_1b",
                                              cfree_vertices=2_000_000))):
        res = api.generate(spec, device=dev)
        digest = edge_digest(res.edges.src, res.edges.dst)
        requested = res.stats.requested_edges
        del res
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_shards_", dir=out_root)
        try:
            t0 = time.perf_counter()
            sres = api.generate(spec.replace(sink="shards",
                                             out_dir=out_dir), device=dev)
            wall = time.perf_counter() - t0
            row = {"phase": label, "requested_edges": requested,
                   "wall_s": wall, "num_shards": sres.manifest["num_shards"],
                   "dropped_edges": sres.stats.dropped_edges,
                   "disk_bytes": sum(
                       os.path.getsize(os.path.join(out_dir, f))
                       for f in os.listdir(out_dir)),
                   "memory_sha256": digest}
            row.update(resume_check(torch, api, edge_digest, spec, dev,
                                    out_dir, digest))
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        emit(row)
    return launches


# --- the analytics: phases 3, 4 and 7 ---------------------------------------------

ANALYTICS_BLOCKS = 16       # community_contrast's B (the reference's default)
ANALYTICS_SOURCES = 16      # sampled_path_stats' BFS sources (its default)
ANALYTICS_SAMPLES = 200     # sampled_clustering_coefficient's (its default)
RICH_CLUB_K = 10
# degree_assortativity's float64 sums over 2E values run on the card in
# another order than numpy's pairwise sums: the one result held to a
# tolerance.
ASSORTATIVITY_RTOL = 1e-9
ASSORTATIVITY_ATOL = 1e-12
SERIAL_BA = (4000, 4, 0)    # serial_ba_reference's (num_vertices, k, seed)


def array_sha256(np, dtype: str, *arrays) -> str:
    """sha256 of the arrays as ``dtype`` (e.g. "<i4"), one after another."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, dtype=dtype).tobytes())
    return h.hexdigest()


def analytics_record(np, analysis, edges, valid_edges, to_numpy,
                     n0=None) -> dict:
    """Every analytics function of ``analysis`` (either package's
    ``core.analysis``: the names and signatures are the same) on
    ``edges``: arrays by their sha256, scalars and dataclasses as they
    are. ``valid_edges(edges)`` gives the package's (src, dst) without
    invalid slots, ``to_numpy`` a host copy of one of its arrays; ``n0``,
    a PK seed's vertex count, adds self_similarity_score."""
    n = edges.num_vertices
    deg = to_numpy(analysis.degree_counts(edges))
    indptr, indices = analysis.to_csr(*valid_edges(edges), n)
    rec = {
        "degree_counts_sha256": array_sha256(np, "<i4", deg),
        "degree_histogram_sha256": array_sha256(
            np, "<i8", *analysis.degree_histogram(deg)),
        "csr_sha256": array_sha256(np, "<i8", to_numpy(indptr),
                                   to_numpy(indices)),
        "bfs_from_0_sha256": array_sha256(np, "<i4", to_numpy(
            analysis.bfs_distances(indptr, indices, 0, n))),
        "power_law": dataclasses.asdict(analysis.fit_power_law(deg)),
        "path_stats": dataclasses.asdict(analysis.sampled_path_stats(
            edges, ANALYTICS_SOURCES, seed=0)),
        "block_density_sha256": array_sha256(
            np, "<f8", analysis.block_density(edges, ANALYTICS_BLOCKS)),
        "community_contrast": analysis.community_contrast(
            edges, ANALYTICS_BLOCKS),
        "clustering": analysis.sampled_clustering_coefficient(
            edges, ANALYTICS_SAMPLES, seed=0),
        "assortativity": analysis.degree_assortativity(edges),
        "rich_club": analysis.rich_club_coefficient(edges, RICH_CLUB_K)}
    if n0:
        rec["self_similarity"] = analysis.self_similarity_score(edges, n0)
    return rec


def analytics_mismatches(got: dict, want: dict) -> list:
    """The keys of ``want`` whose value ``got`` does not equal (the
    assortativity: not within its tolerance)."""
    bad = []
    for key, w in want.items():
        g = got.get(key)
        if key == "assortativity":
            ok = g is not None and abs(g - w) <= \
                ASSORTATIVITY_ATOL + ASSORTATIVITY_RTOL * abs(w)
        else:
            ok = g == w
        if not ok:
            bad.append(key)
    return bad


def check_reference_analytics(torch, np, name: str, edges, case: dict) -> None:
    """Phase 3: every analytics function on the card's edges of a digest
    case against the JAX package's results (reference_analytics.json),
    and degree_counts_device on the histogram kernel against
    degree_counts."""
    from repro_torch.core import analysis
    t0 = time.perf_counter()
    got = analytics_record(np, analysis, edges, analysis.valid_edges,
                           lambda t: t.cpu().numpy(), case["n0"])
    bad = analytics_mismatches(got, case["record"])
    kernel = analysis.degree_counts_device(edges, use_kernel=True)
    if not torch.equal(kernel, analysis.degree_counts(edges)):
        bad.append("degree_counts_device")
    torch.cuda.synchronize()
    emit({"phase": "reference_analytics", "case": name,
          "num_vertices": edges.num_vertices, "mismatches": bad,
          "assortativity": got["assortativity"],
          "assortativity_reference": case["record"]["assortativity"],
          "wall_s": time.perf_counter() - t0})
    if bad:
        raise AssertionError(f"{name}: the card's analytics differ from the "
                             f"JAX package's: {bad}")


GAMMA_BAND = (1.5, 3.5)      # tests/test_graph_properties.py's band
MAIN_PATH_FIT_KMIN = 5


def timed_step(torch, dev, rows: dict, label: str, fn):
    """fn()'s result; ``rows[label]`` gets its wall to the card's finish
    and the peak device memory while it ran."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rows[label] = {"wall_s": time.perf_counter() - t0,
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated(
                       dev)}
    return out


def main_path_analytics(torch, np, ops, dev, edges, emitted: int) -> dict:
    """Phase 4's analytics step on the host path's 64-rank graph, with the
    launch counts set to 0 just before it and read just after:
    degree_counts_device on the histogram kernel (exactly 1 launch, equal
    to degree_counts), then the paper's metrics, each with its value, wall
    and peak device memory; gamma_mle must lie in GAMMA_BAND and the
    degrees must sum to twice the edges. Then, outside the counted step, a
    profile of to_csr and of one BFS (from vertex 0, with its frontier
    sizes), and community_contrast's histogram held to its plain version
    and torch.bincount on the same cells. Returns the degree counts'
    sha256 and max, the step's launch counts and that kernel case."""
    from repro_torch.core import analysis
    from repro_torch.core.graph import to_csr

    n = edges.num_vertices
    rows = {}
    ops.reset_launch_counts()
    counts = timed_step(torch, dev, rows, "degree_counts_device",
                        lambda: analysis.degree_counts_device(
                            edges, use_kernel=True))
    kernel_launches = ops.launch_counts()["histogram"]
    plain = timed_step(torch, dev, rows, "degree_counts",
                       lambda: analysis.degree_counts(edges))
    same = torch.equal(counts, plain)
    del plain
    values = {
        "degree_counts": {"sha256": array_sha256(np, "<i4",
                                                 counts.cpu().numpy()),
                          "max": int(counts.max()),
                          "sum": int(counts.sum(dtype=torch.int64))},
        "fit_power_law": dataclasses.asdict(timed_step(
            torch, dev, rows, "fit_power_law", lambda: analysis.fit_power_law(
                counts, kmin=MAIN_PATH_FIT_KMIN))),
        "sampled_path_stats": dataclasses.asdict(timed_step(
            torch, dev, rows, "sampled_path_stats",
            lambda: analysis.sampled_path_stats(edges, ANALYTICS_SOURCES))),
        "community_contrast": timed_step(
            torch, dev, rows, "community_contrast",
            lambda: analysis.community_contrast(edges, ANALYTICS_BLOCKS)),
        "sampled_clustering_coefficient": timed_step(
            torch, dev, rows, "sampled_clustering_coefficient",
            lambda: analysis.sampled_clustering_coefficient(
                edges, ANALYTICS_SAMPLES)),
        "degree_assortativity": timed_step(
            torch, dev, rows, "degree_assortativity",
            lambda: analysis.degree_assortativity(edges)),
        "rich_club_coefficient": timed_step(
            torch, dev, rows, "rich_club_coefficient",
            lambda: analysis.rich_club_coefficient(edges, RICH_CLUB_K))}
    launches = ops.launch_counts()
    for label, value in values.items():
        rows.setdefault(label, {})["value"] = value
    gamma = values["fit_power_law"]["gamma_mle"]
    row = {"phase": "main_path_analytics", "num_vertices": n,
           "emitted_edges": emitted, "launches": launches,
           "degree_counts_device_histogram_launches": kernel_launches,
           "kernel_equals_degree_counts": same,
           "gamma_mle_band": list(GAMMA_BAND),
           "walls_total_s": sum(r["wall_s"] for r in rows.values()),
           "functions": rows}
    emit(row)
    if kernel_launches != 1 or not same or \
            not GAMMA_BAND[0] < gamma < GAMMA_BAND[1] or \
            values["degree_counts"]["sum"] != 2 * emitted:
        raise AssertionError("main path analytics: degree_counts_device took "
                             f"{kernel_launches} histogram launches, equal "
                             f"to degree_counts: {same}; gamma_mle {gamma}")
    cells = block_cell_cases(torch, analysis, edges, "64-rank",
                             (ANALYTICS_BLOCKS,))

    # What CSR and BFS spend (outside the counted step).
    src, dst = analysis.valid_edges(edges)
    breakdown = {"phase": "main_path_analytics_breakdown"}
    keep = ("wall_s", "profiled_runs", "complete", "kernels_busy_s",
            "device_idle_share_of_wall", "top_device_ops")
    prof = profile_fn(torch, lambda: to_csr(src, dst, n))
    breakdown["to_csr"] = {k: prof[k] for k in keep}
    csr = timed_step(torch, dev, breakdown, "to_csr_run",
                     lambda: to_csr(src, dst, n))
    del src, dst
    dist = analysis.bfs_distances(*csr, 0, n)
    sizes = torch.bincount(dist[dist >= 0]).tolist()
    del dist
    prof = profile_fn(torch, lambda: analysis.bfs_distances(*csr, 0, n))
    breakdown["bfs_from_0"] = {"levels": len(sizes) - 1,
                               "frontier_sizes": sizes,
                               **{k: prof[k] for k in keep}}
    del csr
    torch.cuda.empty_cache()
    emit(breakdown)
    return {"sha256": values["degree_counts"]["sha256"],
            "max": values["degree_counts"]["max"], "launches": launches,
            "cases": cells}


def pk_self_similarity(torch, api, ops, dev) -> tuple[dict, list]:
    """self_similarity_score on PK at L = PK_NOISE_LEVELS (host execution;
    pk_3b's L=10 would hold 28 GB of edges and as much again of int64
    block ids, and its edge count passes int32), with the launch counts
    set to 0 just before it and read just after: two block_density
    counts, one histogram launch each. Then the histogram at both counts'
    cells (B = n0 and n0 * n0) against its plain version and
    torch.bincount. Returns the launch counts and those kernel cases."""
    from repro_torch.core import analysis
    res = api.generate(api.preset("pk_3b", levels=PK_NOISE_LEVELS,
                                  execution="host"), device=dev)
    n0 = res.plan.seed_graph.num_vertices
    rows = {}
    ops.reset_launch_counts()
    score = timed_step(torch, dev, rows, "self_similarity_score",
                       lambda: analysis.self_similarity_score(res.edges, n0))
    launches = ops.launch_counts()
    emit({"phase": "pk_L9_analytics", "levels": PK_NOISE_LEVELS, "n0": n0,
          "edges": res.stats.emitted_edges, "self_similarity": score,
          "launches": launches, **rows["self_similarity_score"]})
    if launches["histogram"] != 2 or not math.isfinite(score):
        raise AssertionError(f"pk self-similarity {score} with "
                             f"{launches['histogram']} histogram launches")
    cases = block_cell_cases(torch, analysis, res.edges,
                             f"pk L={PK_NOISE_LEVELS}", (n0, n0 * n0))
    del res
    torch.cuda.empty_cache()
    return launches, cases


# --- phase 7: the torch.distributed path -------------------------------------------

A2A_OP = "c10d::alltoall_base_"     # all_to_all_single's dispatcher op
DIST_PK_LEVELS = 9                  # L=10's 3.49B edges pass int32 only
                                    # split over several ranks


def distributed_phases(torch, np, api, ops, edge_digest, dev,
                       host_digest: str, stream_digest: str, host_peak: int,
                       degrees: dict) -> dict:
    """The port's torch.distributed code path at world size 1: a NCCL
    group over the card (file:// rendezvous in a temp dir, ``device_id``
    the card) carries the collectives of each run, which must give the
    one-device paths' digests; the sharded analytics of the flat(1) run
    must give phase 4's degree counts (``degrees``: their sha256 and
    max). Returns each run's launch counts."""
    import torch.distributed as dist

    rdzv = tempfile.mkdtemp(prefix="chip_smoke_rdzv_")
    dist.init_process_group("nccl", init_method=f"file://{rdzv}/store",
                            world_size=1, rank=0, device_id=dev)
    launches = {}
    try:
        pba = api.preset("paper_1b_5b", procs=PROCS,
                         vertices_per_proc=VERTICES_PER_PROC,
                         pair_capacity=PAIR_CAPACITY)
        e = 16 << RMAT_SCALE
        rmat = api.GraphSpec(model="rmat", cfree_vertices=1 << RMAT_SCALE,
                             cfree_edges=e, seed=7)
        pk = api.preset("pk_3b", levels=DIST_PK_LEVELS)
        hosts = {}
        for name, spec in (("pk", pk), ("rmat", rmat)):
            res = api.generate(spec.replace(execution="host"), device=dev)
            hosts[name] = edge_digest(res.edges.src, res.edges.dst)
            del res
        torch.cuda.empty_cache()
        cases = (
            ("a_sharded_flat1", pba.replace(
                execution="sharded", topology=api.Topology.flat(1)),
             host_digest, "generate_pba_sharded", 1),
            ("b_sharded_pods1x1", pba.replace(
                execution="sharded", topology=api.Topology.pods(1, 1)),
             host_digest, "generate_pba_sharded", 2),
            ("c_streamed_flat1", pba.replace(
                execution="streamed", topology=api.Topology.flat(1)),
             stream_digest, "pba_stream_sharded", 1),
            ("d_pk_L9_sharded", pk.replace(execution="sharded"),
             hosts["pk"], "generate_pk", 0),
            ("e_rmat_scale26_sharded", rmat.replace(execution="sharded"),
             hosts["rmat"], "generate_cfree", 0))
        for label, spec, want, executor, hops in cases:
            row, launches[label], res = distributed_run(
                torch, api, ops, edge_digest, dev, label, spec, want,
                executor, hops, keep=label == "a_sharded_flat1")
            row["peak_over_host_path_bytes"] = \
                row["peak_allocated_bytes"] - host_peak
            emit(row)
            if res is not None:
                launches["g_analytics_flat1"] = distributed_analytics(
                    torch, np, ops, dev, res, degrees)
            del res
            torch.cuda.empty_cache()
        launches["f_shard_sink_hub_stress"] = distributed_shards(
            torch, api, ops, edge_digest, dev)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)
    return launches


def distributed_run(torch, api, ops, edge_digest, dev, label: str, spec,
                    want: str, executor: str, hops: int, keep: bool = False):
    """One run through the group: launch counts set to 0 just before and
    read just after, the digest against ``want``, then a profiled run
    whose all-to-all count must be ``hops`` x (exchange 1 + one per
    exchange round) (0: no all-to-all at all), counted in one more run
    whose host ops are traced. Returns the row, the launch counts and,
    with ``keep``, the first run's result (else None)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.generate(spec)          # the rank's device: cuda:rank % count
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = res.stats
    got = edge_digest(res.edges.src, res.edges.dst)
    row = {"phase": "distributed", "case": label,
           "executor": res.plan.executor,
           "topology": res.plan.topology.label, "lp": res.plan.lp,
           "device": str(res.plan.device), "world_size": 1,
           "requested_edges": st.requested_edges,
           "dropped_edges": st.dropped_edges,
           "exchange_rounds": st.exchange_rounds,
           "fallback_counts": st.fallback_counts, "launches": launches,
           "wall_s": wall, "edges_per_s": st.requested_edges / wall,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "sha256": got, "matches_one_device_path": got == want}
    kept = res if keep else None
    del res
    torch.cuda.empty_cache()
    rounds = st.exchange_rounds
    expect = hops * (1 + rounds)
    prof = profile_run(torch, api, spec, dev)
    row["profile"] = {k: prof[k] for k in (
        "wall_s", "profiled_runs", "complete", "kernels_busy_s",
        "device_idle_share_of_wall")}
    row["op_calls"] = host_op_calls(
        torch, lambda: api.generate(spec, device=dev), (A2A_OP,))
    row["expected_all_to_all_per_run"] = expect
    kernels = {"generate_pk": ("pk_expand",),
               "generate_cfree": ("cfree_expand",)}.get(
        executor, STREAM_PATH_KERNELS if executor == "pba_stream_sharded"
        else HOST_PATH_KERNELS)
    if row["executor"] != executor or not row["matches_one_device_path"] \
            or st.dropped_edges or st.fallback_counts != {} \
            or min(launches[k] for k in kernels) < 1 \
            or row["op_calls"][A2A_OP] != expect:
        emit(row)
        raise AssertionError(f"{label}: the distributed path differs from "
                             "the one-device path, or took another route")
    return row, launches, kept


def distributed_analytics(torch, np, ops, dev, res, degrees: dict) -> dict:
    """degree_counts_sharded, edge_count_sharded and max_degree_sharded on
    the rank's share of the sharded run ``res``, through the group, with
    the launch counts set to 0 just before them and read just after: equal
    to phase 4's degree counts, the run's emitted edges and their max."""
    from repro_torch.core import distributed_analysis as da
    edges, topo = res.edges, res.plan.topology
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deg = da.degree_counts_sharded(edges, topology=topo)
    count = da.edge_count_sharded(edges, topology=topo)
    top = da.max_degree_sharded(edges, topology=topo)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    got = array_sha256(np, "<i4", deg.cpu().numpy())
    row = {"phase": "distributed", "case": "g_analytics_flat1",
           "topology": topo.label, "launches": launches, "wall_s": wall,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "degree_counts_sha256": got,
           "matches_host_path_degree_counts": got == degrees["sha256"],
           "edge_count": count, "emitted_edges": res.stats.emitted_edges,
           "max_degree": top, "host_path_max_degree": degrees["max"]}
    emit(row)
    del edges, deg
    torch.cuda.empty_cache()
    if got != degrees["sha256"] or count != row["emitted_edges"] or \
            top != degrees["max"] or launches["histogram"] != 2:
        raise AssertionError("sharded analytics differ from the host path's "
                             "or took another route")
    return launches


def distributed_shards(torch, api, ops, edge_digest, dev) -> dict:
    """The stream's shard sink through the group, at reduced depth
    (preset hub_stress on flat(1)): rank 0 gathers and writes each block;
    read back, resumed after two blocks are dropped, against the same
    spec's memory digest."""
    spec = api.preset("hub_stress", execution="streamed",
                      topology=api.Topology.flat(1))
    res = api.generate(spec)
    digest = edge_digest(res.edges.src, res.edges.dst)
    del res
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_shards_")
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sres = api.generate(spec.replace(sink="shards", out_dir=out_dir))
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        row = {"phase": "distributed", "case": "f_shard_sink_hub_stress",
               "executor": sres.plan.executor,
               "num_shards": sres.manifest["num_shards"],
               "dropped_edges": sres.stats.dropped_edges, "wall_s": wall,
               "launches": launches, "memory_sha256": digest}
        row.update(resume_check(torch, api, edge_digest, spec, dev,
                                out_dir, digest))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit(row)
    if sres.plan.executor != "pba_stream_sharded" or \
            launches["band_compact"] != sres.manifest["num_shards"]:
        raise AssertionError("shard sink through the group took another "
                             "route")
    return launches


# --- phase 8: the LM serving path --------------------------------------------------

LM_ARCHS = ("qwen1.5-0.5b", "stablelm-1.6b", "phi3-medium-14b",
            "phi-3-vision-4.2b", "llama4-scout-17b-a16e",
            "qwen3-moe-235b-a22b", "minicpm3-4b", "mamba2-130m",
            "recurrentgemma-2b", "whisper-medium")
LM_SEED = 0                 # convert.numpy_params' seed and the workloads'
LM_TOP = 8                  # a logits row is kept as its top 8 ids and values
LM_DECODE_STEPS = 3         # decode steps after the logit record's prefill
LM_LOGIT_BATCH = (2, 20)    # the logit record's batch and prompt length
# The reduced entries' Engine workload: 6 requests of prompts 16-24 tokens
# long on 2 slots, 8 new tokens each; the full-width entries' is
# launch/serve.py's default (6 requests, 2 slots, 24-token prompts, 16 new).
# The encoder-decoder's entries have no Engine completions: its Engine, as
# the JAX package's, passes tokens only.
LM_REDUCED_WORKLOAD = {"requests": 6, "slots": 2, "prompt_lens": [16, 24],
                       "new_tokens": 8}
LM_FULL_WORKLOAD = {"requests": 6, "slots": 2, "prompt_lens": [24, 24],
                    "new_tokens": 16}
# The full-width entries: each config at its published widths, its depth
# cut for the JAX package's reference, which is made on a CPU in float32:
# qwen1.5-0.5b 24 -> 2 layers (phase 8 runs all 24 against the port on the
# host); llama4-scout 48 -> 1 (one chunked layer: 16 experts and the shared
# one, 4.3B parameters, 17 GB); qwen3-moe 94 -> 1 (128 experts, top 8,
# 3.7B, 15 GB); minicpm3 62 -> 2; mamba2-130m whole; recurrentgemma 26 -> 3
# (one rec, rec, local period, 1.6B); whisper 24 + 24 -> 2 decoder and 2
# encoder layers (encoder_len 1500 kept).
LM_FULL_LAYERS = {"qwen1.5-0.5b": 2, "llama4-scout-17b-a16e": 1,
                  "qwen3-moe-235b-a22b": 1, "minicpm3-4b": 2,
                  "mamba2-130m": 24, "recurrentgemma-2b": 3,
                  "whisper-medium": 2}
LM_FULL_ENCODER_LAYERS = 2
LM_CARD_RTOL = 1e-3         # float32 logits on the card against a reference
LM_CARD_ATOL = 1e-3
LM_MARGIN = 1e-3            # a token chosen by a smaller top-2 margin, and the
                            # rest of its completion, is not compared
# The proposed serving cells: batch 8, 512-token prompts, 128 new tokens;
# the Engine serves 16 such requests over 8 slots. The other families' runs
# decode 32 new tokens, and llama4-scout and qwen3-moe (215 and 470 GB in
# bf16) run 8 of their layers (~39 and ~42 GB; llama4's two chunked x 3 +
# global periods). Their weights come from the port's init with stacked
# matrices rescaled to one layer's fan-in (lm_layer_fan_in): under the
# reference init a 26-layer recurrentgemma at width 2560 is chaotic even
# in float32 (its decode and teacher-forced pass differ by a relative L2
# of 0.74), so no serving contract could be held. The port is not at
# fault there: at width 512 with 26 layers both packages run wholly in
# float64 agree within 1e-8, while each package's float32 run is 0.067
# from its own float64 one (tests/test_torch_lm_models.py's float64
# witness).
LM_CELL = {"batch": 8, "prompt": 512, "new_tokens": 128, "requests": 16}
LM_CELL_ARCHS = ("qwen1.5-0.5b", "phi3-medium-14b")
LM_MIXER_ARCHS = ("llama4-scout-17b-a16e", "qwen3-moe-235b-a22b",
                  "minicpm3-4b", "mamba2-130m", "recurrentgemma-2b",
                  "whisper-medium")
LM_MIXER_NEW_TOKENS = 32
LM_CELL_LAYERS = {"llama4-scout-17b-a16e": 8, "qwen3-moe-235b-a22b": 8}
# phi3's Engine run would add ~40 s; whisper has no Engine path.
LM_ENGINE_ARCHS = ("qwen1.5-0.5b",) + LM_MIXER_ARCHS[:-1]
LM_PRECISION_ARCHS = ("minicpm3-4b", "mamba2-130m", "recurrentgemma-2b",
                      "whisper-medium")
LM_BF16_UNFAITHFUL = ("mamba2-130m",)
QWEN_PARAMS = 463_987_712   # count_params() of qwen1.5-0.5b (JAX package)
# Teacher forcing at full width: each decode step's logits (and the
# prefill's last) against the teacher-forced pass's at the same position.
# bf16: relative L2 error at most 2^-2. The two paths' products run
# through other GEMM kernels (M = 8 against M = 8 x 640), so their bf16
# roundings differ, and the reference's init (a stacked leaf at
# 1/sqrt(depth)) makes scores O(1e2) and softmaxes near one-hot, which
# carries one rounding through the stack; logits of unrelated positions
# differ by a relative L2 of ~1.4 (reported), which a cache written at the
# wrong position would give. An MoE prefill that drops assignments for
# want of capacity (its per-row capacity is cf * s * k / E, so a 512-token
# prompt at cf 1.25 overflows its busiest experts) is not the sum of its
# decode steps, which drop none: the bound applies to an MoE run only if
# its prefill and teacher-forced pass dropped no assignment (both counts
# printed). Nor does it apply to LM_BF16_UNFAITHFUL, whose bf16 path is
# not faithful to its float32 one by the reference's design: mamba2's SSD
# takes dt * a in bf16 before its 256-token chunk sums (ssm.py:151), and
# its bf16 teacher-forced pass reads 1.1-1.2 from float32 on an H100
# (PERF.md).
# At the port's init a deep stack's logits move little from one position
# to the next (minicpm3, recurrentgemma, whisper: 0.02-0.05 on an H100),
# below 2^-2, so each step must also be nearer the logits it is held to than
# those one position on: its gap at most LM_NEAR_SHARE of that reading
# (lm_step_gap; sound runs read 0.04-0.40 of it for the teacher gap,
# 0.28-0.74 for bf16 against float32). LM_PRECISION_ARCHS (whose float32
# copy fits beside the bf16 one) also run the same weights in float32:
# the bf16 prefill and decode steps are held to the float32 ones on the
# same tokens, and the bf16 teacher-forced pass to the float32 one, each
# by both bounds (all but LM_BF16_UNFAITHFUL). float32 (a short run,
# weights drawn in float32): tests/test_serve.py's rtol = atol = 2e-3
# per element; LM_CELL_ARCHS and LM_PRECISION_ARCHS run it.
LM_BF16_REL_L2 = 2.0 ** -2
LM_NEAR_SHARE = 0.85
LM_F32_TOL = 2e-3
LM_F32_TEACHER = {"batch": 2, "prompt": 64, "new_tokens": 16}


def lm_config(get_config, arch: str, width: str):
    """The config of a reference case: ``reduced()``, or ``full_width``
    (the full config with its depth cut to LM_FULL_LAYERS[arch], and an
    encoder's to LM_FULL_ENCODER_LAYERS)."""
    cfg = get_config(arch)
    if width == "reduced":
        return cfg.reduced()
    changes = {"num_layers": LM_FULL_LAYERS[arch]}
    if cfg.encoder_layers:
        changes["encoder_layers"] = LM_FULL_ENCODER_LAYERS
    return dataclasses.replace(cfg, **changes)


def lm_serves_engine(cfg) -> bool:
    """Whether the Engine (tokens only) can serve ``cfg``."""
    return cfg.family != "audio"


def lm_requests(np, vocab: int, workload: dict, seed: int) -> list:
    """(rid, prompt, max_new_tokens) of a workload, drawn from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    lo, hi = workload["prompt_lens"]
    lens = rng.integers(lo, hi + 1, workload["requests"])
    return [(i, rng.integers(0, vocab, int(n)).astype(np.int32),
             workload["new_tokens"]) for i, n in enumerate(lens)]


def lm_max_len(workload: dict) -> int:
    return workload["prompt_lens"][1] + workload["new_tokens"]


def lm_logit_inputs(np, cfg, seed: int):
    """The logit record's tokens, (b, s + LM_DECODE_STEPS): a prompt and the
    tokens each decode step feeds; and the prompt's other inputs, float32:
    image embeddings (b, num_patches, d_model) for a vision config, frames
    (b, encoder_len, d_model) for the encoder-decoder."""
    rng = np.random.default_rng(seed + 1)
    b, s = LM_LOGIT_BATCH
    tokens = rng.integers(0, cfg.vocab_size, (b, s + LM_DECODE_STEPS))
    extras = {}
    if cfg.num_patches:
        extras["image_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model), dtype=np.float32)
    if cfg.family == "audio":
        extras["frames"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model), dtype=np.float32)
    return tokens, extras


def lm_waves(requests: list, slots: int, max_len: int) -> list:
    """The Engine's waves: for each, its (rid, slot) pairs (idle slots,
    which replay slot 0, left out) and the tokens it decodes."""
    plen = max(len(p) for _, p, _ in requests)
    waves = []
    for w in range(0, len(requests), slots):
        wave = requests[w:w + slots]
        steps = min(max(n for _, _, n in wave), max_len - plen)
        waves.append(([(rid, i) for i, (rid, _, _) in enumerate(wave)],
                      steps))
    return waves


def lm_token_margins(np, requests, slots, max_len, call_margins) -> dict:
    """rid -> the top-2 margin of the logits that chose each of its tokens,
    from the Engine's step calls' margins in call order (a wave: its
    prefill, then one decode per token; the last decode's is unused)."""
    out, call = {}, 0
    for pairs, steps in lm_waves(requests, slots, max_len):
        for rid, slot in pairs:
            out[rid] = [float(call_margins[call + t][slot])
                        for t in range(steps)]
        call += steps + 1
    return out


def lm_step_record(np, logits) -> dict:
    """One step's last-position logits (b, V) float: each row's top
    LM_TOP ids and values, the float64 sum, the least top-2 margin."""
    logits = np.asarray(logits, np.float32)
    ids = np.argsort(-logits, axis=-1, kind="stable")[:, :LM_TOP]
    vals = np.take_along_axis(logits, ids, axis=-1)
    return {"top_ids": ids.tolist(), "top_values": vals.tolist(),
            "sum": float(logits.astype(np.float64).sum()),
            "top2_margin": float((vals[:, 0] - vals[:, 1]).min())}


def lm_record(np, completions, margins: dict, step_logits,
              router_margin=None) -> dict:
    """A reference case: the Engine's completions ([rid, tokens] in finish
    order), each token's top-2 margin, the logit record's steps, and for
    MoE the least router margin of the case."""
    out = {"completions": [[int(rid), [int(t) for t in toks]]
                           for rid, toks in completions],
           "token_margins": {str(rid): m for rid, m in margins.items()},
           "logits": [lm_step_record(np, lg) for lg in step_logits]}
    if router_margin is not None:
        out["least_router_margin"] = float(router_margin)
    return out


def lm_compared_tokens(margins: list) -> int:
    """How many leading tokens of a completion are compared: those before
    the first token chosen by a top-2 margin under LM_MARGIN."""
    for t, m in enumerate(margins):
        if m < LM_MARGIN:
            return t
    return len(margins)


def lm_mismatches(np, completions, step_logits, want: dict, rtol: float,
                  atol: float) -> list:
    """Where a port run (completions, full last-position logits per step)
    differs from a record: the finish order; each completion's tokens
    before its first small margin (the record's); per step, the logits at
    the record's top ids within ``rtol``/``atol``, their sum within
    sqrt(n) times that, and the top-1 id where the record's margin exceeds
    twice the tolerance."""
    bad = []
    got = {int(rid): [int(t) for t in toks] for rid, toks in completions}
    if [int(rid) for rid, _ in completions] != \
            [rid for rid, _ in want["completions"]]:
        bad.append("finish order")
    for rid, toks in want["completions"]:
        n = lm_compared_tokens(want["token_margins"][str(rid)])
        if got.get(rid, [])[:n] != toks[:n] or \
                len(got.get(rid, [])) != len(toks):
            bad.append(f"completion {rid}")
    for i, (lg, w) in enumerate(zip(step_logits, want["logits"])):
        lg = np.asarray(lg, np.float32)
        ids = np.asarray(w["top_ids"])
        vals = np.take_along_axis(lg, ids, axis=-1)
        want_vals = np.asarray(w["top_values"], np.float32)
        if not np.allclose(vals, want_vals, rtol=rtol, atol=atol):
            bad.append(f"step {i} top values")
        clear = want_vals[:, 0] - want_vals[:, 1] > \
            2 * (atol + rtol * np.abs(want_vals[:, 0]))
        if (lg.argmax(axis=-1) != ids[:, 0])[clear].any():
            bad.append(f"step {i} top id")
        # the sum of n values each off by up to atol + rtol |x| in
        # independent directions: sqrt(n) (atol + rtol rms(x))
        total = float(lg.astype(np.float64).sum())
        rms = float(np.sqrt(np.mean(np.square(lg, dtype=np.float64))))
        if abs(total - w["sum"]) > math.sqrt(lg.size) * (atol + rtol * rms):
            bad.append(f"step {i} sum")
    if len(step_logits) != len(want["logits"]):
        bad.append("steps")
    return bad


@contextlib.contextmanager
def lm_moe_calls(measure):
    """In the block, ``measure(cfg, p, x)`` of each MoE layer call is
    appended to the yielded list."""
    from repro_torch.models import moe
    seen, apply = [], moe.apply_moe

    def measured(cfg, p, x):
        seen.append(measure(cfg, p, x))
        return apply(cfg, p, x)

    moe.apply_moe = measured
    try:
        yield seen
    finally:
        moe.apply_moe = apply


def lm_router_margin(cfg, p, x) -> float:
    """The least router margin of an MoE call over its tokens: the k-th
    routing probability minus the (k+1)-th (a near-tie can pick other
    experts on another device)."""
    from repro_torch.models import moe
    top = moe.route(cfg, p, x)[0].topk(cfg.top_k + 1, dim=-1).values
    return float((top[..., -2] - top[..., -1]).min())


def lm_port_outputs(torch, np, model, workload: dict, seed: int):
    """The port's side of a reference case on ``model``'s device: the
    Engine's completions on the workload with each token's top-2 margin
    (none for a config the Engine cannot serve), the logit record's
    last-position logits (prefill, then LM_DECODE_STEPS decode steps) as
    float32 numpy, and the least router margin of it all (None without
    MoE)."""
    from repro_torch.serve import Engine, Request
    cfg, dev = model.cfg, model.device
    completions, margins = [], {}
    with lm_moe_calls(lm_router_margin) as routed:
        if lm_serves_engine(cfg):
            reqs = lm_requests(np, cfg.vocab_size, workload, seed)
            max_len = lm_max_len(workload)
            engine = Engine(model, batch_size=workload["slots"],
                            max_len=max_len, device=dev)
            calls = []
            prefill, decode = engine._prefill, engine._decode

            def margin(logits):
                top = logits[:, -1].float().topk(2, dim=-1).values
                calls.append(top[:, 0] - top[:, 1])
                return logits

            engine._prefill = lambda batch: (lambda lg, c: (margin(lg), c))(
                *prefill(batch))
            engine._decode = lambda tok, caches, pos: (lambda lg, c: (
                margin(lg), c))(*decode(tok, caches, pos))
            done = engine.run([Request(rid, p, n) for rid, p, n in reqs])
            completions = [(c.rid, c.tokens) for c in done]
            margins = lm_token_margins(np, reqs, workload["slots"], max_len,
                                       [m.cpu().numpy() for m in calls])

        tokens, extras = lm_logit_inputs(np, cfg, seed)
        s = LM_LOGIT_BATCH[1]
        toks = torch.from_numpy(tokens).to(dev)
        batch = {"tokens": toks[:, :s],
                 **{k: torch.from_numpy(v).to(dev) for k, v in extras.items()}}
        logits, caches = model.prefill(batch, max_len=s + LM_DECODE_STEPS)
        steps = [logits[:, -1]]
        for i in range(LM_DECODE_STEPS):
            logits, caches = model.decode_step(toks[:, s + i:s + i + 1],
                                               caches, s + i)
            steps.append(logits[:, -1])
    return (completions, margins, [x.float().cpu().numpy() for x in steps],
            min(routed) if routed else None)


def lm_layer_fan_in(model, tree=None):
    """``tree`` (``model``'s numpy tree from convert.numpy_params, or by
    default ``model.tree`` after Model.init) with each stacked matrix,
    drawn by the reference init at 1/sqrt(depth), rescaled in place to
    one layer's fan-in (1/sqrt of its second dimension). Returns it."""
    from repro_torch.models.layers import tree_leaves
    tree = model.tree if tree is None else tree
    for spec, leaf in zip(tree_leaves(model.param_specs()),
                          tree_leaves(tree)):
        if spec.init == "fan_in" and spec.axes[0] == "layers" \
                and len(spec.shape) >= 3:
            leaf *= math.sqrt(spec.shape[0] / spec.shape[1])
    return tree


def lm_reference_params(convert, model, seed: int = LM_SEED) -> dict:
    """The numpy tree every reference case is drawn with: stacked
    matrices at one layer's fan-in (lm_layer_fan_in). At the reference
    init's 1/sqrt(depth) the residual stream of a shallow stack grows to
    ~1e3, and two correct float32 implementations differ by up to 4e-5
    in the logits (the order of a matrix product's sums, amplified), past
    the CPU tests' 1e-5; at one layer's fan-in they agree within 1.2e-6."""
    return lm_layer_fan_in(model, convert.numpy_params(model, seed))


def lm_reference_checks(torch, np, dev) -> None:
    """Every case of reference_lm.json (the JAX package's, float32) on the
    card in float32, and qwen1.5-0.5b's full 24 layers on the card against
    the port on the host's CPU (launch/serve.py's workload)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the float32 checks "
                             "need them off (PyTorch's default)")
    with open(os.path.join(HERE, "src", "repro_torch",
                           "reference_lm.json")) as f:
        ref = json.load(f)
    for name, case in sorted(ref["cases"].items()):
        t0 = time.perf_counter()
        cfg = lm_config(get_config, case["arch"], case["width"])
        model = build_model(cfg, compute_dtype=torch.float32, device=dev)
        tree = lm_reference_params(convert, model)
        t_draw = time.perf_counter()
        convert.params_from_numpy(model, tree)
        del tree
        torch.cuda.synchronize()
        t_load = time.perf_counter()
        comps, _, logits, routed = lm_port_outputs(torch, np, model,
                                                   case["workload"], LM_SEED)
        bad = lm_mismatches(np, comps, logits, case, LM_CARD_RTOL,
                            LM_CARD_ATOL)
        row = {"phase": "lm_reference", "case": name, "arch": case["arch"],
               "width": case["width"], "num_layers": cfg.num_layers,
               "params": model.count_params(), "rtol": LM_CARD_RTOL,
               "atol": LM_CARD_ATOL, "mismatches": bad,
               "compared_tokens": {
                   rid: lm_compared_tokens(m)
                   for rid, m in case["token_margins"].items()},
               "least_token_margin": min(
                   (min(m) for m in case["token_margins"].values() if m),
                   default=None),
               "draw_s": t_draw - t0, "load_s": t_load - t_draw,
               "wall_s": time.perf_counter() - t0}
        if cfg.encoder_layers:
            row["encoder_layers"] = cfg.encoder_layers
        if routed is not None:
            row["least_router_margin"] = {
                "card": routed, "reference": case["least_router_margin"]}
        emit(row)
        if bad:
            raise AssertionError(f"{name}: the card's serving path differs "
                                 f"from the JAX package's: {bad}")
        del model
        torch.cuda.empty_cache()
    # All 24 layers at full width: the card against the port on the CPU.
    t0 = time.perf_counter()
    cfg = get_config("qwen1.5-0.5b")
    host = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    tree = convert.numpy_params(host, LM_SEED)
    convert.params_from_numpy(host, tree)
    card = convert.params_from_numpy(
        build_model(cfg, compute_dtype=torch.float32, device=dev), tree)
    del tree
    t_host = time.perf_counter()
    want = lm_record(np, *lm_port_outputs(torch, np, host, LM_FULL_WORKLOAD,
                                          LM_SEED))
    t_card = time.perf_counter()
    comps, _, logits, _ = lm_port_outputs(torch, np, card, LM_FULL_WORKLOAD,
                                          LM_SEED)
    bad = lm_mismatches(np, comps, logits, want, LM_CARD_RTOL, LM_CARD_ATOL)
    emit({"phase": "lm_reference", "case": "qwen1.5-0.5b full config",
          "reference": "the port on the host CPU, float32",
          "num_layers": cfg.num_layers, "params": card.count_params(),
          "rtol": LM_CARD_RTOL, "atol": LM_CARD_ATOL, "mismatches": bad,
          "least_token_margin": min(min(m) for m in
                                    want["token_margins"].values()),
          "completions": want["completions"][:2],
          "setup_s": t_host - t0, "host_s": t_card - t_host,
          "card_s": time.perf_counter() - t_card})
    if bad:
        raise AssertionError(f"qwen1.5-0.5b at full config: the card "
                             f"differs from the CPU: {bad}")
    del host, card
    torch.cuda.empty_cache()


def lm_cell(torch, np, dev, arch: str) -> dict:
    """One serving run at full width in bf16 (LM_CELL_LAYERS cuts an MoE
    config's depth), weights from the port's own init (a torch.Generator
    on the card seeded LM_SEED): prefill of LM_CELL's batch (with its
    frames for the encoder-decoder, whose encoder is also timed apart),
    its decode steps teacher-forced (each step's logits against the
    teacher-forced pass at the same position, LM_BF16_REL_L2, for MoE only
    where no assignment was dropped, not for LM_BF16_UNFAITHFUL), then
    (LM_ENGINE_ARCHS) the Engine on LM_CELL's requests; each with its
    wall, peak device memory and a profiled run's idle share. Then
    (LM_PRECISION_ARCHS) the bf16 prefill and decode steps, and the bf16
    teacher-forced pass, against the same weights' in float32 (lm_step_gap,
    lm_near, not for LM_BF16_UNFAITHFUL), and (LM_CELL_ARCHS,
    LM_PRECISION_ARCHS) the teacher forcing again in float32
    (teacher_forcing_f32)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe
    from repro_torch.serve import Engine, Request

    t_cell = time.perf_counter()
    cfg = get_config(arch)
    b, s = LM_CELL["batch"], LM_CELL["prompt"]
    n = LM_CELL["new_tokens"] if arch in LM_CELL_ARCHS \
        else LM_MIXER_NEW_TOKENS
    layer_fan_in = arch in LM_MIXER_ARCHS
    row = {"phase": "lm_serve", "arch": arch, "dtype": "bfloat16", **LM_CELL,
           "new_tokens": n}
    if arch in LM_CELL_LAYERS:
        row["reduced"] = f"num_layers {cfg.num_layers} -> " \
                         f"{LM_CELL_LAYERS[arch]}"
        cfg = dataclasses.replace(cfg, num_layers=LM_CELL_LAYERS[arch])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(LM_SEED))
    if layer_fan_in:
        lm_layer_fan_in(model)
    torch.cuda.synchronize()
    row["init_s"] = time.perf_counter() - t0
    row["layer_fan_in"] = layer_fan_in
    row["params"] = model.count_params()
    row["params_held"] = model.count_params(model.tree)
    row["weight_bytes"] = sum(t.numel() * t.element_size()
                              for t in model.parameters())
    if row["params_held"] != row["params"] or (
            arch == "qwen1.5-0.5b" and row["params"] != QWEN_PARAMS):
        raise AssertionError(f"{arch}: {row['params_held']} parameters held,"
                             f" {row['params']} specified")
    rng = np.random.default_rng(LM_SEED)
    tokens = torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (b, s + n))).to(dev)
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model), dtype=np.float32)).to(dev)
    prompt = {"tokens": tokens[:, :s], **extras}

    def measured(label, fn, profile_fn_=None):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        row[label] = {"wall_s": time.perf_counter() - t,
                      "peak_allocated_bytes":
                      torch.cuda.max_memory_allocated(dev)}
        if profile_fn_ is not None:
            prof = profile_fn(torch, profile_fn_)
            row[label]["idle_share"] = prof["device_idle_share_of_wall"]
            row[label]["profiled_wall_s"] = prof["wall_s"]
            row[label]["device_busy_s"] = prof["kernels_busy_s"]
            row[label]["top_device_ops"] = prof["top_device_ops"][:6]
        return out

    # prefill: CUDA-event median, then one measured and profiled run
    row["prefill_ms"] = time_ms(torch, lambda: model.prefill(
        prompt, max_len=s + n), reps=5, warmup=1)
    if extras:
        row["encoder_ms"] = time_ms(torch, lambda: model.encode(prompt),
                                    reps=5, warmup=1)
    logits0, caches = measured("prefill", lambda: model.prefill(
        prompt, max_len=s + n), lambda: model.prefill(prompt, max_len=s + n))

    def decode_all():
        out = []
        c = caches
        for i in range(n):
            lg, c = model.decode_step(tokens[:, s + i:s + i + 1], c, s + i)
            out.append(lg[:, 0])
        return out

    def decode_8():
        c = caches
        for i in range(min(8, n)):
            _, c = model.decode_step(tokens[:, s + i:s + i + 1], c, s + i)

    decoded = measured("decode", decode_all, decode_8)
    row["decode"]["profiled_steps"] = min(8, n)
    row["bounds"] = lm_bounds(model, b, s, s + n)
    row["decode_ms_per_step"] = row["decode"]["wall_s"] / n * 1e3
    row["decode_tokens_per_s"] = b * n / row["decode"]["wall_s"]
    # the serving contract: decode = the teacher-forced pass
    full_batch = {"tokens": tokens, **extras}
    full = measured("teacher_forced", lambda: model(full_batch))
    gap = teacher_gap(torch, full, s, logits0, decoded)
    gap["steps"] = lm_step_gap(torch, torch.stack(
        [logits0[:, 0]] + decoded, 1), full[:, s - 1:])
    applies = arch not in LM_BF16_UNFAITHFUL
    if arch in LM_PRECISION_ARCHS:
        # the same draws in float32 (the init rounds a float32 draw): its
        # prefill and decode steps on the same tokens, and its teacher-
        # forced pass
        model32 = build_model(cfg, compute_dtype=torch.float32,
                              device=dev).init(
            torch.Generator(dev).manual_seed(LM_SEED))
        lm_layer_fan_in(model32)
        first32, c32 = model32.prefill(prompt, max_len=s + n)
        steps32 = [first32[:, 0]]
        for i in range(n):
            lg, c32 = model32.decode_step(tokens[:, s + i:s + i + 1], c32,
                                          s + i)
            steps32.append(lg[:, 0])
        del c32
        row["bf16_vs_float32"] = {
            "decode": lm_step_gap(torch, torch.stack(
                [logits0[:, 0]] + decoded, 1), torch.stack(steps32, 1)),
            "teacher_forced": lm_step_gap(
                torch, full[:, s - 1:], model32(full_batch)[:, s - 1:]),
            "tolerance_rel_l2": LM_BF16_REL_L2,
            "tolerance_share": LM_NEAR_SHARE, "bound_applies": applies}
        del first32, steps32
        model32_row = teacher_forcing_f32(torch, np, dev, arch, model32)
        del model32
        torch.cuda.empty_cache()
    if cfg.moe:
        # each pass again with its dropped assignments counted
        dropped = {}
        for label, fn in (("prefill", lambda: model.prefill(
                prompt, max_len=s + n)), ("decode_8_steps", decode_8),
                ("teacher_forced", lambda: model(full_batch))):
            with lm_moe_calls(moe.dropped_assignments) as drops:
                fn()
            dropped[label] = sum(drops)
        gap["dropped_assignments"] = dropped
        applies = dropped["prefill"] == 0 and dropped["teacher_forced"] == 0
    row["teacher_forcing"] = {**gap, "tolerance_rel_l2": LM_BF16_REL_L2,
                              "tolerance_share": LM_NEAR_SHARE,
                              "bound_applies": applies}
    del full, decoded, logits0, caches
    # the Engine (profiled on one wave of 16 new tokens)
    if arch in LM_ENGINE_ARCHS:
        reqs = [Request(i, rng.integers(0, model.cfg.vocab_size, s).astype(
            np.int32), n) for i in range(LM_CELL["requests"])]
        engine = Engine(model, batch_size=b, max_len=s + n, device=dev)
        short = [Request(r.rid, r.prompt, 16) for r in reqs[:b]]
        done = measured("engine", lambda: engine.run(reqs),
                        lambda: engine.run(short))
        emitted = sum(len(c.tokens) for c in done)
        row["engine"]["tokens"] = emitted
        row["engine"]["tokens_per_s"] = emitted / row["engine"]["wall_s"]
        row["engine"]["profiled"] = \
            f"{b} requests of 16 new tokens (one wave)"
        del engine
        if sorted(c.rid for c in done) != list(range(LM_CELL["requests"])) \
                or emitted != LM_CELL["requests"] * n:
            raise AssertionError(f"{arch}: the Engine served {emitted} "
                                 f"tokens to {len(done)} requests")
    del model
    torch.cuda.empty_cache()
    if arch in LM_PRECISION_ARCHS:
        row["teacher_forcing_float32"] = model32_row
    if arch in LM_CELL_ARCHS:
        row["teacher_forcing_float32"] = teacher_forcing_f32(torch, np, dev,
                                                             arch)
    row["wall_s"] = time.perf_counter() - t_cell
    emit(row)
    if (applies and not lm_near(row["teacher_forcing"]["steps"])) \
            or not row.get("teacher_forcing_float32",
                           {"within_tolerance": True})["within_tolerance"]:
        raise AssertionError(f"{arch}: decode differs from the teacher-"
                             f"forced pass: {row['teacher_forcing']}, "
                             f"{row.get('teacher_forcing_float32')}")
    precision = row.get("bf16_vs_float32")
    if precision and applies and not (lm_near(precision["decode"]) and
                                      lm_near(precision["teacher_forced"])):
        raise AssertionError(f"{arch}: the bf16 serving path differs from "
                             f"the same weights in float32: {precision}")
    return row


def lm_near(gap: dict) -> bool:
    """An lm_step_gap within LM_BF16_REL_L2 and LM_NEAR_SHARE."""
    return gap["rel_l2_max"] <= LM_BF16_REL_L2 and \
        gap["share"] <= LM_NEAR_SHARE


def lm_step_gap(torch, got, want) -> dict:
    """Logits ``got`` against ``want`` (B, T, V) at T positions: the
    largest relative L2 (over batch and vocab) of a position; the least of
    got at one position against want at the next, what a cache one slot
    off would read (a deep stack at the port's init moves its logits by
    only 0.02-0.05 from one position to the next); and the share the
    first is of the second."""
    got, want = got.float(), want.float()

    def rel(g, w):
        return (g - w).norm(dim=(0, 2)) / w.norm(dim=(0, 2))

    near = rel(got, want)
    if not bool(near.isfinite().all()):
        raise AssertionError("non-finite logits")
    out = {"rel_l2_max": float(near.max()),
           "unrelated_rel_l2_min": float(rel(got[:, :-1], want[:, 1:]).min())}
    out["share"] = out["rel_l2_max"] / out["unrelated_rel_l2_min"] \
        if out["unrelated_rel_l2_min"] else math.inf
    return out


def lm_bounds(model, b: int, s: int, max_len: int) -> dict:
    """The least times of a serving cell's steps on an H100, from its
    shapes. A decode step reads every weight it uses (all but an encoder's:
    an MoE decode step multiplies every expert) and the whole cache once
    (bytes over the memory rate). For the dense GQA families, a prefill of
    (b, s) tokens multiplies each weight outside the embedding table by
    each token (2 flops, bf16 tensor cores), and takes every score and PV
    product of its (s, s) attention in float32 (the plain path computes
    the masked half too), plus the last position's logits; the other
    families' prefill bound is not computed."""
    cfg = model.cfg
    weight_bytes = sum(t.numel() * t.element_size()
                       for name, t in model.named_parameters()
                       if ".encoder." not in name)
    kv_bytes = sum(math.prod(x.shape) * x.dtype.itemsize for x in
                   _tree_leaves(model.cache_structs(b, max_len)))
    out = {"decode_step_bytes": weight_bytes + kv_bytes,
           "decode_step_ms": (weight_bytes + kv_bytes) / HBM_BYTES_PER_S
           * 1e3}
    if cfg.moe or cfg.attention != "gqa" or set(cfg.layer_pattern) - {
            "global", "local", "chunked"} or cfg.encoder_layers:
        return out
    table = cfg.vocab_size * cfg.d_model
    matmul = 2 * (model.count_params() - table *
                  (1 if cfg.tie_embeddings else 2)) * b * s + 2 * table * b
    scores = cfg.num_layers * b * model.heads * s * s * cfg.head_dim * 4
    return {**out, "prefill_bf16_flops": matmul, "prefill_f32_flops": scores,
            "prefill_ms": (matmul / BF16_FLOP_PER_S +
                           scores / F32_FLOP_PER_S) * 1e3}


def _tree_leaves(tree) -> list:
    from repro_torch.models.layers import tree_leaves
    return tree_leaves(tree)


def teacher_gap(torch, full, s: int, first, decoded) -> dict:
    """The relative L2 gap of the prefill's last logits (``first``) and
    each decode step's (``decoded[i]``, fed token s + i) to the teacher-
    forced logits ``full`` (B, S, V) at the same position; beside it the
    gap between two unrelated positions' logits."""
    def rel(got, want):
        return float((got.float() - want.float()).norm() /
                     want.float().norm())
    pairs = [(first[:, 0], full[:, s - 1])] + [
        (d, full[:, s + i]) for i, d in enumerate(decoded)]
    gaps = [rel(g, w) for g, w in pairs]
    if not all(math.isfinite(x) for x in gaps):
        raise AssertionError("non-finite logits")
    return {"rel_l2_max": max(gaps), "rel_l2_mean": statistics.mean(gaps),
            "max_abs_diff": max(float((g.float() - w.float()).abs().max())
                                for g, w in pairs),
            "max_abs_logit": float(full[:, s - 1:].float().abs().max()),
            "unrelated_positions_rel_l2": rel(full[:, s], full[:, s + 1])}


def teacher_forcing_f32(torch, np, dev, arch: str, model=None) -> dict:
    """The serving contract in float32 at full width: LM_F32_TEACHER's
    prompt prefilled, its decode steps teacher-forced, each step's logits
    within LM_F32_TOL (rtol and atol) of the teacher-forced pass. On
    ``model`` if given (float32), else on one drawn by the port's init."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    b, s, n = (LM_F32_TEACHER[k] for k in ("batch", "prompt", "new_tokens"))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if model is None:
        model = build_model(get_config(arch), compute_dtype=torch.float32,
                            device=dev).init(
            torch.Generator(dev).manual_seed(LM_SEED))
    cfg = model.cfg
    rng = np.random.default_rng(LM_SEED + 1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s + n))).to(dev)
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model), dtype=np.float32)).to(dev)
    first, caches = model.prefill({"tokens": tokens[:, :s], **extras},
                                  max_len=s + n)
    decoded = []
    for i in range(n):
        lg, caches = model.decode_step(tokens[:, s + i:s + i + 1], caches,
                                       s + i)
        decoded.append(lg[:, 0])
    full = model({"tokens": tokens, **extras})
    close = all(bool(torch.allclose(g, full[:, s + i], rtol=LM_F32_TOL,
                                    atol=LM_F32_TOL))
                for i, g in enumerate(decoded)) and bool(torch.allclose(
                    first[:, 0], full[:, s - 1], rtol=LM_F32_TOL,
                    atol=LM_F32_TOL))
    out = {**LM_F32_TEACHER, **teacher_gap(torch, full, s, first, decoded),
           "tolerance": LM_F32_TOL, "within_tolerance": close,
           "weight_bytes": sum(t.numel() * t.element_size()
                               for t in model.parameters()),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "wall_s": time.perf_counter() - t0}
    del model, caches, full, decoded
    torch.cuda.empty_cache()
    return out


def lm_serve_phase(torch, np, dev) -> dict:
    """Phase 8: the reference checks, then each serving run; no kernel of
    the port is on this path (the counts are read to show it)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    lm_reference_checks(torch, np, dev)
    cells = {arch: lm_cell(torch, np, dev, arch)
             for arch in LM_CELL_ARCHS + LM_MIXER_ARCHS}
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the LM path launched a graph kernel: "
                             f"{launches}")
    return cells


# --- phase 9: the LM training path -------------------------------------------------

# The walk corpus of launch/train.py (the port's PBA on the card, 8192
# vertices over 8 logical procs, k = 8): building it launches these graph
# kernels (host execution; pk_expand only for a PK corpus).
TRAIN_CORPUS = {"generator": "pba", "num_vertices": 8192, "seed": 0}
TRAIN_CORPUS_KERNELS = ("resolve_roots", "gather", "histogram")
# The reference cases of reference_train.json (made by the JAX package on
# the CPU in float32): each config's reduced() and qwen1.5-0.5b at full
# width with its depth cut (LM_FULL_LAYERS), params from
# lm_reference_params, TRAIN_REF_STEPS AdamW steps on corpus batches of
# (batch, seq), the launcher's audio and vision stubs from default_rng(1).
TRAIN_REF_STEPS = 3
TRAIN_REF_SHAPES = {"reduced": (4, 32), "full_width": (2, 64)}
TRAIN_REF_OPT = {"lr": 1e-3, "warmup_steps": 2}
# Card (float32, TF32 off) against the file. Step 1's loss and grad norm
# come before any update: rtol 1e-4. Steps 2-3 follow updates whose signs
# Adam takes from gradients of any size, so a gradient near 0 that differs
# in sign moves its weight by 2 lr: on the CPU the port's steps 2-3 read
# up to 4.5e-7 (loss) and 3.7e-5 (grad norm) from the JAX package's
# (tests/test_torch_train.py), so steps 2-3 are held at 1e-4 and 1e-3;
# the parameter checksums (float64 sums of magnitudes and of squares of three
# leaves after the last step) at 1e-3.
TRAIN_REF_RTOL = 1e-4
TRAIN_LATER_RTOL = {"loss": 1e-4, "grad_norm": 1e-3}
TRAIN_CHECKSUM_RTOL = 1e-3
# The proposed training cell: qwen1.5-0.5b at full width (24 layers,
# 463,987,712 parameters), float32 masters, bf16 compute, remat "nothing",
# 8 x 512 tokens per step from the card's corpus, TRAIN_CELL["steps"]
# steps (then the profiled ones).
TRAIN_CELL = {"arch": "qwen1.5-0.5b", "batch": 8, "seq": 512, "steps": 10,
              "remat": "nothing"}
TRAIN_CELL_OPT = {"lr": 1e-3, "warmup_steps": 5}
# bf16 against float32 on step 1's weights and batch (train_precision):
# the loss and the grad norm (relative) and the worst leaf's gradient
# (relative L2). Each bound sits between the sound reading and a control
# that a wrong answer would read: the loss of constant logits (ln V; at
# initialisation every loss sits near it, so the loss alone separates
# little), the float32 grad norm and leaf gradients of the next batch. The
# run fails if a control falls within its bound. accum=2 against accum=1:
# step 1's loss and grad norm, relative, bf16. All were predicted in
# PERF.md before their first run on the card.
TRAIN_BF16_LOSS_RTOL = 2.0 ** -14
TRAIN_BF16_GRAD_NORM_RTOL = 2.0 ** -8
TRAIN_BF16_LEAF_REL_L2 = 2.0 ** -4
TRAIN_ACCUM_RTOL = 2.0 ** -8
# Restart-exactness: TRAIN_RESTART_STEPS[0] steps, a checkpoint, a fresh
# model, optimizer and corpus restored from it, TRAIN_RESTART_STEPS[1]
# more steps, against the same steps run straight; bit for bit, under
# torch.use_deterministic_algorithms (the embedding backward and the MoE
# dispatch accumulate with atomics on CUDA otherwise).
TRAIN_RESTART_ARCHS = ("qwen1.5-0.5b", "qwen3-moe-235b-a22b")
TRAIN_RESTART_STEPS = (2, 2)


@contextlib.contextmanager
def env_var(name: str, value: str):
    """The environment variable ``name`` set to ``value`` inside the block,
    restored (or unset) after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def train_corpus(dev, vocab_size: int):
    """launch/train.py's walk corpus for ``vocab_size``, generated on
    ``dev``."""
    from repro_torch.train.data import WalkCorpus, WalkCorpusConfig
    return WalkCorpus(WalkCorpusConfig(vocab_size=vocab_size, **TRAIN_CORPUS),
                      device=dev)


def train_batches(np, corpus, cfg, steps: int, batch: int, seq: int,
                  accum: int = 1) -> list:
    """``steps`` batches from ``corpus`` ((accum, batch // accum, seq)
    numpy leaves), each with launch/train.py's audio and vision stubs drawn
    from default_rng(1) in its order."""
    from repro_torch.train.data import batches
    it = batches(corpus, batch, seq, accum=accum)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(steps):
        b = next(it)
        mb = batch // accum
        if cfg.family == "audio":
            b["frames"] = rng.normal(size=(
                accum, mb, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        if cfg.num_patches:
            b["image_embeds"] = rng.normal(size=(
                accum, mb, cfg.num_patches, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def corpus_sha256(np, batches: list) -> str:
    """sha256 of the batches' tokens and labels (int32, in order)."""
    h = hashlib.sha256()
    for b in batches:
        for k in ("tokens", "labels"):
            h.update(np.ascontiguousarray(b[k], np.int32).tobytes())
    return h.hexdigest()


def train_checksums(np, named: dict) -> dict:
    """{path: [float64 sum of magnitudes, float64 sum of squares]} of
    ``named`` (path -> float array): the embedding, the final norm and the
    tree's last leaf. Not the plain sum, which cancels: Adam's +-lr steps on
    near-zero gradients move it by more than its share."""
    last = sorted(named)[-1]
    out = {}
    for key in ("embed/tok", "final_norm/scale", last):
        a = np.asarray(named[key], np.float64)
        out[key] = [float(np.abs(a).sum()), float(np.square(a).sum())]
    return out


def train_port_record(torch, np, model, tree, batches: list,
                      opt: dict) -> dict:
    """The port's side of a training reference case: ``len(batches)``
    steps of make_train_step from ``tree`` (float32 masters), each step's
    loss, grad norm and lr, the checksums after the last step and, for
    MoE, the least router margin of step 1's forward."""
    from repro_torch.models.layers import tree_leaves, tree_paths
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    params = model.master_params(tree)
    state = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(**opt))
    rec = {"loss": [], "grad_norm": [], "lr": []}
    if model.cfg.moe:
        first = {k: torch.from_numpy(v[0]).to(model.device)
                 for k, v in batches[0].items()}
        with torch.no_grad(), lm_moe_calls(lm_router_margin) as routed:
            model.loss(first, params)
        rec["least_router_margin"] = min(routed)
    for b in batches:
        params, state, m = step(params, state, b)
        for k in ("loss", "grad_norm", "lr"):
            rec[k].append(float(m[k]))
    rec["checksums"] = train_checksums(np, {
        "/".join(map(str, p)): t.detach().cpu().numpy()
        for p, t in zip(tree_paths(params), tree_leaves(params))})
    return rec


def train_mismatches(got: dict, want: dict, rtol: float, later: dict,
                     checksum_rtol: float) -> list:
    """Where ``got`` (train_port_record) leaves ``want`` (a reference
    case): step 1's loss and grad norm past ``rtol``, later steps' past
    ``later[metric]``, the learning rates unequal (past 1e-7), a checksum
    past ``checksum_rtol``."""
    bad = []

    def off(a, b, tol):
        return abs(a - b) > tol * abs(b)
    for k in ("loss", "grad_norm"):
        for i, (a, b) in enumerate(zip(got[k], want[k])):
            if off(a, b, rtol if i == 0 else later[k]):
                bad.append(f"step {i + 1} {k} {a!r} vs {b!r}")
    for i, (a, b) in enumerate(zip(got["lr"], want["lr"])):
        if off(a, b, 1e-7):
            bad.append(f"step {i + 1} lr {a!r} vs {b!r}")
    for key, want_sums in want["checksums"].items():
        got_sums = got["checksums"][key]
        if any(off(a, b, checksum_rtol) for a, b in zip(got_sums, want_sums)):
            bad.append(f"checksum {key} {got_sums} vs {want_sums}")
    return bad


def train_reference_checks(torch, np, dev, corpora: dict) -> list:
    """Every case of reference_train.json on the card in float32 (TF32
    off): the corpus's digest, then the steps against the file's."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the float32 checks "
                             "need them off (PyTorch's default)")
    with open(os.path.join(HERE, "src", "repro_torch",
                           "reference_train.json")) as f:
        ref = json.load(f)
    rows = []
    for name, case in sorted(ref["cases"].items()):
        t0 = time.perf_counter()
        cfg = lm_config(get_config, case["arch"], case["width"])
        if cfg.vocab_size not in corpora:
            corpora[cfg.vocab_size] = train_corpus(dev, cfg.vocab_size)
        corpus = corpora[cfg.vocab_size]
        corpus.restore({"cursor": 0, "seed": TRAIN_CORPUS["seed"]})
        batches = train_batches(np, corpus, cfg, TRAIN_REF_STEPS,
                                case["batch"], case["seq"])
        digest = corpus_sha256(np, batches)
        model = build_model(cfg, compute_dtype=torch.float32, device=dev)
        tree = lm_reference_params(convert, model)
        got = train_port_record(torch, np, model, tree, batches,
                                case["opt"])
        del tree
        bad = train_mismatches(got, case, TRAIN_REF_RTOL, TRAIN_LATER_RTOL,
                               TRAIN_CHECKSUM_RTOL)
        if digest != case["corpus_sha256"]:
            bad.insert(0, f"corpus digest {digest}")
        row = {"phase": "lm_train_reference", "case": name,
               "num_layers": cfg.num_layers, "params": model.count_params(),
               "batch": case["batch"], "seq": case["seq"],
               "loss": got["loss"], "file_loss": case["loss"],
               "grad_norm": got["grad_norm"],
               "file_grad_norm": case["grad_norm"],
               "rtol_step1": TRAIN_REF_RTOL, "rtol_later": TRAIN_LATER_RTOL,
               "mismatches": bad, "wall_s": time.perf_counter() - t0}
        if "least_router_margin" in case:
            row["least_router_margin"] = {
                "card": got["least_router_margin"],
                "reference": case["least_router_margin"]}
        emit(row)
        rows.append(row)
        if bad:
            raise AssertionError(f"{name}: the card's training steps differ "
                                 f"from the JAX package's: {bad}")
        del model
        torch.cuda.empty_cache()
    return rows


def loss_and_grads(torch, model, params, batch: dict) -> tuple:
    """``model.loss`` of ``batch`` (tensors on the card) at a fresh copy of
    the master ``params``, and its float32 gradients, leaf by leaf."""
    from repro_torch.models.layers import tree_leaves
    p = model.master_params(params)
    loss = model.loss(batch, p)
    grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), [g.float() for g in grads]


def train_precision(torch, bf16, f32, params, batch: dict,
                    next_batch: dict) -> dict:
    """The ``bf16`` model's loss, grad norm and leaf gradients at
    ``params`` on ``batch`` against the ``f32`` model's, each beside its
    control (TRAIN_BF16_LOSS_RTOL's comment) and bound: the loss of constant
    logits and the float32 loss, grad norm and gradients of ``next_batch``;
    the leaves' worst reading against the controls' least."""
    from repro_torch.models.layers import tree_paths

    def l2(x):
        return float(torch.linalg.vector_norm(x, dtype=torch.float64))

    def rel(a, b):
        return abs(a - b) / abs(b)
    names = ["/".join(map(str, p)) for p in tree_paths(params)]
    l16, g16 = loss_and_grads(torch, bf16, params, batch)
    l32, g32 = loss_and_grads(torch, f32, params, batch)
    leaf16 = [l2(a - b) / l2(b) for a, b in zip(g16, g32)]
    n16 = math.sqrt(sum(l2(g) ** 2 for g in g16))
    del g16
    n32 = math.sqrt(sum(l2(g) ** 2 for g in g32))
    lnext, gnext = loss_and_grads(torch, f32, params, next_batch)
    leafnext = [l2(a - b) / l2(b) for a, b in zip(gnext, g32)]
    nnext = math.sqrt(sum(l2(g) ** 2 for g in gnext))
    del g32, gnext
    worst = max(range(len(names)), key=leaf16.__getitem__)
    least = min(range(len(names)), key=leafnext.__getitem__)
    return {
        "loss": {"bf16": l16, "float32": l32, "rel": rel(l16, l32),
                 "control_constant_logits": rel(
                     math.log(f32.cfg.vocab_size), l32),
                 "next_batch_rel": rel(lnext, l32),
                 "bound": TRAIN_BF16_LOSS_RTOL},
        "grad_norm": {"bf16": n16, "float32": n32, "rel": rel(n16, n32),
                      "control_next_batch": rel(nnext, n32),
                      "bound": TRAIN_BF16_GRAD_NORM_RTOL},
        "leaf_rel_l2": {"worst": leaf16[worst], "worst_leaf": names[worst],
                        "control_next_batch_least": leafnext[least],
                        "control_least_leaf": names[least],
                        "bound": TRAIN_BF16_LEAF_REL_L2}}


def precision_failures(prec: dict) -> list:
    """Where train_precision's readings pass their bounds, or a control
    falls within its bound (the gate could not fail)."""
    readings = (("loss", "rel", "control_constant_logits"),
                ("grad_norm", "rel", "control_next_batch"),
                ("leaf_rel_l2", "worst", "control_next_batch_least"))
    bad = []
    for name, reading, control in readings:
        r = prec[name]
        if not r[reading] <= r["bound"]:
            bad.append(f"{name} {r[reading]!r} past {r['bound']!r}")
        if not r[control] > r["bound"]:
            bad.append(f"{name}'s control {r[control]!r} within "
                       f"{r['bound']!r}")
    return bad


def train_flops(model, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 N per token (forward and
    backward; remat's recomputed forward not counted) plus attention's
    12 L B S^2 H hd (scores and PV, forward and backward)."""
    cfg = model.cfg
    return 6 * model.count_params() * batch * seq + \
        12 * cfg.num_layers * batch * seq * seq * model.heads * cfg.head_dim


def lm_train_cell(torch, np, dev, corpora: dict) -> dict:
    """TRAIN_CELL at full width: float32 masters drawn by the port's init
    on the card (stacked matrices at one layer's fan-in, lm_layer_fan_in),
    bf16 compute, under the REPRO_REMAT its caller sets (lm_train_phase:
    TRAIN_CELL's); the steps timed one by one, then a profiled step; the
    accum=2 check and train_precision on step 1's weights and batch; and
    the checkpoint round trip of the trained state."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.checkpoint import (latest_checkpoint,
                                              load_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.data import batches as corpus_batches
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                             opt_state_struct)
    from repro_torch.train.train_step import make_train_step

    c = TRAIN_CELL
    cfg = get_config(c["arch"])
    if cfg.vocab_size not in corpora:
        corpora[cfg.vocab_size] = train_corpus(dev, cfg.vocab_size)
    corpus = corpora[cfg.vocab_size]
    model = build_model(cfg, compute_dtype=torch.bfloat16, device=dev)
    if model.count_params() != QWEN_PARAMS:
        raise AssertionError(f"count_params {model.count_params()}")
    t0 = time.perf_counter()
    with torch.no_grad():
        params = lm_layer_fan_in(model, model.master_params(
            generator=torch.Generator(dev).manual_seed(LM_SEED)))
    corpus.restore({"cursor": 0, "seed": TRAIN_CORPUS["seed"]})
    batches = train_batches(np, corpus, cfg, c["steps"], c["batch"],
                            c["seq"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    opt = AdamWConfig(**TRAIN_CELL_OPT)

    # Step 1's weights and batch: with accum = 2, and bf16 against float32.
    first = batches[0]
    half = {k: v.reshape((2, v.shape[1] // 2) + v.shape[2:])
            for k, v in first.items()}
    step = make_train_step(model, opt)
    checks = {}
    for label, b in (("accum1", first), ("accum2", half)):
        p = model.master_params(params)
        _, _, m = step(p, init_opt_state(p), b)
        checks[label] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        del p, m
    f32 = build_model(cfg, compute_dtype=torch.float32, device=dev)
    precision = train_precision(torch, model, f32, params, *(
        {k: torch.from_numpy(v[0]).to(dev) for k, v in b.items()}
        for b in batches[:2]))
    del f32
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    state = init_opt_state(params)
    losses, norms, ms = [], [], []
    for b in batches[:c["steps"]]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated(dev)
    more = corpus_batches(corpus, c["batch"], c["seq"])
    prof = profile_fn(torch, lambda: step(params, state, next(more)))
    runs = prof["profiled_runs"]

    tokens = c["batch"] * c["seq"]
    step_ms = statistics.median(ms[1:])
    flops = train_flops(model, c["batch"], c["seq"])
    a1, a2 = checks["accum1"], checks["accum2"]
    rel = {k: abs(a2[k] - a1[k]) / abs(a1[k]) for k in a1}
    row = {"phase": "lm_train", **c, "params": model.count_params(),
           "opt": TRAIN_CELL_OPT, "compute_dtype": "bfloat16",
           "master_dtype": "float32", "setup_s": setup_s,
           "loss": losses, "grad_norm": norms, "step_ms": ms,
           "step_ms_median": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "peak_allocated_bytes": peak,
           "model_flops_per_step": flops,
           "bf16_peak_share": flops / (step_ms / 1e3 * BF16_FLOP_PER_S),
           "bf16_bound_ms": flops / BF16_FLOP_PER_S * 1e3,
           "profile": {k: prof[k] for k in (
               "wall_s", "profiled_runs", "kernels_busy_s",
               "device_idle_share_of_wall", "top_device_ops")},
           "device_ops_per_step": prof["device_events"] / runs,
           "accum_check": {**checks, "rel": rel, "rtol": TRAIN_ACCUM_RTOL},
           "bf16_vs_float32": precision}

    # The checkpoint round trip of the trained state, bit for bit.
    tmp = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        t1 = time.perf_counter()
        path = save_checkpoint(tmp, c["steps"], params, state,
                               {"data": corpus.state(), "arch": cfg.name})
        save_s = time.perf_counter() - t1
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        t1 = time.perf_counter()
        lp, lstate, man = load_checkpoint(
            latest_checkpoint(tmp), params, opt_state_struct(params), dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params) + tree_leaves(state["m"]) +
            tree_leaves(state["v"]),
            tree_leaves(lp) + tree_leaves(lstate["m"]) +
            tree_leaves(lstate["v"]))) and \
            int(lstate["step"]) == int(state["step"]) and \
            man["step"] == c["steps"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["checkpoint"] = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                         "bit_equal": same}
    emit(row)
    del params, state, lp, lstate
    torch.cuda.empty_cache()

    finite = all(math.isfinite(x) for x in losses + norms)
    if not finite or not losses[-1] < losses[0]:
        raise AssertionError(f"the full-width loss did not descend: "
                             f"{losses}, grad norms {norms}")
    if max(rel.values()) > TRAIN_ACCUM_RTOL:
        raise AssertionError(f"accum=2 differs from accum=1: {checks}")
    bad = precision_failures(precision)
    if bad:
        raise AssertionError(f"bf16 against float32 at step 1: {bad}")
    if not same:
        raise AssertionError("the full-width checkpoint did not round-trip")
    return row


def train_restart_check(torch, np, dev, corpus, arch: str) -> dict:
    """TRAIN_RESTART_STEPS at reduced(): steps run straight against the
    same steps split by a checkpoint, restored into a fresh model,
    optimizer state and corpus; bit for bit, under deterministic
    algorithms."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.checkpoint import (latest_checkpoint,
                                              load_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                             opt_state_struct)
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(arch).reduced()
    opt = AdamWConfig(**TRAIN_REF_OPT)
    n1, n2 = TRAIN_RESTART_STEPS
    b, s = TRAIN_REF_SHAPES["reduced"]
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        def fresh():
            model = build_model(cfg, compute_dtype=torch.float32,
                                device=dev)
            return model, make_train_step(model, opt)

        model, step = fresh()
        tree = lm_reference_params(convert, model)
        corpus.restore({"cursor": 0, "seed": TRAIN_CORPUS["seed"]})
        params = model.master_params(tree)
        state = init_opt_state(params)
        for bt in train_batches(np, corpus, cfg, n1 + n2, b, s):
            params, state, m = step(params, state, bt)
        straight = (float(m["loss"]), tree_leaves(params))

        model, step = fresh()
        corpus.restore({"cursor": 0, "seed": TRAIN_CORPUS["seed"]})
        params = model.master_params(tree)
        state = init_opt_state(params)
        for bt in train_batches(np, corpus, cfg, n1, b, s):
            params, state, m = step(params, state, bt)
        tmp = tempfile.mkdtemp(prefix="train_restart_")
        try:
            save_checkpoint(tmp, n1, params, state, {"data": corpus.state()})
            model, step = fresh()
            second = train_corpus(dev, cfg.vocab_size)
            loaded, state, man = load_checkpoint(
                latest_checkpoint(tmp), params, opt_state_struct(params),
                dev)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        second.restore(man["data"])
        params = model.master_params(loaded)
        # the restored corpus continues where the first left off
        rest = train_batches(np, second, cfg, n2, b, s)
        for bt in rest:
            params, state, m = step(params, state, bt)
        split = (float(m["loss"]), tree_leaves(params))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    same = straight[0] == split[0] and all(
        torch.equal(x, y) for x, y in zip(straight[1], split[1]))
    row = {"phase": "lm_train_restart", "arch": arch, "width": "reduced",
           "steps": [n1, n2], "deterministic_algorithms": True,
           "loss_straight": straight[0], "loss_restarted": split[0],
           "bit_equal": same}
    emit(row)
    if not same:
        raise AssertionError(f"{arch}: a restart from the checkpoint "
                             "differs from the straight run")
    return row


def lm_train_phase(torch, np, dev) -> dict:
    """Phase 9: the walk corpus on the card (its graph kernels' launches
    counted, 0 fallbacks, its digest against reference_train.json), the
    reference cases, the full-width cell and the restart checks."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    corpus = train_corpus(dev, 512)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    row = {"phase": "lm_train_corpus", **TRAIN_CORPUS, "vocab_size": 512,
           "num_vertices_built": corpus.n,
           "dropped_edges": corpus.stats.dropped_edges,
           "fallback_counts": corpus.stats.fallback_counts,
           "fallback_events": ops.fallback_counts(), "launches": launches,
           "wall_s": time.perf_counter() - t0}
    emit(row)
    if corpus.stats.fallback_counts or ops.fallback_counts() or min(
            launches[k] for k in TRAIN_CORPUS_KERNELS) < 1:
        raise AssertionError(f"the corpus build fell back or left a graph "
                             f"kernel unlaunched: {row}")
    corpora = {512: corpus}
    refs = train_reference_checks(torch, np, dev, corpora)
    t1 = time.perf_counter()
    with env_var("REPRO_REMAT", TRAIN_CELL["remat"]):
        cell = lm_train_cell(torch, np, dev, corpora)
    cell["wall_s"] = time.perf_counter() - t1
    restarts = [train_restart_check(torch, np, dev, corpus, arch)
                for arch in TRAIN_RESTART_ARCHS]
    out = {"launches": launches, "reference_cases": len(refs),
           "cell": cell, "restarts": restarts,
           "wall_s": time.perf_counter() - t0}
    emit({"phase": "lm_train_done", "reference_cases": len(refs),
          "wall_s": out["wall_s"]})
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        return fail(f"cannot import numpy/torch: {e}")
    if not torch.cuda.is_available():
        return fail("CUDA is not available: this script runs on a GPU")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        return fail(f"no src/repro_torch beside {__file__}: run it from "
                    "a checkout of the repository")
    sys.path.insert(0, src)
    from repro_torch import api
    from repro_torch.core.graph import edge_digest
    from repro_torch.kernels import _build, dispatch, ops

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = _nvidia_smi()
    print(smi, flush=True)
    t_start = time.perf_counter()
    phase_ends = {}         # seconds from the start to each phase's end

    def phase_done(name: str) -> None:
        phase_ends[name] = time.perf_counter() - t_start

    # 1. toolchain and build
    t0 = time.perf_counter()
    build_s = _build.build()
    build_wall = time.perf_counter() - t0
    emit({"phase": "toolchain", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(dev),
          "nvcc": _nvcc_version(_build.nvcc()), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc_flags": _build.NVCC_FLAGS,
          "build_s": build_s, "build_wall_s": build_wall})
    phase_done("1_toolchain")

    # 2. kernels against their plain versions at the main paths' shapes
    spec = api.preset("paper_1b_5b", procs=PROCS,
                      vertices_per_proc=VERTICES_PER_PROC,
                      execution="host", pair_capacity=PAIR_CAPACITY)
    pl = api.plan(spec, device=dev)
    cases = kernel_cases(torch, np, dev, SEED, pl.num_procs,
                         spec.vertices_per_proc, spec.edges_per_vertex,
                         BLOCK_CAP)
    cases += histogram_uniform_cases(torch, np, dev, SEED, pl.num_procs,
                                     pl.config.edges_per_proc)
    setup = pba_path_setup(torch, pl)
    cases += gather_cases(torch, np, pl, SEED, setup)
    round_path = round_path_cases(torch, pl, setup)
    cases += round_path
    band_runs = next(c["per_run"]["rounds"] for c in round_path
                     if c["kernel"] == "band_compact" and "per_run" in c)
    del setup
    torch.cuda.empty_cache()
    cases += resolve_cases(torch, pl)
    cases += pk_cfree_kernel_cases(torch, dev)
    phase_done("2_kernels")

    # 3. the JAX package's reference digests
    with open(os.path.join(src, "repro_torch",
                           "reference_digests.json")) as f:
        ref_cases = json.load(f)["cases"]
    with open(os.path.join(src, "repro_torch",
                           "reference_analytics.json")) as f:
        ref_analytics = json.load(f)
    for name, case in sorted(ref_cases.items()):
        overrides = dict(case["overrides"])
        if "topology" in overrides:
            overrides["topology"] = api.Topology.from_label(
                overrides["topology"])
        res = api.generate(api.preset(case["preset"], **overrides),
                           device=dev)
        got = edge_digest(res.edges.src, res.edges.dst)
        row = {"phase": "reference_digest", "case": name,
               "executor": res.plan.executor, "sha256": got,
               "match": got == case["sha256"],
               "exchange_rounds": res.stats.exchange_rounds,
               "dropped_edges": res.stats.dropped_edges}
        emit(row)
        if not row["match"] or res.stats.exchange_rounds != \
                case["exchange_rounds"]:
            raise AssertionError(f"{name}: the card's graph differs from "
                                 "the JAX package's")
        if name in ref_analytics["cases"]:
            check_reference_analytics(torch, np, name, res.edges,
                                      ref_analytics["cases"][name])
        del res
    from repro_torch.core.pba import serial_ba_reference
    ba = serial_ba_reference(*ref_analytics["serial_ba"], device=dev)
    got = edge_digest(ba.src, ba.dst)
    emit({"phase": "reference_analytics", "case": "serial_ba_reference",
          "args": ref_analytics["serial_ba"], "sha256": got,
          "match": got == ref_analytics["serial_ba_sha256"]})
    if got != ref_analytics["serial_ba_sha256"] or ba.src.device != dev:
        raise AssertionError("serial_ba_reference differs from the JAX "
                             "package's")
    del ba
    phase_done("3_reference")

    # 4. the host main path, through the front door
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.generate(pl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    st = res.stats
    main = {"phase": "main_path", "spec": "paper_1b_5b",
            "overrides": {"procs": PROCS,
                          "vertices_per_proc": VERTICES_PER_PROC,
                          "execution": "host",
                          "pair_capacity": PAIR_CAPACITY},
            "reduced": "procs 1000 -> %d" % PROCS,
            "num_vertices": st.num_vertices,
            "requested_edges": st.requested_edges,
            "dropped_edges": st.dropped_edges,
            "exchange_rounds": st.exchange_rounds,
            "pair_capacity": st.pair_capacity,
            "round_capacity": pl.round_capacity,
            "fallback_counts": st.fallback_counts,
            "launches": host_launches,
            "wall_s": wall, "edges_per_s": st.requested_edges / wall,
            "peak_allocated_bytes": peak}
    emit(main)
    if st.dropped_edges != 0 or st.fallback_counts != {}:
        raise AssertionError("main path dropped edges or fell back")
    if min(host_launches[k] for k in HOST_PATH_KERNELS) < 1:
        raise AssertionError(f"a kernel of the host path never launched: "
                             f"{host_launches}")
    if host_launches["resolve_roots"] != URNS_PER_PBA_RUN or \
            host_launches["histogram"] != 1:
        raise AssertionError(f"resolve_roots launched "
                             f"{host_launches['resolve_roots']} and "
                             f"histogram {host_launches['histogram']} times "
                             "on the host path")
    digest = edge_digest(res.edges.src, res.edges.dst)
    host_multiset = multiset_digest(torch, res.edges.src, res.edges.dst,
                                    st.num_vertices)
    kernel_src, kernel_dst = res.edges.src, res.edges.dst
    del res
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dispatch.forced_mode("ref"):
        plain = api.generate(pl)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    same = torch.equal(plain.edges.src, kernel_src) and \
        torch.equal(plain.edges.dst, kernel_dst)
    emit({"phase": "main_path_plain", "wall_s": plain_wall,
          "edges_per_s": plain.stats.requested_edges / plain_wall,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "identical_to_kernel_path": same, "sha256": digest,
          "multiset_sha256": host_multiset})
    if not same:
        raise AssertionError("kernel path and plain path disagree")
    del plain
    torch.cuda.empty_cache()
    cases += degree_count_cases(torch, kernel_src, kernel_dst,
                                st.num_vertices)
    from repro_torch.core.graph import EdgeList
    degrees = main_path_analytics(
        torch, np, ops, dev, EdgeList(kernel_src, kernel_dst,
                                      st.num_vertices), st.emitted_edges)
    del kernel_src, kernel_dst
    torch.cuda.empty_cache()
    cases += degrees["cases"]
    pk_analytics_launches, pk_cells = pk_self_similarity(torch, api, ops, dev)
    cases += pk_cells

    # Kernel path vs plain path end to end, in turns, on the same card.
    order = ["kernel", "plain", "plain", "kernel"] * 2
    walls = {"kernel": [], "plain": []}
    for which in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "plain":
            with dispatch.forced_mode("ref"):
                res = api.generate(pl)
        else:
            res = api.generate(pl)
        torch.cuda.synchronize()
        walls[which].append(time.perf_counter() - t0)
        del res
    emit({"phase": "main_path_repeats", "order": order,
          **{f"{k}_wall_s": v for k, v in walls.items()},
          **{f"{k}_median_s": statistics.median(v)
             for k, v in walls.items()}})
    torch.cuda.empty_cache()

    emit({"phase": "main_path_stages", **stage_times(torch, api, pl)})
    torch.cuda.empty_cache()
    emit({"phase": "main_path_profile", **profile_run(torch, api, spec, dev)})
    torch.cuda.empty_cache()
    phase_done("4_host_main_path")

    # 5. the streamed main path
    stream_launches, stream_digest = streamed_phases(
        torch, api, dispatch, ops, edge_digest, dev, host_multiset)
    if stream_launches["band_compact"] != band_runs or \
            stream_launches["histogram"] != 1 + band_runs:
        raise AssertionError(f"the path cases cover {band_runs} rounds, the "
                             "streamed run launched band_compact "
                             f"{stream_launches['band_compact']} and "
                             f"histogram {stream_launches['histogram']} "
                             "times")

    phase_done("5_streamed_main_path")

    # 6. PK and the communication-free family
    pk_cfree_launches = pk_cfree_phases(torch, api, dispatch, ops,
                                        edge_digest, dev)
    phase_done("6_pk_cfree")

    # 7. the torch.distributed path through a world-size-1 NCCL group
    dist_launches = distributed_phases(
        torch, np, api, ops, edge_digest, dev, host_digest=digest,
        stream_digest=stream_digest, host_peak=main["peak_allocated_bytes"],
        degrees=degrees)
    phase_done("7_distributed")

    # 8. the LM serving path: no kernel of the port lies on it
    lm_serve_phase(torch, np, dev)
    phase_done("8_lm_serve")

    # 9. the LM training path: its walk corpus launches the PBA kernels
    train = lm_train_phase(torch, np, dev)
    phase_done("9_lm_train")
    emit({"phase": "phase_ends", "seconds_from_start": phase_ends})

    # 10. the kernels line and the last line
    table = {
        "resolve_roots": ("src/repro/kernels/edge_resolve.py:87",
                          "src/repro_torch/kernels/csrc/resolve.cu",
                          "resolve_roots phase-2 pools"),
        "resolve_step": ("src/repro/kernels/edge_resolve.py:87",
                         "src/repro_torch/kernels/csrc/gather.cu",
                         f"resolve_step {pl.num_procs}x"),
        "gather": ("src/repro/kernels/edge_resolve.py:110",
                   "src/repro_torch/kernels/csrc/gather.cu",
                   "gather path receives r0 "),
        "gather_chunked": ("src/repro/kernels/edge_resolve.py:194",
                           "src/repro_torch/kernels/csrc/gather.cu",
                           "gather_chunked path grants r0 "),
        "histogram": ("src/repro/kernels/histogram.py:47",
                      "src/repro_torch/kernels/csrc/histogram.cu",
                      "histogram path phase1 "),
        "band_compact": ("src/repro/kernels/band_compact.py:107",
                         "src/repro_torch/kernels/csrc/band_compact.cu",
                         "band_compact path r0 "),
        "pk_expand": ("src/repro/kernels/pk_expand.py:72",
                      "src/repro_torch/kernels/csrc/pk_expand.cu",
                      "pk_expand slab"),
        "cfree_expand": ("src/repro/kernels/cfree_expand.py:74",
                         "src/repro_torch/kernels/csrc/cfree_expand.cu",
                         "cfree_expand ba_cfree slab"),
    }
    # Each kernel's main path: the PBA kernels' the streamed PBA run (their
    # host-path counts beside it), pk_expand's the pk_3b stream,
    # cfree_expand's the ba_cfree_1b stream; other paths' counts beside.
    main_launches = {**stream_launches,
                     "pk_expand": pk_cfree_launches["pk_3b_stream"]
                     ["pk_expand"],
                     "cfree_expand": pk_cfree_launches[
                         "ba_cfree_1b_stream_host"]["cfree_expand"]}
    no_library = {
        "resolve_roots": "no single PyTorch call computes the fixpoint of "
                         "pointer chains",
        "band_compact": "no single PyTorch call computes a per-row, "
                        "-1-padded stable compaction",
        "pk_expand": "no single PyTorch call computes a mixed-radix "
                     "Kronecker expansion",
        "cfree_expand": "no single PyTorch call computes the uint32 hash "
                        "chains"}
    kernels = []
    for name, (replaces, source, headline) in table.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = [c for c in mine if c["case"].startswith(headline)][-1]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": max(c["max_abs_diff"] for c in mine),
            "ms": head.get("kernel_device_ms", head["kernel_ms"]),
            "ms_from": "profiled device time per launch"
            if "kernel_device_ms" in head else "CUDA events",
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "timed_case": head["case"]})
        if name in STREAM_PATH_KERNELS:
            kernels[-1]["launches_host_path"] = host_launches[name]
        if name in no_library:
            kernels[-1]["library_ms_note"] = no_library[name]
        if "previous_design_ms" in head:
            kernels[-1]["previous_design"] = {
                c["case"]: {k: c[k] for k in ("kernel_ms", "bound_ms",
                                              "previous_design_ms",
                                              "previous_design_rounds")}
                for c in mine}
        if "per_run" in head:
            kernels[-1]["per_run"] = head["per_run"]
        kernels[-1]["launches_distributed"] = {
            k: v[name] for k, v in dist_launches.items() if v.get(name)}
        kernels[-1]["launches_train"] = train["launches"].get(name, 0)
    hist = next(k for k in kernels if k["name"] == "histogram")
    hist["launches_analytics"] = {
        "main_path_analytics": degrees["launches"]["histogram"],
        "pk_L9_self_similarity": pk_analytics_launches["histogram"],
        "distributed_g_analytics_flat1":
            dist_launches["g_analytics_flat1"]["histogram"]}
    kernels[-2]["launches_other_paths"] = {
        k: v["pk_expand"] for k, v in pk_cfree_launches.items()
        if k.startswith("pk_")}
    kernels[-1]["launches_other_paths"] = {
        k: v["cfree_expand"] for k, v in pk_cfree_launches.items()
        if not k.startswith("pk_")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
