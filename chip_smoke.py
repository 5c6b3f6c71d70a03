#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line (any failure raises, exit code != 0):

 1. toolchain: nvidia-smi's name and power limit, nvcc and torch versions;
    build every CUDA kernel from kernels/csrc/ (one nvcc per source, all
    started together) and report the build seconds.
 2. kernels: each kernel wrapper against its plain PyTorch version on the
    card, at the main paths' shapes, on inputs drawn from
    numpy.random.default_rng(SEED); exact equality is required (integer
    kernels, tolerance 0). Kernel, plain and library-call times are CUDA
    event medians of 7 runs after 2 warm-ups.
 3. reference digests: generate() on the card for the specs in
    src/repro_torch/reference_digests.json (made by the JAX package: host
    execution, the device stream and the host-driven stream) must
    reproduce their sha256.
 4. host main path: generate(preset("paper_1b_5b", procs=64,
    execution="host", pair_capacity=262144)), the paper's per-rank scale
    (1M vertices x k=5 per rank, R=8) with procs cut from 1000 to 64 to
    fit one card; zero dropped edges, no kernel fallbacks, every kernel of
    the path launched; then the same spec under forced_mode("ref") must
    give identical edges; then 4 + 4 timed runs of the kernel and plain
    paths in turns, a per-stage timing run and a profiled run.
 5. streamed main path: the same preset at its own execution="streamed"
    on Topology.flat(1) (the device stream), same single cut: into memory
    (every kernel launched, band_compact once per block); under
    forced_mode("ref") (identical edges); parity mode (auto_capacity=False:
    the host path's edge multiset); the host-driven stream (the device
    stream's digest); a profiled run; and the shard sink with overlap on
    and off, read back, then resumed after two blocks are dropped from the
    manifest (only those two shards rewritten).
 6. the kernels line, then {"ok": true, "device": {...}} as the last line.

Exits with a non-zero code and prints no result when CUDA is not
available or the repository's src/ is not beside this file.
"""
from __future__ import annotations

import json
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
PROCS = 64                  # the paper's 1000 ranks, cut to fit one card
VERTICES_PER_PROC = 1_000_000   # the paper's per-rank scale, not cut
PAIR_CAPACITY = 262144      # pinned: C_r = 32768 per pair at R=8
BLOCK_CAP = 2_097_152       # min(E, P * C_r): a streamed round's block
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

def kernel_cases(torch, np, dev, seed: int, procs: int, vpp: int, k: int,
                 round_cap: int, block_cap: int) -> list[dict]:
    from repro_torch.kernels import band_compact, edge_resolve, histogram, ref

    gen = np.random.default_rng(seed)
    e_local = vpp * k
    pool_n = 3 * e_local                 # E + t_cap at total_capacity_factor 2
    recv_n = procs * round_cap           # one round's (P, C_r) buffer per rank

    def draw(rows: int, n: int, high) -> "torch.Tensor":
        """(rows, n) int32 uniform in [0, high) from numpy words."""
        out = torch.empty((rows, n), dtype=torch.int32, device=dev)
        for r in range(rows):
            w = gen.integers(0, 2**32, n, dtype=np.uint32).view(np.int32)
            out[r] = ((torch.from_numpy(w).to(dev).long() & M32)
                      % high).to(torch.int32)
        return out

    def poke(idx, m):
        """A few indices past both ends exercise the clip contract."""
        flat = idx.view(-1)
        flat[:4] = torch.tensor([-1, -7, m, m + 100], dtype=torch.int32,
                                device=dev)

    def gather_bytes(idx, rows: int, m: int) -> int:
        """Bytes a gather of ``rows`` sources of ``m`` entries must move:
        idx read and out written once each, and each distinct source
        entry that this idx touches read once."""
        flat = idx.reshape(rows, -1).clamp(0, m - 1).long()
        flat += torch.arange(rows, device=dev)[:, None] * m
        seen = torch.zeros(rows * m, dtype=torch.bool, device=dev)
        seen[flat.view(-1)] = True
        return 4 * (2 * idx.numel() + int(seen.sum()))

    results = []

    def run(name, wrapper, plain, library, args, nbytes, shape):
        got = wrapper(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        diff = max_abs_diff(torch, got, want)
        del got, want
        row = {"case": name, "kernel": wrapper.__name__, "shape": shape,
               "max_abs_diff": diff,
               "kernel_ms": time_ms(torch, lambda: wrapper(*args)),
               "plain_ms": time_ms(torch, lambda: plain(*args)),
               "library_ms": time_ms(torch, library) if library else None,
               "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
        results.append(row)
        emit({"phase": "kernel_case", **row})
        if diff:
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"(max abs diff {diff})")
        torch.cuda.empty_cache()

    # Downward pointers ptr[r, j] in [0, j]: the urns' pointer layout.
    ptr = draw(procs, pool_n, torch.arange(1, pool_n + 1, device=dev))
    for m in (e_local, pool_n):
        p = ptr[:, :m].contiguous()
        p64 = p.long()
        run(f"resolve_step {procs}x{m}", edge_resolve.resolve_step,
            ref.resolve_step_ref, lambda: torch.gather(p, 1, p64), (p,),
            8 * p.numel(), [procs, m])
        del p, p64

    # Grants: each rank's pool (P, E + t_cap) gathered at one round's
    # (P, P*C_r) slots -- the port's batched form of the grant lookup.
    gidx = draw(procs, recv_n, pool_n)
    poke(gidx, pool_n)
    g64 = gidx.clamp(0, pool_n - 1).long()
    run(f"gather_chunked rows {procs}x{pool_n} <- {procs}x{recv_n}",
        edge_resolve.gather_chunked, ref.gather_ref,
        lambda: torch.gather(ptr, 1, g64), (ptr, gidx),
        gather_bytes(gidx, procs, pool_n), [procs, pool_n, recv_n])
    del g64

    # The 1-D form: one shared source, indices of any rank.
    src1 = ptr[0].contiguous()
    idx3 = gidx.view(procs, procs, round_cap)
    i64 = idx3.reshape(-1).clamp(0, pool_n - 1).long()
    run(f"gather 1-D {pool_n} <- {procs}x{procs}x{round_cap}",
        edge_resolve.gather,
        lambda s, i: ref.gather_ref(s, i.reshape(-1)).reshape(i.shape),
        lambda: torch.take(src1, i64), (src1, idx3),
        gather_bytes(idx3, 1, pool_n), [pool_n, procs, procs, round_cap])
    del ptr, src1, idx3, i64, gidx
    torch.cuda.empty_cache()

    # Receives: each rank's (P*C_r) received buffer at its E edges.
    rsrc = draw(procs, recv_n, 2**31)
    ridx = draw(procs, e_local, recv_n)
    poke(ridx, recv_n)
    r64 = ridx.clamp(0, recv_n - 1).long()
    run(f"gather rows {procs}x{recv_n} <- {procs}x{e_local}",
        edge_resolve.gather, ref.gather_ref,
        lambda: torch.gather(rsrc, 1, r64), (rsrc, ridx),
        gather_bytes(ridx, procs, recv_n), [procs, recv_n, e_local])
    del rsrc, ridx, r64
    torch.cuda.empty_cache()

    # Band compaction at a streamed round's shape: a ~1/12 band (a round
    # of 12), an overflowing band (truncation at block_cap), and small
    # rows that are empty, all band, or narrower than block_cap.
    def band_bytes(band, cap: int) -> int:
        """band read once, u and v read where band is set and kept, both
        outputs written in full."""
        cap = min(cap, band.shape[1])
        kept = int(band.sum(1).clamp(max=cap).sum())
        return band.numel() + 8 * kept + 8 * band.shape[0] * cap

    bu = draw(procs, e_local, 2**31)
    bv = draw(procs, e_local, 2**31)
    for label, share in (("round", 12), ("overflow", 2)):
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

    # Phase-1 counts (P bins) and a bin count past shared memory; -1 and
    # past-the-end values must be ignored.
    for nb in (procs, 70_000):
        vals = draw(procs, e_local, nb + 2) - 1
        ok = (vals >= 0) & (vals < nb)
        rows = torch.arange(procs, device=dev)[:, None] * (nb + 1)
        flat = (torch.where(ok, vals, nb).long() + rows).reshape(-1)
        del ok, rows
        run(f"histogram {procs}x{e_local} bins {nb}", histogram.histogram,
            ref.histogram_ref,
            lambda: torch.bincount(flat, minlength=procs * (nb + 1)),
            (vals, nb), 4 * (vals.numel() + procs * nb),
            [procs, e_local, nb])
        del vals, flat
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


def profile_run(torch, api, spec, dev) -> dict:
    """Device-time share and the top device ops of one main-path run."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.generate(spec, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    from torch.autograd import DeviceType

    # CUPTI marks the spans where the launch queue was full (the host
    # waited on the device) as device events; they are not kernels.
    queue_full = "Command Buffer Full"

    def on_device(e):
        return getattr(e, "device_type", None) == DeviceType.CUDA

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if on_device(e) and e.name != queue_full)
    busy_us, cur = 0.0, None
    for start, end in spans:          # union of kernel intervals
        if cur is None or start > cur[1]:
            busy_us += (cur[1] - cur[0]) if cur else 0.0
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy_us += (cur[1] - cur[0]) if cur else 0.0
    window_us = (spans[-1][1] - spans[0][0]) if spans else 0.0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in prof.key_averages() if on_device(e)]
    top = sorted(kernels, key=dev_us, reverse=True)[:14]
    return {"wall_s": wall, "kernels_busy_s": busy_us / 1e6,
            "first_to_last_kernel_s": window_us / 1e6,
            "device_idle_share_of_wall": 1 - busy_us / 1e6 / wall,
            "top_device_ops": [{"name": e.key[:90], "calls": e.count,
                                "device_ms": dev_us(e) / 1e3}
                               for e in top]}


# --- phase 5: the streamed main path ---------------------------------------------

HOST_PATH_KERNELS = ("resolve_step", "gather", "gather_chunked", "histogram")
STREAM_PATH_KERNELS = HOST_PATH_KERNELS + ("band_compact",)


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
                    host_multiset: str) -> dict:
    """The streamed main path at full width; returns its launch counts."""
    from repro_torch.core import storage
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

    # Shard sink: overlap on, overlap off, read back, resume two blocks.
    out_root = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_root, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_shards_", dir=out_root)
    try:
        walls = {}
        for overlap in (True, False):
            shutil.rmtree(out_dir)
            with PeakRss() as rss:
                sres, walls[overlap] = timed(lambda: api.generate(
                    spec.replace(sink="shards", out_dir=out_dir,
                                 overlap=overlap), device=dev))
            emit({"phase": "stream_shards", "overlap": overlap,
                  "wall_s": walls[overlap],
                  "edges_per_s": sres.stats.requested_edges
                  / walls[overlap],
                  "num_shards": sres.manifest["num_shards"],
                  "dropped_edges": sres.stats.dropped_edges,
                  "peak_host_rss_bytes": rss.peak,
                  "disk_bytes": sum(
                      os.path.getsize(os.path.join(out_dir, f))
                      for f in os.listdir(out_dir))})
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
        _, resume_wall = timed(lambda: api.generate(
            spec.replace(sink="shards", out_dir=out_dir), device=dev))
        rewritten = [i for i in range(n)
                     if os.stat(shard(i)).st_mtime_ns != stamps[i]]
        src, dst, _ = storage.read_shards(out_dir)
        resumed_digest = edge_digest(src, dst)
        del src, dst
        emit({"phase": "stream_shards_resume", "read_back_sha256":
              read_digest, "read_back_matches": read_digest == digest,
              "resume_wall_s": resume_wall, "rewritten": rewritten,
              "resumed_matches": resumed_digest == digest,
              "overlap_on_s": walls[True], "overlap_off_s": walls[False]})
        if read_digest != digest or resumed_digest != digest \
                or rewritten != [n - 2, n - 1]:
            raise AssertionError("shard sink read back or resumed wrong")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches


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

    # 1. toolchain and build
    t0 = time.perf_counter()
    build_s = _build.build()
    build_wall = time.perf_counter() - t0
    emit({"phase": "toolchain", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(dev),
          "nvcc": _nvcc_version(_build.nvcc()), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc_flags": _build.NVCC_FLAGS,
          "build_s": build_s, "build_wall_s": build_wall})

    # 2. kernels against their plain versions at the main paths' shapes
    spec = api.preset("paper_1b_5b", procs=PROCS,
                      vertices_per_proc=VERTICES_PER_PROC,
                      execution="host", pair_capacity=PAIR_CAPACITY)
    pl = api.plan(spec, device=dev)
    cases = kernel_cases(torch, np, dev, SEED, pl.num_procs,
                         spec.vertices_per_proc, spec.edges_per_vertex,
                         pl.round_capacity, BLOCK_CAP)

    # 3. the JAX package's reference digests
    with open(os.path.join(src, "repro_torch",
                           "reference_digests.json")) as f:
        ref_cases = json.load(f)["cases"]
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
        del res

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
    del plain, kernel_src, kernel_dst
    torch.cuda.empty_cache()

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

    # 5. the streamed main path
    stream_launches = streamed_phases(torch, api, dispatch, ops, edge_digest,
                                      dev, host_multiset)

    # 6. the kernels line and the last line
    table = {
        "resolve_step": ("src/repro/kernels/edge_resolve.py:87",
                         "src/repro_torch/kernels/csrc/gather.cu",
                         f"resolve_step {pl.num_procs}x"),
        "gather": ("src/repro/kernels/edge_resolve.py:110",
                   "src/repro_torch/kernels/csrc/gather.cu",
                   "gather rows"),
        "gather_chunked": ("src/repro/kernels/edge_resolve.py:194",
                           "src/repro_torch/kernels/csrc/gather.cu",
                           "gather_chunked rows"),
        "histogram": ("src/repro/kernels/histogram.py:47",
                      "src/repro_torch/kernels/csrc/histogram.cu",
                      f"histogram {pl.num_procs}x{pl.config.edges_per_proc}"
                      f" bins {pl.num_procs}"),
        "band_compact": ("src/repro/kernels/band_compact.py:107",
                         "src/repro_torch/kernels/csrc/band_compact.cu",
                         "band_compact round"),
    }
    kernels = []
    for name, (replaces, source, headline) in table.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = [c for c in mine if c["case"].startswith(headline)][-1]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": stream_launches[name],
            "launches_host_path": host_launches[name],
            "max_abs_err": max(c["max_abs_diff"] for c in mine),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "timed_case": head["case"]})
        if name == "band_compact":
            kernels[-1]["library_ms_note"] = (
                "no single PyTorch call computes a per-row, -1-padded "
                "stable compaction")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
