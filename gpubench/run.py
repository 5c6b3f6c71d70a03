"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration, traffic mix and metric readers are the
files of that name under ``gpubench/``. The last line of standard output
is the result's JSON object; the last lines of standard error are the
numbers compared, each beside its limit. A cell of more than one chip
runs one process a chip, started here, under a ``file://`` rendezvous in
the run's temporary directory and NCCL; rank 0 prints. With fewer CUDA
devices than the cell asks for it prints no result and exits 2; it exits
3 if the JAX package or JAX was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# CUDA's own cache of compiled device code stays inside the checkout.
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / ".gpubench_cache" / "nv"))


def run_rank(args, rank: int, world: int, rdzv=None, *, backend="nccl",
             device_type="cuda", bench_path=None, dirs=None) -> int:
    """Rank ``rank`` of a run over ``world`` chips; rank 0 prints the
    result. Returns the exit code."""
    import torch

    from gpubench import harness
    if rank == 0:
        harness.log(f"set-up: torch imported at "
                    f"{time.perf_counter() - T0:.3f} s")
    if device_type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < world:
            harness.log(f"cell {args.workload} needs {world} CUDA "
                        f"device(s); found {torch.cuda.device_count()}")
            return 2
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    if world > 1:
        import datetime

        import torch.distributed as dist
        dist.init_process_group(
            backend, init_method=f"file://{rdzv}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=600),
            device_id=device if device_type == "cuda" else None)
    try:
        kw = {"bench_path": bench_path, "dirs": dirs} if dirs else {}
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device=device, t0=T0,
                                  **kw)
    except harness.ForbiddenModules as exc:
        harness.log(str(exc))
        return 3
    finally:
        if world > 1:
            dist.destroy_process_group()
    if result is None:
        return 0
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    return 0 if result["correct"] else 1


def _rank_entry(t0: float, *args, **kwargs) -> None:
    global T0
    T0 = t0
    sys.exit(run_rank(*args, **kwargs))


def launch(args, world: int, **kwargs) -> int:
    """One process a chip, under a ``file://`` rendezvous in the run's
    temporary directory; waits for every rank, and stops the others once
    one has failed. Returns rank 0's exit code, or another rank's if rank
    0 succeeded."""
    import multiprocessing
    import multiprocessing.connection
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    rdzv = pathlib.Path(tempfile.gettempdir()) / \
        f"gpubench-{os.getpid()}.rendezvous"
    rdzv.unlink(missing_ok=True)
    procs = [ctx.Process(target=_rank_entry,
                         args=(T0, args, r, world, str(rdzv)),
                         kwargs=kwargs) for r in range(world)]
    for p in procs:
        p.start()
    try:
        alive = list(procs)
        while alive:
            multiprocessing.connection.wait([p.sentinel for p in alive])
            alive = [p for p in alive if p.exitcode is None]
            if alive and any(p.exitcode for p in procs
                             if p.exitcode is not None):
                for p in alive:
                    p.join(60)
                    if p.is_alive():
                        p.terminate()
                break
    finally:
        for p in procs:
            p.join()
        rdzv.unlink(missing_ok=True)
    codes = [p.exitcode for p in procs]
    return codes[0] or next((c for c in codes if c), 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench import traffic
    chips = traffic.cell(traffic.benchmark(ROOT / "BENCHMARK.json"),
                         args.workload)["chips"]
    if chips == 1:
        return run_rank(args, 0, 1)
    return launch(args, chips)


if __name__ == "__main__":
    sys.exit(main())
