"""The control: the plain reference one precision below the configuration,
put in the program's place, must come out not correct.

    python3 gpubench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--graphs G] [--device cuda|cpu]

For each seed it makes the graphs that a run with that seed would check
(the full comparisons the seed picks, of the whole graph or of the rows
it picks, and with positional samples the first ``G`` graphs), computed
by the reference with ``control=True`` on one device,
and hands them to the run's own comparison. One JSON line per seed gives
the numbers compared beside their limits; the exit code is 0 when every
seed's control fails at least one of them. It does not time anything and
does not run the program.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control_checks(name: str, seed: int, graphs: int, device, *,
                   bench_path=None, dirs=None) -> dict:
    """The run's comparison of cell ``name``'s control for ``seed``."""
    from gpubench import check, harness
    from gpubench import traffic as traffic_lib

    dirs = dirs or (harness.HERE,)
    bench = traffic_lib.benchmark(bench_path or ROOT / "BENCHMARK.json")
    entry = traffic_lib.cell(bench, name)
    config = traffic_lib.load("configs", entry["config"], dirs)
    traffic = traffic_lib.load("traffic", entry["traffic"], dirs)
    reference = harness.load_reference(config["reference"], dirs)
    full_at, rows = harness.picks(seed, traffic, config)
    keep = {"digests": [], "samples": []}
    for i in full_at:
        graph = traffic_lib.graph_config(config, traffic_lib.derived_seed(
            seed, i))
        blocks = (reference.edge_blocks(graph, device, control=True)
                  if rows is None else
                  reference.row_blocks(graph, rows, device, control=True))
        keep["digests"].append((i, graph["seed"],
                                check.blocks_digest(blocks)))
    positions = None
    samples = traffic.get("edge_samples", 0)
    if samples:
        requested = reference.requested_edges(config["graph"])
        positions = check.sample_positions(
            traffic_lib.derived_seed(seed, -2), requested, samples, device)
        seeds = [traffic_lib.derived_seed(seed, i) for i in range(graphs)]
        for a in range(0, graphs, 256):
            batch = seeds[a:a + 256]
            u, v = reference.endpoints_at(
                [traffic_lib.graph_config(config, s) for s in batch],
                positions, control=True)
            keep["samples"] += [(s, u[k].cpu(), v[k].cpu())
                                for k, s in enumerate(batch)]
    return harness.compare(reference, config, keep, positions, device, 0,
                           len(full_at), rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--graphs", type=int, default=1,
                    help="graphs whose sampled positions are compared")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    device = torch.device(args.device)
    all_fail = True
    for seed in args.seeds:
        checks = control_checks(args.workload, seed, args.graphs, device)
        failed = any(c["value"] > c["limit"] for c in checks.values())
        all_fail &= failed
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_failed": failed, "checks": checks}),
              flush=True)
    return 0 if all_fail else 1


if __name__ == "__main__":
    sys.exit(main())
