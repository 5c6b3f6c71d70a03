"""Quickstart on the PyTorch/CUDA port: generate PBA + PK graphs, verify
the paper's properties (the counterpart of ``examples/quickstart.py``).

One front door: describe the graph with a ``repro_torch.api.GraphSpec``
and call ``repro_torch.api.generate``; the planner picks the execution
path. Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch import api
from repro_torch.core.analysis import (community_contrast, fit_power_law,
                                       sampled_path_stats)
from repro_torch.core.factions import FactionSpec
from repro_torch.core.graph import degree_counts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default, raises without a card) or cpu")
    args = ap.parse_args(argv)

    # ---- PBA: two-phase preferential attachment over 8 logical processors
    res = api.generate(api.GraphSpec(
        model="pba", procs=8, vertices_per_proc=4000, edges_per_vertex=4,
        interfaction_prob=0.05, seed=7,
        factions=FactionSpec(num_factions=4, min_size=2, max_size=4,
                             seed=1)), device=args.device)
    edges, stats = res.edges, res.stats
    deg = degree_counts(edges)
    fit = fit_power_law(deg, kmin=5)
    paths = sampled_path_stats(edges, num_sources=8)
    print("== PBA ==")
    print(f"  vertices={stats.num_vertices:,} edges={stats.emitted_edges:,} "
          f"(dropped {stats.dropped_edges})")
    print(f"  power law: gamma_mle={fit.gamma_mle:.2f} (paper: >2)  "
          f"max_degree={int(deg.max())}")
    print(f"  small world: avg_path={paths.avg_path_length:.2f} "
          f"diameter~{paths.diameter_estimate}")
    print(f"  communities: contrast={community_contrast(edges, 8):.2f}")

    # ---- PK: closed-form Kronecker expansion of a 5-vertex seed
    res = api.generate(api.GraphSpec(model="pk", levels=6, noise=0.05,
                                     seed=3), device=args.device)
    edges, stats = res.edges, res.stats
    deg = degree_counts(edges)
    fit = fit_power_law(deg, kmin=4)
    paths = sampled_path_stats(edges, num_sources=8)
    print("== PK ==")
    print(f"  vertices={stats.num_vertices:,} edges={stats.emitted_edges:,}")
    print(f"  heavy tail: gamma_mle={fit.gamma_mle:.2f} "
          f"max_degree={int(deg.max())}")
    print(f"  small world: avg_path={paths.avg_path_length:.2f} "
          f"diameter~{paths.diameter_estimate} (paper PK: 3.20 / 5)")


if __name__ == "__main__":
    main()
