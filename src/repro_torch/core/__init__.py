"""Core library: the paper's contribution — parallel scale-free graph
generation — over torch tensors, with the JAX package's public names.

The **one front door** is ``repro_torch.api``:
  GraphSpec -> repro_torch.api.plan() -> repro_torch.api.generate()

The per-model entry points below (generate_pba*, generate_pk*, PBAStream,
PKStream, stream_to_shards) are the internal executors that front door
dispatches to. They remain importable for compatibility but are
deprecated as public entry points: new callers build a GraphSpec.

  PBA (parallel Barabási–Albert): PBAConfig, generate_pba, generate_pba_host
  PK (parallel Kronecker): PKConfig, SeedGraph, generate_pk, generate_pk_host
  Factions: FactionSpec, FactionTable, make_factions, block_factions
  Out-of-core streaming: PBAStream, PKStream, stream_to_shards
  Containers: EdgeList, GenStats
  Analysis: fit_power_law, sampled_path_stats, community_contrast, ...
"""
import warnings

from repro_torch.core.graph import EdgeList, GenStats, degree_counts, to_csr
from repro_torch.core.factions import (FactionSpec, FactionTable,
                                       make_factions, block_factions,
                                       hub_factions)
from repro_torch.core import pba as _pba
from repro_torch.core import pk as _pk
from repro_torch.core import stream as _stream
from repro_torch.core.pba import PBAConfig, serial_ba_reference
from repro_torch.core.pk import (PKConfig, SeedGraph, star_clique_seed,
                                 dense_power_seed, dense_kronecker_power,
                                 pk_sizes, xor_randomize)
from repro_torch.core.spec import GraphSpec, spec_digest
from repro_torch.core.stream import EdgeBlock
from repro_torch.core.analysis import (fit_power_law, sampled_path_stats,
                                       community_contrast, block_density,
                                       self_similarity_score,
                                       sampled_clustering_coefficient,
                                       degree_histogram)


# Deprecation shims (PEP 562): the legacy entry points resolve to the very
# executors ``repro_torch.api.generate`` dispatches to (type identity and
# signatures kept), but touching them through ``repro_torch.core`` warns.
_DEPRECATED_ENTRY_POINTS = {
    "generate_pba": _pba.generate_pba,
    "generate_pba_host": _pba.generate_pba_host,
    "generate_pba_sharded": _pba.generate_pba_sharded,
    "generate_pk": _pk.generate_pk,
    "generate_pk_host": _pk.generate_pk_host,
    "PBAStream": _stream.PBAStream,
    "PKStream": _stream.PKStream,
    "stream_to_shards": _stream.stream_to_shards,
}


def __getattr__(name):
    obj = _DEPRECATED_ENTRY_POINTS.get(name)
    if obj is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    warnings.warn(
        f"repro_torch.core.{name} is deprecated as a public entry point; "
        "build a repro_torch.api.GraphSpec and call "
        "repro_torch.api.generate (see README 'One front door')",
        DeprecationWarning, stacklevel=2)
    return obj


__all__ = [
    "EdgeList", "GenStats", "degree_counts", "to_csr",
    "FactionSpec", "FactionTable", "make_factions", "block_factions",
    "hub_factions",
    "GraphSpec", "spec_digest",
    "PBAConfig", "generate_pba", "generate_pba_host", "generate_pba_sharded",
    "serial_ba_reference",
    "PKConfig", "SeedGraph", "generate_pk", "generate_pk_host",
    "star_clique_seed", "dense_power_seed", "dense_kronecker_power",
    "pk_sizes", "xor_randomize",
    "EdgeBlock", "PBAStream", "PKStream", "stream_to_shards",
    "fit_power_law", "sampled_path_stats", "community_contrast",
    "block_density", "self_similarity_score",
    "sampled_clustering_coefficient", "degree_histogram",
]
