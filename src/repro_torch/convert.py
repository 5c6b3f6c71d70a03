"""Carry state across from the JAX package's objects.

The generators have no weights: their state is the faction table, the PK
seed graph and the configs. These helpers rebuild the port's objects from
the reference's numpy arrays and dataclass fields (plain Python values),
without importing the reference, so a test can feed both packages the same
state. The LM side's weights are random, drawn from a seed:
:func:`numpy_params` draws them with numpy in the JAX package's tree
layout, so both packages can load the same tree.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.cfree import CFreeConfig
from repro_torch.core.factions import FactionSpec, FactionTable
from repro_torch.core.pba import PBAConfig
from repro_torch.core.pk import PKConfig
from repro_torch.core.spec import GraphSpec, SeedGraph
from repro_torch.models.layers import init_scale, tree_leaves, tree_map
from repro_torch.runtime.topology import Topology

# Dataclasses a spec (or spec_digest) may nest, by class name (the names
# the digest uses).
_PORT_CLASSES = {c.__name__: c
                 for c in (FactionSpec, FactionTable, SeedGraph, Topology,
                           PKConfig, CFreeConfig)}


def faction_table_from_numpy(procs, s, factions=()) -> FactionTable:
    """A FactionTable from the reference's (P, max_s) ``procs`` and (P,)
    ``s`` arrays (and its raw faction lists, which the digest covers)."""
    return FactionTable(procs=np.asarray(procs, np.int32),
                        s=np.asarray(s, np.int32),
                        factions=tuple(tuple(int(x) for x in f)
                                       for f in factions))


def pba_config_from_fields(fields: dict) -> PBAConfig:
    """A PBAConfig from the reference PBAConfig's field values."""
    return PBAConfig(**fields)


def pk_config_from_fields(fields: dict) -> PKConfig:
    """A PKConfig from the reference PKConfig's field values."""
    return PKConfig(**fields)


def cfree_config_from_fields(fields: dict) -> CFreeConfig:
    """A CFreeConfig from the reference CFreeConfig's field values."""
    return CFreeConfig(**fields)


def seed_graph_from_numpy(u, v, num_vertices: int) -> SeedGraph:
    """A SeedGraph from the reference seed's (e0,) ``u`` / ``v`` arrays
    and vertex count."""
    return SeedGraph(np.asarray(u, np.int32), np.asarray(v, np.int32),
                     int(num_vertices))


def _port_value(value):
    """A reference dataclass value rebuilt as the port's class of the same
    name (recursively); other values pass through."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = _PORT_CLASSES.get(type(value).__name__)
        if cls is None:
            raise TypeError(
                f"no port counterpart for {type(value).__name__}")
        return cls(**{f.name: _port_value(getattr(value, f.name))
                      for f in dataclasses.fields(value)})
    return value


def spec_from_fields(fields: dict) -> GraphSpec:
    """A GraphSpec from the reference GraphSpec's field values (nested
    FactionSpec / FactionTable / SeedGraph / Topology values included)."""
    return GraphSpec(**{k: _port_value(v) for k, v in fields.items()})


#: Elements per independently seeded piece of a numpy_params leaf.
DRAW_CHUNK = 1 << 24


def numpy_params(model, seed: int) -> dict:
    """The parameters of ``model`` (a ``repro_torch.models.Model``) as
    float32 numpy arrays in the JAX package's nested layout, drawn with
    numpy by each spec's init kind (``models.layers.init_scale``). Leaf
    ``i`` of the spec tree, in ``jax.tree_util.tree_flatten``'s order
    (dict keys sorted, lists in order), is filled flat in pieces of DRAW_CHUNK elements, piece ``j``
    by ``np.random.default_rng((seed, i, j)).standard_normal``, the
    pieces in parallel threads (numpy draws outside the GIL): the same
    tree on any machine, ~5x faster than one stream on 8 cores."""
    specs = tree_leaves(model.param_specs())
    arrays = []
    jobs = []
    for i, spec in enumerate(specs):
        if spec.init in ("zeros", "ones"):
            arrays.append(np.full(spec.shape, spec.init == "ones",
                                  np.float32))
            continue
        arrays.append(np.empty(spec.shape, np.float32))
        scale = np.float32(init_scale(spec))
        flat = arrays[-1].reshape(-1)
        jobs += [(i, j, flat[j * DRAW_CHUNK:(j + 1) * DRAW_CHUNK], scale)
                 for j in range(-(-flat.size // DRAW_CHUNK))]

    def fill(job):
        i, j, out, scale = job
        np.random.default_rng((seed, i, j)).standard_normal(
            out=out, dtype=np.float32)
        out *= scale

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(fill, jobs))
    leaves = iter(arrays)
    return tree_map(lambda _, __: next(leaves), model.param_specs())


def params_from_numpy(model, tree: dict, rules=None):
    """Load a numpy tree in the JAX layout (:func:`numpy_params`) into
    ``model``, cast per ``Model.param_dtype`` on its device; with
    ``rules`` (``repro_torch.sharding.Rules``) only this rank's block of
    each leaf (each leaf a view of its array, sliced before it is copied).
    Returns the model."""
    return model.set_params(tree_map(
        lambda _, a: torch.from_numpy(np.asarray(a)), tree), rules)
