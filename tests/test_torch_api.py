"""repro_torch's front door against repro.api: spec digests, plans and
generated graphs equal the reference's; the committed reference digests
cannot go stale; and the port imports nothing of JAX or the JAX package.
"""
import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import api as japi
from repro.core import factions as jfactions
from repro.core import spec as jspec
from repro.runtime.topology import Topology as JTopology
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import factions as tfactions
from repro_torch.core import spec as tspec
from repro_torch.core.graph import edge_digest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PBA_HOST_PRESETS = {"paper_smoke": {}, "hub_stress": {}, "pod_1000rank": {},
                    "paper_1b_5b": {"execution": "host"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers per machine; torch's intra-op thread
    pool then oversubscribes the cores (a 10^5-word draw went from 0.3 s
    to 30 s). One thread per worker keeps the CPU path's time stable."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(spec):
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


@pytest.mark.parametrize("name", sorted(japi.PRESETS))
def test_preset_digests_match(name):
    jspec_ = japi.preset(name)
    assert tapi.preset(name).digest() == jspec_.digest()
    assert convert.spec_from_fields(_fields(jspec_)).digest() == \
        jspec_.digest()


def test_nested_dataclass_digests_match():
    """Class and field names feed the digest: a spec carrying factions,
    a seed graph and a topology fingerprints alike in both packages."""
    from repro.core.pk import star_clique_seed
    table = jfactions.make_factions(12, jfactions.FactionSpec(5, 2, 6,
                                                              seed=3))
    for factions in (jfactions.FactionSpec(4, 2, 5, seed=9), table, "hub",
                     "block:4"):
        spec = japi.GraphSpec(model="pba", procs=12, vertices_per_proc=50,
                              edges_per_vertex=3, factions=factions,
                              topology=JTopology.pods(2, 2),
                              seed_graph=star_clique_seed(4))
        tsp = convert.spec_from_fields(_fields(spec))
        assert tsp.digest() == spec.digest()
        assert tspec.spec_digest(tsp, tsp.factions) == \
            jspec.spec_digest(spec, spec.factions)


def test_faction_builders_match():
    for got, want in [
            (tfactions.make_factions(9, tfactions.FactionSpec(4, 2, 5, 1)),
             jfactions.make_factions(9, jfactions.FactionSpec(4, 2, 5, 1))),
            (tfactions.hub_factions(7), jfactions.hub_factions(7)),
            (tfactions.block_factions(8, 4), jfactions.block_factions(8, 4))]:
        np.testing.assert_array_equal(got.procs, want.procs)
        np.testing.assert_array_equal(got.s, want.s)
        assert got.factions == want.factions


@pytest.mark.parametrize("name", sorted(PBA_HOST_PRESETS))
def test_plan_fields_match(name):
    overrides = PBA_HOST_PRESETS[name]
    jp = japi.plan(japi.preset(name, **overrides))
    tp = tapi.plan(tapi.preset(name, **overrides), device="cpu")
    for f in dataclasses.fields(jp):
        if f.name in ("spec", "config", "table", "topology"):
            continue
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    assert tp.topology.label == jp.topology.label
    assert dataclasses.asdict(tp.config) == dataclasses.asdict(jp.config)
    np.testing.assert_array_equal(tp.table.procs, jp.table.procs)
    assert tp.device == torch.device("cpu")
    assert "generate_pba_host" in tp.describe()


PK_CFREE_PLANS = {
    "pk_smoke": ("pk_smoke", {}),
    "pk_smoke_streamed": ("pk_smoke", dict(execution="streamed",
                                           slab_edges=4096)),
    "pk_3b": ("pk_3b", {}),
    "rmat_smoke": ("rmat_smoke", {}),
    "ba_cfree_1b": ("ba_cfree_1b", {}),
    "ba_cfree_1b_flat1": ("ba_cfree_1b", dict(topology="flat_1x1")),
    "er": ("rmat_smoke", dict(model="er", cfree_vertices=50000,
                              cfree_edges=100000, procs=3)),
    "er_shards": ("rmat_smoke", dict(model="er", cfree_vertices=5000,
                                     cfree_edges=70000, sink="shards",
                                     out_dir="/nonexistent/plan-only")),
}


@pytest.mark.parametrize("name", sorted(PK_CFREE_PLANS))
def test_pk_and_cfree_plan_fields_match(name):
    """Plans only (pk_3b and ba_cfree_1b are paper-scale): every GenPlan
    field, the config and the seed graph equal the reference's."""
    preset, overrides = PK_CFREE_PLANS[name]
    jover, tover = dict(overrides), dict(overrides)
    if "topology" in overrides:
        topo = tapi.Topology.from_label(overrides["topology"])
        jover["topology"] = JTopology(topo.axis_names, topo.axis_sizes)
        tover["topology"] = topo
    jp = japi.plan(japi.preset(preset, **jover))
    tp = tapi.plan(tapi.preset(preset, **tover), device="cpu")
    for f in dataclasses.fields(jp):
        if f.name in ("spec", "config", "table", "topology", "seed_graph"):
            continue
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    assert tp.topology.label == jp.topology.label
    assert type(tp.config).__name__ == type(jp.config).__name__
    assert dataclasses.asdict(tp.config) == dataclasses.asdict(jp.config)
    if jp.seed_graph is None:
        assert tp.seed_graph is None
    else:
        np.testing.assert_array_equal(tp.seed_graph.u, jp.seed_graph.u)
        np.testing.assert_array_equal(tp.seed_graph.v, jp.seed_graph.v)
    assert tp.executor in tp.describe()


def test_generate_on_cpu_matches_reference():
    spec = dict(procs=6, vertices_per_proc=400, edges_per_vertex=3, seed=11,
                factions="block:3", pair_capacity=96)
    jres = japi.generate(japi.GraphSpec(model="pba", **spec))
    tres = tapi.generate(tapi.GraphSpec(model="pba", **spec), device="cpu")
    np.testing.assert_array_equal(tres.edges.src.numpy(),
                                  np.asarray(jres.edges.src))
    np.testing.assert_array_equal(tres.edges.dst.numpy(),
                                  np.asarray(jres.edges.dst))
    assert tres.stats.dropped_edges == jres.stats.dropped_edges
    assert tres.plan.executor == jres.plan.executor == "generate_pba_host"
    js, jd = jres.edges.to_numpy()
    ts, td = tres.edges.to_numpy()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)


def _case_overrides(overrides: dict, jax_side: bool) -> dict:
    """A digest case's overrides with its topology label (if any) turned
    into either package's Topology."""
    out = dict(overrides)
    if "topology" in out:
        topo = tapi.Topology.from_label(out["topology"])
        out["topology"] = JTopology(topo.axis_names, topo.axis_sizes) \
            if jax_side else topo
    return out


def test_reference_digests_are_current():
    """The committed digests chip_smoke.py holds the card to equal what
    the JAX package generates now (host execution and both streams)."""
    committed = json.loads((PORT / "reference_digests.json").read_text())
    assert {c["overrides"].get("topology") for c in
            committed["cases"].values()} >= {"host", "flat_1x1"}
    for name, case in committed["cases"].items():
        res = japi.generate(japi.preset(
            case["preset"], **_case_overrides(case["overrides"], True)))
        fresh = edge_digest(np.asarray(res.edges.src),
                            np.asarray(res.edges.dst))
        assert fresh == case["sha256"], (name, fresh)
        assert res.stats.pair_capacity == case["pair_capacity"]
        assert res.stats.exchange_rounds == case["exchange_rounds"]
        assert res.stats.dropped_edges == case["dropped_edges"]
        tres = tapi.generate(tapi.preset(
            case["preset"], **_case_overrides(case["overrides"], False)),
            device="cpu")
        assert tres.plan.executor == res.plan.executor
        assert edge_digest(tres.edges.src, tres.edges.dst) == fresh


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tapi.preset("paper_smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.generate(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.plan(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.plan(spec, device="cuda")
    pl = tapi.plan(spec.replace(vertices_per_proc=20), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.generate(pl, device="cuda")
    # the LM serving path: build_model, the Engine and the launcher
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as tlaunch
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    cfg = get_config("qwen1.5-0.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, device="cuda")
    model = build_model(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(model, batch_size=2, max_len=8)
    assert Engine(model, batch_size=2, max_len=8, device="cpu").run([]) == []
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--requests", "1"])


@pytest.mark.parametrize("spec,want", [
    (dict(model="pk", levels=3, execution="sharded"),
     ("generate_pk", "flat_1x1", 1)),
    (dict(model="rmat", cfree_vertices=64, cfree_edges=64,
          execution="sharded"), ("generate_cfree", "flat_1x1", 1)),
    (dict(model="pba", procs=4, vertices_per_proc=10, edges_per_vertex=2,
          execution="streamed", topology=tapi.Topology.flat(2)),
     "world size (is )?1"),
    (dict(model="pba", procs=4, vertices_per_proc=10, edges_per_vertex=2,
          execution="sharded"), ("generate_pba_sharded", "flat_1x1", 4)),
    (dict(model="ba_cfree", cfree_vertices=64, execution="streamed",
          topology=tapi.Topology.flat(2)), "world size (is )?1"),
])
def test_unported_paths_name_their_roadmap_item(spec, want, tmp_path):
    """The multi-device paths, refused before they were ported: each spec
    resolves to the JAX package's executor, topology and lp on one
    device, with no process group and under a world-size-1 gloo group;
    a topology of two devices raises ``ValueError`` naming the world
    size it lacks, as the JAX package refuses it on one device."""
    tspec = tapi.GraphSpec(**spec)
    jspec = japi.GraphSpec(**{**spec, **(
        {"topology": JTopology.flat(spec["topology"].num_devices)}
        if "topology" in spec else {})})
    for grouped in (False, True):
        if grouped:
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp_path}/rdzv",
                world_size=1, rank=0)
        try:
            if isinstance(want, str):
                with pytest.raises(ValueError, match=want):
                    tapi.plan(tspec, device="cpu")
                with pytest.raises(ValueError, match="devices"):
                    japi.plan(jspec)
                continue
            pl, jpl = tapi.plan(tspec, device="cpu"), japi.plan(jspec)
            assert (pl.executor, pl.topology.label, pl.lp) == want == (
                jpl.executor, jpl.topology.label, jpl.lp)
            assert pl.execution == "sharded" and pl.rank == 0
        finally:
            if grouped:
                dist.destroy_process_group()


def test_only_the_runtime_calls_torch_distributed():
    """Collectives and group probes live in repro_torch/runtime/ (the JAX
    package's rule for shard_map and all_to_all, runtime/__init__.py)."""
    for path in sorted(PORT.rglob("*.py")):
        if path.parent.name == "runtime":
            continue
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.value, ast.Name) and node.value.id == "torch":
                names = [f"torch.{node.attr}"]
            assert not any(n.startswith("torch.distributed")
                           for n in names), (path, node.lineno)


def test_invalid_specs_raise_value_error():
    for spec in (dict(model="nope"),
                 dict(model="pba", procs=0, vertices_per_proc=1,
                      edges_per_vertex=1),
                 dict(model="pba", procs=4, vertices_per_proc=5,
                      edges_per_vertex=1, factions="ring"),
                 dict(model="pba", procs=4, vertices_per_proc=5,
                      edges_per_vertex=1, execution="fast")):
        with pytest.raises(ValueError):
            tapi.plan(tapi.GraphSpec(**spec), device="cpu")
    with pytest.raises(ValueError):
        tapi.preset("no_such_preset")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
