"""repro_torch's sharding tables against the JAX package's, on the CPU.

The pure functions of the sharding slice: ``Rules.param_pspec`` for every
leaf of every arch's ``build_model(cfg, tp)``, ``activation_spec`` for
every role and mode (with the ``REPRO_MOE_*`` overrides), ``make_rules``'
choice of batch axes, ``cache_shardings`` and ``batch_shardings`` for
every arch's structs (the reference's on 8 forced host devices,
``tests/helpers.py::run_with_devices``), ``make_production_mesh`` for
1..1100 devices of each kind, and the elastic partition functions. A
mesh for the tables is a stand-in with ``shape`` and ``axis_names``, as
``tests/test_sharding.py`` fakes one; the port's ``PartitionSpec`` must
equal ``tuple(jax.sharding.PartitionSpec)`` entry for entry.
"""
import dataclasses
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from helpers import run_with_devices
from repro.configs import get_config as jget_config
from repro.launch import elastic as jelastic
from repro.launch import mesh as jmesh
from repro.models import build_model as jbuild
from repro.models.layers import ParamSpec as JParamSpec
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import elastic as telastic
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.serve import serve_step as tserve
from repro_torch.sharding import rules as trules
from repro_torch.train import train_step as ttrain

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (1, 4)),
          (("data", "model"), (2, 2)), (("data", "model"), (2, 4)),
          (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
TPS = (1, 2, 4, 8, 16)
VARIANTS = (dict(), dict(kv_sharded=False), dict(no_tp=True))
ROLES = ("act_btd", "act_bti", "act_bshd", "act_bskd", "cache_bskd",
         "cache_bsr", "logits_btv", "moe_ecd", "moe_ecf", "moe_becd",
         "moe_becf", "moe_btkd", "no_such_role")


def _fake(names, sizes):
    return SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)


def _same(port, ref) -> bool:
    if ref is None or port is None:
        return port is None and ref is None
    return tuple(port) == tuple(ref)


def _rules(pkg, mesh, variant, mode="decode", batch_axes=("data",)):
    if variant.get("no_tp"):
        return pkg.Rules(mesh=mesh, mode=mode, batch_axes=batch_axes,
                         kv_sharded=False, seq_parallel=False,
                         seq_shard_cache=False, no_tp=True)
    return pkg.Rules(mesh=mesh, mode=mode, batch_axes=batch_axes, **variant)


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_for_every_leaf(arch):
    """Every leaf of the padded model at each tp, on each mesh, under the
    default rules, with unsplittable KV heads and with no_tp (ZeRO over
    both axes where the embed dim divides)."""
    checked = 0
    for tp in TPS:
        specs = tlayers.tree_leaves(build_model(
            get_config(arch), tp=tp, device="cpu").param_specs())
        jspecs = jax.tree_util.tree_leaves(
            jbuild(jget_config(arch), tp=tp).param_specs(),
            is_leaf=lambda x: isinstance(x, JParamSpec))
        assert [(s.shape, s.axes) for s in specs] == \
            [(s.shape, s.axes) for s in jspecs]
        for names, sizes in MESHES:
            mesh = _fake(names, sizes)
            for variant in VARIANTS:
                port = _rules(trules, mesh, variant)
                ref = _rules(jrules, mesh, variant)
                for s, js in zip(specs, jspecs):
                    assert _same(port.param_pspec(s), ref.param_pspec(js)), \
                        (tp, sizes, variant, s)
                    checked += 1
    assert checked > 1000


def test_param_pspec_edge_cases():
    """One use per mesh axis, the no_tp divisibility ladder, and the
    tree form (Rules.param_pspecs, elastic.reshard_plan)."""
    mesh = _fake(("data", "model"), (16, 16))
    cases = [((64, 64), ("mlp", "heads")), ((1024, 16, 64),
                                             ("embed", "heads", None)),
             ((48, 64), ("embed", "mlp")), ((3, 5), ("embed", "mlp")),
             ((8, 8), ("embed", "embed")), ((10, 128), ("kv", None)),
             ((2, 4), ("layers", "vocab"))]
    for variant in VARIANTS:
        for shape, axes in cases:
            got = _rules(trules, mesh, variant).param_pspec(
                tlayers.ParamSpec(shape, axes))
            want = _rules(jrules, mesh, variant).param_pspec(
                JParamSpec(shape, axes))
            assert _same(got, want), (variant, shape, axes)
    specs = build_model(get_config("qwen1.5-0.5b"), device="cpu") \
        .param_specs()
    port = trules.make_rules(mesh, "prefill", 32)
    tree = port.param_pspecs(specs)
    plan = telastic.reshard_plan(specs, port)
    assert tlayers.tree_paths(tree) == tlayers.tree_paths(specs)
    assert tlayers.tree_leaves(tree) == tlayers.tree_leaves(plan)
    assert tree["embed"]["tok"] == trules.PartitionSpec("model", "data")


def test_partition_spec_normalises_as_jax():
    P = trules.PartitionSpec
    for parts in ((("data",), "model", None), ((), None),
                  (("data", "model"), None), (None,), ()):
        assert tuple(P(*parts)) == tuple(jax.sharding.PartitionSpec(*parts))
    assert P("a", ("b", "c")).axes_of(1) == ("b", "c")
    assert P(None).axes_of(0) == ()
    assert tlayers.tree_leaves({"x": P("a", None)}) == [P("a", None)]


# ---------------------------------------------------------------- activations

@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_activation_specs_match_every_role(mode, monkeypatch):
    checked = 0
    for names, sizes in MESHES[:4] + [MESHES[5]]:
        mesh = _fake(names, sizes)
        for batch_axes in ((), ("data",), ("pod", "data")):
            for flags in ((True, True, True), (False, True, True),
                          (True, False, False), (False, False, True)):
                for no_tp in (False, True):
                    kw = dict(mesh=mesh, mode=mode, batch_axes=batch_axes,
                              kv_sharded=flags[0], seq_parallel=flags[1],
                              seq_shard_cache=flags[2], no_tp=no_tp)
                    port, ref = trules.Rules(**kw), jrules.Rules(**kw)
                    for role in ROLES:
                        for ndim in range(1, 6):
                            assert _same(port.activation_spec(role, ndim),
                                         ref.activation_spec(role, ndim)), \
                                (kw, role, ndim)
                            checked += 1
                    for extra in range(4):
                        assert _same(port.batch_pspec(extra),
                                     ref.batch_pspec(extra))
    assert checked > 5000
    # the hillclimb overrides
    for var, value in (("REPRO_MOE_BECD", "b,none,model,none"),
                       ("REPRO_MOE_BECF", "none,b,,none"),
                       ("REPRO_MOE_BTKD", "b,model,none")):
        monkeypatch.setenv(var, value)
    mesh = _fake(("data", "model"), (2, 4))
    port = trules.make_rules(mesh, mode, 8)
    ref = jrules.make_rules(mesh, mode, 8)
    for role in ("moe_becd", "moe_becf", "moe_btkd"):
        for ndim in (3, 4):
            assert _same(port.activation_spec(role, ndim),
                         ref.activation_spec(role, ndim))
    assert port.activation_spec("moe_becd", 4) == \
        trules.PartitionSpec("data", None, "model", None)


@pytest.mark.parametrize("no_tp", [False, True])
def test_make_rules_batch_axes_match(no_tp):
    for names, sizes in MESHES + [(("data", "model"), (3, 2)),
                                  (("pod", "data", "model"), (2, 3, 2)),
                                  (("model",), (4,))]:
        mesh = _fake(names, sizes)
        for batch in range(1, 41):
            for mode in ("train", "decode"):
                for kv in (True, False):
                    port = trules.make_rules(mesh, mode, batch,
                                             kv_sharded=kv, no_tp=no_tp)
                    ref = jrules.make_rules(mesh, mode, batch,
                                            kv_sharded=kv, no_tp=no_tp)
                    assert dataclasses.asdict(port) | {"mesh": None} == \
                        dataclasses.asdict(ref) | {"mesh": None}, \
                        (sizes, batch, mode)
    assert trules.mesh_axis_size(_fake(("data",), (3,)), "model") == 1


# ---------------------------------------------------------------- cache / batch

# Meshes of at most 8 host devices for the reference's NamedShardings.
STRUCT_MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (1, 4)),
                 (("data", "model"), (2, 2)), (("data", "model"), (1, 8)),
                 (("data", "model"), (2, 4)), (("data", "model"), (4, 2)),
                 (("pod", "data", "model"), (2, 2, 2))]
STRUCT_SHAPES = ((1, 64), (2, 64), (6, 4096), (8, 5000))
STRUCT_CASES = [(arch, names, sizes, b, max_len, flags)
                for arch in ARCH_IDS for names, sizes in STRUCT_MESHES
                for b, max_len in STRUCT_SHAPES
                for flags in ((True, True), (False, True), (False, False))]

_REFERENCE_STRUCTS = """
import json
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import build_model
from repro.serve.serve_step import cache_shardings
from repro.sharding.rules import make_rules
from repro.train.train_step import batch_shardings, batch_struct
out = []
for arch, names, sizes, b, max_len, flags in CASES:
    n = int(np.prod(sizes))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(sizes), tuple(names))
    model = build_model(get_config(arch), tp=sizes[-1])
    kv = model.kv_sharded if flags[0] else False
    rules = make_rules(mesh, "decode", b, kv_sharded=kv,
                       seq_shard_cache=flags[1])
    cache = jax.tree_util.tree_leaves(
        cache_shardings(rules, model.cache_structs(b, max_len)),
        is_leaf=lambda x: hasattr(x, "spec"))
    batch = jax.tree_util.tree_leaves(
        batch_shardings(rules, batch_struct(model, b * 2, 32, accum=2)),
        is_leaf=lambda x: hasattr(x, "spec"))
    out.append([[list(s.spec) for s in cache], [list(s.spec) for s in batch]])
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_structs():
    code = "CASES = " + repr(STRUCT_CASES) + "\n" + _REFERENCE_STRUCTS
    out = run_with_devices(code, 8, timeout=300)
    line = next(x for x in out.splitlines() if x.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


def _jsonable(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_shardings_match(arch, reference_structs):
    """Every cache leaf's layout (KV by heads, by sequence, or whole; MLA
    by sequence; recurrent states by channel) and every batch leaf's, for
    each mesh, batch, length and KV flag."""
    n = 0
    for case, (want_cache, want_batch) in zip(STRUCT_CASES,
                                              reference_structs):
        if case[0] != arch:
            continue
        _, names, sizes, b, max_len, flags = case
        model = build_model(get_config(arch), tp=sizes[-1], device="cpu")
        rules = trules.make_rules(
            _fake(tuple(names), tuple(sizes)), "decode", b,
            kv_sharded=model.kv_sharded if flags[0] else False,
            seq_shard_cache=flags[1])
        cache = tlayers.tree_leaves(tserve.cache_shardings(
            rules, model.cache_structs(b, max_len)))
        batch = tlayers.tree_leaves(ttrain.batch_shardings(
            rules, ttrain.batch_struct(model, b * 2, 32, accum=2)))
        assert [_jsonable(s) for s in cache] == want_cache, case
        assert [_jsonable(s) for s in batch] == want_batch, case
        n += 1
    assert n == len(STRUCT_MESHES) * len(STRUCT_SHAPES) * 3


# ---------------------------------------------------------------- meshes

def _mesh_or_error(fn, **kw):
    try:
        topo = fn(**kw)
    except ValueError as e:
        return ("ValueError", str(e))
    return (tuple(topo.axis_names), tuple(topo.axis_sizes))


@pytest.mark.parametrize("kind", ["TPU v5 lite", "NVIDIA H100 80GB HBM3",
                                  "cpu"])
def test_make_production_mesh_matches(kind):
    for n in range(1, 1101):
        for multi in (False, True):
            kw = dict(multi_pod=multi, num_devices=n, device_kind=kind)
            assert _mesh_or_error(tmesh.make_production_mesh, **kw) == \
                _mesh_or_error(jmesh.make_production_mesh, **kw), kw
    assert tmesh._kind_family(kind) == jmesh._kind_family(kind)
    assert _mesh_or_error(tmesh.make_production_mesh, num_devices=4,
                          device_kind="NVIDIA H100 80GB HBM3") == \
        (("data", "model"), (2, 2))


def test_production_mesh_defaults_to_the_world():
    """No group: one device of the CPU kind; the process mesh of it."""
    from repro_torch.runtime.mesh import ProcessMesh
    topo = tmesh.make_production_mesh(device_kind="cpu")
    assert (topo.axis_names, topo.axis_sizes) == (("data", "model"), (1, 1))
    mesh = ProcessMesh.build(topo, "cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    assert tmesh.make_proc_mesh().axis_sizes == (1,)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tmesh.make_proc_mesh(2)


# ---------------------------------------------------------------- elastic

def test_elastic_functions_match():
    for total in (0, 1, 7, 100, 1001):
        for workers in (1, 2, 3, 8):
            for fn, args in ((telastic.partition_range, (total, workers)),
                             (telastic.repartition, (total, 5, workers))):
                got = fn(*args)
                want = getattr(jelastic, fn.__name__)(*args)
                assert np.array_equal(got.starts, want.starts)
                assert np.array_equal(got.stops, want.stops)
                assert [got.for_rank(r) for r in range(workers)] == \
                    [want.for_rank(r) for r in range(workers)]
            for failed in ({0}, {workers - 1}, set(range(1, workers))):
                if len(failed) == workers:
                    with pytest.raises(RuntimeError, match="no survivors"):
                        telastic.surviving_assignment(total, workers, failed)
                    continue
                got = telastic.surviving_assignment(total, workers, failed)
                want = jelastic.surviving_assignment(total, workers, failed)
                assert np.array_equal(got.starts, want.starts)
                assert np.array_equal(got.stops, want.stops)
