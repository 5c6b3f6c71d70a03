"""repro_torch's sharded LM serving against the JAX package, on the CPU.

Gloo spawns of 2 and 4 ranks (``torch.multiprocessing.spawn``, a
``file://`` rendezvous under the test's tmp dir, as
``tests/test_torch_distributed.py`` runs them) serve the six GQA-family
configs, reduced, in float32, on the meshes (data, model) = (1, 2), (1, 4)
and (2, 2): each rank loads its blocks of one numpy tree
(``convert.params_from_numpy(..., rules=)``), prefills its batch rows and
runs 8 decode steps (``serve.make_serve_fns(model, rules=...)``, prefill
and decode rules), and writes its rows and block of the vocabulary of
every step's logits. The test assembles them and holds them, at rtol/atol
1e-5, to the JAX package's ``build_model(cfg, tp)`` run unsharded on the
same tree (the padded model: a tp-4 run is never compared with tp 1).
Ranks that hold the same block must agree bit for bit.

The edge cases: KV heads that cannot be split (a cache split by sequence,
its ring too, and the flash-decoding combine; a cache too short to split,
held whole), a prompt "model" does not divide, a batch "data" does not
divide, a vocabulary padded for tp, MoE with drops forced and with experts
"model" does not divide, ``local`` ring and ``chunked`` layers. The
port's expert parallelism is held to the reference's ``_grouped_manual``
(``REPRO_MOE_MANUAL=1`` on a 4-device host mesh) and ``_grouped_auto``;
then the refusals.
"""
import dataclasses
import datetime
import json
import os
import pathlib
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from helpers import run_with_devices
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import tree_leaves, tree_paths
from repro_torch.runtime.mesh import ProcessMesh
from repro_torch.serve import make_serve_fns
from repro_torch.sharding import ctx as tctx
from repro_torch.sharding import rules as trules

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (lm_reference_params)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SPAWN_TIMEOUT_S = 150
F32 = dict(rtol=1e-5, atol=1e-5)
GQA_ARCHS = ("qwen1.5-0.5b", "stablelm-1.6b", "phi3-medium-14b",
             "phi-3-vision-4.2b", "llama4-scout-17b-a16e",
             "qwen3-moe-235b-a22b")
# MLA, the SSD, the RG-LRU and the encoder-decoder: served sharded in
# tests/test_torch_lm_tp_mixers.py, laid out under the rules here
MIXER_ARCHS = ("minicpm3-4b", "mamba2-130m", "recurrentgemma-2b",
               "whisper-medium")


def _case(arch, mesh, over=None, batch=2, prompt=16, steps=8, max_len=0):
    return dict(arch=arch, mesh=mesh, over=over or {}, batch=batch,
                prompt=prompt, steps=steps,
                max_len=max_len or prompt + steps)


CASES = {f"{arch}-{m[0]}x{m[1]}": _case(arch, m)
         for m in ((1, 2), (1, 4), (2, 2)) for arch in GQA_ARCHS}
CASES.update({
    # KV heads 2 < tp 4: the cache splits by sequence (24 positions), the
    # local layers' ring (8 slots) too
    "kv_seq_split": _case("qwen1.5-0.5b", (1, 4), dict(
        num_kv_heads=2, num_layers=4, layer_pattern=("global", "local"),
        local_window=8)),
    # ... a prompt "model" does not divide, into a split cache of 28
    "kv_seq_split_odd_prompt": _case("qwen1.5-0.5b", (2, 2), dict(
        num_kv_heads=1), prompt=18, max_len=28),
    # ... a cache of 21 positions, which does not split: held whole
    "kv_whole_cache": _case("qwen1.5-0.5b", (1, 4), dict(num_kv_heads=2),
                            prompt=13),
    "batch_not_divided": _case("stablelm-1.6b", (2, 2), batch=3),
    "vocab_padded": _case("phi3-medium-14b", (1, 4), dict(vocab_size=510)),
    "moe_drops": _case("qwen3-moe-235b-a22b", (1, 4), dict(
        capacity_factor=0.5)),
    "moe_drops_2x2": _case("llama4-scout-17b-a16e", (2, 2), dict(
        capacity_factor=0.5), prompt=40),
    "moe_uneven_experts": _case("qwen3-moe-235b-a22b", (1, 4), dict(
        num_experts=6), prompt=15),
    "local_ring_chunked": _case("llama4-scout-17b-a16e", (1, 4), dict(
        layer_pattern=("chunked", "local", "global", "chunked"),
        chunk_size=8, local_window=8)),
})
EP_CASES = {"qwen3-moe-235b-a22b": dict(capacity_factor=1.0),
            "llama4-scout-17b-a16e": dict(capacity_factor=2.0)}
EP_SHAPE = (2, 16)


def _cfg(case, pkg_get=get_config):
    return dataclasses.replace(pkg_get(case["arch"]).reduced(),
                               **case["over"])


def _tree(case):
    """The case's numpy tree: each stacked matrix at one layer's fan-in
    (see chip_smoke.lm_reference_params), the norms' scales perturbed."""
    model = build_model(_cfg(case), tp=case["mesh"][1],
                        compute_dtype=torch.float32, device="cpu")
    tree = chip_smoke.lm_reference_params(convert, model, seed=7)
    rng = np.random.default_rng(8)
    for path, a in zip(tree_paths(tree), tree_leaves(tree)):
        if "scale" in path or path[-1] in ("bq", "bk", "bv"):
            a += 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    return tree


def _inputs(name, case, cfg, cases=None):
    """The case's tokens (B, prompt + steps) and extras (image embeddings,
    an encoder's frames), drawn from the case's index in ``cases``
    (default this file's CASES)."""
    rng = np.random.default_rng(sorted(cases or CASES).index(name))
    b, s, n = case["batch"], case["prompt"], case["steps"]
    tokens = rng.integers(0, cfg.vocab_size, (b, s + n))
    extras = {}
    if cfg.num_patches:
        extras["image_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        extras["frames"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return tokens, extras


# --- the ranks' jobs ---------------------------------------------------------------

def _serve(name, case, res, cases=None):
    """One case of ``cases`` (default CASES) on this rank: its rows and
    vocabulary block of every step's logits, where they lie, and the
    shapes of its caches."""
    cfg = _cfg(case)
    mesh = ProcessMesh(("data", "model"), case["mesh"], "cpu")
    model = build_model(cfg, tp=case["mesh"][1], compute_dtype=torch.float32,
                        device="cpu")
    b, s = case["batch"], case["prompt"]
    prules = trules.make_rules(mesh, "prefill", b,
                               kv_sharded=model.kv_sharded)
    drules = trules.make_rules(mesh, "decode", b,
                               kv_sharded=model.kv_sharded)
    convert.params_from_numpy(model, _tree(case), rules=prules)
    tokens, extras = _inputs(name, case, model.cfg, cases)
    bax = prules.batch_axes
    lo, hi = trules.block_range(b, mesh.axis_size(bax), mesh.axis_index(bax)) \
        if bax else (0, b)
    prefill, _ = make_serve_fns(model, rules=prules, max_len=case["max_len"])
    _, decode = make_serve_fns(model, rules=drules)
    batch = {"tokens": torch.from_numpy(tokens[lo:hi, :s]),
             **{k: torch.from_numpy(v[lo:hi]) for k, v in extras.items()}}
    logits, caches = prefill(batch)
    steps = [logits[:, 0]]
    for i in range(case["steps"]):
        logits, caches = decode(
            torch.from_numpy(tokens[lo:hi, s + i:s + i + 1]), caches, s + i)
        steps.append(logits[:, 0])
    v = model.cfg.vocab_size // case["mesh"][1]
    t = mesh.axis_index("model")
    res[f"{name}__logits"] = torch.stack(steps, 1).numpy()
    res[f"{name}__where"] = np.array([lo, hi, t * v, (t + 1) * v])
    res[f"{name}__cache_shapes"] = np.array(json.dumps(
        [list(c.shape) for c in tree_leaves(caches)]))


def _ep_inputs(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), **EP_CASES[arch])
    rng = np.random.default_rng(11)
    b, s = EP_SHAPE
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    p = {k: (rng.standard_normal(sp.shape) / np.sqrt(sp.shape[-2])).astype(
        np.float32) for k, sp in tmoe.moe_specs(cfg).items()}
    return cfg, x, p


def _ep(res):
    """The MoE layer alone under the prefill rules of (1, 4): this rank's
    sequence block of its output, and its aux loss."""
    mesh = ProcessMesh(("data", "model"), (1, 4), "cpu")
    rules = trules.make_rules(mesh, "prefill", EP_SHAPE[0])
    t = mesh.axis_index("model")
    for arch in EP_CASES:
        cfg, x, p = _ep_inputs(arch)
        e0, e1 = trules.block_range(cfg.num_experts, 4, t)
        f0, f1 = trules.block_range(cfg.shared_expert_d_ff, 4, t)
        local = {k: torch.from_numpy(
            v[e0:e1] if k in ("wi", "wg", "wo") else
            v[:, f0:f1] if k in ("shared_wi", "shared_wg") else
            v[f0:f1] if k == "shared_wo" else v) for k, v in p.items()}
        with tctx.sharding_ctx(rules, mesh, cfg.d_model):
            y, aux = tmoe.apply_moe(cfg, local, torch.from_numpy(x))
        res[f"ep_{arch}"] = y.numpy()
        res[f"ep_{arch}_aux"] = np.array(float(aux))


def _message(fn) -> str:
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _refusals(res):
    mesh = ProcessMesh(("data", "model"), (1, 4), "cpu")
    out = {"mesh_of_2_in_4": _message(
        lambda: ProcessMesh(("data", "model"), (1, 2), "cpu"))}
    for arch in MIXER_ARCHS:
        model = build_model(get_config(arch).reduced(), tp=4, device="cpu")
        rules = trules.make_rules(mesh, "prefill", 2,
                                  kv_sharded=model.kv_sharded)
        out[arch] = _message(lambda: model.init(torch.Generator(), rules))
    model = build_model(get_config("qwen1.5-0.5b").reduced(), tp=4,
                        device="cpu")
    out["no_tp"] = _message(lambda: model.init(
        torch.Generator(), trules.make_rules(mesh, "train", 4, no_tp=True)))
    out["tp_mismatch"] = _message(lambda: build_model(
        get_config("qwen1.5-0.5b").reduced(), tp=2, device="cpu").init(
            torch.Generator(), trules.make_rules(mesh, "prefill", 2)))
    rules = trules.make_rules(mesh, "prefill", 2)
    model.init(torch.Generator(), rules)
    out["outside_the_context"] = _message(
        lambda: model.prefill({"tokens": torch.zeros((2, 4), dtype=torch.long)}))
    res["refusals"] = np.array(json.dumps(out))


def _world(rank, world, res):
    for name, case in CASES.items():
        if case["mesh"][0] * case["mesh"][1] == world:
            _serve(name, case, res)
    if world == 4:
        _ep(res)
        _refusals(res)
    return res


def _rank_main(rank, world, init_file, out, job=None):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=90))
    try:
        res = (job or _world)(rank, world, {})
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, world: int, job=None) -> list:
    """``job(rank, world, res)`` (default this file's cases) on ``world``
    gloo ranks; every rank's ``res``, in rank order."""
    out = tmp_path / f"world{world}"
    out.mkdir()
    ctx = mp.spawn(_rank_main, args=(world, str(tmp_path / f"{world}.rdzv"),
                                     str(out), job), nprocs=world, join=False)
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=2):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("lm_tp"), 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("lm_tp"), 4)


# --- the JAX package's side ----------------------------------------------------------

def jax_steps(name, case, cases=None) -> np.ndarray:
    """(B, steps + 1, V) float32: the padded JAX model's prefill and decode
    logits, unsharded, on the case's tree and inputs (a case of ``cases``,
    default CASES)."""
    jmodel = jbuild(_cfg(case, jget_config), tp=case["mesh"][1],
                    compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(case))
    tokens, extras = _inputs(name, case, jmodel.cfg, cases)
    s = case["prompt"]
    # jitted: 4-6x faster than op-by-op on the CPU at these sizes
    prefill = jax.jit(lambda p, b: jmodel.prefill(p, b,
                                                  max_len=case["max_len"]))
    decode = jax.jit(jmodel.decode_step)
    logits, caches = prefill(
        params, {"tokens": jnp.asarray(tokens[:, :s]),
                 **{k: jnp.asarray(v) for k, v in extras.items()}})
    steps = [logits[:, -1]]
    for i in range(case["steps"]):
        logits, caches = decode(params, jnp.asarray(tokens[:, s + i:s + i + 1]),
                                caches, jnp.int32(s + i))
        steps.append(logits[:, -1])
    return np.stack([np.asarray(x, np.float32) for x in steps], 1)


def assemble(ranks, name, shape) -> np.ndarray:
    """Every rank's block in place; blocks held twice must be equal."""
    got = np.full(shape, np.nan, np.float32)
    for r in ranks:
        lo, hi, v0, v1 = r[f"{name}__where"]
        block = r[f"{name}__logits"]
        seen = got[lo:hi, :, v0:v1]
        assert np.isnan(seen).all() or np.array_equal(seen, block), name
        got[lo:hi, :, v0:v1] = block
    assert not np.isnan(got).any(), name
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_serving_matches_jax(name, world2, world4):
    case = CASES[name]
    ranks = world2 if case["mesh"] == (1, 2) else world4
    want = jax_steps(name, case)
    np.testing.assert_allclose(assemble(ranks, name, want.shape), want, **F32)


def test_edge_cases_take_their_layouts(world4):
    """The cases lay their caches out as meant: split by sequence (KV heads
    2 < tp 4: 24 positions -> 6 a rank, the ring of 8 slots -> 2), held
    whole (21 positions), by heads; the batch held whole on both data
    ranks when "data" does not divide it; and the MoE cases drop
    assignments for want of capacity."""
    def shapes(name):
        return json.loads(str(world4[0][f"{name}__cache_shapes"]))
    assert shapes("kv_seq_split") == [[2, 2, 6, 2, 32], [2, 2, 6, 2, 32],
                                      [2, 2, 2, 2, 32], [2, 2, 2, 2, 32]]
    assert shapes("kv_seq_split_odd_prompt") == [[2, 1, 14, 1, 32]] * 2
    assert shapes("kv_whole_cache") == [[2, 2, 21, 2, 32]] * 2
    assert shapes("qwen1.5-0.5b-1x4") == [[2, 2, 24, 1, 32]] * 2
    assert [list(r["batch_not_divided__where"][:2]) for r in world4] == \
        [[0, 3]] * 4
    for name in ("moe_drops", "moe_drops_2x2"):
        case = CASES[name]
        model = build_model(_cfg(case), tp=case["mesh"][1],
                            compute_dtype=torch.float32, device="cpu")
        convert.params_from_numpy(model, _tree(case))
        tokens, _ = _inputs(name, case, model.cfg)
        with chip_smoke.lm_moe_calls(tmoe.dropped_assignments) as drops:
            model.prefill({"tokens": torch.from_numpy(
                tokens[:, :case["prompt"]])}, case["max_len"])
        assert sum(drops) > 0, name


# --- expert parallelism against _grouped_manual and _grouped_auto -------------------

_MANUAL = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import moe
from repro.sharding.ctx import sharding_ctx
from repro.sharding.rules import make_rules
import dataclasses
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
for arch, over in OVER.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    z = np.load(f"{DIR}/{arch}.npz")
    p = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("p_")}
    rules = make_rules(mesh, "prefill", int(z["x"].shape[0]))
    with sharding_ctx(rules, mesh):
        y, aux = jax.jit(lambda p, x: moe.apply_moe(cfg, p, x))(
            p, jnp.asarray(z["x"]))
    np.savez(f"{DIR}/{arch}_manual.npz", y=np.asarray(y), aux=np.asarray(aux))
"""


@pytest.fixture(scope="module")
def manual_moe(tmp_path_factory):
    d = tmp_path_factory.mktemp("manual_moe")
    for arch in EP_CASES:
        _, x, p = _ep_inputs(arch)
        np.savez(d / f"{arch}.npz", x=x, **{f"p_{k}": v for k, v in p.items()})
    run_with_devices(f"OVER = {EP_CASES!r}\nDIR = {str(d)!r}\n" + _MANUAL, 4,
                     extra_env={"REPRO_MOE_MANUAL": "1"}, timeout=300)
    return {arch: dict(np.load(d / f"{arch}_manual.npz")) for arch in EP_CASES}


@pytest.mark.parametrize("arch", sorted(EP_CASES))
def test_expert_parallel_matches_grouped_manual_and_auto(arch, world4,
                                                         manual_moe):
    """The port's EP prefill on (1, 4), gathered by sequence, against the
    reference's shard_map region (REPRO_MOE_MANUAL=1, a 4-device host
    mesh) and its unsharded _grouped_auto; the aux loss from the global
    routing. qwen3-moe's capacity drops assignments, the same in all
    three."""
    cfg, x, p = _ep_inputs(arch)
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **EP_CASES[arch])
    auto, auto_aux = jmoe.apply_moe(jcfg, {k: jnp.asarray(v)
                                           for k, v in p.items()},
                                    jnp.asarray(x))
    got = np.concatenate([r[f"ep_{arch}"] for r in world4], axis=1)
    np.testing.assert_allclose(got, manual_moe[arch]["y"], **F32)
    np.testing.assert_allclose(got, np.asarray(auto), **F32)
    for r in world4:
        np.testing.assert_allclose(r[f"ep_{arch}_aux"], float(auto_aux),
                                   rtol=1e-6)
    np.testing.assert_allclose(manual_moe[arch]["aux"], float(auto_aux),
                               rtol=1e-6)
    if arch.startswith("qwen3"):
        assert tmoe.dropped_assignments(cfg, {k: torch.from_numpy(v)
                                              for k, v in p.items()},
                                        torch.from_numpy(x)) > 0


# --- refusals ------------------------------------------------------------------------

def test_sharded_runs_refuse(world4):
    """Before any work: a mesh whose size is not the group's; the no_tp
    rules on a model padded for tp 4 (they take the model at tp 1, as the
    reference builds it); a mesh "model" axis other than the
    model's tp; a sharded model called outside its context. MLA, the
    SSD, the RG-LRU and the encoder-decoder lay out under rules at tp 4
    (tests/test_torch_lm_tp_mixers.py serves them)."""
    got = json.loads(str(world4[0]["refusals"]))
    assert got["mesh_of_2_in_4"].startswith("ValueError") and \
        "world size is 4" in got["mesh_of_2_in_4"]
    for arch in MIXER_ARCHS:
        assert got[arch] == "no error", got[arch]
    assert got["no_tp"].startswith("ValueError") and \
        "model built at tp=1" in got["no_tp"], got["no_tp"]
    assert got["tp_mismatch"].startswith("ValueError: the model is padded")
    assert got["outside_the_context"].startswith("ValueError") and \
        "sharding_ctx" in got["outside_the_context"]


def test_no_group_and_backend_refusals(tmp_path):
    """No group: a mesh of 2 devices refuses; a world-size-1 gloo group
    refuses a mesh on a CUDA device (gloo carries CPU tensors here), as
    NCCL refuses the CPU (runtime/spmd.py::check_backend)."""
    with pytest.raises(ValueError, match="none is initialised"):
        ProcessMesh(("data", "model"), (1, 2), "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="backend is gloo"):
            ProcessMesh(("data", "model"), (1, 1), torch.device("cuda", 0))
        mesh = ProcessMesh(("data", "model"), (1, 1), "cpu")
        x = torch.ones(3, 4)
        assert mesh.all_gather(x, "model", 1) is x
        assert mesh.reduce_scatter(x, "data", 0) is x
        assert mesh.all_reduce(x, ("data", "model")) is x
    finally:
        dist.destroy_process_group()


def test_training_and_layouts_refuse_under_rules():
    """Model.loss takes no serving rules; for every family (qwen, llama4's
    MoE, minicpm3's MLA, mamba2's SSD, recurrentgemma's RG-LRU and
    whisper's encoder-decoder) on a (1, 1) mesh Model.loss under the
    train rules is the unsharded loss bit for bit
    (tests/test_torch_lm_train_tp*.py hold them on 2 and 4 ranks);
    constrain refuses a tensor that is not this rank's block of its
    role."""
    mesh = ProcessMesh(("data", "model"), (1, 1), "cpu")
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.long),
             "labels": torch.zeros((2, 4), dtype=torch.long)}
    for arch in ("qwen1.5-0.5b", "llama4-scout-17b-a16e", "minicpm3-4b",
                 "mamba2-130m", "recurrentgemma-2b", "whisper-medium"):
        cfg = get_config(arch).reduced()
        model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
        rules = trules.make_rules(mesh, "train", 2,
                                  kv_sharded=model.kv_sharded)
        params = model.master_params(
            generator=torch.Generator().manual_seed(3))
        b = dict(batch)
        if cfg.family == "audio":
            b["frames"] = torch.randn(
                (2, cfg.encoder_len, cfg.d_model),
                generator=torch.Generator().manual_seed(4))
        with tctx.sharding_ctx(rules, mesh, cfg.d_model):
            sharded = model.loss(b, params)
        assert torch.equal(sharded, model.loss(b, params)), arch
    with tctx.sharding_ctx(trules.make_rules(mesh, "prefill", 2), mesh,
                           cfg.d_model):
        with pytest.raises(ValueError, match="train rules"):
            model.loss(batch, params)
    fake = SimpleNamespace(shape={"data": 2, "model": 4},
                           axis_names=("data", "model"),
                           axis_size=lambda a: 2 if a in ("data", ("data",))
                           else 4 if a in ("model", ("model",)) else 8,
                           axis_index=lambda a: 1)
    prules = trules.make_rules(fake, "prefill", 4)
    with tctx.sharding_ctx(prules, fake, 16):
        x = torch.zeros(2, 3, 16)
        assert tctx.constrain(x, "act_btd", (4, 12, 16)) is x
        with pytest.raises(ValueError, match="act_btd"):
            tctx.constrain(x, "act_btd", (4, 16, 16))
        assert tctx.constrain(x, "not_a_role", (1,)) is x
    assert tctx.constrain(x, "act_btd", (9, 9, 9)) is x
