"""repro_torch's training path (AdamW, the train step, the walk corpus,
checkpoint / restart, the int8 DP sync, the launcher) against the JAX
package's, on the CPU.

Both packages get the same parameter tree (``chip_smoke.
lm_reference_params``) and the same batches (the walk corpus, whose
tokens the two packages draw bit for bit). Tolerances: ``adamw_update``
fed the same gradients, state and parameters within 1e-6 relative, plus
1e-6 of the leaf's largest magnitude (the clip scale comes from a norm
summed in another order, and an updated weight near 0 is a difference of
two close numbers);
three train steps of every config's ``reduced()`` within 1e-5 (step 1's
loss and grad norm, and every loss) and 1e-4 (later grad norms, the
parameter checksums) of the JAX package's: Adam moves a weight by ~lr
whatever the size of its gradient, so a gradient near 0 that differs in
sign moves it by 2 lr. The walk corpus, checkpoints (either package
restores the other's) and ``dp_sync`` (gloo ranks against JAX devices)
are bit-equal.

The committed ``src/repro_torch/reference_train.json``, which
``chip_smoke.py`` holds the card to, is made here by the JAX package
(``chip_smoke.train_batches`` on its corpus, three steps of its
``make_train_step``); a test regenerates its reduced entries. To rewrite
it after a deliberate change:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_train.py

and add ``--full`` for qwen1.5-0.5b at its published widths (depth cut to
``chip_smoke.LM_FULL_LAYERS``; ~1 min, ~6 GB).
"""
import dataclasses
import datetime
import functools
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the training record both sides share)

from helpers import run_with_devices  # noqa: E402
from test_torch_dp_worker import dp_inputs, rank_main  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_paths  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import compress as tcompress  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

REFERENCE = REPO / "src" / "repro_torch" / "reference_train.json"
CPU_RTOL = 1e-5                       # step 1, and every step's loss
CPU_LATER = {"loss": 1e-5, "grad_norm": 1e-4}
CPU_CHECKSUM_RTOL = 1e-4
ADAMW_RTOL = 1e-6
DP_RANKS = (2, 4, 8)
SPAWN_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (see test_torch_api.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jkey(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jnamed(tree) -> dict:
    return {_jkey(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tnamed(tree) -> dict:
    return {"/".join(map(str, p)): t.detach().cpu().numpy()
            for p, t in zip(tree_paths(tree), tree_leaves(tree))}


@functools.lru_cache(maxsize=None)
def _jax_corpus(vocab_size: int):
    return jdata.WalkCorpus(jdata.WalkCorpusConfig(
        vocab_size=vocab_size, **chip_smoke.TRAIN_CORPUS))


def _jax_corpus_batches(arch: str, width: str):
    cfg = chip_smoke.lm_config(jget_config, arch, width)
    b, s = chip_smoke.TRAIN_REF_SHAPES[width]
    corpus = _jax_corpus(cfg.vocab_size)
    corpus.restore({"cursor": 0, "seed": chip_smoke.TRAIN_CORPUS["seed"]})
    return chip_smoke.train_batches(np, corpus, cfg,
                                    chip_smoke.TRAIN_REF_STEPS, b, s)


def _reference_tree(arch: str, width: str):
    cfg = chip_smoke.lm_config(get_config, arch, width)
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    return model, chip_smoke.lm_reference_params(convert, model)


def _jax_router_margin(jmodel, jparams, micro) -> float:
    """The least router margin (chip_smoke.lm_router_margin) over the MoE
    calls of the JAX package's loss on ``micro``."""
    seen, apply = [], jmoe.apply_moe

    def recorded(cfg, p, x):
        probs = jax.nn.softmax(x @ p["router"].astype(jnp.float32), axis=-1)
        top = jax.lax.top_k(probs, cfg.top_k + 1)[0]
        jax.debug.callback(lambda m: seen.append(float(m)),
                           (top[..., -2] - top[..., -1]).min())
        return apply(cfg, p, x)

    jmoe.apply_moe = recorded
    try:
        jax.jit(jmodel.loss)(jparams, micro)
        jax.effects_barrier()
    finally:
        jmoe.apply_moe = apply
    return min(seen)


def jax_reference_case(arch: str, width: str) -> dict:
    """A reference case made by the JAX package: its corpus's batches,
    TRAIN_REF_STEPS steps of its jitted make_train_step from the reference
    tree, each step's metrics and the checksums after the last."""
    cfg = chip_smoke.lm_config(jget_config, arch, width)
    batches = _jax_corpus_batches(arch, width)
    _, tree = _reference_tree(arch, width)
    jmodel = jbuild(cfg, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    del tree
    opt = chip_smoke.TRAIN_REF_OPT
    rec = {"arch": arch, "width": width, "num_layers": cfg.num_layers,
           "batch": int(batches[0]["tokens"].shape[1]),
           "seq": int(batches[0]["tokens"].shape[2]), "opt": opt,
           "corpus_sha256": chip_smoke.corpus_sha256(np, batches),
           "loss": [], "grad_norm": [], "lr": []}
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    if cfg.moe:
        rec["least_router_margin"] = _jax_router_margin(
            jmodel, params, {k: v[0] for k, v in jb[0].items()})
    state = jopt.init_opt_state(params)
    step = jax.jit(jstep.make_train_step(jmodel, jopt.AdamWConfig(**opt)))
    for b in jb:
        params, state, m = step(params, state, b)
        for k in ("loss", "grad_norm", "lr"):
            rec[k].append(float(m[k]))
    rec["checksums"] = chip_smoke.train_checksums(np, _jnamed(params))
    return rec


def port_reference_run(arch: str, width: str) -> dict:
    """The port's side of a reference case on the CPU, on the port's own
    corpus."""
    model, tree = _reference_tree(arch, width)
    b, s = chip_smoke.TRAIN_REF_SHAPES[width]
    corpus = chip_smoke.train_corpus("cpu", model.cfg.vocab_size)
    batches = chip_smoke.train_batches(np, corpus, model.cfg,
                                       chip_smoke.TRAIN_REF_STEPS, b, s)
    rec = chip_smoke.train_port_record(torch, np, model, tree, batches,
                                       chip_smoke.TRAIN_REF_OPT)
    rec["corpus_sha256"] = chip_smoke.corpus_sha256(np, batches)
    return rec


# --- the reference file ---------------------------------------------------------

@pytest.mark.parametrize("arch", chip_smoke.LM_ARCHS)
def test_train_steps_match_the_reference(arch):
    """The file's reduced entry regenerated from the JAX package; the
    port's corpus digest and three train steps (loss, grad norm, lr,
    checksums) on the CPU against it, at CPU_RTOL / CPU_LATER."""
    want = json.loads(REFERENCE.read_text())["cases"][f"{arch} reduced"]
    fresh = jax_reference_case(arch, "reduced")
    for k in ("corpus_sha256", "batch", "seq", "opt", "num_layers", "lr"):
        assert fresh[k] == want[k], k
    assert ("least_router_margin" in want) == get_config(arch).moe
    assert chip_smoke.train_mismatches(fresh, want, 1e-6, {
        "loss": 1e-6, "grad_norm": 1e-6}, 1e-6) == []
    got = port_reference_run(arch, "reduced")
    assert got["corpus_sha256"] == want["corpus_sha256"]
    assert chip_smoke.train_mismatches(got, want, CPU_RTOL, CPU_LATER,
                                       CPU_CHECKSUM_RTOL) == []
    if "least_router_margin" in want:
        np.testing.assert_allclose(got["least_router_margin"],
                                   want["least_router_margin"], rtol=1e-5,
                                   atol=1e-6)


def test_reference_train_covers_the_cases():
    ref = json.loads(REFERENCE.read_text())
    assert sorted(ref["cases"]) == sorted(
        [f"{a} reduced" for a in chip_smoke.LM_ARCHS] +
        ["qwen1.5-0.5b full_width"])
    full = ref["cases"]["qwen1.5-0.5b full_width"]
    assert (full["batch"], full["seq"]) == \
        chip_smoke.TRAIN_REF_SHAPES["full_width"]
    assert full["num_layers"] == chip_smoke.LM_FULL_LAYERS["qwen1.5-0.5b"]


def test_train_mismatches_catch_a_wrong_step():
    want = json.loads(REFERENCE.read_text())["cases"]["qwen1.5-0.5b reduced"]
    assert chip_smoke.train_mismatches(want, want, 0, {"loss": 0,
                                                       "grad_norm": 0}, 0) \
        == []
    for key, i in (("loss", 0), ("grad_norm", 2), ("lr", 1)):
        bad = json.loads(json.dumps(want))
        bad[key][i] *= 1 + 1e-3
        assert chip_smoke.train_mismatches(bad, want, 1e-4, {
            "loss": 1e-4, "grad_norm": 1e-4}, 1e-4) != []
    bad = json.loads(json.dumps(want))
    bad["checksums"]["embed/tok"][1] *= 1.01
    assert chip_smoke.train_mismatches(bad, want, 1e-4, {
        "loss": 1e-4, "grad_norm": 1e-4}, 1e-3) != []


def test_train_precision_passes_bf16_and_fails_without_a_control(
        monkeypatch):
    """chip_smoke.train_precision, the card's bf16-against-float32 gate, at
    qwen1.5-0.5b's reduced(): sound bf16 within every TRAIN_BF16_* bound
    with every control past it; the same batch as its own control leaves
    the grad-norm and leaf controls at 0, and a bf16 side that reads the
    other batch passes every bound."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    bf16, f32 = (build_model(cfg, compute_dtype=d, device="cpu")
                 for d in (torch.bfloat16, torch.float32))
    params = f32.master_params(chip_smoke.lm_reference_params(convert, f32))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 4, 33))
    b1, b2 = ({"tokens": torch.from_numpy(t[:, :-1]),
               "labels": torch.from_numpy(t[:, 1:])} for t in toks)
    sound = chip_smoke.train_precision(torch, bf16, f32, params, b1, b2)
    assert chip_smoke.precision_failures(sound) == [], sound
    no_control = chip_smoke.train_precision(torch, bf16, f32, params, b1, b1)
    assert [b.split("'")[0] for b in chip_smoke.precision_failures(
        no_control)] == ["grad_norm", "leaf_rel_l2"]
    loss = bf16.loss
    monkeypatch.setattr(bf16, "loss", lambda batch, p: loss(b2, p))
    wrong = chip_smoke.train_precision(torch, bf16, f32, params, b1, b2)
    assert [b.split(" ")[0] for b in chip_smoke.precision_failures(
        wrong)] == ["loss", "grad_norm", "leaf_rel_l2"]


# --- AdamW ------------------------------------------------------------------------

@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_jax(clipped):
    """Fed the same gradients, state and parameters (a later step, non-zero
    moments; the clip active or not), the port's update is the JAX
    package's within ADAMW_RTOL relative, leaf by leaf."""
    rng = np.random.default_rng(3)
    shapes = {"a": (64, 32), "b": [(7,), (3, 5, 2)]}
    scale = 1.0 if clipped else 1e-3

    def draw(s=1.0):
        return {"a": (s * rng.standard_normal(shapes["a"])).astype(
            np.float32),
                "b": [(s * rng.standard_normal(x)).astype(np.float32)
                      for x in shapes["b"]]}
    params, grads, m, v = draw(), draw(scale), draw(1e-2), draw(1e-2)
    v = jax.tree_util.tree_map(np.abs, v)
    cfg = dict(lr=3e-3, warmup_steps=10, weight_decay=0.1)
    jp, js, jmet = jopt.adamw_update(
        jopt.AdamWConfig(**cfg), jax.tree_util.tree_map(jnp.asarray, grads),
        {"m": jax.tree_util.tree_map(jnp.asarray, m),
         "v": jax.tree_util.tree_map(jnp.asarray, v),
         "step": jnp.int32(4)}, jax.tree_util.tree_map(jnp.asarray, params))
    t = functools.partial(jax.tree_util.tree_map, torch.from_numpy)
    tp, ts, tmet = topt.adamw_update(
        topt.AdamWConfig(**cfg), t(grads),
        {"m": t(m), "v": t(v), "step": torch.tensor(4, dtype=torch.int32)},
        t(params))
    assert int(ts["step"]) == int(js["step"]) == 5
    assert (float(jmet["grad_norm"]) > 1.0) == clipped
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=ADAMW_RTOL)
    assert float(tmet["lr"]) == float(jmet["lr"])
    worst = 0.0
    for ours, theirs in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            a, b = a.numpy(), np.asarray(b)
            scale = float(np.abs(b).max())
            worst = max(worst, float(np.abs(a - b).max()) / scale)
            np.testing.assert_allclose(a, b, rtol=ADAMW_RTOL,
                                       atol=ADAMW_RTOL * scale)
    print(f"adamw_update: max difference {worst:.3g} of the leaf's scale")


def test_opt_state_struct_matches():
    model, tree = _reference_tree("qwen1.5-0.5b", "reduced")
    params = model.master_params(tree)
    state = topt.init_opt_state(params)
    struct = topt.opt_state_struct(params)
    for a, b in zip(tree_leaves(state), tree_leaves(struct)):
        assert tuple(a.shape) == b.shape and a.dtype == b.dtype
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


# --- the train step ----------------------------------------------------------------

def _tiny(seed_tokens: int = 0):
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    tree = chip_smoke.lm_reference_params(convert, model)
    return cfg, model, tree


def test_grad_accum_equivalence():
    """accum=2 over a 2x batch == accum=1 over the same tokens (the port of
    tests/test_train.py's case)."""
    cfg, model, tree = _tiny()
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 33))
    b1 = {"tokens": toks[None, :, :-1], "labels": toks[None, :, 1:]}
    b2 = {"tokens": toks[:, :-1].reshape(2, 4, 32),
          "labels": toks[:, 1:].reshape(2, 4, 32)}
    step = tstep.make_train_step(model, opt)
    out = []
    for b in (b1, b2):
        p = model.master_params(tree)
        out.append(step(p, topt.init_opt_state(p), b))
    (p1, _, m1), (p2, _, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-6)


def test_train_step_descends_and_counts():
    """The reference init (convert.numpy_params), accum 2, and a vocab of
    4096 over a 1024-vertex corpus: a quarter of the tokens occur, which
    the first steps learn. (At the reduced vocab of 512 over 2048 vertices
    neither package's loss falls in 8 steps: both read 6.239 -> 6.25.)"""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              vocab_size=4096)
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    params = model.master_params(convert.numpy_params(model, 0))
    state = topt.init_opt_state(params)
    step = tstep.make_train_step(model, topt.AdamWConfig(lr=3e-3,
                                                         warmup_steps=1))
    corpus = tdata.WalkCorpus(tdata.WalkCorpusConfig(
        generator="pba", num_vertices=1024, vocab_size=cfg.vocab_size,
        seed=0), device="cpu")
    it = tdata.batches(corpus, 8, 32, accum=2)
    losses = [float(step(params, state, next(it))[2]["loss"])
              for _ in range(8)]
    assert losses[-1] < losses[0] - 0.1, losses
    assert int(state["step"]) == 8


def test_train_step_refuses_sharding_rules_and_builds_batch_structs():
    cfg, model, _ = _tiny()
    with pytest.raises(NotImplementedError, match="15d"):
        tstep.make_train_step(model, topt.AdamWConfig(), rules=object())
    for arch in ("qwen1.5-0.5b", "phi-3-vision-4.2b", "whisper-medium"):
        for bf16 in (False, True):
            model = build_model(get_config(arch).reduced(), device="cpu",
                                compute_dtype=torch.bfloat16 if bf16
                                else torch.float32)
            jmodel = jbuild(jget_config(arch).reduced(),
                            compute_dtype=jnp.bfloat16 if bf16
                            else jnp.float32)
            ours = tstep.batch_struct(model, 8, 32, 2)
            theirs = jstep.batch_struct(jmodel, 8, 32, 2)
            assert sorted(ours) == sorted(theirs)
            for k in ours:
                assert ours[k].shape == theirs[k].shape
                assert str(ours[k].dtype).split(".")[-1] == \
                    str(theirs[k].dtype)


# --- the walk corpus ---------------------------------------------------------------

@pytest.mark.parametrize("generator", ["pba", "pk", "zipf"])
def test_walk_corpus_matches_jax(generator):
    """The port's corpus (its graph from the port's generate on the CPU)
    draws the JAX package's tokens bit for bit, and so after state() /
    restore() into a fresh corpus."""
    kw = dict(generator=generator, num_vertices=4096, vocab_size=1000,
              seed=3)
    ours = tdata.WalkCorpus(tdata.WalkCorpusConfig(**kw), device="cpu")
    theirs = jdata.WalkCorpus(jdata.WalkCorpusConfig(**kw))
    assert ours.n == theirs.n
    if generator != "zipf":
        np.testing.assert_array_equal(ours.deg, theirs.deg)
    for _ in range(2):
        a, b = ours.next_batch(4, 48), theirs.next_batch(4, 48)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    state = ours.state()
    assert state == theirs.state()
    want = theirs.next_batch(3, 16)
    fresh = tdata.WalkCorpus(tdata.WalkCorpusConfig(**kw), device="cpu")
    fresh.restore(state)
    got = fresh.next_batch(3, 16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="seed"):
        fresh.restore({"cursor": 0, "seed": 4})


def test_launcher_corpus_graph_matches_jax():
    """The launcher's corpus graph (8192 vertices, 8 logical procs, k = 8):
    the port's edges equal the JAX package's, with the pair capacity the
    port pins equal to the one the JAX package derives on the CPU."""
    from repro import api as japi
    cfg = tdata.WalkCorpusConfig(vocab_size=512, **chip_smoke.TRAIN_CORPUS)
    spec = tdata.corpus_spec(cfg)
    ours = tdata.WalkCorpus(cfg, device="cpu")
    theirs = japi.generate(japi.GraphSpec(**{
        f: getattr(spec, f) for f in ("model", "procs", "vertices_per_proc",
                                      "edges_per_vertex", "seed",
                                      "execution")},
        factions=japi.FactionSpec(**vars(spec.factions))))
    assert spec.pair_capacity == theirs.stats.pair_capacity == \
        ours.stats.pair_capacity
    src, dst = theirs.edges.to_numpy()
    indptr, indices = jdata.to_csr(src, dst, theirs.edges.num_vertices)
    np.testing.assert_array_equal(ours.indptr, indptr)
    np.testing.assert_array_equal(ours.indices, indices)


# --- checkpoints --------------------------------------------------------------------

def _trained_state(model, tree, steps: int = 1):
    params = model.master_params(tree)
    state = topt.init_opt_state(params)
    step = tstep.make_train_step(model, topt.AdamWConfig(lr=1e-3,
                                                         warmup_steps=1))
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab_size,
                                             (1, 2, 17))
    for _ in range(steps):
        params, state, _ = step(params, state, {"tokens": toks[..., :-1],
                                                "labels": toks[..., 1:]})
    return params, state


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_packages(writer, tmp_path):
    """One package saves, the other loads: every leaf, the step and the
    manifest's extras equal; a shape that differs raises."""
    cfg, model, tree = _tiny()
    params, state = _trained_state(model, tree)
    extra = {"arch": cfg.name, "data": {"cursor": 42, "seed": 0}}
    jparams = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.detach().numpy()), params)
    jstate = {"m": jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                          state["m"]),
              "v": jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                          state["v"]),
              "step": jnp.int32(int(state["step"]))}
    jmodel = jbuild(jget_config("qwen1.5-0.5b").reduced(),
                    compute_dtype=jnp.float32)
    if writer == "jax":
        d = jckpt.save_checkpoint(str(tmp_path), 7, jparams, jstate, extra)
        assert tckpt.latest_checkpoint(str(tmp_path)) == d
        p2, s2, man = tckpt.load_checkpoint(
            d, params, topt.opt_state_struct(params))
        got = (_tnamed(p2), _tnamed(s2["m"]), _tnamed(s2["v"]),
               int(s2["step"]))
    else:
        d = tckpt.save_checkpoint(str(tmp_path), 7, params, state, extra)
        assert jckpt.latest_checkpoint(str(tmp_path)) == d
        p2, s2, man = jckpt.load_checkpoint(
            d, jmodel.param_struct(),
            jopt.opt_state_struct(jmodel.param_struct()))
        got = (_jnamed(p2), _jnamed(s2["m"]), _jnamed(s2["v"]),
               int(s2["step"]))
    assert man["step"] == 7 and man["data"] == extra["data"]
    want = (_tnamed(params), _tnamed(state["m"]), _tnamed(state["v"]),
            int(state["step"]))
    assert got[3] == want[3] == 1
    for g, w in zip(got[:3], want[:3]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    like = dict(params, final_norm={"scale": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_checkpoint(d, like, topt.opt_state_struct(params))


def test_checkpoint_restart_exact(tmp_path):
    """Save at step 3, keep training; a restart from disk (fresh model
    state and corpus) gives an identical next step (the port of
    tests/test_train.py's case, bit for bit on the CPU)."""
    cfg, model, tree = _tiny()
    params = model.master_params(tree)
    state = topt.init_opt_state(params)
    step = tstep.make_train_step(model, topt.AdamWConfig(lr=1e-3,
                                                         warmup_steps=1))
    kw = dict(num_vertices=1024, vocab_size=cfg.vocab_size, seed=1)
    corpus = tdata.WalkCorpus(tdata.WalkCorpusConfig(**kw), device="cpu")
    it = tdata.batches(corpus, 4, 32)
    for _ in range(3):
        params, state, _ = step(params, state, next(it))
    tckpt.save_checkpoint(str(tmp_path), 3, params, state,
                          {"data": corpus.state()})
    b4 = next(it)
    pa, _, ma = step(params, state, b4)
    pa = _tnamed(pa)

    model2 = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    like = model2.master_params(tree)
    p2, s2, man = tckpt.load_checkpoint(
        tckpt.latest_checkpoint(str(tmp_path)), like,
        topt.opt_state_struct(like))
    corpus2 = tdata.WalkCorpus(tdata.WalkCorpusConfig(**kw), device="cpu")
    corpus2.restore(man["data"])
    b4r = next(tdata.batches(corpus2, 4, 32))
    np.testing.assert_array_equal(b4["tokens"], b4r["tokens"])
    pb, _, mb = tstep.make_train_step(model2, topt.AdamWConfig(
        lr=1e-3, warmup_steps=1))(model2.master_params(p2), s2, b4r)
    assert float(ma["loss"]) == float(mb["loss"])
    for k, v in _tnamed(pb).items():
        np.testing.assert_array_equal(v, pa[k])


# --- int8 compression and the DP sync --------------------------------------------

def test_quantize_roundtrip_matches_jax():
    x = np.random.default_rng(0).normal(size=(128, 64)).astype(np.float32)
    q, s = tcompress.quantize(torch.from_numpy(x))
    jq, js = jcompress.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and float(s) == float(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    err = np.abs(tcompress.dequantize(q, s).numpy() - x).max()
    assert err <= float(s) * 0.51  # half-ulp of the int8 grid
    np.testing.assert_array_equal(tcompress.dequantize(q, s).numpy(),
                                  np.asarray(jcompress.dequantize(jq, js)))


JAX_DP = """
import numpy as np, jax, jax.numpy as jnp
from repro.runtime import spmd
from repro.train.compress import dp_sync
inputs = dict(np.load({inputs!r}))
out = {{}}
for world in {ranks}:
    mesh = spmd.make_proc_mesh(world, axis_name="data")
    err = None
    for i in range(2):
        g = {{"w": jnp.asarray(inputs[f"{{world}}_{{i}}_w"]),
              "b": [jnp.asarray(inputs[f"{{world}}_{{i}}_b"])]}}
        red, err = dp_sync(g, err, mesh=mesh, axis_name="data")
        for name, tree in (("red", red), ("err", err)):
            for j, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                out[f"{{world}}_{{i}}_{{name}}_{{j}}"] = np.asarray(leaf)
np.savez({out!r}, **out)
"""


@pytest.fixture(scope="module")
def jax_dp_sync(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_dp")
    inputs = {f"{world}_{i}_{k}": (g[k] if k == "w" else g[k][0])
              for world in DP_RANKS
              for i, g in enumerate(dp_inputs(world)) for k in ("w", "b")}
    np.savez(tmp / "inputs.npz", **inputs)
    out = tmp / "jax.npz"
    run_with_devices(JAX_DP.format(inputs=str(tmp / "inputs.npz"),
                                   ranks=DP_RANKS, out=str(out)), 8)
    return dict(np.load(out))


@pytest.mark.parametrize("world", DP_RANKS)
def test_dp_sync_over_gloo_matches_jax(world, jax_dp_sync, tmp_path):
    """Each gloo rank's reduced mean and error buffers, two steps (the
    second carrying the first's error), equal the JAX package's dp_sync on
    as many devices, bit for bit; every rank holds the same mean."""
    ctx = mp.spawn(rank_main, args=(world, str(tmp_path / "rdzv"),
                                   str(tmp_path)), nprocs=world, join=False)
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=5):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish")
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    keys = [k for k in jax_dp_sync if k.startswith(f"{world}_")]
    assert keys and sorted(keys) == sorted(ranks[0])
    for k in keys:
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got[k], jax_dp_sync[k][r],
                                          err_msg=f"{k} rank {r}")
    mean = np.mean(dp_inputs(world)[0]["w"], axis=0)
    scale = np.abs(dp_inputs(world)[0]["w"]).max() / 127.0
    assert np.abs(ranks[0][f"{world}_0_red_1"] - mean).max() < 2 * scale


def test_dp_sync_without_a_group_is_one_rank():
    """With no process group dp_sync is the JAX package's on one device."""
    g = {"w": dp_inputs(1)[0]["w"]}
    red, err = tcompress.dp_sync(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a[0]), g))
    q, s = tcompress.quantize(torch.from_numpy(g["w"][0]))
    jred, jerr = jcompress.dp_sync(jax.tree_util.tree_map(jnp.asarray, g))
    np.testing.assert_array_equal(red["w"].numpy(), np.asarray(jred["w"])[0])
    np.testing.assert_array_equal(err["w"].numpy(), np.asarray(jerr["w"])[0])
    assert np.abs(red["w"].numpy() - tcompress.dequantize(q, s).numpy()) \
        .max() <= 1e-6 * float(s)          # q * (peak / 127) or its rewrite


# --- the launcher -------------------------------------------------------------------

def test_launcher_trains_then_restarts_on_the_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--batch", "4", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "6"]
    first = tlaunch.main(args + ["--steps", "12"])
    out = capsys.readouterr().out
    assert "[train] qwen1.5-0.5b: 394,624 params" in out
    assert "[train] done" in out and "restart" not in out
    assert [s for s, _ in first] == [1, 10]
    assert sorted(os.listdir(tmp_path)) == ["step_00000006",
                                            "step_00000012"]
    again = tlaunch.main(args + ["--steps", "14"])
    out = capsys.readouterr().out
    assert "[train] restart from step 12" in out
    assert [s for s, _ in again] == [13]
    assert all(np.isfinite(loss) for _, loss in first + again)


def write_reference(full: bool) -> None:
    """Rewrite reference_train.json's reduced entries, and its full-width
    entry with ``full`` (else the old one is kept)."""
    old = json.loads(REFERENCE.read_text()) if REFERENCE.exists() else {}
    cases = {f"{a} reduced": jax_reference_case(a, "reduced")
             for a in chip_smoke.LM_ARCHS}
    key = "qwen1.5-0.5b full_width"
    if full:
        cases[key] = jax_reference_case("qwen1.5-0.5b", "full_width")
    elif key in old.get("cases", {}):
        cases[key] = old["cases"][key]
    REFERENCE.write_text(json.dumps({
        "about": "Made by the JAX package on the CPU in float32 (tests/"
                 "test_torch_train.py): params from chip_smoke."
                 "lm_reference_params; the batches from its walk corpus "
                 "(chip_smoke.TRAIN_CORPUS, the launcher's: PBA, 8192 "
                 "vertices) by chip_smoke.train_batches (whisper's frames "
                 "and phi-3-vision's image embeddings from "
                 "default_rng(1)), corpus_sha256 their tokens and labels; "
                 "per step of its jitted make_train_step "
                 "(AdamWConfig(**opt)) the loss, grad norm and lr; the "
                 "float64 sums of magnitudes and of squares of three "
                 "leaves after "
                 "the last step; for MoE the least router margin of step "
                 "1's forward. The reduced entries are regenerated by a "
                 "test; the full-width one (qwen1.5-0.5b at its published "
                 "widths, 2 of 24 layers) only by `python tests/"
                 "test_torch_train.py --full`.",
        "cases": cases}, indent=1, sort_keys=True) + "\n")
    print(f"wrote {REFERENCE}")


if __name__ == "__main__":
    write_reference("--full" in sys.argv[1:])
