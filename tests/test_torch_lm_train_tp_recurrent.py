"""repro_torch's train step under sharding rules for the Mamba-2 SSD, the
RG-LRU and the encoder-decoder against the JAX package, on the CPU.

As ``tests/test_torch_lm_train_tp.py`` and ``..._mixers.py`` hold the GQA,
MoE and MLA families, gloo spawns of 2 and 4 ranks train mamba2-130m (the
SSD), recurrentgemma-2b (RG-LRU with local MQA) and whisper-medium (the
encoder-decoder over 64 frames), reduced, in float32, on the meshes (data,
model) = (1, 2), (1, 4) and (2, 2), under the TP rules and under
``no_tp``. Each rank loads its blocks of one numpy tree and its rows of
each batch (the frames too), takes step 1's gradients
(``train_step.train_grads``) and two steps of ``make_train_step(model,
opt, rules)``; the test assembles the blocks and holds them to the JAX
package's jitted ``make_train_step`` of the padded model run unsharded,
with ``test_torch_lm_train_tp``'s bounds: every gradient leaf within 1e-4
of its largest, step 1's loss and grad norm and step 2's loss within rtol
1e-5, step 2's grad norm 1e-4, the checksums 1e-4.

The edge cases: each config without sequence parallelism (the leaves the
mixers mark ``partial_grad`` are then the only ones summed over "model"),
whisper with KV heads "model" does not divide (the cross K/V held whole;
training never reaches the sequence-split combine that serving takes for
them), an SSD whose heads are padded for tp (18 -> 20), a sequence and a
frame count "model" does not divide, two microbatches, and the backward
pass on a thread of its own. The SSD layer alone, backward on (1, 4) with
and without sequence parallelism, equals the unsharded layer: its gated
norm's sum of squares carries its gradient summed over "model". A
checkpoint of each family written on (1, 4) continues there bit for bit,
restores on (2, 2) under both rule sets and reads back in the JAX package.
"""
import dataclasses
import datetime
import json
import math
import os
import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_lm_train_tp as gqa
import test_torch_lm_train_tp_mixers as mixers
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import tree_leaves, tree_paths
from repro_torch.runtime.mesh import ProcessMesh
from repro_torch.sharding import ctx as tctx
from repro_torch.sharding import rules as trules
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tstep

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SPAWN_TIMEOUT_S = 300
MAMBA2, RGEMMA, WHISPER = ("mamba2-130m", "recurrentgemma-2b",
                           "whisper-medium")
ARCHS = (MAMBA2, RGEMMA, WHISPER)
MESHES = ((1, 2), (1, 4), (2, 2))
OPT, GRAD_TOL, RTOL = gqa.OPT, gqa.GRAD_TOL, gqa.RTOL
LATER_GRAD_NORM_RTOL, CHECKSUM_RTOL = gqa.LATER_GRAD_NORM_RTOL, \
    gqa.CHECKSUM_RTOL
LAYER_TOL = 1e-5             # the SSD layer alone, of the largest gradient
_case = gqa._case
_tp, _cfg, _padded, _jkey = mixers._tp, mixers._cfg, mixers._padded, \
    mixers._jkey

CASES = {f"{arch}-{m[0]}x{m[1]}-{'no_tp' if no_tp else 'tp'}":
         _case(arch, m, no_tp)
         for arch in ARCHS for m in MESHES for no_tp in (False, True)}
CASES.update({
    "ssm_no_seq_parallel": _case(MAMBA2, (1, 4), False, seq_parallel=False),
    "rglru_no_seq_parallel": _case(RGEMMA, (1, 4), False,
                                   seq_parallel=False),
    "encdec_no_seq_parallel": _case(WHISPER, (1, 4), False,
                                    seq_parallel=False),
    # 2 KV heads < tp 4: the cross K/V held whole (serving would split
    # its 64 frames by position over "model")
    "cross_kv_whole": _case(WHISPER, (1, 4), False, dict(num_kv_heads=2)),
    # 18 SSD heads pad to 20 at tp 4
    "ssm_heads_padded": _case(MAMBA2, (1, 4), False,
                              dict(ssm_d_inner=288)),
    # 23 positions and 62 frames, each padded to a multiple of 4
    "seq_frames_padded": _case(WHISPER, (1, 4), False,
                               dict(encoder_len=62), seq=23),
    "rglru_seq_padded": _case(RGEMMA, (1, 4), False, seq=23),
    "ssm_accum2": _case(MAMBA2, (2, 2), False, batch=8, accum=2),
})
# the backward pass on a thread of its own (the card's autograd thread)
ELSEWHERE_CASES = (f"{MAMBA2}-1x4-tp", f"{WHISPER}-2x2-tp")
# a checkpoint of each family on (1, 4); restored on (2, 2) into the model
# the (1, 4) run padded (the SSD's 20 heads at tp 2 and 1 too)
CKPTS = {"ssm": _case(MAMBA2, (1, 4), False, dict(ssm_d_inner=288)),
         "rglru": _case(RGEMMA, (1, 4), False),
         "encdec": _case(WHISPER, (1, 4), False)}
CKPT_RESTORES = {"2x2-tp": ((2, 2), False), "2x2-no_tp": ((2, 2), True)}
SSD_LAYER = _case(MAMBA2, (1, 4), False)
# leaves whose zero or one init is perturbed, as the norms' scales are
PERTURBED = ("norm", "conv_xb", "conv_bb", "conv_cb", "a_log", "dt_bias",
             "d_skip", "ba", "bx")


def _tree(case):
    """The numpy tree of the case's padded model (base._tree's draws),
    the SSD's and the RG-LRU's zero-initialised vectors perturbed."""
    tree = gqa._tree(case)
    rng = np.random.default_rng(10)
    rec = bool(_cfg(case).rglru_width)
    for path, a in zip(tree_paths(tree), tree_leaves(tree)):
        if path[-1] in PERTURBED or (rec and path[-1] == "conv_b"):
            a += 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    return tree


def _fake_mesh(data: int, model: int, model_index: int = 0):
    """A stand-in mesh of (data, model) for the rules' tables: this rank
    at ``model_index`` on "model", 0 on "data"."""
    sizes = {"data": data, "model": model}
    at = {"data": 0, "model": model_index}

    def names(axes):
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def index(axes):
        out = 0
        for a in names(axes):
            out = out * sizes[a] + at[a]
        return out
    return SimpleNamespace(
        shape=sizes, axis_names=("data", "model"), axis_index=index,
        axis_size=lambda axes: math.prod(sizes[a] for a in names(axes)))


def _batches(case, steps: int = 2) -> list:
    """``steps`` batches of (accum, batch // accum, ...) leaves from the
    case's _jkey, with the encoder-decoder's frames."""
    cfg = _cfg(case)
    rng = np.random.default_rng(zlib.crc32(_jkey(case).encode()))
    a, b, s = case["accum"], case["batch"] // case["accum"], case["seq"]
    out = []
    for _ in range(steps):
        step = {k: rng.integers(0, cfg.vocab_size, (a, b, s)).astype(np.int32)
                for k in ("tokens", "labels")}
        if cfg.family == "audio":
            step["frames"] = rng.standard_normal(
                (a, b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        out.append(step)
    return out


# --- the ranks' jobs ---------------------------------------------------------------

def _setup(case, shape=None, no_tp=None, cfg=None):
    shape = shape or case["mesh"]
    no_tp = case["no_tp"] if no_tp is None else no_tp
    case = {**case, "mesh": shape, "no_tp": no_tp}
    mesh = ProcessMesh(("data", "model"), shape, "cpu")
    model = build_model(cfg or _cfg(case), tp=_tp(case),
                        compute_dtype=torch.float32, device="cpu")
    return model, gqa._rules(case, mesh, model)


def _train(name, case, res):
    model, rules = _setup(case)
    batches = mixers._rows(case, rules, _batches(case))
    params = model.master_params(_tree(case), rules=rules)
    loss, grads = tstep.train_grads(model, params, batches[0], rules)
    gqa._blocks(res, f"{name}__g", model, rules, grads)
    if name in ELSEWHERE_CASES:
        with gqa._backward_elsewhere():
            _, other = tstep.train_grads(model, params, batches[0], rules)
        res[f"{name}__elsewhere_equal"] = np.array(all(
            torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                              tree_leaves(other))))
    step = tstep.make_train_step(model, topt.AdamWConfig(**OPT), rules)
    state = topt.init_opt_state(params)
    metrics = []
    for i, b in enumerate(batches):
        params, state, m = step(params, state, b)
        metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        gqa._blocks(res, f"{name}__p{i + 1}", model, rules, params)
    res[f"{name}__metrics"] = np.array(metrics)
    res[f"{name}__loss1"] = np.array(float(loss))
    res[f"{name}__batch_axes"] = np.array(json.dumps(list(rules.batch_axes)))
    res[f"{name}__rows"] = np.array([b["tokens"].shape[1] for b in batches])
    if "frames" in batches[0]:
        res[f"{name}__frame_rows"] = np.array(batches[0]["frames"].shape)


def _ssd_layer(case):
    """(cfg, layer 0's SSD leaves as float32 tensors, their ParamSpecs, x,
    r): the layer's input and the weights of the loss sum(y * r)."""
    model = _padded(case)
    layer = _tree(case)["stack"]["groups"][0]["mixer"]
    whole = {k: torch.from_numpy(np.array(v[0])) for k, v in layer.items()}
    rng = np.random.default_rng(12)
    shape = (case["batch"], case["seq"], model.cfg.d_model)
    x, r = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    return model.cfg, whole, tssm.ssm_specs(model.cfg), x, r


def _ssd_layer_grads(res):
    """The SSD layer alone on (1, 4), sum(y * r) backward with and without
    sequence parallelism: this rank's block of each leaf's gradient
    (summed over the axes the train step sums it over) and of the
    input's."""
    cfg, whole, specs, x, r = _ssd_layer(SSD_LAYER)
    mesh = ProcessMesh(("data", "model"), SSD_LAYER["mesh"], "cpu")
    s = x.shape[1]
    for sp in (True, False):
        rules = trules.make_rules(mesh, "train", SSD_LAYER["batch"],
                                  seq_parallel=sp)
        p = {k: v[trules.local_slices(rules.param_pspec(specs[k]),
                                      specs[k].shape, mesh)].clone()
             .requires_grad_(True) for k, v in whole.items()}
        with tctx.sharding_ctx(rules, mesh, cfg.d_model):
            xl = tctx.split_seq(x).clone().requires_grad_(True)
            y, _ = tssm.apply_ssm(cfg, p, tctx.gather_seq(xl, s))
            loss = (tctx.reduce_seq(y) * tctx.split_seq(r)).sum()
            if sp:
                loss = mesh.reduce_from(loss, "model")
            loss.backward()
        key = f"ssd__{'sp' if sp else 'no_sp'}"
        for k, t in p.items():
            axes = tstep.grad_reduce_axes(specs[k], rules)
            if axes:
                mesh.all_reduce(t.grad, axes)
            res[f"{key}__{k}"] = t.grad.numpy().copy()
        res[f"{key}__x"] = xl.grad.numpy().copy()
        res[f"{key}__loss"] = np.array(float(loss))


def _checkpoint(res, label, case, ckpt_dir):
    """``case`` on (1, 4): 2 steps, a checkpoint, a third step; the
    checkpoint restored on (1, 4) and stepped again (bit for bit the third
    step), and on (2, 2) under both rule sets into the same padded model
    (this rank's blocks recorded)."""
    batches = _batches(case, 3)
    model, rules = _setup(case)
    padded = model.cfg
    step = tstep.make_train_step(model, topt.AdamWConfig(**OPT), rules)
    specs = model.param_specs()
    params = model.master_params(_tree(case), rules=rules)
    state = topt.init_opt_state(params)
    mine = mixers._rows(case, rules, batches)
    for b in mine[:2]:
        params, state, _ = step(params, state, b)
    gqa._blocks(res, f"ckpt_{label}__p2", model, rules, params)
    path = tckpt.save_checkpoint(ckpt_dir, 2, params, state, {"note": label},
                                 rules=rules, specs=specs)
    params, state, m3 = step(params, state, mine[2])
    lp, lstate, man = tckpt.load_checkpoint(path, specs, None, rules=rules)
    lp = model.master_params(lp, rules=rules)
    lp, lstate, n3 = step(lp, lstate, mine[2])
    res[f"ckpt_{label}__continues"] = np.array(
        all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params) + tree_leaves(state),
            tree_leaves(lp) + tree_leaves(lstate)))
        and float(m3["loss"]) == float(n3["loss"]) and man["step"] == 2)
    for where, (shape, no_tp) in CKPT_RESTORES.items():
        model, rules = _setup(case, shape, no_tp, padded)
        lp, lstate, _ = tckpt.load_checkpoint(path, model.param_specs(),
                                              None, rules=rules)
        gqa._blocks(res, f"ckpt_{label}__{where}", model, rules, lp)
        gqa._blocks(res, f"ckpt_{label}__{where}__m", model, rules,
                    lstate["m"])
    res[f"ckpt_{label}__path"] = np.array(path)


def _world(rank, world, res, out):
    for name, case in CASES.items():
        if case["mesh"][0] * case["mesh"][1] == world:
            _train(name, case, res)
    if world == 4:
        _ssd_layer_grads(res)
        for label, case in CKPTS.items():
            _checkpoint(res, label, case, os.path.join(out, f"ckpt_{label}"))
    return res


def _rank_main(rank, world, init_file, out):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=90))
    try:
        res = _world(rank, world, {}, out)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        torch.distributed.destroy_process_group()


def _start(tmp, world):
    out = tmp / f"world{world}"
    out.mkdir()
    ctx = mp.spawn(_rank_main, args=(world, str(tmp / f"{world}.rdzv"),
                                     str(out)), nprocs=world, join=False)
    return ctx, out, datetime.datetime.now()


def _join(ctx, out, started, world) -> list:
    deadline = started + datetime.timedelta(seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=2):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


# --- the JAX package's side ----------------------------------------------------------

def jax_run(case) -> dict:
    """The padded JAX model's jitted make_train_step, unsharded, two steps
    on the case's tree and batches: each step's metrics and leaves, and
    step 1's gradients (from its first moment)."""
    jmodel = jbuild(_cfg(case, jget_config), tp=_tp(case),
                    compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(case))
    state = jopt.init_opt_state(params)
    opt = jopt.AdamWConfig(**OPT)
    step = jax.jit(jstep.make_train_step(jmodel, opt))
    out = {"metrics": [], "params": []}
    for b in _batches(case):
        params, state, m = step(params, state, {k: jnp.asarray(v)
                                                for k, v in b.items()})
        out["metrics"].append([float(m[k]) for k in ("loss", "grad_norm",
                                                     "lr")])
        out["params"].append([np.asarray(x) for x in
                              jax.tree_util.tree_leaves(params)])
        if len(out["metrics"]) == 1:
            clip = min(1.0, opt.grad_clip / (float(m["grad_norm"]) + 1e-9))
            out["grads"] = [np.asarray(x, np.float64) / ((1 - opt.b1) * clip)
                            for x in jax.tree_util.tree_leaves(state["m"])]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns run while this process makes the JAX side's
    references."""
    tmp = tmp_path_factory.mktemp("lm_train_tp_recurrent")
    started = {w: _start(tmp, w) for w in (2, 4)}
    refs = {}
    for case in CASES.values():
        if _jkey(case) not in refs:
            refs[_jkey(case)] = jax_run(case)
    ranks = {w: _join(*started[w], w) for w in (2, 4)}
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_train_step_matches_jax(name, runs):
    case = CASES[name]
    world = case["mesh"][0] * case["mesh"][1]
    ranks = runs["ranks"][world]
    want = runs["refs"][_jkey(case)]
    specs = tree_leaves(_padded(case).param_specs())
    paths = mixers._paths(case)
    metrics = ranks[0][f"{name}__metrics"]
    for r in ranks:             # the same metrics on every rank
        assert np.array_equal(r[f"{name}__metrics"], metrics), name
        assert float(r[f"{name}__loss1"]) == metrics[0][0]
    (l1, g1, lr1), (l2, g2, lr2) = metrics
    (jl1, jg1, jlr1), (jl2, jg2, jlr2) = want["metrics"]
    np.testing.assert_allclose([l1, g1, l2], [jl1, jg1, jl2], rtol=RTOL)
    np.testing.assert_allclose(g2, jg2, rtol=LATER_GRAD_NORM_RTOL)
    assert (lr1, lr2) == (np.float32(jlr1), np.float32(jlr2))
    for i, spec in enumerate(specs):
        got = gqa._leaf(ranks, f"{name}__g", i, spec.shape)
        ref = want["grads"][i]
        scale = float(np.abs(ref).max()) or 1.0
        err = float(np.abs(got - ref).max())
        assert err <= GRAD_TOL * scale, (name, paths[i], err, scale)
    for s in (1, 2):
        got = [gqa._leaf(ranks, f"{name}__p{s}", i, spec.shape)
               for i, spec in enumerate(specs)]
        ours, theirs = (gqa._checksums(x, paths)
                        for x in (got, want["params"][s - 1]))
        for p in paths:
            np.testing.assert_allclose(ours[p], theirs[p],
                                       rtol=CHECKSUM_RTOL, err_msg=p)


@pytest.mark.parametrize("name", ELSEWHERE_CASES)
def test_remat_recomputes_in_the_sharding_context(name, runs):
    """The backward pass on a thread of its own: the gradients are bit for
    bit those of the caller's thread."""
    world = CASES[name]["mesh"][0] * CASES[name]["mesh"][1]
    for r in runs["ranks"][world]:
        assert bool(r[f"{name}__elsewhere_equal"]), name


def test_cases_take_their_layouts_and_rows(runs):
    """The batch axes of the rule sets and each rank's rows of the tokens
    and the frames: TP over "data" on (2, 2), no_tp over both axes (a
    row a rank), the frames split by the same rows."""
    def rank0(name):
        world = CASES[name]["mesh"][0] * CASES[name]["mesh"][1]
        return runs["ranks"][world][0]
    assert json.loads(str(rank0(f"{WHISPER}-2x2-tp")[
        f"{WHISPER}-2x2-tp__batch_axes"])) == ["data"]
    assert json.loads(str(rank0(f"{WHISPER}-1x4-no_tp")[
        f"{WHISPER}-1x4-no_tp__batch_axes"])) == ["data", "model"]
    for name, rows in ((f"{WHISPER}-2x2-tp", 2), (f"{WHISPER}-1x4-no_tp", 1),
                       (f"{WHISPER}-1x4-tp", 4)):
        r = rank0(name)
        assert list(r[f"{name}__rows"]) == [rows, rows], name
        assert tuple(r[f"{name}__frame_rows"]) == (1, rows, 64, 128), name
    r = rank0("seq_frames_padded")
    assert tuple(r["seq_frames_padded__frame_rows"]) == (1, 4, 62, 128)


@pytest.mark.parametrize("sp", ["sp", "no_sp"])
def test_ssd_layer_backward_matches_unsharded(sp, runs):
    """The SSD layer alone, sum(y * r) backward on (1, 4): every leaf's
    gradient (summed as the train step sums it) and every rank's block of
    the input's gradient equal the unsharded layer's within 1e-5 of the
    largest. Each rank normalises its heads' block by the whole sum of
    squares, so that sum's gradient must be summed over "model": with the
    forward sum alone (its gradient passed through) the gradients
    differ."""
    cfg, whole, specs, x, r = _ssd_layer(SSD_LAYER)
    x = x.clone().requires_grad_(True)
    p = {k: v.clone().requires_grad_(True) for k, v in whole.items()}
    y, _ = tssm.apply_ssm(cfg, p, x)
    loss = (y * r).sum()
    loss.backward()
    data, tp = SSD_LAYER["mesh"]
    key = f"ssd__{sp}"
    for t, rank in enumerate(runs["ranks"][4]):
        np.testing.assert_allclose(float(rank[f"{key}__loss"]),
                                   float(loss.detach()), rtol=1e-6)
        fake = _fake_mesh(data, tp, t)
        rules = trules.make_rules(fake, "train", SSD_LAYER["batch"])
        for k, v in p.items():
            want = v.grad.numpy()[trules.local_slices(
                rules.param_pspec(specs[k]), specs[k].shape, fake)]
            err = float(np.abs(rank[f"{key}__{k}"] - want).max())
            scale = float(np.abs(v.grad.numpy()).max()) or 1.0
            assert err <= LAYER_TOL * scale, (t, k, err, scale)
        want = x.grad.numpy()
        if sp == "sp":
            want = want[:, slice(*trules.block_range(x.shape[1], tp, t))]
        err = float(np.abs(rank[f"{key}__x"] - want).max())
        assert err <= LAYER_TOL * float(np.abs(want).max()), (t, err)


@pytest.mark.parametrize("label", sorted(CKPTS))
def test_sharded_checkpoint_round_trips(label, runs):
    """Written on (1, 4) (each leaf gathered whole: the encoder and
    decoder stacks, the SSD's leaves at their 20 padded heads, the
    RG-LRU's): the file holds the state the ranks held, the JAX package
    reads it, the run restored on (1, 4) continues bit for bit, and (2, 2)
    under the TP and the no_tp rules restores every leaf's blocks of the
    same state."""
    case = CKPTS[label]
    ranks = runs["ranks"][4]
    assert all(bool(r[f"ckpt_{label}__continues"]) for r in ranks)
    path = str(ranks[0][f"ckpt_{label}__path"])
    model = _padded(case)
    specs = tree_leaves(model.param_specs())
    paths = mixers._paths(case)
    with np.load(os.path.join(path, "params.npz")) as z:
        saved = {k: z[k] for k in z.files}
    with np.load(os.path.join(path, "opt_m.npz")) as z:
        saved_m = {k: z[k] for k in z.files}
    assert sorted(saved) == sorted(paths)
    if label == "ssm":
        assert saved["stack/groups/0/mixer/a_log"].shape == (2, 20)
    for i, (p, spec) in enumerate(zip(paths, specs)):
        assert np.array_equal(gqa._leaf(ranks, f"ckpt_{label}__p2", i,
                                        spec.shape), saved[p]), p
        for where in CKPT_RESTORES:
            got = gqa._leaf(ranks, f"ckpt_{label}__{where}", i, spec.shape)
            assert np.array_equal(got, saved[p]), (where, p)
            got = gqa._leaf(ranks, f"ckpt_{label}__{where}__m", i,
                            spec.shape)
            assert np.array_equal(got, saved_m[p]), (where, p)
    jmodel = jbuild(_cfg(case, jget_config), tp=_tp(case),
                    compute_dtype=jnp.float32)
    like = jmodel.param_struct()
    jp, jstate, man = jckpt.load_checkpoint(path, like, {"m": like,
                                                         "v": like})
    assert man["step"] == 2 and int(jstate["step"]) == 2
    for p, x in zip(paths, jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(x), saved[p]), p


# --- without a spawn ---------------------------------------------------------------

@pytest.mark.parametrize("no_tp", [False, True], ids=["tp", "no_tp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_trains_under_both_rule_sets(arch, no_tp):
    """No config is refused under the train rules: on a (1, 1) mesh
    make_train_step builds for each of the ten, check_rules raises
    nothing, and under the TP rules of a (1, 4) stand-in mesh (the model
    padded for tp 4) check_rules takes the SSD whatever its serving
    cache's layout."""
    mesh = ProcessMesh(("data", "model"), (1, 1), "cpu")
    model = build_model(get_config(arch).reduced(),
                        compute_dtype=torch.float32, device="cpu")
    rules = trules.make_rules(mesh, "train", 2, kv_sharded=model.kv_sharded,
                              no_tp=no_tp)
    model.check_rules(rules)
    assert callable(tstep.make_train_step(model, topt.AdamWConfig(), rules))
    fake = _fake_mesh(1, 4)
    big = build_model(get_config(arch).reduced(), tp=1 if no_tp else 4,
                      device="cpu")
    big.check_rules(trules.make_rules(fake, "train", 4,
                                      kv_sharded=big.kv_sharded,
                                      no_tp=no_tp))


def test_ssd_serving_rules_still_check_the_cache_layout():
    """A state split by its head dimension is a serving cache layout the
    SSD does not read: the prefill rules refuse it, the train rules (no
    cache) take the model."""
    cfg = dataclasses.replace(get_config(MAMBA2).reduced(), ssm_headdim=64,
                              ssm_state=8, ssm_d_inner=256)
    model = build_model(cfg, tp=4, device="cpu")
    fake = _fake_mesh(1, 4)
    for mode in ("prefill", "decode"):
        with pytest.raises(NotImplementedError, match="head dimension"):
            model.check_rules(trules.make_rules(fake, mode, 4,
                                                kv_sharded=False))
    model.check_rules(trules.make_rules(fake, "train", 4, kv_sharded=False))


def test_rglru_folds_h0_in_place_only_with_a_cache(monkeypatch):
    """The RG-LRU writes h0 into ``b`` in place (``b.float()`` is ``b``
    itself in float32) only with a cache: the training path (no cache,
    grad on) leaves ``b`` as the gates made it and differentiates."""
    cfg = get_config(RGEMMA).reduced()
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    params = model.master_params(generator=torch.Generator().manual_seed(4))
    p = params["stack"]["groups"][0]["mixer"]
    made = []
    plain = trglru._lru_gates

    def recording(p_, x_):
        a, b = plain(p_, x_)
        made.append(b)
        return a, b
    monkeypatch.setattr(trglru, "_lru_gates", recording)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    y, _ = trglru.apply_rglru(cfg, {k: v[0] for k, v in p.items()}, x)
    y.sum().backward()
    assert made[-1]._version == 0
    assert p["lam"].grad is not None
    cache = {k: torch.randn(s.shape) for k, s in
             trglru.rglru_cache_struct(cfg, 2, torch.float32).items()}
    with torch.no_grad():
        trglru.apply_rglru(cfg, {k: v[0] for k, v in p.items()}, x, cache)
    assert made[-1]._version > 0


def test_batch_shardings_carry_the_frames():
    """batch_struct and batch_shardings of whisper's step: the frames
    split by the rules' batch axes as the tokens are."""
    fake = _fake_mesh(2, 2)
    model = build_model(get_config(WHISPER).reduced(), tp=2, device="cpu")
    structs = tstep.batch_struct(model, 8, 16, accum=2)
    for no_tp, bax in ((False, "data"), (True, ("data", "model"))):
        rules = trules.make_rules(fake, "train", 8, no_tp=no_tp)
        sh = tstep.batch_shardings(rules, structs)
        assert tuple(structs["frames"].shape) == (2, 4, 64, 128)
        assert sh["frames"] == trules.PartitionSpec(None, bax, None, None)
        assert sh["tokens"] == trules.PartitionSpec(None, bax, None)
