"""repro_torch's train step under sharding rules for the MoE and MLA
families against the JAX package, on the CPU.

As ``tests/test_torch_lm_train_tp.py`` holds the dense and vision GQA
families, gloo spawns of 2 and 4 ranks train llama4-scout-17b-a16e (top-1
with a shared expert), qwen3-moe-235b-a22b (top-2 of 4 at reduced()) and
minicpm3-4b (MLA), reduced, in float32, on the meshes (data, model) =
(1, 2), (1, 4) and (2, 2), under the TP rules (expert parallelism and
tensor parallelism over "model", the residual split by sequence, "embed"
over "data") and under ``no_tp`` (ZeRO over both axes, the batch over
"model" too, the model at tp 1). Each rank loads its blocks of one numpy
tree and its rows of each batch, takes step 1's gradients
(``train_step.train_grads``) and two steps of ``make_train_step(model,
opt, rules)``; the test assembles the blocks and holds them to the JAX
package's jitted ``make_train_step`` of the padded model run unsharded,
with ``test_torch_lm_train_tp``'s bounds: every gradient leaf within 1e-4
of its largest, step 1's loss and grad norm and step 2's loss within rtol
1e-5, step 2's grad norm 1e-4, the checksums 1e-4.

The edge cases: assignments dropped past the expert capacity (asserted to
happen), 6 experts over tp 4 (blocks 2, 2, 2 and an empty one, its rank
joining every collective, forward and recomputed), MoE and MLA without
sequence parallelism, a sequence "model" does not divide, two
microbatches, a batch no batch axis divides, and the backward pass on a
thread of its own. The load-balancing loss alone, backward through one
MoE layer on (1, 4) with and without sequence parallelism, equals the
unsharded layer's (its gradient counted once over "model", not tp times).
An MoE checkpoint with an empty expert block, written on (1, 4),
continues there bit for bit, restores on (2, 2) under both rule sets and
reads back in the JAX package.
"""
import dataclasses
import datetime
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_lm_tp as base
import test_torch_lm_train_tp as gqa
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import tree_leaves, tree_paths
from repro_torch.runtime.mesh import ProcessMesh
from repro_torch.sharding import ctx as tctx
from repro_torch.sharding import rules as trules
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tstep

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SPAWN_TIMEOUT_S = 300
LLAMA4, QWEN3, MINICPM3 = ("llama4-scout-17b-a16e", "qwen3-moe-235b-a22b",
                           "minicpm3-4b")
ARCHS = (LLAMA4, QWEN3, MINICPM3)
MESHES = ((1, 2), (1, 4), (2, 2))
OPT, GRAD_TOL, RTOL = gqa.OPT, gqa.GRAD_TOL, gqa.RTOL
LATER_GRAD_NORM_RTOL, CHECKSUM_RTOL = gqa.LATER_GRAD_NORM_RTOL, \
    gqa.CHECKSUM_RTOL
AUX_TOL = 1e-6               # of the largest gradient, float32
_case = gqa._case

CASES = {f"{arch}-{m[0]}x{m[1]}-{'no_tp' if no_tp else 'tp'}":
         _case(arch, m, no_tp)
         for arch in ARCHS for m in MESHES for no_tp in (False, True)}
CASES.update({
    # capacity 8 a row for 48 top-2 assignments over 4 experts
    "moe_drops": _case(QWEN3, (1, 4), False, dict(capacity_factor=0.5)),
    # expert blocks 2, 2, 2, 0 over "model"
    "experts_not_divided": _case(QWEN3, (1, 4), False, dict(num_experts=6)),
    "moe_no_seq_parallel": _case(LLAMA4, (1, 4), False, seq_parallel=False),
    "mla_no_seq_parallel": _case(MINICPM3, (1, 4), False,
                                 seq_parallel=False),
    # 23 positions: the ranks own 6, 6, 6 and 5 of the routing's sums
    "moe_seq_padded": _case(QWEN3, (1, 4), False, seq=23),
    "moe_accum2": _case(QWEN3, (2, 2), False, batch=8, accum=2),
    # a batch of 3: no batch axis, the data ranks route the same rows
    "moe_batch_not_divided": _case(QWEN3, (2, 2), False, batch=3),
})
# the backward pass on a thread of its own (the card's autograd thread):
# remat recomputes the empty expert rank's layers in step with the others
ELSEWHERE_CASES = ("experts_not_divided", f"{MINICPM3}-2x2-tp")
# each reduction (its axes of size > 1) that one MoE layer's prefill makes
# with mesh.reduce_from, the routing sums': serving (no grad, the prefill
# rules) over the batch axes alone, as every "model" rank routes the whole
# sequence; training (grad, the train rules) over them and "model"
SUMS_MESHES = {2: (1, 2), 4: (2, 2)}
SUMS_AXES = {(1, 2): {"serve": [], "train": [["model"]]},
             (2, 2): {"serve": [["data"]], "train": [["data", "model"]]}}
CKPT = _case(QWEN3, (1, 4), False, dict(num_experts=6))
CKPT_RESTORES = {"2x2-tp": ((2, 2), False), "2x2-no_tp": ((2, 2), True)}
AUX_CASE = _case(LLAMA4, (1, 4), False)


def _tp(case) -> int:
    return 1 if case["no_tp"] else case["mesh"][1]


def _cfg(case, pkg_get=get_config):
    return dataclasses.replace(pkg_get(case["arch"]).reduced(),
                               **case["over"])


def _padded(case):
    return build_model(_cfg(case), tp=_tp(case), device="cpu")


def _jkey(case) -> str:
    """What the JAX side's run depends on: the padded model (the same at
    tp 1, 2 and 4 for these reduced configs) and the batch; cases that
    share it share one run and draw the same batches."""
    m = _padded(case)
    return json.dumps([dataclasses.asdict(m.cfg), m.heads, m.kv_heads,
                       case["batch"], case["seq"], case["accum"]],
                      sort_keys=True, default=str)


def _tree(case):
    """The numpy tree of the case's padded model (base._tree's draws),
    MLA's latent norms perturbed as the other norms are."""
    tree = base._tree({**case, "mesh": (1, _tp(case))})
    rng = np.random.default_rng(9)
    for path, a in zip(tree_paths(tree), tree_leaves(tree)):
        if path[-1] in ("q_norm", "kv_norm"):
            a += 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    return tree


def _batches(case, steps: int = 2) -> list:
    cfg = _cfg(case)
    rng = np.random.default_rng(zlib.crc32(_jkey(case).encode()))
    a, b, s = case["accum"], case["batch"] // case["accum"], case["seq"]
    return [{k: rng.integers(0, cfg.vocab_size, (a, b, s)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(steps)]


# --- the ranks' jobs ---------------------------------------------------------------

def _setup(case, shape=None, no_tp=None):
    shape = shape or case["mesh"]
    no_tp = case["no_tp"] if no_tp is None else no_tp
    case = {**case, "mesh": shape, "no_tp": no_tp}
    mesh = ProcessMesh(("data", "model"), shape, "cpu")
    model = build_model(_cfg(case), tp=_tp(case),
                        compute_dtype=torch.float32, device="cpu")
    return model, gqa._rules(case, mesh, model)


def _rows(case, rules, batches):
    bax = rules.batch_axes
    mb = case["batch"] // case["accum"]
    mesh = rules.mesh
    lo, hi = trules.block_range(mb, mesh.axis_size(bax),
                                mesh.axis_index(bax)) if bax else (0, mb)
    return [{k: v[:, lo:hi] for k, v in b.items()} for b in batches]


def _train(name, case, res):
    model, rules = _setup(case)
    batches = _rows(case, rules, _batches(case))
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


def _moe_layer(case):
    """(cfg, layer 0's MoE leaves as float32 tensors, their ParamSpecs)
    of the case's tree."""
    model = _padded(case)
    tree = _tree(case)
    layer = tree["stack"]["groups"][0]["mlp"]
    specs = tmoe.moe_specs(model.cfg)
    return model.cfg, {k: torch.from_numpy(np.array(v[0]))
                       for k, v in layer.items()}, specs


def _aux_input(cfg, seq: int):
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.standard_normal(
        (AUX_CASE["batch"], seq, cfg.d_model)).astype(np.float32))


def _aux_grads(res):
    """The load-balancing loss alone, backward through layer 0's MoE on
    (1, 4) with and without sequence parallelism: this rank's block of the
    input's gradient and the router's, summed over the axes the train
    step sums it over."""
    cfg, whole, specs = _moe_layer(AUX_CASE)
    x = _aux_input(cfg, AUX_CASE["seq"])
    mesh = ProcessMesh(("data", "model"), AUX_CASE["mesh"], "cpu")
    for sp in (True, False):
        rules = trules.make_rules(mesh, "train", AUX_CASE["batch"],
                                  seq_parallel=sp)
        p = {k: v[trules.local_slices(rules.param_pspec(specs[k]),
                                      specs[k].shape, mesh)].clone()
             .requires_grad_(True) for k, v in whole.items()}
        with tctx.sharding_ctx(rules, mesh, cfg.d_model):
            xl = tctx.split_seq(x).clone().requires_grad_(True)
            _, aux = tmoe.apply_moe(cfg, p, tctx.gather_seq(xl, x.shape[1]))
            aux.backward()
        g = p["router"].grad
        axes = tstep.grad_reduce_axes(specs["router"], rules)
        if axes:
            mesh.all_reduce(g, axes)
        key = f"aux__{'sp' if sp else 'no_sp'}"
        res[f"{key}__value"] = np.array(float(aux))
        res[f"{key}__router"] = g.numpy().copy()
        res[f"{key}__x"] = xl.grad.numpy().copy()
        res[f"{key}__axes"] = np.array(json.dumps(list(axes)))


def _routing_sums_axes(res, shape):
    """AUX_CASE's MoE layer on ``shape``, prefilled on this rank's rows and
    positions without grad under the prefill rules and with grad under
    the train rules: the axes of size > 1 of each mesh.reduce_from."""
    cfg, whole, specs = _moe_layer(AUX_CASE)
    x = _aux_input(cfg, AUX_CASE["seq"])
    mesh = ProcessMesh(("data", "model"), shape, "cpu")
    seen = []
    plain = mesh.reduce_from

    def reduce_from(t, axes):
        seen.append([a for a in axes if mesh.shape[a] > 1])
        return plain(t, axes)
    mesh.reduce_from = reduce_from
    for label, mode in (("serve", "prefill"), ("train", "train")):
        rules = trules.make_rules(mesh, mode, AUX_CASE["batch"])
        p = {k: v[trules.local_slices(rules.param_pspec(specs[k]),
                                      specs[k].shape, mesh)]
             for k, v in whole.items()}
        bax = rules.batch_axes
        lo, hi = trules.block_range(x.shape[0], mesh.axis_size(bax),
                                    mesh.axis_index(bax)) \
            if bax else (0, x.shape[0])
        with torch.set_grad_enabled(label == "train"), \
                tctx.sharding_ctx(rules, mesh, cfg.d_model):
            xl = tctx.split_seq(x[lo:hi])
            tmoe.apply_moe(cfg, p, tctx.gather_seq(xl, x.shape[1]))
        res[f"sums__{label}"] = np.array(json.dumps([a for a in seen if a]))
        seen.clear()


def _checkpoint(res, ckpt_dir):
    """CKPT on (1, 4) (an empty expert block on model rank 3): 2 steps, a
    checkpoint, a third step; the checkpoint restored on (1, 4) and
    stepped again (bit for bit the third step), and on (2, 2) under both
    rule sets (this rank's blocks recorded)."""
    batches = _batches(CKPT, 3)
    model, rules = _setup(CKPT)
    step = tstep.make_train_step(model, topt.AdamWConfig(**OPT), rules)
    specs = model.param_specs()
    params = model.master_params(_tree(CKPT), rules=rules)
    state = topt.init_opt_state(params)
    for b in batches[:2]:
        params, state, _ = step(params, state, b)
    gqa._blocks(res, "ckpt__p2", model, rules, params)
    path = tckpt.save_checkpoint(ckpt_dir, 2, params, state, {"note": "moe"},
                                 rules=rules, specs=specs)
    params, state, m3 = step(params, state, batches[2])
    lp, lstate, man = tckpt.load_checkpoint(path, specs, None, rules=rules)
    lp = model.master_params(lp, rules=rules)
    lp, lstate, n3 = step(lp, lstate, batches[2])
    res["ckpt__continues"] = np.array(
        all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params) + tree_leaves(state),
            tree_leaves(lp) + tree_leaves(lstate)))
        and float(m3["loss"]) == float(n3["loss"]) and man["step"] == 2)
    for label, (shape, no_tp) in CKPT_RESTORES.items():
        model, rules = _setup(CKPT, shape, no_tp)
        lp, lstate, _ = tckpt.load_checkpoint(path, model.param_specs(),
                                              None, rules=rules)
        gqa._blocks(res, f"ckpt__{label}", model, rules, lp)
        gqa._blocks(res, f"ckpt__{label}__m", model, rules, lstate["m"])
    res["ckpt__path"] = np.array(path)


def _world(rank, world, res, out):
    for name, case in CASES.items():
        if case["mesh"][0] * case["mesh"][1] == world:
            _train(name, case, res)
    _routing_sums_axes(res, SUMS_MESHES[world])
    if world == 4:
        _aux_grads(res)
        _checkpoint(res, os.path.join(out, "ckpt"))
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
    tmp = tmp_path_factory.mktemp("lm_train_tp_mixers")
    started = {w: _start(tmp, w) for w in (2, 4)}
    refs = {}
    for case in CASES.values():
        if _jkey(case) not in refs:
            refs[_jkey(case)] = jax_run(case)
    ranks = {w: _join(*started[w], w) for w in (2, 4)}
    return {"ranks": ranks, "refs": refs}


def _paths(case) -> list:
    return ["/".join(map(str, p)) for p in
            tree_paths(_padded(case).param_specs())]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_train_step_matches_jax(name, runs):
    case = CASES[name]
    world = case["mesh"][0] * case["mesh"][1]
    ranks = runs["ranks"][world]
    want = runs["refs"][_jkey(case)]
    specs = tree_leaves(_padded(case).param_specs())
    paths = _paths(case)
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
    bit those of the caller's thread (the empty expert rank too)."""
    world = CASES[name]["mesh"][0] * CASES[name]["mesh"][1]
    for r in runs["ranks"][world]:
        assert bool(r[f"{name}__elsewhere_equal"]), name


def test_cases_take_their_layouts_and_drop(runs, monkeypatch):
    """The batch axes of the MoE edge cases, and drops: the port's
    unsharded loss on moe_drops' first microbatch drops assignments past
    the capacity (reduced()'s capacity factor 4.0 drops none)."""
    def bax(name):
        world = CASES[name]["mesh"][0] * CASES[name]["mesh"][1]
        return json.loads(str(runs["ranks"][world][0][f"{name}__batch_axes"]))
    assert bax(f"{QWEN3}-2x2-tp") == ["data"]
    assert bax(f"{LLAMA4}-1x4-no_tp") == ["data", "model"]
    assert bax("moe_batch_not_divided") == []

    def dropped(case):
        model = build_model(_cfg(case), tp=_tp(case),
                            compute_dtype=torch.float32, device="cpu")
        params = model.master_params(_tree(case))
        seen = []
        plain = tmoe.apply_moe

        def counting(cfg, p, x):
            seen.append(tmoe.dropped_assignments(cfg, p, x))
            return plain(cfg, p, x)
        monkeypatch.setattr(tmoe, "apply_moe", counting)
        b = _batches(case)[0]
        with torch.no_grad():
            model.loss({k: torch.from_numpy(v[0]) for k, v in b.items()},
                       params)
        monkeypatch.setattr(tmoe, "apply_moe", plain)
        return seen
    drops = dropped(CASES["moe_drops"])
    assert len(drops) == _cfg(CASES["moe_drops"]).num_layers
    assert min(drops) > 0, drops
    assert sum(dropped(CASES[f"{QWEN3}-1x4-tp"])) == 0


@pytest.mark.parametrize("sp", ["sp", "no_sp"])
def test_moe_aux_gradient_counted_once(sp, runs):
    """The load-balancing loss alone, backward through one MoE layer on
    (1, 4): its value, the router's gradient (summed over "model" as the
    train step sums it) and every rank's block of the input's gradient
    equal the unsharded layer's within 1e-6 of the largest. Each "model"
    rank routes the whole sequence; a loss taken from every rank's
    replicated probabilities would count its gradient tp times."""
    cfg, whole, _ = _moe_layer(AUX_CASE)
    x = _aux_input(cfg, AUX_CASE["seq"]).requires_grad_(True)
    p = {k: v.clone().requires_grad_(True) for k, v in whole.items()}
    _, aux = tmoe.apply_moe(cfg, p, x)
    aux.backward()
    ranks = runs["ranks"][4]
    key = f"aux__{sp}"
    tp = AUX_CASE["mesh"][1]
    s = x.shape[1]
    for t, r in enumerate(ranks):
        assert json.loads(str(r[f"{key}__axes"])) == ["model"]
        np.testing.assert_allclose(float(r[f"{key}__value"]),
                                   float(aux.detach()), rtol=AUX_TOL)
        want = p["router"].grad.numpy()
        err = np.abs(r[f"{key}__router"] - want).max()
        assert err <= AUX_TOL * np.abs(want).max(), (t, err)
        want = x.grad.numpy()
        if sp == "sp":
            lo, hi = trules.block_range(s, tp, t)
            want = want[:, lo:hi]
        err = np.abs(r[f"{key}__x"] - want).max()
        assert err <= AUX_TOL * np.abs(want).max(), (t, err)


@pytest.mark.parametrize("world", sorted(SUMS_MESHES))
def test_moe_routing_sums_reduced_where_needed(world, runs):
    """A sharded MoE prefill reduces its routing sums over the batch axes
    alone when serving (no grad: every "model" rank routed the whole
    sequence, so serving makes no reduction over "model" for the unused
    load-balancing loss), and, when training, each rank's own positions
    over the batch axes and "model"."""
    want = SUMS_AXES[SUMS_MESHES[world]]
    for r in runs["ranks"][world]:
        for label in ("serve", "train"):
            assert json.loads(str(r[f"sums__{label}"])) == want[label], \
                label


def test_sharded_moe_checkpoint_round_trips(runs):
    """Written on (1, 4) with an empty expert block (each leaf gathered
    whole, the short blocks padded): the file holds the state the ranks
    held, the JAX package reads it, the run restored on (1, 4) continues
    bit for bit, and (2, 2) under the TP and the no_tp rules restores
    every leaf's blocks of the same state."""
    ranks = runs["ranks"][4]
    assert all(bool(r["ckpt__continues"]) for r in ranks)
    path = str(ranks[0]["ckpt__path"])
    model = _padded(CKPT)
    specs = tree_leaves(model.param_specs())
    paths = _paths(CKPT)
    with np.load(os.path.join(path, "params.npz")) as z:
        saved = {k: z[k] for k in z.files}
    with np.load(os.path.join(path, "opt_m.npz")) as z:
        saved_m = {k: z[k] for k in z.files}
    assert sorted(saved) == sorted(paths)
    experts = [p for p in paths if p.endswith("mlp/wi")]
    assert experts and saved[experts[0]].shape[1] == 6
    for i, (p, spec) in enumerate(zip(paths, specs)):
        assert np.array_equal(gqa._leaf(ranks, "ckpt__p2", i, spec.shape),
                              saved[p]), p
        for label in CKPT_RESTORES:
            assert np.array_equal(gqa._leaf(ranks, f"ckpt__{label}", i,
                                            spec.shape), saved[p]), \
                (label, p)
            assert np.array_equal(gqa._leaf(ranks, f"ckpt__{label}__m", i,
                                            spec.shape), saved_m[p]), \
                (label, p)
    jmodel = jbuild(_cfg(CKPT, jget_config), tp=_tp(CKPT),
                    compute_dtype=jnp.float32)
    like = jmodel.param_struct()
    jp, jstate, man = jckpt.load_checkpoint(path, like, {"m": like,
                                                         "v": like})
    assert man["step"] == 2 and int(jstate["step"]) == 2
    for p, x in zip(paths, jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(x), saved[p]), p



@pytest.mark.parametrize("arch", ARCHS + ("mamba2-130m", "recurrentgemma-2b",
                                          "whisper-medium", "qwen1.5-0.5b"))
def test_partial_grad_leaves_are_their_mixers_own(arch):
    """The leaves the train step sums over "model" because each rank
    computes part of their gradient (``ParamSpec.partial_grad``, read by
    ``grad_reduce_axes``) are marked by their own mixer and kept through
    the layer stack: the MoE router and MLA's latent projections and norms,
    the SSD's B and C projections and convs (each rank's heads read B and
    C whole), the RG-LRU's gate biases and decay (sliced to each rank's
    channels), and no other leaf of any config, whatever its name (the
    SSD's gated norm is a "norm" too; the encoder-decoder marks none)."""
    model = build_model(get_config(arch).reduced(), tp=4, device="cpu")
    specs = model.param_specs()
    marked = {p[-2:] for p, s in zip(tree_paths(specs), tree_leaves(specs))
              if s.partial_grad}
    want = {("mlp", "router")} if model.cfg.moe else set()
    mixer = {MINICPM3: ("wdq", "wdkv", "wkr", "q_norm", "kv_norm"),
             "mamba2-130m": ("wb", "wc", "conv_b", "conv_bb", "conv_c",
                             "conv_cb"),
             "recurrentgemma-2b": ("ba", "bx", "lam")}.get(arch, ())
    want |= {("mixer", n) for n in mixer}
    assert marked == want
