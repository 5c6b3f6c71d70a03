"""repro_torch's train step under sharding rules against the JAX package,
on the CPU.

Gloo spawns of 2 and 4 ranks (``tests/test_torch_lm_tp.py``'s rendezvous)
train the dense and vision GQA configs (qwen1.5-0.5b, stablelm-1.6b,
phi3-medium-14b, phi-3-vision-4.2b), reduced, in float32, on the meshes
(data, model) = (1, 2), (1, 4) and (2, 2), under the TP rules (tensor
parallelism over "model", the residual split by sequence, "embed" over
"data") and under ``no_tp`` (ZeRO over both axes, the batch over "model"
too, the model at tp 1): each rank loads its blocks of one numpy tree
(``Model.master_params(tree, rules=)``) and its rows of
each batch, takes step 1's gradients (``train_step.train_grads``) and two
steps of ``make_train_step(model, opt, rules)``. The test assembles every
rank's blocks and holds them to the JAX package's jitted
``make_train_step`` of the padded ``build_model(cfg, tp)`` run unsharded
on the same tree and batches: every leaf's gradient before AdamW within
1e-4 of that leaf's largest gradient (read from the reference step's
first moment, m = (1 - b1) x clip x g), step 1's loss and grad norm and
step 2's loss within rtol 1e-5, step 2's grad norm 1e-4, every leaf's
checksums after each step within 1e-4 (``test_torch_train.py``'s
bounds). Ranks that hold the same block (the leaves held whole, the
gradients and parameters of each data row) must agree bit for bit, and
every rank's metrics too.

The edge cases: KV heads held whole (2 < tp 4: the KV projections' and
biases' gradients summed over "model"), a sequence "model" does not
divide (the residual padded; stablelm's layernorm puts its bias on the
padding), a batch "data" does not divide (the data ranks compute the same
rows, so the FSDP gather's gradient is sliced, not summed), ``no_tp``
with a batch only "data" divides (the ZeRO gather over ("data", "model")
summed over one axis and sliced over the other), two microbatches, a
vocabulary padded for tp, and the TP rules without sequence parallelism
(Megatron's f and g). One case against the reference's own
``make_train_step(model, opt, rules)`` on a 4-device host mesh. A
checkpoint written on (1, 4) continues there bit for bit, restores on
(2, 2) under both rule sets leaf for leaf, and reads back in the JAX
package. Then one step of the SSD, the RG-LRU and the encoder-decoder
under both rule sets on (1, 4), the same on every rank.
"""
import contextlib
import dataclasses
import datetime
import json
import os
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_lm_tp as base
from helpers import run_with_devices
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.layers import tree_leaves, tree_paths
from repro_torch.runtime.mesh import ProcessMesh
from repro_torch.sharding import rules as trules
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tstep

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SPAWN_TIMEOUT_S = 300
ARCHS = ("qwen1.5-0.5b", "stablelm-1.6b", "phi3-medium-14b",
         "phi-3-vision-4.2b")
# trained under the rules, against the JAX package, in
# tests/test_torch_lm_train_tp_mixers.py (MoE, MLA) and
# tests/test_torch_lm_train_tp_recurrent.py (these three)
MIXER_ARCHS = ("mamba2-130m", "recurrentgemma-2b", "whisper-medium")
MESHES = ((1, 2), (1, 4), (2, 2))
OPT = {"lr": 1e-3, "warmup_steps": 2}
GRAD_TOL = 1e-4              # of the leaf's largest gradient
RTOL = 1e-5                  # step 1's loss and grad norm, every loss
LATER_GRAD_NORM_RTOL = 1e-4
CHECKSUM_RTOL = 1e-4


def _case(arch, mesh, no_tp, over=None, batch=4, seq=24, accum=1,
          seq_parallel=True):
    return dict(arch=arch, mesh=mesh, no_tp=no_tp, over=over or {},
                batch=batch, seq=seq, accum=accum, seq_parallel=seq_parallel)


CASES = {f"{arch}-{m[0]}x{m[1]}-{'no_tp' if no_tp else 'tp'}":
         _case(arch, m, no_tp)
         for arch in ARCHS for m in MESHES for no_tp in (False, True)}
CASES.update({
    # 2 KV heads < tp 4: wk, wv, bk, bv held whole, each rank's heads
    # reading theirs
    "kv_whole": _case("qwen1.5-0.5b", (1, 4), False, dict(num_kv_heads=2)),
    # 23 positions pad to 24 on the residual split by sequence
    "seq_padded": _case("stablelm-1.6b", (1, 4), False, seq=23),
    # a batch of 3: no batch axis, the data ranks compute the same rows
    "batch_not_divided": _case("qwen1.5-0.5b", (2, 2), False, batch=3),
    # a batch of 2 under no_tp: the batch over "data" only
    "no_tp_batch_by_data": _case("stablelm-1.6b", (2, 2), True, batch=2),
    "accum2": _case("phi3-medium-14b", (2, 2), False, batch=8, accum=2),
    "vocab_padded": _case("phi3-medium-14b", (1, 4), False,
                          dict(vocab_size=510)),
    "no_seq_parallel": _case("qwen1.5-0.5b", (1, 4), False,
                             dict(num_kv_heads=2), seq_parallel=False),
})
# cases whose step-1 gradients are taken again with the backward pass on a
# thread of its own (the card's autograd thread)
ELSEWHERE_CASES = ("qwen1.5-0.5b-2x2-no_tp", "stablelm-1.6b-1x4-tp")
# the case the reference's own sharded make_train_step runs (4 devices)
MANUAL_CASE = "qwen1.5-0.5b-2x2-tp"
CKPT = _case("qwen1.5-0.5b", (1, 4), False)
CKPT_RESTORES = {"2x2-tp": ((2, 2), False), "2x2-no_tp": ((2, 2), True)}


def _tp(case) -> int:
    return 1 if case["no_tp"] else case["mesh"][1]


def _cfg(case, pkg_get=get_config):
    return dataclasses.replace(pkg_get(case["arch"]).reduced(),
                               **case["over"])


def _jkey(case) -> str:
    """What the JAX side's run depends on: cases that share it share one
    run (and draw the same batches)."""
    return json.dumps([case["arch"], sorted(case["over"].items()), _tp(case),
                       case["batch"], case["seq"], case["accum"]])


def _tree(case):
    """The numpy tree of the case's padded model (base._tree's draws)."""
    return base._tree({**case, "mesh": (1, _tp(case))})


def _batches(case, steps: int = 2) -> list:
    """``steps`` steps' batches, (accum, batch // accum, seq) leaves, drawn
    from the case's _jkey."""
    cfg = _cfg(case)
    rng = np.random.default_rng(zlib.crc32(_jkey(case).encode()))
    a, b, s = case["accum"], case["batch"] // case["accum"], case["seq"]
    out = []
    for _ in range(steps):
        step = {k: rng.integers(0, cfg.vocab_size, (a, b, s)).astype(np.int32)
                for k in ("tokens", "labels")}
        if cfg.num_patches:
            step["image_embeds"] = rng.standard_normal(
                (a, b, cfg.num_patches, cfg.d_model)).astype(np.float32)
        out.append(step)
    return out


# --- the ranks' jobs ---------------------------------------------------------------

def _rules(case, mesh, model):
    return trules.make_rules(mesh, "train", case["batch"],
                             kv_sharded=model.kv_sharded,
                             seq_parallel=case["seq_parallel"],
                             no_tp=case["no_tp"])


def _blocks(res, prefix, model, rules, tree):
    """Each leaf of ``tree`` (this rank's blocks) and where it lies."""
    specs = tree_leaves(model.param_specs())
    for i, (spec, t) in enumerate(zip(specs, tree_leaves(tree))):
        sl = trules.local_slices(rules.param_pspec(spec), spec.shape,
                                 rules.mesh)
        res[f"{prefix}__{i}"] = t.detach().numpy().copy()
        res[f"{prefix}__at{i}"] = np.array([[s.start, s.stop] for s in sl])


@contextlib.contextmanager
def _backward_elsewhere():
    """Tensor.backward run on a thread of its own, which does not see the
    caller's sharding context: as the backward pass of CUDA tensors runs
    on autograd's device thread, where remat recomputes the layers."""
    plain = torch.Tensor.backward

    def elsewhere(self, *args, **kwargs):
        err = []

        def run():
            try:
                plain(self, *args, **kwargs)
            except BaseException as e:      # re-raised on the caller
                err.append(e)
        t = threading.Thread(target=run)
        t.start()
        t.join()
        if err:
            raise err[0]
    torch.Tensor.backward = elsewhere
    try:
        yield
    finally:
        torch.Tensor.backward = plain


@contextlib.contextmanager
def _counted(mesh):
    """The mesh's collectives (gathers, reduce-scatters, all-reduces) in
    the block, counted."""
    calls = {"gather": 0, "scatter": 0, "reduce": 0}
    plain = {k: getattr(mesh, f"_{k}") for k in calls}

    def counting(kind):
        def call(*args, **kwargs):
            calls[kind] += 1
            return plain[kind](*args, **kwargs)
        return call
    for k in calls:
        setattr(mesh, f"_{k}", counting(k))
    try:
        yield calls
    finally:
        for k in calls:
            delattr(mesh, f"_{k}")


def _train(name, case, res):
    cfg = _cfg(case)
    mesh = ProcessMesh(("data", "model"), case["mesh"], "cpu")
    model = build_model(cfg, tp=_tp(case), compute_dtype=torch.float32,
                        device="cpu")
    rules = _rules(case, mesh, model)
    bax = rules.batch_axes
    mb = case["batch"] // case["accum"]
    lo, hi = trules.block_range(mb, mesh.axis_size(bax),
                                mesh.axis_index(bax)) if bax else (0, mb)
    batches = [{k: v[:, lo:hi] for k, v in b.items()}
               for b in _batches(case)]
    params = model.master_params(_tree(case), rules=rules)
    loss, grads = tstep.train_grads(model, params, batches[0], rules)
    _blocks(res, f"{name}__g", model, rules, grads)
    if name in ELSEWHERE_CASES:
        with _backward_elsewhere():
            _, other = tstep.train_grads(model, params, batches[0], rules)
        res[f"{name}__elsewhere_equal"] = np.array(all(
            torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                              tree_leaves(other))))
    step = tstep.make_train_step(model, topt.AdamWConfig(**OPT), rules)
    state = topt.init_opt_state(params)
    metrics = []
    for i, b in enumerate(batches):
        with _counted(mesh) as calls:
            params, state, m = step(params, state, b)
        metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        _blocks(res, f"{name}__p{i + 1}", model, rules, params)
    res[f"{name}__calls"] = np.array(json.dumps(calls))
    res[f"{name}__metrics"] = np.array(metrics)
    res[f"{name}__loss1"] = np.array(float(loss))
    res[f"{name}__batch_axes"] = np.array(json.dumps(list(bax)))


def _checkpoint(rank, res, ckpt_dir):
    """CKPT on (1, 4): 2 steps, a checkpoint, a third step; the checkpoint
    restored on (1, 4) and stepped again (bit for bit the third step), and
    on (2, 2) under both rule sets (this rank's blocks recorded)."""
    cfg = _cfg(CKPT)
    batches = _batches(CKPT, 3)

    def setup(shape, no_tp):
        mesh = ProcessMesh(("data", "model"), shape, "cpu")
        model = build_model(cfg, tp=1 if no_tp else shape[1],
                            compute_dtype=torch.float32, device="cpu")
        case = {**CKPT, "mesh": shape, "no_tp": no_tp}
        return model, _rules(case, mesh, model)

    model, rules = setup(CKPT["mesh"], False)
    step = tstep.make_train_step(model, topt.AdamWConfig(**OPT), rules)
    specs = model.param_specs()
    params = model.master_params(_tree(CKPT), rules=rules)
    state = topt.init_opt_state(params)
    for b in batches[:2]:
        params, state, _ = step(params, state, b)
    _blocks(res, "ckpt__p2", model, rules, params)
    path = tckpt.save_checkpoint(ckpt_dir, 2, params, state, {"note": "tp"},
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
        model, rules = setup(shape, no_tp)
        lp, lstate, _ = tckpt.load_checkpoint(path, model.param_specs(),
                                              None, rules=rules)
        _blocks(res, f"ckpt__{label}", model, rules, lp)
        _blocks(res, f"ckpt__{label}__m", model, rules, lstate["m"])
    res["ckpt__path"] = np.array(path)


def _other_mixers(res):
    """The SSD, the RG-LRU and the encoder-decoder, reduced, one step on
    (1, 4) under the TP rules (at tp 4) and under no_tp (at tp 1), each
    rank on its rows of one batch: the step's metrics."""
    mesh = ProcessMesh(("data", "model"), (1, 4), "cpu")
    out = {}
    for arch in MIXER_ARCHS:
        cfg = get_config(arch).reduced()
        rng = np.random.default_rng(13)
        batch = {k: rng.integers(0, cfg.vocab_size, (1, 4, 16)).astype(
            np.int32) for k in ("tokens", "labels")}
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (1, 4, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        for no_tp in (False, True):
            model = build_model(cfg, tp=1 if no_tp else 4,
                                compute_dtype=torch.float32, device="cpu")
            rules = trules.make_rules(mesh, "train", 4,
                                      kv_sharded=model.kv_sharded,
                                      no_tp=no_tp)
            bax = rules.batch_axes
            lo, hi = trules.block_range(4, mesh.axis_size(bax),
                                        mesh.axis_index(bax))
            params = model.master_params(
                generator=torch.Generator().manual_seed(3), rules=rules)
            step = tstep.make_train_step(model, topt.AdamWConfig(), rules)
            _, _, m = step(params, topt.init_opt_state(params),
                           {k: v[:, lo:hi] for k, v in batch.items()})
            out[f"{arch}-{no_tp}"] = [float(m[k]) for k in
                                      ("loss", "grad_norm", "lr")]
    res["other_mixers"] = np.array(json.dumps(out))


def _world(rank, world, res, out):
    for name, case in CASES.items():
        if case["mesh"][0] * case["mesh"][1] == world:
            _train(name, case, res)
    if world == 4:
        _checkpoint(rank, res, os.path.join(out, "ckpt"))
        _other_mixers(res)
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


# the reference's own sharded step: qwen's reduced() at tp 2 on a (2, 2)
# host mesh, in_shardings as launch/dryrun.py lowers a train cell
_MANUAL = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import build_model
from repro.sharding.rules import make_rules
from repro.train import optimizer as jopt, train_step as jstep
z = np.load(f"{DIR}/in.npz")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
model = build_model(get_config("qwen1.5-0.5b").reduced(), tp=2,
                    compute_dtype=jnp.float32)
rules = make_rules(mesh, "train", BATCH, kv_sharded=model.kv_sharded)
treedef = jax.tree_util.tree_structure(model.param_struct())
n = treedef.num_leaves
params = treedef.unflatten([jnp.asarray(z[f"p{i}"]) for i in range(n)])
p_sh = rules.param_shardings(model.param_specs())
o_sh = {"m": p_sh, "v": p_sh, "step": NamedSharding(mesh, P())}
b_sh = {k: NamedSharding(mesh, P(None, rules.batch_axes or None, None))
        for k in ("tokens", "labels")}
step = jax.jit(jstep.make_train_step(model, jopt.AdamWConfig(**OPT), rules),
               in_shardings=(p_sh, o_sh, b_sh))
state = jopt.init_opt_state(params)
res = {}
for s in range(2):
    batch = {k: jnp.asarray(z[f"{k}{s}"]) for k in ("tokens", "labels")}
    with mesh:
        params, state, m = step(params, state, batch)
    res[f"metrics{s}"] = np.array([float(m[k]) for k in
                                   ("loss", "grad_norm", "lr")])
for i, x in enumerate(jax.tree_util.tree_leaves(params)):
    res[f"p{i}"] = np.asarray(x)
np.savez(f"{DIR}/out.npz", **res)
"""


def _manual(d, box):
    case = CASES[MANUAL_CASE]
    feed = {f"p{i}": a for i, a in enumerate(tree_leaves(_tree(case)))}
    for s, b in enumerate(_batches(case)):
        feed.update({f"{k}{s}": b[k] for k in ("tokens", "labels")})
    np.savez(d / "in.npz", **feed)
    try:
        run_with_devices(f"DIR = {str(d)!r}\nOPT = {OPT!r}\n"
                         f"BATCH = {case['batch']}\n" + _MANUAL, 4,
                         timeout=300)
        box["out"] = dict(np.load(d / "out.npz"))
    except Exception as e:      # reported by the test that reads it
        box["error"] = e


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns and the reference's sharded step run while this process
    makes the JAX side's references."""
    tmp = tmp_path_factory.mktemp("lm_train_tp")
    started = {w: _start(tmp, w) for w in (2, 4)}
    manual_dir = tmp / "manual"
    manual_dir.mkdir()
    manual = {}
    thread = threading.Thread(target=_manual, args=(manual_dir, manual))
    thread.start()
    refs = {}
    for case in CASES.values():
        if _jkey(case) not in refs:
            refs[_jkey(case)] = jax_run(case)
    ranks = {w: _join(*started[w], w) for w in (2, 4)}
    thread.join()
    return {"ranks": ranks, "refs": refs, "manual": manual}


def _leaf(ranks, prefix, i, shape) -> np.ndarray:
    """Every rank's block of leaf ``i`` in place; blocks held twice must be
    equal, bit for bit."""
    got = np.full(shape, np.nan, np.float32)
    for r in ranks:
        sl = tuple(slice(a, b) for a, b in r[f"{prefix}__at{i}"])
        block = r[f"{prefix}__{i}"]
        seen = got[sl]
        assert np.isnan(seen).all() or np.array_equal(seen, block), \
            (prefix, i)
        got[sl] = block
    assert not np.isnan(got).any(), (prefix, i)
    return got


def _specs(case) -> list:
    return tree_leaves(build_model(_cfg(case), tp=_tp(case), device="cpu")
                       .param_specs())


def _checksums(leaves, paths) -> dict:
    return {p: [float(np.abs(np.asarray(a, np.float64)).sum()),
                float(np.square(np.asarray(a, np.float64)).sum())]
            for p, a in zip(paths, leaves)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_train_step_matches_jax(name, runs):
    case = CASES[name]
    world = case["mesh"][0] * case["mesh"][1]
    ranks = runs["ranks"][world]
    want = runs["refs"][_jkey(case)]
    specs = _specs(case)
    paths = ["/".join(map(str, p)) for p in tree_paths(
        build_model(_cfg(case), tp=_tp(case), device="cpu").param_specs())]
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
        got = _leaf(ranks, f"{name}__g", i, spec.shape)
        ref = want["grads"][i]
        scale = float(np.abs(ref).max()) or 1.0
        err = float(np.abs(got - ref).max())
        assert err <= GRAD_TOL * scale, (name, paths[i], err, scale)
    for s in (1, 2):
        got = [_leaf(ranks, f"{name}__p{s}", i, spec.shape)
               for i, spec in enumerate(specs)]
        ours, theirs = (_checksums(x, paths)
                        for x in (got, want["params"][s - 1]))
        for p in paths:
            np.testing.assert_allclose(ours[p], theirs[p],
                                       rtol=CHECKSUM_RTOL, err_msg=p)


@pytest.mark.parametrize("name", ELSEWHERE_CASES)
def test_remat_recomputes_in_the_sharding_context(name, runs):
    """The backward pass run on a thread of its own (as CUDA runs it):
    remat recomputes each layer inside the step's sharding context all the
    same, and the gradients are bit for bit those of the caller's
    thread."""
    for r in runs["ranks"][4]:
        assert bool(r[f"{name}__elsewhere_equal"]), name


def test_cases_take_their_layouts(runs):
    """The batch axes each rule set picks: TP over "data" where it divides
    the batch, no_tp over both axes, or only "data" (batch 2 on (2, 2)),
    none for a batch of 3."""
    def bax(name):
        world = CASES[name]["mesh"][0] * CASES[name]["mesh"][1]
        return json.loads(str(runs["ranks"][world][0][f"{name}__batch_axes"]))
    assert bax("qwen1.5-0.5b-2x2-tp") == ["data"]
    assert bax("qwen1.5-0.5b-1x4-no_tp") == ["data", "model"]
    assert bax("qwen1.5-0.5b-2x2-no_tp") == ["data", "model"]
    assert bax("no_tp_batch_by_data") == ["data"]
    assert bax("batch_not_divided") == []


def test_remat_gathers_again_and_the_collectives_per_step(runs):
    """A step's collectives on (1, 4): under no_tp each layer gathers its
    nine weights (the norms, wq, wk, wv, wo, wi, wg, wo) in the forward
    pass and again when remat recomputes the layer in the backward pass
    (nothing gathered is kept across layers), plus the embedding, the head
    and the final norm; every gather's adjoint reduce-scatters; three
    all-reduces (the loss, the replicated leaves' gradients, the norm).
    Under the TP rules each layer gathers the residual by sequence twice
    and reduce-scatters it twice; the recompute stops before its last
    reduce-scatter, whose output the backward pass does not read."""
    def calls(name):
        return json.loads(str(runs["ranks"][4][0][f"{name}__calls"]))
    layers = get_config("qwen1.5-0.5b").reduced().num_layers
    fwd = 9 * layers + 3
    assert calls("qwen1.5-0.5b-1x4-no_tp") == {
        "gather": fwd + 9 * layers, "scatter": fwd, "reduce": 3}
    fwd = 2 * layers + 1
    assert calls("qwen1.5-0.5b-1x4-tp") == {
        "gather": fwd + 2 * layers + fwd, "scatter": fwd + layers + fwd,
        "reduce": 3 + 2}


def test_reference_sharded_step_agrees(runs):
    """The reference's own make_train_step(model, opt, rules), jitted on a
    (2, 2) host mesh, against the port's (2, 2) TP run of the same case."""
    manual = runs["manual"]
    if "error" in manual:
        raise manual["error"]
    out = manual["out"]
    ranks = runs["ranks"][4]
    case = CASES[MANUAL_CASE]
    specs = _specs(case)
    paths = [str(i) for i in range(len(specs))]
    metrics = ranks[0][f"{MANUAL_CASE}__metrics"]
    np.testing.assert_allclose(metrics[0][:2], out["metrics0"][:2],
                               rtol=RTOL)
    np.testing.assert_allclose(metrics[1][0], out["metrics1"][0], rtol=RTOL)
    np.testing.assert_allclose(metrics[1][1], out["metrics1"][1],
                               rtol=LATER_GRAD_NORM_RTOL)
    got = [_leaf(ranks, f"{MANUAL_CASE}__p2", i, s.shape)
           for i, s in enumerate(specs)]
    ours = _checksums(got, paths)
    theirs = _checksums([out[f"p{i}"] for i in range(len(specs))], paths)
    for p in paths:
        np.testing.assert_allclose(ours[p], theirs[p], rtol=CHECKSUM_RTOL)


def test_sharded_checkpoint_round_trips(runs):
    """Written on (1, 4) (each leaf gathered whole): the file holds the
    state the ranks held, the JAX package reads it, the run restored on
    (1, 4) continues bit for bit, and (2, 2) under the TP and the no_tp
    rules restores every leaf's blocks of the same state."""
    ranks = runs["ranks"][4]
    assert all(bool(r["ckpt__continues"]) for r in ranks)
    path = str(ranks[0]["ckpt__path"])
    model = build_model(_cfg(CKPT), tp=4, device="cpu")
    specs = tree_leaves(model.param_specs())
    paths = ["/".join(map(str, p)) for p in tree_paths(model.param_specs())]
    with np.load(os.path.join(path, "params.npz")) as z:
        saved = {k: z[k] for k in z.files}
    with np.load(os.path.join(path, "opt_m.npz")) as z:
        saved_m = {k: z[k] for k in z.files}
    assert sorted(saved) == sorted(paths)
    for i, (p, spec) in enumerate(zip(paths, specs)):
        assert np.array_equal(_leaf(ranks, "ckpt__p2", i, spec.shape),
                              saved[p]), p
        for label in CKPT_RESTORES:
            assert np.array_equal(_leaf(ranks, f"ckpt__{label}", i,
                                        spec.shape), saved[p]), (label, p)
            assert np.array_equal(_leaf(ranks, f"ckpt__{label}__m", i,
                                        spec.shape), saved_m[p]), (label, p)
    jmodel = jbuild(_cfg(CKPT, jget_config), tp=4,
                    compute_dtype=jnp.float32)
    like = jmodel.param_struct()
    jp, jstate, man = jckpt.load_checkpoint(path, like, {"m": like,
                                                         "v": like})
    assert man["step"] == 2 and int(jstate["step"]) == 2
    for p, x in zip(paths, jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(x), saved[p]), p
    tp_, ts, tman = tckpt.load_checkpoint(path, model.param_specs(),
                                          {"m": model.param_specs(),
                                           "v": model.param_specs()})
    assert tman == man
    for p, x in zip(paths, tree_leaves(tp_)):
        assert np.array_equal(x.numpy(), saved[p]), p


def test_sharded_training_takes_the_other_mixers(runs):
    """The SSD, the RG-LRU and the encoder-decoder train under the TP rules
    (at tp 4) and under no_tp (at tp 1) on a (1, 4) mesh: one step, its
    metrics finite and the same on every rank
    (tests/test_torch_lm_train_tp_recurrent.py holds them to the JAX
    package)."""
    ranks = [json.loads(str(r["other_mixers"])) for r in runs["ranks"][4]]
    assert sorted(ranks[0]) == sorted(f"{a}-{n}" for a in MIXER_ARCHS
                                      for n in (False, True))
    for key, metrics in ranks[0].items():
        assert all(np.isfinite(metrics)), (key, metrics)
        assert all(r[key] == metrics for r in ranks), key
