"""repro_torch's ``Model.loss`` and its gradients against the JAX
package's (``jax.value_and_grad``), on the CPU, for every config's
``reduced()``.

Both packages get the same float32 master tree (``chip_smoke.
lm_reference_params``) and the same batch (tokens from a numpy seed;
whisper's frames and phi-3-vision's image embeddings too). float32: the
loss within rtol 1e-5, each leaf's gradient within 1e-4 of that leaf's
largest gradient (rtol 1e-4 plus atol 1e-4 x max |g|). bf16 compute over
the float32 masters: both packages round at the same points but sum in
other orders, so the loss is held within 2^-10 relative and each leaf's
gradient within a relative L2 of 2^-4 (mamba2-130m: 2^-2; its bf16 SSD
takes dt * a in bf16 before the chunk sums, and the two packages' a_log
gradients read 0.13 apart; the JAX package's cumsum is taken in float32
here, as tests/test_torch_lm_mixers.py does). MoE routing is piecewise:
in bf16 a near-tie at the top-k boundary can route a token to another
expert in one package, and that token's later layers then differ too. So
the expert sets chosen by both are recorded: at the first layer where
they differ, each differing token must be a near tie (router margin below
BF16_NEAR_TIE in both packages), at most BF16_FLIP_SHARE of all routings
may differ, and the gradient bound applies only to a config whose
choices all agree (the loss bound to all).

``REPRO_REMAT`` "nothing", "none" and "dots" give the same gradients bit
for bit, and each recomputes what it says (counted in the backward pass).
"""
import contextlib
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_paths  # noqa: E402

ARCHS = chip_smoke.LM_ARCHS
BATCH = (2, 32)
F32_LOSS_RTOL = 1e-5
F32_GRAD_TOL = 1e-4
BF16_LOSS_RTOL = 2.0 ** -10
BF16_GRAD_REL_L2 = {"mamba2-130m": 2.0 ** -2}
BF16_GRAD_REL_L2_DEFAULT = 2.0 ** -4
BF16_NEAR_TIE = 1e-3
BF16_FLIP_SHARE = 0.02
REMATS = ("nothing", "none", "dots")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (see test_torch_api.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def remat(monkeypatch):
    def use(policy):
        monkeypatch.setenv("REPRO_REMAT", policy)
    return use


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    b, s = BATCH
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model), dtype=np.float32)
    if cfg.num_patches:
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model), dtype=np.float32)
    return out


def _port(arch: str, dtype):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, compute_dtype=dtype, device="cpu")
    tree = chip_smoke.lm_reference_params(convert, model)
    return model, tree


def port_loss_and_grads(model, params, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model.loss(tb, params)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return float(loss.detach()), [g.float().numpy() for g in grads]


def jax_loss_and_grads(arch: str, tree, batch, dtype):
    jmodel = jbuild(jget_config(arch).reduced(), compute_dtype=dtype)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree_util.tree_leaves(grads)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_in_float32(arch):
    model, tree = _port(arch, torch.float32)
    batch = _batch(model.cfg)
    loss, grads = port_loss_and_grads(model, model.master_params(tree),
                                      batch)
    jloss, jgrads = jax_loss_and_grads(arch, tree, batch, jnp.float32)
    np.testing.assert_allclose(loss, jloss, rtol=F32_LOSS_RTOL)
    assert len(grads) == len(jgrads)
    for path, g, w in zip(tree_paths(tree), grads, jgrads):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=F32_GRAD_TOL,
                                   atol=F32_GRAD_TOL * scale,
                                   err_msg="/".join(map(str, path)))


class _Float32Cumsum:
    """``jax.numpy`` with ``cumsum`` accumulating in float32 (see
    tests/test_torch_lm_mixers.py): JAX's CPU bf16 cumsum adds in bf16."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def cumsum(x, axis=None):
        return jnp.cumsum(x.astype(jnp.float32), axis=axis).astype(x.dtype)


@contextlib.contextmanager
def _routes(module, record):
    """Every apply_moe call of ``module`` reports ``record(cfg, p, x)``."""
    seen, apply = [], module.apply_moe

    def recorded(cfg, p, x):
        record(seen, cfg, p, x)
        return apply(cfg, p, x)

    module.apply_moe = recorded
    try:
        yield seen
    finally:
        module.apply_moe = apply


def _port_routes(model, params, batch):
    """(expert ids, per-assignment margin) of each MoE call, port side."""
    def record(seen, cfg, p, x):
        probs, _, ids = tmoe.route(cfg, p, x)
        top = probs.topk(cfg.top_k + 1, dim=-1).values
        seen.append((ids.numpy(), (top[..., -2] - top[..., -1]).numpy()))
    with torch.no_grad(), _routes(tmoe, record) as seen:
        model.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                   params)
    return seen


def _jax_routes(arch, tree, batch):
    def record(seen, cfg, p, x):
        probs = jax.nn.softmax(x @ p["router"].astype(jnp.float32), axis=-1)
        top, ids = jax.lax.top_k(probs, cfg.top_k + 1)
        jax.debug.callback(
            lambda i, m: seen.append((np.asarray(i), np.asarray(m))),
            ids[..., :cfg.top_k], top[..., -2] - top[..., -1])
    jmodel = jbuild(jget_config(arch).reduced(), compute_dtype=jnp.bfloat16)
    with _routes(jmoe, record) as seen:
        jax.jit(jmodel.loss)(jax.tree_util.tree_map(jnp.asarray, tree),
                             {k: jnp.asarray(v) for k, v in batch.items()})
        jax.effects_barrier()
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_in_bf16(arch, monkeypatch):
    if arch == "mamba2-130m":
        monkeypatch.setattr(jssm, "jnp", _Float32Cumsum())
    model, tree = _port(arch, torch.bfloat16)
    params = model.master_params(tree)
    batch = _batch(model.cfg)
    loss, grads = port_loss_and_grads(model, params, batch)
    jloss, jgrads = jax_loss_and_grads(arch, tree, batch, jnp.bfloat16)
    assert abs(loss - jloss) <= BF16_LOSS_RTOL * abs(jloss), (loss, jloss)
    flips = 0
    if model.cfg.moe:
        ours, theirs = _port_routes(model, params, batch), \
            _jax_routes(arch, tree, batch)
        assert len(ours) == len(theirs) == model.cfg.num_layers
        for layer, ((ids, margin), (jids, jmargin)) in enumerate(
                zip(ours, theirs)):
            differ = (np.sort(ids, -1) != np.sort(jids, -1)).any(-1)
            if differ.any() and not flips:
                # the first layer that routes otherwise: near ties only
                assert (margin[differ] < BF16_NEAR_TIE).all(), layer
                assert (jmargin[differ] < BF16_NEAR_TIE).all(), layer
            flips += int(differ.sum())
        tokens = ids.shape[0] * ids.shape[1] * len(ours)
        print(f"{arch}: {flips} of {tokens} routings differ")
        assert flips <= BF16_FLIP_SHARE * tokens
    if flips:
        return
    bound = BF16_GRAD_REL_L2.get(arch, BF16_GRAD_REL_L2_DEFAULT)
    worst = 0.0
    for path, g, w in zip(tree_paths(tree), grads, jgrads):
        rel = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        worst = max(worst, rel)
        assert rel <= bound, ("/".join(map(str, path)), rel)
    print(f"{arch}: bf16 gradients within relative L2 {worst:.3g}")


# --- remat ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_equal_grads(arch, remat):
    model, tree = _port(arch, torch.float32)
    params = model.master_params(tree)
    batch = _batch(model.cfg, seed=1)
    out = {}
    for policy in REMATS:
        remat(policy)
        out[policy] = port_loss_and_grads(model, params, batch)
    for policy in REMATS[1:]:
        assert out[policy][0] == out["nothing"][0]
        for g, w in zip(out[policy][1], out["nothing"][1]):
            np.testing.assert_array_equal(g, w)


class _OpCounts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_say(remat):
    """The ops of the backward pass: "none" recomputes nothing; "dots"
    recomputes the group bodies but not their weight products (mm), so it
    runs as many mm as "none" and more of the rest (bmm, the attention
    einsums, among them); "nothing" recomputes the products too. The rem
    layers (none here: 4 layers of period 1) and the loss head are never
    recomputed."""
    model, tree = _port("qwen1.5-0.5b", torch.float32)
    params = model.master_params(tree)
    tb = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    counts = {}
    for policy in REMATS:
        remat(policy)
        loss = model.loss(tb, params)
        with _OpCounts() as mode:
            torch.autograd.grad(loss, tree_leaves(params))
        counts[policy] = mode.counts
    mm = {p: counts[p].get("mm", 0) for p in REMATS}
    bmm = {p: counts[p].get("bmm", 0) for p in REMATS}
    total = {p: sum(counts[p].values()) for p in REMATS}
    assert mm["none"] == mm["dots"] < mm["nothing"], mm
    assert bmm["none"] < bmm["dots"] == bmm["nothing"], bmm
    assert total["none"] < total["dots"] < total["nothing"], total


def test_remat_runs_only_in_training(remat):
    """Serving passes (caches given, or the teacher-forced forward) never
    enter torch.utils.checkpoint."""
    remat("nothing")
    model, tree = _port("qwen1.5-0.5b", torch.float32)
    convert.params_from_numpy(model, tree)
    calls = []
    real = ttf.ckpt.checkpoint

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    ttf.ckpt.checkpoint = spy
    try:
        tokens = torch.from_numpy(_batch(model.cfg)["tokens"])
        logits, caches = model.prefill({"tokens": tokens[:, :8]}, 10)
        model.decode_step(tokens[:, 8:9], caches, 8)
        model({"tokens": tokens})
        assert calls == []
        model.loss({"tokens": tokens, "labels": tokens})
        assert len(calls) == model.cfg.num_layers
    finally:
        ttf.ckpt.checkpoint = real


# --- the loss itself --------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "qwen3-moe-235b-a22b", "stablelm-1.6b"])
def test_loss_is_cross_entropy_plus_the_moe_aux(arch):
    """Model.loss = the mean cross entropy of the teacher-forced logits
    (Model.forward, under inference mode) + 0.01 x the stack's summed
    load-balancing loss (0 without MoE); after serving passes on the same
    model, so no tensor made under inference mode reaches the loss."""
    model, tree = _port(arch, torch.float32)
    convert.params_from_numpy(model, tree)
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    logits = model(batch)
    model.prefill({"tokens": batch["tokens"][:, :4]}, 6)
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), batch["labels"].reshape(-1)
        .long())
    x = model._embed(batch, model.tree)
    _, _, aux = ttf.apply_stack(model.cfg, model.tree["stack"], x,
                                model._positions(x.shape[1]), None,
                                model.heads, model.kv_heads)
    params = model.master_params(tree)
    loss = model.loss(batch, params)
    assert loss.requires_grad and not loss.is_inference()
    assert (float(aux) > 0) == model.cfg.moe
    np.testing.assert_allclose(float(loss.detach()),
                               float(ce) + 0.01 * float(aux),
                               rtol=1e-6)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert all(bool(g.isfinite().all()) for g in grads)
