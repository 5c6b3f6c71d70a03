"""repro_torch's LM configs, layers, attention and models against the JAX
package's, on the CPU.

The same numpy inputs and parameter trees go through both packages: the
configs and spec trees must be equal; module and model outputs agree
within rtol/atol 1e-5 in float32. In bf16 both packages round at the same
points but accumulate in other orders, and one ulp of a bf16 term moves a
sum by the term's size, not the sum's: bf16 outputs agree within 2^-6 (4
bf16 ulps) of the output's largest magnitude, plus rtol 2^-6. Parameters
come from ``repro_torch.convert.numpy_params`` (``jnp.asarray`` per leaf
for JAX), with the norms' scales and the biases perturbed where a test
needs them non-zero; module weights are drawn at 1/sqrt(fan_in), so
outputs are O(1) and 1e-5 is a tolerance on rounding, not on scale.
"""
import dataclasses
import importlib
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import applicable_shapes as japplicable
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models.layers import ParamSpec as JParamSpec
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.configs import base as tbase
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (lm_layer_fan_in, lm_reference_params)

LM_ARCHS = list(ARCH_IDS)
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -6, atol=2.0 ** -6, scaled=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (see test_torch_api.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    tol = dict(tol)
    if tol.pop("scaled", False):
        tol["atol"] *= float(np.abs(want).max())
    np.testing.assert_allclose(got, want, **tol)


def _pair(rng, shape, scale=1.0):
    """The same float32 draw for both packages."""
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _perturbed(tree, seed):
    """The constant leaves of a numpy tree (norm scales, biases) plus
    0.1 N(0, 1), so they are not zeros and ones."""
    rng = np.random.default_rng(seed)

    def perturb(_, a):
        if np.ptp(a) != 0:
            return a
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return tlayers.tree_map(perturb, tree)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match(arch, reduced):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert isinstance(cfg, tbase.ArchConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.num_active_params() == jcfg.num_active_params()
    assert cfg.layer_kinds() == jcfg.layer_kinds()
    assert cfg.is_subquadratic == jcfg.is_subquadratic
    assert cfg.has_decoder == jcfg.has_decoder
    assert applicable_shapes(cfg) == japplicable(jcfg)


def test_registry_and_shapes_match():
    from repro.configs import SHAPES as JSHAPES
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


# ---------------------------------------------------------------- specs

def _jax_spec_leaves(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JParamSpec))
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
             s.shape, s.axes, s.init, jnp.dtype(s.dtype).name)
            for path, s in flat]


def _port_spec_leaves(specs):
    out = []
    tlayers.tree_map(lambda path, s: out.append(
        (path, s.shape, s.axes, s.init, str(s.dtype).removeprefix("torch."))),
        specs)
    return out


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_specs_match_at_full_config(arch, tp):
    """Padding, spec tree, parameter count and cache shapes at full width,
    from the specs alone (nothing allocated)."""
    model = build_model(get_config(arch), tp=tp, device="cpu")
    jmodel = jbuild(jget_config(arch), tp=tp)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jmodel.cfg)
    assert (model.heads, model.kv_heads, model.kv_sharded) == \
        (jmodel.heads, jmodel.kv_heads, jmodel.kv_sharded)
    assert _port_spec_leaves(model.param_specs()) == \
        _jax_spec_leaves(jmodel.param_specs())
    assert model.count_params() == jmodel.count_params()
    assert model.tree is None
    for batch, max_len in ((2, 64), (3, 5000)):
        got = tlayers.tree_leaves(model.cache_structs(batch, max_len))
        want = jax.tree_util.tree_leaves(jmodel.cache_structs(batch, max_len))
        assert [(tuple(s.shape), str(s.dtype).removeprefix("torch."))
                for s in got] == [(tuple(s.shape), jnp.dtype(s.dtype).name)
                                  for s in want]


def test_qwen_count_params():
    assert build_model(get_config("qwen1.5-0.5b"),
                       device="cpu").count_params() == 463_987_712


def test_tensor_parallel_models_hold_no_parameters():
    """A model of tp > 1 holds no parameters until it is given some; given
    no sharding rules it holds the whole padded tree and runs unsharded,
    as the JAX package's does (the reference of every sharded run at that
    tp, tests/test_torch_lm_tp.py)."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              vocab_size=511)
    model = build_model(cfg, tp=2, device="cpu")
    with pytest.raises(RuntimeError, match="no parameters"):
        model.prefill({"tokens": torch.zeros((1, 4), dtype=torch.long)})
    model.init(torch.Generator().manual_seed(0))
    jmodel = jbuild(dataclasses.replace(jget_config("qwen1.5-0.5b").reduced(),
                                        vocab_size=511), tp=2)
    assert model.param_rules is None and model.cfg.vocab_size == 512
    assert model.count_params(model.tree) == model.count_params() == \
        jmodel.count_params()
    logits, _ = model.prefill({"tokens": torch.zeros((1, 4),
                                                     dtype=torch.long)})
    assert logits.shape == (1, 1, 512) and bool(logits.isfinite().all())


def test_init_draws_each_kind_in_its_dtype():
    """The port's own init: the JAX init kinds (zeros, ones, small, fan_in
    by the leading dimension), float32 norms and bf16 weights, the same
    draw for the same seed."""
    cfg = get_config("stablelm-1.6b").reduced()
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    again = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    tree = model.tree
    layer = tree["stack"]["groups"][0]
    assert tree["embed"]["tok"].dtype == torch.bfloat16
    assert layer["norm1"]["scale"].dtype == torch.float32
    assert torch.equal(layer["norm1"]["scale"], torch.ones_like(
        layer["norm1"]["scale"]))
    assert not layer["norm1"]["bias"].any()
    assert abs(float(tree["embed"]["tok"].float().std()) - 0.01) < 1e-3
    n = cfg.num_layers       # fan_in of a stacked leaf: the stack's depth
    assert abs(float(layer["mixer"]["wq"].float().std()) - n ** -0.5) < 0.02
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    assert sum(p.numel() for p in model.parameters()) == model.count_params()
    wide = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    chip_smoke.lm_layer_fan_in(wide)
    np.testing.assert_allclose(
        wide.tree["stack"]["groups"][0]["mixer"]["wq"].float().numpy(),
        (layer["mixer"]["wq"].float() * np.sqrt(n / cfg.d_model)).numpy(),
        rtol=2 ** -7)
    assert torch.equal(wide.tree["embed"]["tok"], tree["embed"]["tok"])
    assert any(k.endswith("groups.0.mixer.wq")
               for k in model.state_dict())


@pytest.mark.parametrize("chunk", [convert.DRAW_CHUNK, 1000])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama4-scout-17b-a16e",
                                  "recurrentgemma-2b", "whisper-medium"])
def test_numpy_params_draw_in_jax_tree_order(arch, chunk, monkeypatch):
    """numpy_params walks the spec tree in tree_flatten's order: drawing
    the JAX package's own spec leaves in that order, leaf i's piece j of
    ``chunk`` elements from default_rng((seed, i, j)), gives the same
    arrays (every init kind: zeros, ones, small, normal, fan_in; MoE's
    router, experts and shared expert, the encoder-decoder's stacks).
    chip_smoke.lm_reference_params: the same draws, a stacked matrix
    rescaled to one layer's fan-in."""
    monkeypatch.setattr(convert, "DRAW_CHUNK", chunk)
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    tree = convert.numpy_params(model, seed=5)
    per_layer = chip_smoke.lm_reference_params(convert, model, seed=5)
    specs, _ = jax.tree_util.tree_flatten(
        jbuild(jget_config(arch).reduced()).param_specs(),
        is_leaf=lambda x: isinstance(x, JParamSpec))
    got = tlayers.tree_leaves(tree)
    assert len(got) == len(specs)
    kinds = set()
    for i, (a, b, s) in enumerate(zip(got, tlayers.tree_leaves(per_layer),
                                      specs)):
        kinds.add(s.init)
        if s.init in ("zeros", "ones"):
            want = np.full(s.shape, 1.0 if s.init == "ones" else 0.0)
        else:
            scale = {"small": 0.01, "normal": 1.0}.get(
                s.init, 1 / np.sqrt(s.shape[0] if len(s.shape) >= 2
                                    else max(s.shape[0], 1)))
            n = int(np.prod(s.shape))
            want = np.concatenate([
                np.random.default_rng((5, i, j)).standard_normal(
                    min(chunk, n - j * chunk), dtype=np.float32)
                for j in range(-(-n // chunk))]).reshape(s.shape) * \
                np.float32(scale)
        assert a.dtype == np.float32 and np.array_equal(a, want)
        if s.init == "fan_in" and s.axes[0] == "layers" and len(s.shape) > 2:
            np.testing.assert_allclose(
                b, a * np.float32(np.sqrt(s.shape[0] / s.shape[1])),
                rtol=1e-6)
        else:
            assert np.array_equal(a, b)
    assert {"zeros", "small", "fan_in"} <= kinds
    assert ("normal" in kinds) == (arch == "recurrentgemma-2b")


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_and_mlps_match(dtype):
    tol = F32 if dtype == "float32" else BF16
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(0)
    tx, jx = _pair(rng, (2, 7, 64), 3.0)
    tx, jx = tx.to(tdt), jx.astype(jdt)
    ts, js = _pair(rng, (64,), 0.5)
    tb, jb = _pair(rng, (64,), 0.5)
    _close(tlayers.rmsnorm(tx, ts), jlayers.rmsnorm(jx, js), tol)
    _close(tlayers.layernorm(tx, ts, tb), jlayers.layernorm(jx, js, jb), tol)
    assert tlayers.rmsnorm(tx, ts).dtype == tdt

    for theta, hd in ((1e6, 64), (1e4, 32)):
        tq, jq = _pair(rng, (2, 7, 3, hd))
        tq, jq = tq.to(tdt), jq.astype(jdt)
        pos = np.arange(100, 107, dtype=np.int32)
        tc, ts_ = tlayers.rope_freqs(hd, theta, torch.from_numpy(pos))
        jc, js_ = jlayers.rope_freqs(hd, theta, jnp.asarray(pos))
        _close(tc, jc, F32)
        _close(ts_, js_, F32)
        _close(tlayers.apply_rope(tq, tc, ts_),
               jlayers.apply_rope(jq, jc, js_), tol)

    for mlp in ("swiglu", "gelu"):
        cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                                  d_model=64, d_ff=96, mlp=mlp)
        tp, jp = {}, {}
        for key, spec in tlayers.mlp_specs(cfg).items():
            tp[key], jp[key] = _pair(rng, spec.shape, spec.shape[0] ** -0.5)
        _close(tlayers.apply_mlp(cfg, tp, tx),
               jlayers.apply_mlp(cfg, jp, jx), tol)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    got = tlayers.apply_mlp(
        dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), mlp="gelu"),
        {"wi": torch.eye(101), "wo": torch.eye(101)}, x[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(
        jax.nn.gelu(jnp.asarray(x.numpy()))), **F32)
    assert not torch.allclose(got[0], torch.nn.functional.gelu(x), atol=1e-5)


# ---------------------------------------------------------------- attention

WINDOW = CHUNK = 8
PROMPT = 20


def _attn_cfg(cls_get):
    """qwen's reduced config (QKV bias) with 4 query heads over 2 KV heads
    and an 8-token window and chunk."""
    return dataclasses.replace(cls_get("qwen1.5-0.5b").reduced(),
                               num_kv_heads=2, local_window=WINDOW,
                               chunk_size=CHUNK)


def _attn_params(rng, cfg):
    tp, jp = {}, {}
    for key, spec in tattn.gqa_specs(cfg, 4, 2).items():
        fan_in = spec.shape[0] if spec.init == "fan_in" else 1
        tp[key], jp[key] = _pair(rng, spec.shape, fan_in ** -0.5)
    return tp, jp


ATTN_CASES = [("global", "train"), ("global", "prefill"),
              ("global", "decode"), ("chunked", "train"),
              ("chunked", "prefill"), ("chunked", "decode"),
              ("local", "train"), ("local", "prefill"), ("local", "decode"),
              ("local", "ring_prefill"), ("local", "ring_decode")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,branch", ATTN_CASES)
def test_gqa_attention_branches_match(kind, branch, dtype):
    """gqa_attention's five branches: no cache (train), prefill (the
    prompt written at offset 0), decode steps (written at pos, attending
    over the whole cache), and for local layers the ring buffer's prefill
    (the last window of the prompt) and decode (positions wrapping past
    the window). The caches must agree after every call."""
    tol = F32 if dtype == "float32" else BF16
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    cfg, jcfg = _attn_cfg(get_config), _attn_cfg(jget_config)
    rng = np.random.default_rng(len(kind) * 10 + len(branch))
    tp, jp = _attn_params(rng, cfg)
    steps = 12 if branch.endswith("decode") else 0
    tx, jx = _pair(rng, (2, PROMPT + steps, cfg.d_model))
    tx, jx = tx.to(tdt), jx.astype(jdt)
    ring = branch.startswith("ring")
    max_len = WINDOW if ring else PROMPT + steps

    def both(s0, s1, tc, jc):
        pos = np.arange(s0, s1, dtype=np.int32)
        ty, tc = tattn.gqa_attention(cfg, tp, tx[:, s0:s1], kind,
                                     torch.from_numpy(pos), tc, 4, 2)
        jy, jc = jattn.gqa_attention(jcfg, jp, jx[:, s0:s1], kind,
                                     jnp.asarray(pos), jc, 4, 2)
        _close(ty, jy, tol)
        if jc is not None:
            _close(tc["k"], jc["k"], tol)
            _close(tc["v"], jc["v"], tol)
        return tc, jc

    if branch == "train":
        both(0, PROMPT, None, None)
        return
    shape = (2, max_len, 2, cfg.head_dim)
    tc = {k: torch.zeros(shape, dtype=tdt) for k in "kv"}
    jc = {k: jnp.zeros(shape, jdt) for k in "kv"}
    tc, jc = both(0, PROMPT, tc, jc)
    for i in range(steps):
        tc, jc = both(PROMPT + i, PROMPT + i + 1, tc, jc)


@pytest.mark.parametrize("kind", ["global", "local", "chunked"])
def test_sdpa_blockwise_matches(kind):
    """The online-softmax path (forced, padded to 1024-blocks) against the
    JAX package's and against the materialised scores."""
    rng = np.random.default_rng(7)
    tq, jq = _pair(rng, (1, 40, 2, 2, 16))
    tk, jk = _pair(rng, (1, 45, 2, 16))
    tv, jv = _pair(rng, (1, 45, 2, 16))
    qpos = np.arange(5, 45, dtype=np.int32)
    kpos = np.arange(45, dtype=np.int32)
    args = (kind, WINDOW, CHUNK)
    got = tattn.sdpa(tq, tk, tv, *args, torch.from_numpy(qpos),
                     torch.from_numpy(kpos), force_blockwise=True)
    want = jattn.sdpa(jq, jk, jv, *args, jnp.asarray(qpos), jnp.asarray(kpos),
                      force_blockwise=True)
    _close(got, want, F32)
    _close(got, tattn.sdpa(tq, tk, tv, *args, torch.from_numpy(qpos),
                           torch.from_numpy(kpos)), F32)


# ---------------------------------------------------------------- models

@pytest.fixture(scope="module")
def perturbed_models():
    """Each arch's reduced model in both packages, float32, on one
    perturbed numpy tree (stacked matrices at one layer's fan-in: at the
    reference init's 1/sqrt(depth) a shallow stack amplifies float32
    rounding past 1e-5, see chip_smoke.lm_reference_params)."""
    out = {}
    for arch in LM_ARCHS:
        model = build_model(get_config(arch).reduced(),
                            compute_dtype=torch.float32, device="cpu")
        tree = _perturbed(chip_smoke.lm_reference_params(convert, model,
                                                         seed=1), seed=2)
        convert.params_from_numpy(model, tree)
        jmodel = jbuild(jget_config(arch).reduced(), compute_dtype=jnp.float32)
        out[arch] = (model, jmodel,
                     jax.tree_util.tree_map(jnp.asarray, tree))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_prefill_and_decode_match(arch, perturbed_models):
    """Prefill logits and every cache, then three decode steps (the
    vision arch with image embeddings spliced over its first positions,
    the encoder-decoder with frames), then the teacher-forced pass."""
    model, jmodel, jparams = perturbed_models[arch]
    cfg = model.cfg
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 21))
    tb, jb = {"tokens": torch.from_numpy(tokens[:, :18])}, \
        {"tokens": jnp.asarray(tokens[:, :18])}
    if cfg.num_patches:
        tb["image_embeds"], jb["image_embeds"] = _pair(
            rng, (2, cfg.num_patches, cfg.d_model))
    if cfg.family == "audio":
        tb["frames"], jb["frames"] = _pair(
            rng, (2, cfg.encoder_len, cfg.d_model))
    tl, tc = model.prefill(tb, max_len=24)
    jl, jc = jmodel.prefill(jparams, jb, max_len=24)
    _close(tl, jl, F32)
    assert tl.shape == (2, 1, cfg.vocab_size)

    def caches_close():
        got, want = tlayers.tree_leaves(tc), jax.tree_util.tree_leaves(jc)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            # The reference's init draws a stacked leaf at 1/sqrt(depth)
            # (0.71 here), so scores reach ~1e2 and one float32 rounding in
            # a score moves a later layer's K and V by far more than an
            # ulp: 1e-4 of their largest magnitude (the logits: 1e-5).
            _close(g, w, dict(rtol=1e-5, atol=1e-4, scaled=True))

    caches_close()
    for i in range(3):
        tok = tokens[:, 18 + i:19 + i]
        tl, tc = model.decode_step(torch.from_numpy(tok), tc, 18 + i)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                    jnp.int32(18 + i))
        _close(tl, jl, F32)
        caches_close()
    if not cfg.num_patches:
        full = model(dict(tb, tokens=torch.from_numpy(tokens)))
        _close(full[:, 20], tl[:, 0], dict(rtol=2e-3, atol=2e-3))


def test_model_bf16_matches():
    """The default compute dtype: weights held in bf16 (cast once on load)
    against the JAX package's float32 weights cast at every use."""
    arch = "stablelm-1.6b"
    model = build_model(get_config(arch).reduced(), device="cpu")
    tree = _perturbed(convert.numpy_params(model, seed=1), seed=2)
    convert.params_from_numpy(model, tree)
    assert model.tree["embed"]["tok"].dtype == torch.bfloat16
    jmodel = jbuild(jget_config(arch).reduced())
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens = np.random.default_rng(5).integers(0, 512, (2, 12))
    tl, tc = model.prefill({"tokens": torch.from_numpy(tokens[:, :10])}, 12)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :10])},
                            12)
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    _close(tl, jl, BF16)
    for i in range(2):
        tok = tokens[:, 10 + i:11 + i]
        tl, tc = model.decode_step(torch.from_numpy(tok), tc, 10 + i)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                    jnp.int32(10 + i))
        _close(tl, jl, BF16)


def test_stack_layout_and_views():
    """groups hold the period's layers on a leading axis, rem the rest;
    apply_stack hands each layer views of its slice, so a decode step's
    cache writes land in the stacked buffers, in place."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              num_layers=5, layer_pattern=("global", "local"),
                              local_window=4)
    jcfg = dataclasses.replace(jget_config("qwen1.5-0.5b").reduced(),
                               num_layers=5, layer_pattern=("global", "local"),
                               local_window=4)
    specs = ttf.stack_specs(cfg, 4, 4)
    assert len(specs["groups"]) == 2 and len(specs["rem"]) == 1
    assert specs["groups"][1]["mixer"]["wq"].shape[0] == 2
    assert _port_spec_leaves(specs) == _jax_spec_leaves(
        __import__("repro.models.transformer", fromlist=["x"]).stack_specs(
            jcfg, 4, 4))
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    convert.params_from_numpy(model, convert.numpy_params(model, 0))
    caches = model.init_cache(1, 16)
    assert caches["groups"][1]["k"].shape == (2, 1, 4, 4, 32)  # the ring
    buffers = ([caches["groups"][pos]["k"][j] for j in range(2)
                for pos in range(2)] + [caches["rem"][0]["k"]])
    ptrs = [b.data_ptr() for b in buffers]
    _, out = model.decode_step(torch.tensor([[3]]), caches, 2)
    assert out["groups"][0]["k"] is caches["groups"][0]["k"]
    assert [b.data_ptr() for b in buffers] == ptrs
    for b in buffers:                   # every layer, in stack order
        assert b[:, 2].ne(0).any()      # position 2 (slot 2 of the ring)
        assert b[:, :2].eq(0).all() and b[:, 3:].eq(0).all()


# ---------------------------------------------------------------- float64

class _Dtypes:
    """A module (``torch`` or ``jax.numpy``) whose float32 is float64."""

    def __init__(self, module, wide):
        self._module, self.float32 = module, wide

    def __getattr__(self, name):
        return getattr(self._module, name)


MODEL_MODULES = ("attention", "encdec", "layers", "model", "moe", "rglru",
                 "ssm", "transformer")


def float64_witness(arch: str, num_layers: int, d_model: int = 0) -> dict:
    """Both packages on one reference-init tree (numpy_params, stacked
    leaves at 1/sqrt(depth)) of ``arch``'s reduced config at
    ``num_layers`` (and ``d_model``): the last-position logits of an
    18-token prefill and three decode steps, in float32 and wholly in
    float64 (every float32 the modules name is float64 there). The
    relative L2 (largest over steps) of the port against the JAX package
    in each, and of each package's float32 run against its float64 one:
    where the first is far above the second, the packages compute other
    functions; where it is of the order of the last two, float32
    rounding, amplified by the stack, is all that parts them."""
    kw = dict(num_layers=num_layers, **({"d_model": d_model} if d_model
                                        else {}))
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **kw)
    tree = convert.numpy_params(build_model(cfg, device="cpu"), seed=1)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 21))

    def run(tdt, jdt):
        model = build_model(cfg, compute_dtype=tdt, device="cpu")
        convert.params_from_numpy(model, tree)
        assert {p.dtype for p in model.parameters()} == {tdt}
        jmodel = jbuild(jcfg, compute_dtype=jdt)
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)
        tl, tc = model.prefill({"tokens": torch.from_numpy(tokens[:, :18])},
                               max_len=24)
        jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(tokens[:, :18])},
                                max_len=24)
        out = [(tl, jl)]
        for i in range(18, 21):
            tl, tc = model.decode_step(torch.from_numpy(tokens[:, i:i + 1]),
                                       tc, i)
            jl, jc = jmodel.decode_step(jp, jnp.asarray(tokens[:, i:i + 1]),
                                        jc, jnp.int32(i))
            out.append((tl, jl))
        assert tl.dtype == tdt and jl.dtype == jdt
        return (np.stack([t[:, -1].double().numpy() for t, _ in out], 1),
                np.stack([np.asarray(j[:, -1], np.float64) for _, j in out],
                         1))

    def rel(a, b):
        return float((np.linalg.norm(a - b, axis=-1) /
                      np.linalg.norm(b, axis=-1)).max())

    t32, j32 = run(torch.float32, jnp.float32)
    saved = []
    jax.config.update("jax_enable_x64", True)
    try:
        for name in MODEL_MODULES:
            for mod, attr, wide in (
                    (importlib.import_module("repro.models." + name), "jnp",
                     jnp.float64),
                    (importlib.import_module("repro_torch.models." + name),
                     "torch", torch.float64)):
                if hasattr(mod, attr):
                    saved.append((mod, attr, getattr(mod, attr)))
                    setattr(mod, attr, _Dtypes(getattr(mod, attr), wide))
        saved.append((torch.Tensor, "float", torch.Tensor.float))
        torch.Tensor.float = torch.Tensor.double
        t64, j64 = run(torch.float64, jnp.float64)
    finally:
        for mod, attr, value in reversed(saved):
            setattr(mod, attr, value)
        jax.config.update("jax_enable_x64", False)
    return {"arch": arch, "num_layers": num_layers, "d_model": cfg.d_model,
            "float32_port_vs_jax": rel(t32, j32),
            "float64_port_vs_jax": rel(t64, j64),
            "jax_float32_vs_float64": rel(j32, j64),
            "port_float32_vs_float64": rel(t32, t64)}


def test_reference_init_agrees_in_float64():
    """At the reference init a deep recurrentgemma stack parts the two
    packages' float32 logits by far more than the 1e-5 the model tests
    hold (the reason they draw at one layer's fan-in); wholly in float64
    the packages agree, and in float32 they are no further apart than
    the JAX package's own float32 run is from its float64 one."""
    got = float64_witness("recurrentgemma-2b", 8)
    assert got["float32_port_vs_jax"] > 1e-4, got
    assert got["float64_port_vs_jax"] < 1e-9, got
    assert got["float32_port_vs_jax"] < 4 * got["jax_float32_vs_float64"], \
        got
    assert torch.Tensor.float is not torch.Tensor.double
    assert not jax.config.jax_enable_x64


if __name__ == "__main__":
    # python tests/test_torch_lm_models.py ARCH LAYERS [D_MODEL]: the
    # float64 witness's readings at that size.
    print(float64_witness(sys.argv[1], int(sys.argv[2]),
                          int(sys.argv[3]) if len(sys.argv) > 3 else 0))
