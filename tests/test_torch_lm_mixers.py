"""repro_torch's MoE, MLA, Mamba-2 SSD, RG-LRU and encoder-decoder modules
against the JAX package's, on the CPU.

The same numpy inputs and parameters go through both packages. Matrices
are drawn at 1/sqrt(fan_in) (a stacked leaf at one layer's fan-in),
vectors that init to zeros or ones get 0.1 N(0, 1) around it, so outputs
are O(1). float32 outputs agree within rtol = atol = 1e-5; bf16 within
2^-6 (4 bf16 ulps) of the output's largest magnitude plus rtol 2^-6 (see
test_torch_lm_models.py). Caches are compared after every call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -6, atol=2.0 ** -6, scaled=True)
DTYPES = ["float32", "bfloat16"]


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


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


def _cast(dtype, t, j):
    return t.to(getattr(torch, dtype)), j.astype(getattr(jnp, dtype))


def _pair(rng, shape, scale=1.0):
    """The same float32 draw for both packages (JAX gets its own copy: the
    port writes caches in place)."""
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a.copy())


def _fan_in(spec) -> int:
    """One matrix's fan-in: its input dimensions, past a leading layers or
    experts axis (all but the last for an output projection to "embed")."""
    shape, axes = spec.shape, spec.axes
    while axes[0] in ("layers", "experts"):
        shape, axes = shape[1:], axes[1:]
    return int(np.prod(shape[:-1])) if axes[-1] == "embed" else shape[0]


def _draw(rng, specs):
    """(port tree, JAX tree) of ``specs``: matrices at 1/sqrt(fan_in),
    constant vectors perturbed by 0.1 N(0, 1), "normal" leaves N(0, 1)."""
    def leaf(spec):
        shape = spec.shape
        stacked = spec.axes[:1] == ("layers",)
        if spec.init in ("zeros", "ones"):
            base = 1.0 if spec.init == "ones" else 0.0
            a = base + 0.1 * rng.standard_normal(shape)
        elif spec.init == "normal" or len(shape) - stacked < 2:
            a = rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * _fan_in(spec) ** -0.5
        return a.astype(np.float32)

    tree = tlayers.tree_map(lambda _, s: leaf(s), specs)
    return (tlayers.tree_map(lambda _, a: torch.from_numpy(a), tree),
            tlayers.tree_map(lambda _, a: jnp.asarray(a.copy()), tree))


def _configs(arch, **changes):
    return (dataclasses.replace(get_config(arch).reduced(), **changes),
            dataclasses.replace(jget_config(arch).reduced(), **changes))


def _jcache(tc):
    """A JAX copy of a port cache tree, in its dtype."""
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(_np(t).copy()).astype(
            getattr(jnp, str(t.dtype).removeprefix("torch."))),
        tlayers.tree_map(lambda _, t: t, tc))


def _caches_close(tc, jc, tol):
    got, want = tlayers.tree_leaves(tc), jax.tree_util.tree_leaves(jc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches(with_state, dtype):
    rng = np.random.default_rng(11)
    tx, jx = _cast(dtype, *_pair(rng, (2, 9, 24)))
    tw, jw = _pair(rng, (4, 24), 0.5)
    ts = js = None
    if with_state:
        ts, js = _cast(dtype, *_pair(rng, (2, 3, 24)))
    ty, tst = tlayers.causal_conv1d(tx, tw, ts)
    jy, jst = jlayers.causal_conv1d(jx, jw, js)
    assert ty.dtype == tx.dtype and tuple(tst.shape) == jst.shape
    _close(ty, jy, _tol(dtype))
    _close(tst, jst, F32)           # the tail is copied, not computed
    # a one-row step from the tail continues the sequence
    ty1, _ = tlayers.causal_conv1d(tx[:, -1:], tw, tlayers.causal_conv1d(
        tx[:, :-1], tw, ts)[1])
    _close(ty1, ty[:, -1:], F32)


# ---------------------------------------------------------------- MoE

@pytest.mark.parametrize("shape", [(1, 40), (3, 17), (96,)])
def test_position_in_expert_matches(shape):
    """Occurrence ranks in flat order (per row, as the reference vmaps
    it), ties broken by position: a stable sort."""
    rng = np.random.default_rng(len(shape))
    ids = rng.integers(0, 5, shape)
    got = tmoe._position_in_expert(torch.from_numpy(ids))
    fn = jmoe._position_in_expert
    if len(shape) == 2:
        want = jax.vmap(lambda r: fn(r, 5))(jnp.asarray(ids))
    else:
        want = fn(jnp.asarray(ids), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = ids.reshape(-1, shape[-1])
    for row, ranks in zip(flat, got.numpy().reshape(flat.shape)):
        for e in range(5):
            np.testing.assert_array_equal(ranks[row == e],
                                          np.arange((row == e).sum()))


def test_routing_breaks_ties_to_the_lower_expert():
    """jax.lax.top_k takes the lower index first among equal values;
    torch.topk does not promise it, so the port sorts stably."""
    cfg, _ = _configs("qwen3-moe-235b-a22b", num_experts=6, top_k=3)
    x = torch.ones((1, 1, 2))
    router = torch.tensor([[0.0, 1.0, 1.0, 1.0, -1.0, 1.0]] * 2)
    _, gates, ids = tmoe.route(cfg, {"router": router}, x)
    jprobs = jax.nn.softmax(jnp.asarray(x.numpy() @ router.numpy()), -1)
    _, jids = jax.lax.top_k(jprobs, 3)
    assert ids.tolist() == np.asarray(jids).tolist() == [[[1, 2, 3]]]
    np.testing.assert_allclose(gates.numpy(), 1 / 3, rtol=1e-6)


MOE_ARCHS = ["llama4-scout-17b-a16e", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("branch", ["prefill", "decode"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_with_drops(arch, branch, dtype):
    """Both dispatch branches, capacity cut (cf 0.25) until assignments
    drop: llama4 with its shared expert (top 1), qwen3 without (top 2,
    here); the aux loss too. A prefill of 48 tokens dispatches per row; a
    decode step of 48 rows flat."""
    cfg, jcfg = _configs(arch, capacity_factor=0.25)
    assert bool(cfg.shared_expert_d_ff) == (arch == MOE_ARCHS[0])
    rng = np.random.default_rng(len(arch) + len(branch))
    tp, jp = _draw(rng, tmoe.moe_specs(cfg))
    shape = (2, 48, cfg.d_model) if branch == "prefill" \
        else (48, 1, cfg.d_model)
    tx, jx = _cast(dtype, *_pair(rng, shape))
    ty, taux = tmoe.apply_moe(cfg, tp, tx)
    jy, jaux = jmoe.apply_moe(jcfg, jp, jx)
    assert ty.dtype == tx.dtype
    _close(ty, jy, _tol(dtype))
    _close(taux, jaux, F32)
    assert tmoe.dropped_assignments(cfg, tp, tx) > 0
    # with room for every assignment nothing drops, and the output differs
    roomy = dataclasses.replace(cfg, capacity_factor=64.0)
    assert tmoe.dropped_assignments(roomy, tp, tx) == 0
    assert not torch.allclose(tmoe.apply_moe(roomy, tp, tx)[0], ty)


# ---------------------------------------------------------------- MLA

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("branch", ["train", "prefill_decode"])
def test_mla_attention_matches(branch, dtype):
    """No cache; a prefill (the compressed cache written from slot 0) then
    absorbed decode steps (written at pos, scored in the latent space)."""
    tol = _tol(dtype)
    cfg, jcfg = _configs("minicpm3-4b")
    heads = cfg.num_heads
    rng = np.random.default_rng(5 + len(branch))
    tp, jp = _draw(rng, tattn.mla_specs(cfg, heads))
    prompt, steps = 14, 5 if branch != "train" else 0
    tx, jx = _cast(dtype, *_pair(rng, (2, prompt + steps, cfg.d_model)))

    def both(s0, s1, tc, jc):
        pos = np.arange(s0, s1, dtype=np.int32)
        ty, tc = tattn.mla_attention(cfg, tp, tx[:, s0:s1], "global",
                                     torch.from_numpy(pos), tc, heads)
        jy, jc = jattn.mla_attention(jcfg, jp, jx[:, s0:s1], "global",
                                     jnp.asarray(pos), jc, heads)
        _close(ty, jy, tol)
        if jc is not None:
            _caches_close(tc, jc, tol)
        return tc, jc

    if branch == "train":
        both(0, prompt, None, None)
        return
    structs = tattn.mla_cache_struct(cfg, 2, prompt + steps,
                                     getattr(torch, dtype))
    tc = tlayers.tree_map(lambda _, s: torch.zeros(s.shape, dtype=s.dtype),
                          structs)
    jc = _jcache(tc)
    tc, jc = both(0, prompt, tc, jc)
    for i in range(steps):
        tc, jc = both(prompt + i, prompt + i + 1, tc, jc)


# ---------------------------------------------------------------- SSD

class _Float32Cumsum:
    """``jax.numpy`` with ``cumsum`` accumulating in float32 and rounding
    once to its input's dtype, as ``torch.cumsum`` does. On the CPU, JAX
    lowers a bf16 cumsum to a reduce_window that adds in bf16: against the
    exact sum it is off by 0.25 at 64 terms and by 8 at 256 (a chunk), so
    the bf16 SSD's decays there are rounding noise of the lowering. The
    bf16 SSD tests hold the port to the JAX package with this one
    accumulation in float32; the float32 tests use it unchanged."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def cumsum(x, axis=None):
        return jnp.cumsum(x.astype(jnp.float32), axis=axis).astype(x.dtype)


@pytest.fixture
def jssm_cumsum_f32(monkeypatch):
    monkeypatch.setattr(jssm, "jnp", _Float32Cumsum())


def test_jax_bf16_cumsum_rounds_in_bf16():
    """The condition the fixture above works around, kept visible."""
    x = jnp.full((256,), -0.7, jnp.bfloat16)
    exact = float(jnp.sum(x.astype(jnp.float32)))
    assert abs(float(jnp.cumsum(x)[-1]) - exact) > 1.0
    assert abs(float(_Float32Cumsum.cumsum(x)[-1]) - exact) <= 1.0
    got = torch.cumsum(torch.full((256,), -0.7, dtype=torch.bfloat16), 0)
    assert abs(float(got[-1]) - exact) <= 1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches(with_h0, dtype, request):
    """40 tokens in chunks of 16 (a zero-padded tail), from h0 or zeros."""
    if dtype == "bfloat16":
        request.getfixturevalue("jssm_cumsum_f32")
    tol = _tol(dtype)
    rng = np.random.default_rng(21 + with_h0)
    b, s, h, p, n = 2, 40, 3, 8, 6
    tx, jx = _cast(dtype, *_pair(rng, (b, s, h, p)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    tdt, jdt = _cast(dtype, torch.from_numpy(dt), jnp.asarray(dt))
    ta, ja = _cast(dtype, torch.from_numpy(a), jnp.asarray(a))
    tb, jb = _cast(dtype, *_pair(rng, (b, s, n)))
    tcc, jcc = _cast(dtype, *_pair(rng, (b, s, n)))
    th0 = jh0 = None
    if with_h0:
        th0, jh0 = _cast(dtype, *_pair(rng, (b, h, p, n)))
    ty, th = tssm._ssd_chunked(tx, tdt, ta, tb, tcc, 16, th0)
    jy, jh = jssm._ssd_chunked(jx, jdt, ja, jb, jcc, 16, jh0)
    _close(ty, jy, tol)
    _close(th, jh, tol)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_the_unpatched_reference_in_bf16(with_h0):
    """bf16 against the JAX package as it is (its cumsum adding in bf16):
    36 tokens in chunks of 8 (a zero-padded tail), short enough that the
    reference's bf16 chunk sums stay within the bf16 tolerance."""
    tol = _tol("bfloat16")
    rng = np.random.default_rng(23 + with_h0)
    b, s, h, p, n = 2, 36, 3, 8, 6
    tx, jx = _cast("bfloat16", *_pair(rng, (b, s, h, p)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    tdt, jdt = _cast("bfloat16", torch.from_numpy(dt), jnp.asarray(dt))
    ta, ja = _cast("bfloat16", torch.from_numpy(a), jnp.asarray(a))
    tb, jb = _cast("bfloat16", *_pair(rng, (b, s, n)))
    tcc, jcc = _cast("bfloat16", *_pair(rng, (b, s, n)))
    th0 = jh0 = None
    if with_h0:
        th0, jh0 = _cast("bfloat16", *_pair(rng, (b, h, p, n)))
    assert jssm.jnp is jnp
    ty, th = tssm._ssd_chunked(tx, tdt, ta, tb, tcc, 8, th0)
    jy, jh = jssm._ssd_chunked(jx, jdt, ja, jb, jcc, 8, jh0)
    _close(ty, jy, tol)
    _close(th, jh, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_ssm_prefill_and_decode_match(dtype, request):
    """A 40-token prefill (chunks of 32, a padded tail) into the cache,
    then five O(1) decode steps; the conv tails and the state after each."""
    if dtype == "bfloat16":
        request.getfixturevalue("jssm_cumsum_f32")
    tol = _tol(dtype)
    cfg, jcfg = _configs("mamba2-130m")
    rng = np.random.default_rng(31)
    tp, jp = _draw(rng, tssm.ssm_specs(cfg))
    prompt, steps = 40, 5
    tx, jx = _cast(dtype, *_pair(rng, (2, prompt + steps, cfg.d_model)))
    structs = tssm.ssm_cache_struct(cfg, 2, getattr(torch, dtype))
    tc = tlayers.tree_map(lambda _, s: torch.zeros(s.shape, dtype=s.dtype),
                          structs)
    jc = _jcache(tc)
    ty, tc = tssm.apply_ssm(cfg, tp, tx[:, :prompt], tc)
    jy, jc = jssm.apply_ssm(jcfg, jp, jx[:, :prompt], jc)
    _close(ty, jy, tol)
    _caches_close(tc, jc, tol)
    for i in range(prompt, prompt + steps):
        ty, tc = tssm.apply_ssm(cfg, tp, tx[:, i:i + 1], tc)
        jy, jc = jssm.apply_ssm(jcfg, jp, jx[:, i:i + 1], jc)
        _close(ty, jy, tol)
        _caches_close(tc, jc, tol)
    full, _ = tssm.apply_ssm(cfg, tp, tx.float())
    if dtype == "float32":
        _close(ty, full[:, -1:], dict(rtol=1e-4, atol=1e-4))


# ---------------------------------------------------------------- RG-LRU

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("branch", ["train", "h0_then_decode"])
def test_apply_rglru_matches(branch, dtype):
    """No cache (the scan from zeros); a prefill from a cache holding a
    state h0 and a conv tail (h0 folded into b_0), then decode steps."""
    tol = _tol(dtype)
    cfg, jcfg = _configs("recurrentgemma-2b")
    rng = np.random.default_rng(41 + len(branch))
    tp, jp = _draw(rng, trglru.rglru_specs(cfg))
    prompt, steps = 33, 4
    tx, jx = _cast(dtype, *_pair(rng, (2, prompt + steps, cfg.d_model)))
    if branch == "train":
        ty, _ = trglru.apply_rglru(cfg, tp, tx)
        jy, _ = jrglru.apply_rglru(jcfg, jp, jx)
        _close(ty, jy, tol)
        return
    tc = {"conv": _pair(rng, (2, cfg.rglru_conv - 1, cfg.rglru_width))[0],
          "h": _pair(rng, (2, cfg.rglru_width))[0]}
    tc = {k: v.to(getattr(torch, dtype)) for k, v in tc.items()}
    jc = _jcache(tc)
    ty, tc = trglru.apply_rglru(cfg, tp, tx[:, :prompt], tc)
    jy, jc = jrglru.apply_rglru(jcfg, jp, jx[:, :prompt], jc)
    _close(ty, jy, tol)
    _caches_close(tc, jc, tol)
    for i in range(prompt, prompt + steps):
        ty, tc = trglru.apply_rglru(cfg, tp, tx[:, i:i + 1], tc)
        jy, jc = jrglru.apply_rglru(jcfg, jp, jx[:, i:i + 1], jc)
        _close(ty, jy, tol)
        _caches_close(tc, jc, tol)


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(3)
    for s in (1, 2, 7, 64, 100):
        a = torch.from_numpy(rng.uniform(0, 1, (2, s, 5)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((2, s, 5)).astype(
            np.float32))
        h, want = torch.zeros(2, 5), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        _close(trglru.linear_scan(a, b), torch.stack(want, 1), F32)


# ---------------------------------------------------------------- encdec

@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_decoder_match(dtype):
    """run_encoder over 64 frames, project_cross_kv, then run_decoder: a
    prefill into the self-attention caches and three decode steps with the
    cross K/V carried."""
    tol = _tol(dtype)
    cfg, jcfg = _configs("whisper-medium")
    h, kv = cfg.num_heads, cfg.num_kv_heads
    rng = np.random.default_rng(51)
    tp, jp = _draw(rng, tencdec.encdec_specs(cfg, h, kv))
    tf_, jf = _cast(dtype, *_pair(rng, (2, cfg.encoder_len, cfg.d_model)))
    tenc = tencdec.run_encoder(cfg, tp, tf_, h, kv)
    jenc = jencdec.run_encoder(jcfg, jp, jf, h, kv)
    _close(tenc, jenc, tol)
    tkv = tencdec.project_cross_kv(cfg, tp, tenc, h, kv)
    jkv = jencdec.project_cross_kv(jcfg, jp, jenc, h, kv)
    for g, w in zip(tkv, jkv):
        _close(g, w, tol)
    prompt, steps = 11, 3
    tx, jx = _cast(dtype, *_pair(rng, (2, prompt + steps, cfg.d_model)))
    structs = tencdec.encdec_cache_structs(cfg, 2, prompt + steps,
                                           getattr(torch, dtype), kv)
    want = jencdec.encdec_cache_structs(jcfg, 2, prompt + steps,
                                        getattr(jnp, dtype), kv)
    assert [tuple(s.shape) for s in tlayers.tree_leaves(structs)] == \
        [s.shape for s in jax.tree_util.tree_leaves(want)]
    tc = tlayers.tree_map(lambda _, s: torch.zeros(s.shape, dtype=s.dtype),
                          structs["self"])
    jc = _jcache(tc)
    pos = np.arange(prompt, dtype=np.int32)
    ty, tc = tencdec.run_decoder(cfg, tp, tx[:, :prompt],
                                 torch.from_numpy(pos), tc, tkv, h, kv)
    jy, jc = jencdec.run_decoder(jcfg, jp, jx[:, :prompt], jnp.asarray(pos),
                                 jc, jkv, h, kv, train=False)
    _close(ty, jy, tol)
    _caches_close(tc, jc, tol)
    for i in range(prompt, prompt + steps):
        pos = np.array([i], np.int32)
        ty, tc = tencdec.run_decoder(cfg, tp, tx[:, i:i + 1],
                                     torch.from_numpy(pos), tc, tkv, h, kv)
        jy, jc = jencdec.run_decoder(jcfg, jp, jx[:, i:i + 1],
                                     jnp.asarray(pos), jc, jkv, h, kv,
                                     train=False)
        _close(ty, jy, tol)
        _caches_close(tc, jc, tol)


# ---------------------------------------------------------------- dtypes

# The leaves each family's reference reads uncast in float32, by the path
# of the leaf within a layer's (or the model's top-level) dict.
_NORMS = {"norm1/scale", "norm2/scale", "final_norm/scale"}
FLOAT32_LEAVES = {
    "qwen1.5-0.5b": _NORMS,
    "llama4-scout-17b-a16e": _NORMS | {"mlp/router"},
    "qwen3-moe-235b-a22b": _NORMS | {"mlp/router"},
    "minicpm3-4b": _NORMS | {"mixer/q_norm", "mixer/kv_norm"},
    "mamba2-130m": {"norm1/scale", "final_norm/scale", "mixer/a_log",
                    "mixer/dt_bias", "mixer/norm"},
    "recurrentgemma-2b": _NORMS | {"mixer/lam"},
    "whisper-medium": {f"{n}/{k}" for n in ("norm1", "norm2", "norm_x",
                                            "enc_norm", "final_norm")
                       for k in ("scale", "bias")},
}


@pytest.mark.parametrize("arch", sorted(FLOAT32_LEAVES))
def test_leaves_the_reference_reads_in_float32_stay_float32(arch):
    """A bf16 model stores these leaves in float32 (stored in bf16 the
    router would round and routing pick other experts) and every other
    leaf in bf16."""
    model = build_model(get_config(arch), device="cpu")
    named = {}
    for path in tlayers.tree_paths(model.param_specs()):
        keys = [k for k in path if isinstance(k, str)]
        named.setdefault("/".join(keys[-2:]), set()).add(
            model.param_dtype(path))
    f32 = {k for k, d in named.items() if torch.float32 in d}
    assert f32 == FLOAT32_LEAVES[arch]
    assert all(d == {torch.float32} or d == {torch.bfloat16}
               for d in named.values())

