"""repro_torch's serving path (prefill, KV-cached decode, the Engine, the
launcher) against the JAX package's, on the CPU, in float32.

Both packages get the same parameter tree (``convert.numpy_params``,
``jnp.asarray`` per leaf for JAX) and the same requests: every Engine
completion must be equal token for token and the logits within rtol/atol
1e-5. The committed ``src/repro_torch/reference_lm.json``, which
``chip_smoke.py`` holds the card to, is made here by the JAX package
(``chip_smoke.lm_record``: completions, each token's top-2 margin, the
top-8 logits of a prefill and three decode steps, and for MoE the least
router margin); its reduced entries are regenerated by a test and must
not have gone stale. To rewrite them after a deliberate change:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_lm_serve.py

and the full-width entries (each config at its published widths, its
depth cut to ``chip_smoke.LM_FULL_LAYERS``) with ``--full``, or ``--full
ARCH ...`` for some of them. The two MoE entries hold 17 and 15 GB of
float32 parameters: only the JAX package's copy is built, leaf by leaf
from the numpy draw, so the peak stays near one copy (~25 GB).
"""
import contextlib
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the LM record both sides share)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import serve_step as jserve_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import (Engine, Request, make_serve_fns,  # noqa: E402
                               prefill_input_structs)

REFERENCE = REPO / "src" / "repro_torch" / "reference_lm.json"
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (see test_torch_api.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair_models(arch: str, width: str, reference_params: bool = True):
    """The port's float32 model on the CPU and the JAX package's, with its
    params, both on ``chip_smoke.lm_reference_params`` (else on
    ``numpy_params(seed=LM_SEED)``, the reference init)."""
    cfg = chip_smoke.lm_config(get_config, arch, width)
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    tree = chip_smoke.lm_reference_params(convert, model) \
        if reference_params else convert.numpy_params(model,
                                                       chip_smoke.LM_SEED)
    convert.params_from_numpy(model, tree)
    jmodel = jbuild(chip_smoke.lm_config(jget_config, arch, width),
                    compute_dtype=jnp.float32)
    return model, jmodel, jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_model(arch: str, width: str):
    """The JAX package's float32 model and params alone, each leaf moved
    into JAX as it is drawn and the numpy copy dropped (the full-width MoE
    trees are 15-17 GB)."""
    cfg = chip_smoke.lm_config(get_config, arch, width)
    tree = chip_smoke.lm_reference_params(
        convert, build_model(cfg, compute_dtype=torch.float32, device="cpu"))

    def move(node):
        for key in (sorted(node) if isinstance(node, dict)
                    else range(len(node))):
            if isinstance(node[key], (dict, list)):
                move(node[key])
            else:
                node[key] = jnp.asarray(node[key])
        return node

    jmodel = jbuild(chip_smoke.lm_config(jget_config, arch, width),
                    compute_dtype=jnp.float32)
    return jmodel, move(tree)


@contextlib.contextmanager
def jax_router_margins():
    """``chip_smoke.lm_router_margin`` for the JAX package: each MoE
    call's least router margin, sent out of the traced code by a debug
    callback."""
    from repro.models import moe as jmoe
    seen, apply = [], jmoe.apply_moe

    def recorded(cfg, p, x):
        probs = jax.nn.softmax(x @ p["router"].astype(jnp.float32), axis=-1)
        top = jax.lax.top_k(probs, cfg.top_k + 1)[0]
        jax.debug.callback(lambda m: seen.append(float(m)),
                           (top[..., -2] - top[..., -1]).min())
        return apply(cfg, p, x)

    jmoe.apply_moe = recorded
    try:
        yield seen
    finally:
        jax.effects_barrier()
        jmoe.apply_moe = apply


def _jax_margins(logits) -> np.ndarray:
    top = -np.sort(-np.asarray(logits[:, -1], np.float32), axis=-1)[:, :2]
    return top[:, 0] - top[:, 1]


def jax_outputs(jmodel, jparams, workload: dict, seed: int):
    """The JAX package's side of a reference case: what
    ``chip_smoke.lm_port_outputs`` computes for the port."""
    cfg = jmodel.cfg
    completions, margins = [], {}
    with jax_router_margins() as routed:
        if chip_smoke.lm_serves_engine(cfg):
            reqs = chip_smoke.lm_requests(np, cfg.vocab_size, workload, seed)
            max_len = chip_smoke.lm_max_len(workload)
            engine = jengine.Engine(jmodel, jparams,
                                    batch_size=workload["slots"],
                                    max_len=max_len)
            calls = []
            prefill, decode = engine._prefill, engine._decode

            def recorded(out):
                calls.append(_jax_margins(out[0]))
                return out

            engine._prefill = lambda p, b: recorded(prefill(p, b))
            engine._decode = lambda p, t, c, pos: recorded(
                decode(p, t, c, pos))
            done = engine.run([jengine.Request(rid, p, n)
                               for rid, p, n in reqs])
            completions = [(c.rid, c.tokens) for c in done]
            margins = chip_smoke.lm_token_margins(
                np, reqs, workload["slots"], max_len, calls)
        tokens, extras = chip_smoke.lm_logit_inputs(np, cfg, seed)
        s = chip_smoke.LM_LOGIT_BATCH[1]
        batch = {"tokens": jnp.asarray(tokens[:, :s]),
                 **{k: jnp.asarray(v) for k, v in extras.items()}}
        logits, caches = jmodel.prefill(
            jparams, batch, max_len=s + chip_smoke.LM_DECODE_STEPS)
        steps = [logits[:, -1]]
        for i in range(chip_smoke.LM_DECODE_STEPS):
            logits, caches = jmodel.decode_step(
                jparams, jnp.asarray(tokens[:, s + i:s + i + 1]), caches,
                jnp.int32(s + i))
            steps.append(logits[:, -1])
        steps = [np.asarray(x, np.float32) for x in steps]
        jax.effects_barrier()
    return completions, margins, steps, min(routed) if routed else None


def reference_case(arch: str, width: str, outputs=None) -> dict:
    workload = chip_smoke.LM_REDUCED_WORKLOAD if width == "reduced" \
        else chip_smoke.LM_FULL_WORKLOAD
    if outputs is None:
        jmodel, jparams = _jax_model(arch, width)
        outputs = jax_outputs(jmodel, jparams, workload, chip_smoke.LM_SEED)
        del jparams
    return {"arch": arch, "width": width, "workload": workload,
            **chip_smoke.lm_record(np, *outputs)}


@pytest.fixture(scope="module")
def serving_runs():
    """arch -> (port outputs, JAX outputs) of each reduced reference case."""
    out = {}
    for arch in chip_smoke.LM_ARCHS:
        model, jmodel, jparams = _pair_models(arch, "reduced")
        args = (chip_smoke.LM_REDUCED_WORKLOAD, chip_smoke.LM_SEED)
        out[arch] = (chip_smoke.lm_port_outputs(torch, np, model, *args),
                     jax_outputs(jmodel, jparams, *args))
    return out


@pytest.mark.parametrize("arch", chip_smoke.LM_ARCHS)
def test_engine_and_logits_match_jax(arch, serving_runs):
    """The Engine's completions token for token (none for the encoder-
    decoder: its Engine, as the JAX package's, passes tokens only), every
    top-2 margin, the logit record and the MoE router margins."""
    (comps, margins, logits, routed), (jcomps, jmargins, jlogits,
                                       jrouted) = serving_runs[arch]
    cfg = get_config(arch)
    assert bool(comps) == chip_smoke.lm_serves_engine(cfg)
    assert (routed is None) == (jrouted is None) == (not cfg.moe)
    if cfg.moe:
        np.testing.assert_allclose(routed, jrouted, **F32)
    assert [(rid, t.tolist()) for rid, t in comps] == \
        [(rid, t.tolist()) for rid, t in jcomps]
    assert all(t.dtype == np.int32 for _, t in comps)
    for rid in margins:
        np.testing.assert_allclose(margins[rid], jmargins[rid], **F32)
    assert len(logits) == len(jlogits) == 1 + chip_smoke.LM_DECODE_STEPS
    for got, want in zip(logits, jlogits):
        np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("arch", chip_smoke.LM_ARCHS)
def test_reference_lm_is_current(arch, serving_runs):
    """The file's reduced entries, regenerated from the JAX package; and
    the port on the CPU passes chip_smoke's check of them at 1e-5."""
    want = json.loads(REFERENCE.read_text())["cases"][f"{arch} reduced"]
    fresh = reference_case(arch, "reduced", serving_runs[arch][1])
    assert fresh["completions"] == want["completions"]
    assert fresh["workload"] == want["workload"]
    assert ("least_router_margin" in want) == get_config(arch).moe
    if "least_router_margin" in want:
        np.testing.assert_allclose(fresh["least_router_margin"],
                                   want["least_router_margin"], **F32)
    for f, w in zip(fresh["logits"], want["logits"]):
        assert f["top_ids"] == w["top_ids"]
        np.testing.assert_allclose(f["top_values"], w["top_values"], **F32)
        np.testing.assert_allclose(f["sum"], w["sum"], **F32)
    comps, _, logits, _ = serving_runs[arch][0]
    assert chip_smoke.lm_mismatches(np, comps, logits, want, 1e-5,
                                    1e-5) == []


def test_reference_lm_covers_the_cases():
    ref = json.loads(REFERENCE.read_text())
    assert sorted(ref["cases"]) == sorted(
        [f"{a} reduced" for a in chip_smoke.LM_ARCHS] +
        [f"{a} full_width" for a in chip_smoke.LM_FULL_LAYERS])
    for arch in chip_smoke.LM_FULL_LAYERS:
        full = ref["cases"][f"{arch} full_width"]
        cfg = get_config(arch)
        assert full["workload"] == chip_smoke.LM_FULL_WORKLOAD
        assert len(full["logits"]) == 1 + chip_smoke.LM_DECODE_STEPS
        assert all(len(row) == chip_smoke.LM_TOP for step in full["logits"]
                   for row in step["top_ids"])
        assert ("least_router_margin" in full) == cfg.moe
        if chip_smoke.lm_serves_engine(cfg):
            assert len(full["completions"]) == 6 and all(
                len(t) == 16 for _, t in full["completions"])
        else:
            assert full["completions"] == []


def test_mismatches_catch_a_wrong_token_and_logit(serving_runs):
    want = json.loads(REFERENCE.read_text())["cases"]["qwen1.5-0.5b reduced"]
    comps, _, logits, _ = serving_runs["qwen1.5-0.5b"][0]
    assert chip_smoke.lm_mismatches(np, comps, logits, want, 1e-5,
                                    1e-5) == []
    # a token before the completion's first small margin is compared
    rid = next(int(r) for r, m in sorted(want["token_margins"].items())
               if chip_smoke.lm_compared_tokens(m) > 0)
    bad_tokens = [(r, t.copy()) for r, t in comps]
    next(t for r, t in bad_tokens if r == rid)[0] += 1
    assert chip_smoke.lm_mismatches(np, bad_tokens, logits, want, 1e-3,
                                    1e-3) == [f"completion {rid}"]
    shifted = [lg.copy() for lg in logits]
    shifted[2][0, want["logits"][2]["top_ids"][0][3]] += 0.01
    assert chip_smoke.lm_mismatches(np, comps, shifted, want, 1e-3,
                                    1e-3) == ["step 2 top values"]
    shifted[3] += 0.01
    assert "step 3 sum" in chip_smoke.lm_mismatches(np, comps, shifted,
                                                    want, 1e-3, 1e-3)


# ---------------------------------------------------------------- Engine

@pytest.fixture(scope="module")
def qwen_pair():
    return _pair_models("qwen1.5-0.5b", "reduced", reference_params=False)


def _engine_pair(model, jmodel, jparams, prompts, new_tokens, slots,
                 max_len, eos_id=None):
    reqs = [(i, np.asarray(p, np.int32), n)
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    got = Engine(model, batch_size=slots, max_len=max_len, eos_id=eos_id,
                 device="cpu").run([Request(*r) for r in reqs])
    want = jengine.Engine(jmodel, jparams, batch_size=slots, max_len=max_len,
                          eos_id=eos_id).run(
        [jengine.Request(*r) for r in reqs])
    return ([(c.rid, c.tokens.tolist()) for c in got],
            [(c.rid, c.tokens.tolist()) for c in want])


@pytest.mark.parametrize("case", ["left_pad_partial_wave", "mixed_new_tokens",
                                  "max_len_cap", "eos_trim", "one_slot"])
def test_engine_semantics_match_jax(case, qwen_pair):
    """Left-padded mixed prompts (the pad attended to), a partial last
    wave (idle slots replay slot 0, dropped by rid), per-request
    max_new_tokens, the max_len cap, EOS trimming, finish order."""
    model, jmodel, jparams = qwen_pair
    rng = np.random.default_rng(len(case))
    lens = [5, 9, 7, 12, 3]
    prompts = [rng.integers(1, 512, n) for n in lens]
    new = [6] * 5
    slots, max_len, eos = 2, 12 + 6, None
    if case == "mixed_new_tokens":
        new = [2, 7, 4, 1, 5]
    elif case == "max_len_cap":
        max_len = 12 + 3
    elif case == "one_slot":
        slots = 1
    elif case == "eos_trim":
        _, plain = _engine_pair(model, jmodel, jparams, prompts, new, slots,
                                max_len)
        eos = plain[0][1][2]            # a token the first completion emits
    got, want = _engine_pair(model, jmodel, jparams, prompts, new, slots,
                             max_len, eos)
    assert got == want
    assert sorted(rid for rid, _ in got) == list(range(5))
    if case == "max_len_cap":
        assert all(len(t) == 3 for _, t in got)
    if case == "eos_trim":
        assert len(got[0][1]) == 3 and got[0][1][-1] == eos
    if case == "mixed_new_tokens":
        # requests 0 and 1 share a wave: min(7, 18 - 12) steps
        assert [len(t) for _, t in sorted(got)] == [2, 6, 4, 1, 5]


def test_engine_serves_an_empty_workload(qwen_pair):
    assert Engine(qwen_pair[0], 2, 16, device="cpu").run([]) == []


@pytest.mark.parametrize("arch", chip_smoke.LM_ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """The port's decode, token by token, equals its prefill over the
    whole sequence (tests/test_serve.py's contract for the JAX package),
    and its teacher-forced forward at every decoded position."""
    model, _, _ = _pair_models(arch, "reduced")
    cfg = model.cfg
    rng = np.random.default_rng(3)
    b, s, extra = 2, 24, 6
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + extra)))
    batch = {"tokens": tokens[:, :s]}
    if cfg.num_patches:
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32))
    full_logits, _ = model.prefill(dict(batch, tokens=tokens),
                                   max_len=s + extra)
    forward = model(dict(batch, tokens=tokens))
    logits, caches = model.prefill(batch, max_len=s + extra)
    tol = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               forward[:, s - 1].numpy(), **tol)
    for i in range(extra):
        logits, caches = model.decode_step(tokens[:, s + i:s + i + 1],
                                           caches, s + i)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   forward[:, s + i].numpy(), **tol)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               full_logits[:, 0].numpy(), **tol)


def test_decode_updates_the_cache_in_place(qwen_pair):
    model = qwen_pair[0]
    tokens = torch.arange(1, 9).reshape(2, 4)
    _, caches = model.prefill({"tokens": tokens}, max_len=6)
    k = caches["groups"][0]["k"]
    ptr = k.data_ptr()
    before = k.clone()
    _, out = model.decode_step(tokens[:, :1], caches, 4)
    assert out["groups"][0]["k"] is k and k.data_ptr() == ptr
    assert torch.equal(k[:, :, :4], before[:, :, :4])
    assert not torch.equal(k[:, :, 4], before[:, :, 4])
    assert not k[:, :, 5].any()


def test_serve_fns_and_input_structs(qwen_pair):
    model, jmodel, jparams = qwen_pair
    prefill, decode = make_serve_fns(model, max_len=10)
    tokens = torch.arange(1, 13).reshape(2, 6)
    logits, caches = prefill({"tokens": tokens})
    assert caches["groups"][0]["k"].shape[2] == 10
    jprefill, jdecode = jserve_step.make_serve_fns(jmodel, max_len=10)
    jlogits, jcaches = jprefill(jparams, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **F32)
    logits, _ = decode(tokens[:, :1], caches, 6)
    jlogits, _ = jdecode(jparams, jnp.asarray(tokens[:, :1]), jcaches,
                         jnp.int32(6))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **F32)
    for arch in ("phi-3-vision-4.2b", "qwen1.5-0.5b", "whisper-medium"):
        got = prefill_input_structs(
            build_model(get_config(arch), device="cpu"), 4, 300)
        want = jserve_step.prefill_input_structs(
            jbuild(jget_config(arch)), 4, 300)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()} == \
            {k: (tuple(v.shape), jnp.dtype(v.dtype).name)
             for k, v in want.items()}


def test_launcher_serves_on_the_cpu(capsys):
    outs = tlaunch.main(["--device", "cpu", "--arch", "stablelm-1.6b",
                         "--requests", "3", "--new-tokens", "4"])
    assert sorted(c.rid for c in outs) == [0, 1, 2]
    assert all(len(c.tokens) == 4 for c in outs)
    printed = capsys.readouterr().out
    assert "params" in printed and "tok/s" in printed and "device=cpu" \
        in printed


def test_launcher_cannot_serve_the_encoder_decoder():
    """The Engine passes tokens only, in both packages: the JAX launcher's
    Engine fails on whisper for want of frames, and so does the port's,
    naming them."""
    with pytest.raises(ValueError, match="frames"):
        tlaunch.main(["--device", "cpu", "--arch", "whisper-medium",
                      "--requests", "1", "--new-tokens", "1"])
    jmodel, jparams = _jax_model("whisper-medium", "reduced")
    engine = jengine.Engine(jmodel, jparams, batch_size=1, max_len=8)
    with pytest.raises(KeyError, match="frames"):
        engine.run([jengine.Request(0, np.ones(4, np.int32), 1)])


def write_reference(full_archs) -> None:
    """Rewrite reference_lm.json's reduced entries and the full-width
    entries of ``full_archs`` (the others are kept as they are)."""
    old = json.loads(REFERENCE.read_text()) if REFERENCE.exists() else {}
    cases = {f"{a} reduced": reference_case(a, "reduced")
             for a in chip_smoke.LM_ARCHS}
    for arch in chip_smoke.LM_FULL_LAYERS:
        key = f"{arch} full_width"
        if arch in full_archs:
            cases[key] = reference_case(arch, "full_width")
            print(f"made {key}", flush=True)
        elif key in old.get("cases", {}):
            cases[key] = old["cases"][key]
    depths = ", ".join(f"{a} {n} layers" for a, n in
                       chip_smoke.LM_FULL_LAYERS.items())
    REFERENCE.write_text(json.dumps({
        "about": "Made by the JAX package on the CPU in float32 (tests/"
                 "test_torch_lm_serve.py; chip_smoke.lm_record): params "
                 "from chip_smoke.lm_reference_params (repro_torch."
                 "convert.numpy_params(model, seed=0), each stacked "
                 "matrix rescaled to one layer's fan-in); per case the Engine's completions (finish "
                 "order; none for whisper-medium, whose Engine passes "
                 "tokens only), each token's top-2 margin, the top-8 ids "
                 "and values, float64 sum and least top-2 margin of the "
                 "last-position logits of a prefill (whisper's with "
                 "frames from the seed) and three decode steps, and for "
                 "MoE the least router margin (k-th minus (k+1)-th "
                 "routing probability) over every routing of the case. "
                 "The reduced entries (each config's reduced()) are "
                 "regenerated by a test; the full-width ones (published "
                 f"widths, depth cut: {depths}; whisper's encoder to "
                 f"{chip_smoke.LM_FULL_ENCODER_LAYERS} layers, "
                 "encoder_len 1500 kept) only by `python tests/"
                 "test_torch_lm_serve.py --full [ARCH ...]` (the MoE "
                 "entries hold 17 and 15 GB of float32 parameters).",
        "cases": cases}, indent=1, sort_keys=True) + "\n")
    print(f"wrote {REFERENCE}")


if __name__ == "__main__":
    args = sys.argv[1:]
    full = []
    if "--full" in args:
        full = args[args.index("--full") + 1:] or list(
            chip_smoke.LM_FULL_LAYERS)
    write_reference(full)
