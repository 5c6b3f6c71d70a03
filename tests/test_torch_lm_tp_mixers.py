"""repro_torch's sharded serving of MLA, the Mamba-2 SSD, the RG-LRU and
the encoder-decoder against the JAX package, on the CPU.

The spawns, trees, inputs and assembly are ``tests/test_torch_lm_tp.py``'s
(imported): gloo spawns of 2 and 4 ranks serve minicpm3-4b, mamba2-130m,
recurrentgemma-2b and whisper-medium, reduced, in float32, on the meshes
(data, model) = (1, 2), (1, 4) and (2, 2): each rank loads its blocks of
one numpy tree, prefills its batch rows (whisper with their frames) and
runs 8 decode steps under the prefill and decode rules, and its rows and
block of the vocabulary of every step's logits are held, at rtol/atol
1e-5, to the JAX package's ``build_model(cfg, tp)`` run unsharded on the
same tree. Ranks that hold the same block must agree bit for bit.

The edge cases and the cache layouts they take: the SSD with a state
wider than its heads and head dimension (``h``, ``conv_b`` and ``conv_c``
split by the state N, as at mamba2-130m's full width), with a state
"model" does not divide (held whole), and with a head count it does not
divide (the inner dimension padded); MLA with a cache length "model"
does not divide (held whole); the encoder-decoder with KV heads that do
not divide "model" (the cross cache split by encoder position) and again
with an encoder length that does not divide (held whole); recurrentgemma
with a prompt "model" does not divide (the residual padded) and a local
ring shorter than the prompt (split by slots). Then the layouts the layer
code refuses.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import test_torch_lm_tp as base
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import tree_leaves, tree_paths
from repro_torch.sharding import rules as trules

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

MIXER_ARCHS = base.MIXER_ARCHS
_case = base._case

CASES = {f"{arch}-{m[0]}x{m[1]}": _case(arch, m)
         for m in ((1, 2), (1, 4), (2, 2)) for arch in MIXER_ARCHS}
CASES.update({
    # h (16 heads, 16, 32): the state N is the widest, as at full width
    # (24, 64, 128): h, conv_b and conv_c split by N
    "ssd_state_split": _case("mamba2-130m", (1, 4), dict(ssm_state=32)),
    # ... N = 18 is the widest and does not divide 4: held whole
    "ssd_state_whole": _case("mamba2-130m", (1, 4), dict(ssm_state=18)),
    # 18 heads pad to 20 (the inner dimension 288 -> 320), split by heads
    "ssd_heads_padded": _case("mamba2-130m", (1, 4), dict(
        ssm_d_inner=288)),
    # a cache of 21 positions does not split: held whole
    "mla_whole_cache": _case("minicpm3-4b", (1, 4), prompt=13),
    # KV heads 2 < tp 4: the cross cache splits by encoder position (64)
    # and the self cache by sequence (24)
    "cross_seq_split": _case("whisper-medium", (1, 4), dict(
        num_kv_heads=2)),
    # ... 62 frames do not split: the cross cache whole, the encoder's
    # residual padded to 64
    "cross_whole": _case("whisper-medium", (1, 4), dict(
        num_kv_heads=2, encoder_len=62)),
    # an 18-token prompt padded to 20 in the residual; the local layers'
    # ring of 8 slots split by slots, 2 a rank
    "rglru_odd_prompt_ring": _case("recurrentgemma-2b", (1, 4), dict(
        local_window=8), prompt=18),
})


def _world(rank, world, res):
    for name, case in CASES.items():
        if case["mesh"][0] * case["mesh"][1] == world:
            base._serve(name, case, res, CASES)
    return res


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return base.spawn(tmp_path_factory.mktemp("lm_tp_mixers"), 2, _world)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return base.spawn(tmp_path_factory.mktemp("lm_tp_mixers"), 4, _world)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_mixers_match_jax(name, world2, world4):
    case = CASES[name]
    ranks = world2 if case["mesh"] == (1, 2) else world4
    want = base.jax_steps(name, case, CASES)
    np.testing.assert_allclose(base.assemble(ranks, name, want.shape), want,
                               **base.F32)


def _shapes(ranks, name):
    return json.loads(str(ranks[0][f"{name}__cache_shapes"]))


# rank 0's cache leaves in the tree's order (stacked: layers, batch, ...)
LAYOUTS = {
    # h by heads (16 -> 4); conv_b / conv_c by N (16 -> 4); conv_x by width
    "mamba2-130m-1x4": [[2, 2, 3, 4], [2, 2, 3, 4], [2, 2, 3, 64],
                        [2, 2, 4, 16, 16]],
    # every SSD cache by the state N (32 -> 8)
    "ssd_state_split": [[2, 2, 3, 8], [2, 2, 3, 8], [2, 2, 3, 64],
                        [2, 2, 16, 16, 8]],
    "ssd_state_whole": [[2, 2, 3, 18], [2, 2, 3, 18], [2, 2, 3, 64],
                        [2, 2, 16, 16, 18]],
    "ssd_heads_padded": [[2, 2, 3, 4], [2, 2, 3, 4], [2, 2, 3, 80],
                         [2, 2, 5, 16, 16]],
    # the latent cache by sequence (24 -> 6), or whole (21)
    "minicpm3-4b-1x4": [[2, 2, 6, 32], [2, 2, 6, 16]],
    "mla_whole_cache": [[2, 2, 21, 32], [2, 2, 21, 16]],
    # cross (ck, cv), then self (k, v): by KV heads (4 -> 1)
    "whisper-medium-1x4": [[2, 2, 64, 1, 32]] * 2 + [[2, 2, 24, 1, 32]] * 2,
    "cross_seq_split": [[2, 2, 16, 2, 32]] * 2 + [[2, 2, 6, 2, 32]] * 2,
    "cross_whole": [[2, 2, 62, 2, 32]] * 2 + [[2, 2, 6, 2, 32]] * 2,
    # rec, rec (conv, h by width 128 -> 32), local (the 24-slot cache by
    # sequence)
    "recurrentgemma-2b-1x4": [[2, 2, 3, 32], [2, 2, 32]] * 2 +
                             [[2, 2, 6, 1, 32]] * 2,
    # ... the ring of 8 slots by slots
    "rglru_odd_prompt_ring": [[2, 2, 3, 32], [2, 2, 32]] * 2 +
                             [[2, 2, 2, 1, 32]] * 2,
}


def test_caches_take_their_layouts(world4):
    """The cases lay their caches out as serve_step.cache_shardings says:
    by heads, by the state N, by sequence, by encoder position, by ring
    slots, or whole."""
    for name, want in LAYOUTS.items():
        assert _shapes(world4, name) == want, name


def _fake_rules(tp: int, data: int = 1, coords=(0, 0), kv_sharded=True):
    """Rules over a stand-in (data, model) mesh seen from ``coords``."""
    shape = {"data": data, "model": tp}

    def names(a):
        return (a,) if isinstance(a, str) else tuple(a)

    def index(a):
        out = 0
        for n in names(a):
            out = out * shape[n] + dict(zip(shape, coords))[n]
        return out

    mesh = types.SimpleNamespace(
        shape=shape, axis_names=("data", "model"), size=data * tp,
        axis_size=lambda a: int(np.prod([shape[n] for n in names(a)])),
        axis_index=index)
    return trules.make_rules(mesh, "prefill", 2, kv_sharded=kv_sharded)


@pytest.mark.parametrize("arch,over", [(a, {}) for a in MIXER_ARCHS] + [
    ("mamba2-130m", dict(ssm_d_inner=288))])
@pytest.mark.parametrize("mesh,coords", [((1, 4), (0, 2)), ((2, 2), (1, 1))])
def test_init_under_rules_keeps_blocks_of_the_whole_tree(arch, over, mesh,
                                                         coords):
    """Model.init(gen, rules) holds, leaf for leaf, this rank's block of
    what Model.init(gen) draws whole: the SSD's padded inner dimension,
    the encoder stack and every other leaf of the four mixers."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    whole = build_model(cfg, tp=mesh[1], compute_dtype=torch.float32,
                        device="cpu").init(torch.Generator().manual_seed(3))
    model = build_model(cfg, tp=mesh[1], compute_dtype=torch.float32,
                        device="cpu")
    rules = _fake_rules(mesh[1], mesh[0], coords, model.kv_sharded)
    model.init(torch.Generator().manual_seed(3), rules)
    slices_of = model._slices_of(rules)
    specs = dict(zip(tree_paths(model.param_specs()),
                     tree_leaves(model.param_specs())))
    got = dict(zip(tree_paths(model.tree), tree_leaves(model.tree)))
    sliced = 0
    for path, w in zip(tree_paths(whole.tree), tree_leaves(whole.tree)):
        block = w[slices_of(path, specs[path])]
        sliced += block.shape != w.shape
        assert torch.equal(got[path], block), path
    assert sliced


@pytest.mark.parametrize("over,tp,error,match", [
    # h (4 heads, 32, 16): its head dimension is the widest
    (dict(ssm_d_inner=128, ssm_headdim=32), 4, NotImplementedError,
     "head dimension"),
    (dict(rglru_width=130), 4, ValueError, "RG-LRU width 130"),
])
def test_layouts_the_layers_do_not_read_refuse(over, tp, error, match):
    """Before any work: an SSD state split by its head dimension P, and an
    RG-LRU width "model" does not divide (the reference does not pad it)."""
    arch = "mamba2-130m" if "ssm_d_inner" in over else "recurrentgemma-2b"
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = build_model(cfg, tp=tp, device="cpu")
    with pytest.raises(error, match=match):
        model.check_rules(_fake_rules(tp))


def test_ssd_cache_layout_follows_cache_shardings():
    """ssm.cache_layout names the dimension cache_shardings splits, for
    the reduced and the full-width mamba2 and the edge cases."""
    from repro_torch.serve.serve_step import cache_shardings
    for over, tp, want in ((dict(), 4, ("heads", "state")),
                           (dict(ssm_state=32), 4, ("state", "state")),
                           (dict(ssm_state=18), 4, ("whole", "whole")),
                           (None, 4, ("state", "state")),
                           (None, 2, ("state", "state"))):
        cfg = get_config("mamba2-130m")
        cfg = cfg if over is None else dataclasses.replace(cfg.reduced(),
                                                           **over)
        model = build_model(cfg, tp=tp, device="cpu")
        got = tssm.cache_layout(model.cfg, tp)
        assert (got["h"], got["bc"]) == want, (over, tp)
        rules = _fake_rules(tp)
        specs = cache_shardings(rules, model.cache_structs(2, 8))
        h, bc = specs["groups"][0]["h"], specs["groups"][0]["conv_b"]
        dim = {"heads": 2, "state": 4, "whole": None}
        assert [i for i, a in enumerate(h) if a == "model"] == \
            ([dim[want[0]]] if dim[want[0]] else [])
        assert ("model" in bc) == (want[1] == "state")
