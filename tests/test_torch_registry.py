"""The port's kernel registry and kernel checker against the JAX package's.

``repro_torch.kernels.registry()`` keeps the reference's five entries,
their sizes and their numpy seeds, so each reference case's inputs are
the port's own (held here array by array), and every plain version of
the port (``kernels/ref.py``) is bit-equal to the reference's
``repro.kernels.ref`` oracle on the registry's inputs, the port's own
path cases included. The launch geometry (``kernels/geometry.py``, what
the wrappers launch with) passes KC004 at an H100's limits, and a corpus
of broken cases gives exactly its expected findings (by identity:
kind, kernel, case, operand). The structural view of the CPU inventory
equals the committed ``results/torch_kernel_audit_baseline.json``.
"""
import dataclasses
import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import registry as jregistry
from repro_torch.analysis import cli, kernelcheck
from repro_torch.kernels import KernelCase, KernelEntry, geometry, registry
from repro_torch.kernels.edge_resolve import CHUNKED_MIN_ENTRIES

REPO = pathlib.Path(__file__).resolve().parents[1]
BASELINE = REPO / "results" / "torch_kernel_audit_baseline.json"
PORT_KEYS = ("op", "masked", "regime", "ops_noise")   # the port's cases


def _reference_sizes(entry):
    from repro.kernels.edge_resolve import MAX_VMEM_ENTRIES
    sizes = []
    for size in entry.sizes():
        size = dict(size)
        # the reference's resident bound -> the port's own (registry doc)
        if entry.name == "edge_resolve" and \
                size["m"] in (MAX_VMEM_ENTRIES, MAX_VMEM_ENTRIES + 1):
            size["m"] += CHUNKED_MIN_ENTRIES - 1 - MAX_VMEM_ENTRIES
        sizes.append(size)
    return sizes


def _port_cases():
    return [(e.name, size, e.build(**size)) for e in registry()
            for size in e.sizes()]


def test_entries_and_sizes_are_the_references():
    mine = {e.name: e for e in registry()}
    theirs = {e.name: e for e in jregistry()}
    assert list(mine) == list(theirs)
    for name, entry in theirs.items():
        port = [s for s in mine[name].sizes()
                if not any(k in s for k in PORT_KEYS)]
        assert port == _reference_sizes(entry), name


def test_the_port_adds_its_path_kernels():
    labels = {name: [c.label for _, s, c in _port_cases() if _ == name
                     and any(k in s for k in PORT_KEYS)]
              for name in ("edge_resolve", "histogram", "pk_expand")}
    assert labels["edge_resolve"] == [
        "resolve_roots_m4097", "resolve_roots_r4_m5000",
        "gather_m70001_n4099", "gather_r3_m5003_n2049",
        f"gather_chunked_m{CHUNKED_MIN_ENTRIES}_n4096"]
    assert labels["histogram"] == [
        "m65536_b1537_masked", "m70001_b54016_block",
        "m70001_b54017_cluster", "m70001_b432128_cluster",
        "m70001_b432129_global"]
    assert labels["pk_expand"] == ["m3001_n5_L4_ops_noise"]
    launches = {c.launches for _, _, c in _port_cases()}
    assert launches == {"resolve_roots", "resolve_step", "gather",
                        "gather_chunked", "histogram", "band_compact",
                        "pk_expand", "cfree_expand"}


def test_meta_states_the_static_facts():
    meta = {e.name: e.meta() for e in registry()}
    assert meta["edge_resolve"]["chunked_min_entries"] == CHUNKED_MIN_ENTRIES
    assert meta["edge_resolve"]["fallback_events"] == {}
    from repro.core.cfree import CHAIN_BOUND
    assert meta["cfree_expand"]["chain_bound"] == CHAIN_BOUND == 64
    assert meta["histogram"]["regime_boundaries_h100"] == {
        "block_last": 54016, "cluster_first": 54017,
        "cluster_last": 432128, "global_first": 432129}


def _reference_args():
    """The reference registry's cases by (entry, label)."""
    out = {}
    for e in jregistry():
        for size in e.sizes():
            c = e.build(**size)
            out[(e.name, c.label)] = c
    return out


@pytest.mark.parametrize("name,size", [(n, s) for n, s, _ in _port_cases()],
                         ids=lambda x: x if isinstance(x, str) else
                         "-".join(f"{k}{v}" for k, v in x.items()))
def test_plain_version_equals_the_reference_oracle(name, size):
    """Port plain version == repro.kernels.ref on the registry's inputs,
    bit for bit; where the reference has the same case, its inputs are
    the port's."""
    case = next(e for e in registry() if e.name == name).build(**size)
    theirs = _reference_args().get((name, case.label))
    if theirs is not None:
        flat = [a for a in case.args if not isinstance(a, tuple)]
        ref_flat = [np.asarray(a) for a in theirs.args]
        if name == "cfree_expand":
            assert tuple(int(w) for w in ref_flat[1]) == case.args[1]
            flat, ref_flat = flat[:1], ref_flat[:1]
        elif name == "pk_expand":
            assert tuple(int(d) for d in ref_flat[1]) == case.args[1]
            ref_flat = ref_flat[:1] + ref_flat[2:]
        for a, b in zip(flat, ref_flat):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    args = case.tensors("cpu")
    got = case.ref(*(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args))
    want = case.oracle(jref, jnp.asarray, *case.args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype or name == "cfree_expand"
        assert np.array_equal(g.numpy().astype(np.int64),
                              w.astype(np.int64)), case.label


def test_geometry_passes_kc004_at_h100_limits():
    findings, inv = kernelcheck.run_registry(device="cpu")
    assert findings == [] and inv["ok"]
    assert inv["limits"] == dataclasses.asdict(geometry.H100)
    assert inv["fallback_events"] == {}


def test_wrappers_run_their_plain_versions_on_the_cpu():
    findings, inv = kernelcheck.run_registry(device="cpu", execute=True)
    assert findings == []
    ran = [label for k in inv["kernels"].values()
           for label, c in k["cases"].items() if c["differential"]]
    assert len(ran) >= 25


def test_geometry_constants_are_the_sources():
    csrc = REPO / "src" / "repro_torch" / "kernels" / "csrc"
    names = {"resolve": "resolve", "gather": "gather",
             "histogram": "histogram", "band_compact": "band_compact",
             "pk_expand": "pk_expand", "cfree_expand": "cfree_expand"}
    for key, src in names.items():
        text = (csrc / f"{src}.cu").read_text()
        got = int(re.search(r"constexpr int kThreads = (\d+);", text)[1])
        assert geometry.THREADS[key] == got, key
    pk = (csrc / "pk_expand.cu").read_text()
    assert int(re.search(r"kSharedTab = (\d+);", pk)[1]) == \
        geometry.PK_SHARED_TAB
    cf = (csrc / "cfree_expand.cu").read_text()
    assert 32 * int(re.search(r"kPerLane = (\d+);", cf)[1]) == \
        geometry.CFREE_WARP_TILE


# --- the broken-case corpus --------------------------------------------------

def _entry(name, **case):
    base = dict(fn=lambda v: v + 1, args=(np.arange(8, dtype=np.int32),),
                ref=lambda v: v + 1, label="c", launches="gather",
                geometry=lambda lim: (geometry.Launch(
                    "gather_rows_kernel", (1, 1, 1), (256, 1, 1)),))
    base.update(case)
    return KernelEntry(name, lambda: KernelCase(**base), lambda: ({},))


BROKEN = {
    "threads": (_entry("threads", geometry=lambda lim: (geometry.Launch(
        "gather_rows_kernel", (1, 1, 1), (2048, 1, 1)),)),
        {("KC004", "threads", "c", "launch[0]")}),
    "grid_y": (_entry("grid_y", geometry=lambda lim: (geometry.Launch(
        "gather_rows_kernel", (1, 70000, 1), (256, 1, 1)),)),
        {("KC004", "grid_y", "c", "launch[0]")}),
    "smem": (_entry("smem", geometry=lambda lim: (
        geometry.Launch("gather_rows_kernel", (1, 1, 1), (256, 1, 1)),
        geometry.Launch("scatter_kernel", (1, 1, 1), (256, 1, 1),
                        200 * 1024),)),
        {("KC004", "smem", "c", "launch[1]")}),
    "cluster": (_entry("cluster", geometry=lambda lim: (geometry.Launch(
        "histogram_kernel", (32, 1, 1), (1024, 1, 1), 0, 16),)),
        {("KC004", "cluster", "c", "launch[0]")}),
    "disagrees": (_entry("disagrees", ref=lambda v: v + 2),
                  {("KC006", "disagrees", "c", "out[0]")}),
    "dtype": (_entry("dtype", ref=lambda v: (v + 1).long()),
              {("KC005", "dtype", "c", "out[0]")}),
    "launch_key": (_entry("launch_key", launches="no_such_kernel"),
                   {("KC000", "launch_key", "c", "")}),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_case_gives_exactly_its_findings(name):
    entry, want = BROKEN[name]
    findings, _ = kernelcheck.run_registry(device="cpu", execute=True,
                                           entries=[entry])
    assert {(f.kind, f.kernel, f.case, f.operand) for f in findings} == want


def test_clean_fixture_gives_no_finding():
    findings, _ = kernelcheck.run_registry(device="cpu", execute=True,
                                           entries=[_entry("clean")])
    assert findings == []


def test_structural_view_matches_the_committed_baseline():
    _, inv = kernelcheck.run_registry(device="cpu")
    view = json.loads(json.dumps(kernelcheck.structural_view(inv)))
    base = json.loads(BASELINE.read_text())
    assert kernelcheck.diff_paths(base, view) == []


def test_kernels_command_exits_clean(capsys):
    assert cli.main(["kernels", "--device", "cpu"]) == 0
    assert "kernels: clean" in capsys.readouterr().out


def test_kernels_command_needs_the_card_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(SystemExit) as exit_:
        cli.main(["kernels"])
    assert exit_.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernelcheck.run_registry()


def test_sanitizer_unsupported_is_not_a_finding():
    text = ("========= COMPUTE-SANITIZER\n========= Error: Device not "
            "supported. Please refer to ...\n========= ERROR SUMMARY: 3 "
            "errors\n")
    assert kernelcheck.sanitizer_unsupported(text)
    assert not kernelcheck.sanitizer_unsupported(
        "========= Invalid __global__ read of size 4\n"
        "========= ERROR SUMMARY: 1 error\n")
