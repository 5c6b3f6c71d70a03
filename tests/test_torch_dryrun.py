"""repro_torch.launch.dryrun's train-cell choices against the JAX
package's ``launch/dryrun.py``, on the CPU.

The reference module sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so nothing here imports it: its ``lower_cell`` choices are a
table (each config on the single-pod 16 x 16 and multi-pod 2 x 16 x 16
meshes at ``train_4k``'s global batch of 256, and on four cards as (1, 4)
and (2, 2) at a batch of 8), and its ``accum_steps`` is read out of its
source with ``ast`` and run on its own, over a sweep of batches and
data-parallel degrees.
"""
import ast
import dataclasses
import pathlib

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun

REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro" / \
    "launch" / "dryrun.py"
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (1, 4): ("data", "model"), (2, 2): ("data", "model")}

# (arch, mesh, global batch, no_tp, dp, accum): lower_cell's choices
TABLE = (
    ("qwen1.5-0.5b", (16, 16), 256, True, 256, 1),
    ("qwen1.5-0.5b", (2, 16, 16), 256, False, 32, 1),
    ("qwen1.5-0.5b", (1, 4), 8, True, 4, 1),
    ("qwen1.5-0.5b", (2, 2), 8, True, 4, 1),
    ("phi3-medium-14b", (16, 16), 256, False, 16, 8),
    ("phi3-medium-14b", (2, 16, 16), 256, False, 32, 4),
    ("phi3-medium-14b", (1, 4), 8, False, 1, 4),
    ("phi3-medium-14b", (2, 2), 8, False, 2, 2),
    ("stablelm-1.6b", (16, 16), 256, True, 256, 1),
    ("stablelm-1.6b", (2, 16, 16), 256, False, 32, 1),
    ("stablelm-1.6b", (1, 4), 8, True, 4, 1),
    ("stablelm-1.6b", (2, 2), 8, True, 4, 1),
    ("minicpm3-4b", (16, 16), 256, False, 16, 2),
    ("minicpm3-4b", (2, 16, 16), 256, False, 32, 1),
    ("minicpm3-4b", (1, 4), 8, False, 1, 1),
    ("minicpm3-4b", (2, 2), 8, False, 2, 1),
    ("llama4-scout-17b-a16e", (16, 16), 256, False, 16, 4),
    ("llama4-scout-17b-a16e", (2, 16, 16), 256, False, 32, 4),
    ("llama4-scout-17b-a16e", (1, 4), 8, False, 1, 4),
    ("llama4-scout-17b-a16e", (2, 2), 8, False, 2, 2),
    ("qwen3-moe-235b-a22b", (16, 16), 256, False, 16, 4),
    ("qwen3-moe-235b-a22b", (2, 16, 16), 256, False, 32, 4),
    ("qwen3-moe-235b-a22b", (1, 4), 8, False, 1, 4),
    ("qwen3-moe-235b-a22b", (2, 2), 8, False, 2, 2),
    ("whisper-medium", (16, 16), 256, False, 16, 2),
    ("whisper-medium", (2, 16, 16), 256, False, 32, 1),
    ("whisper-medium", (1, 4), 8, False, 1, 1),
    ("whisper-medium", (2, 2), 8, False, 2, 1),
    ("mamba2-130m", (16, 16), 256, False, 16, 4),
    ("mamba2-130m", (2, 16, 16), 256, False, 32, 2),
    ("mamba2-130m", (1, 4), 8, False, 1, 2),
    ("mamba2-130m", (2, 2), 8, False, 2, 1),
    ("phi-3-vision-4.2b", (16, 16), 256, False, 16, 2),
    ("phi-3-vision-4.2b", (2, 16, 16), 256, False, 32, 1),
    ("phi-3-vision-4.2b", (1, 4), 8, False, 1, 1),
    ("phi-3-vision-4.2b", (2, 2), 8, False, 2, 1),
    ("recurrentgemma-2b", (16, 16), 256, False, 16, 2),
    ("recurrentgemma-2b", (2, 16, 16), 256, False, 32, 1),
    ("recurrentgemma-2b", (1, 4), 8, False, 1, 1),
    ("recurrentgemma-2b", (2, 2), 8, False, 2, 1),
)


def _reference_accum_steps():
    """The reference's accum_steps, compiled from its source alone."""
    tree = ast.parse(REFERENCE.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "accum_steps")
    ns: dict = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(REFERENCE),
                 "exec"), ns)
    return ns["accum_steps"]


def test_table_covers_every_config():
    assert sorted({row[0] for row in TABLE}) == sorted(ARCH_IDS)
    assert SHAPES["train_4k"].global_batch == 256


@pytest.mark.parametrize("row", TABLE, ids=lambda r: f"{r[0]}-{r[1]}")
def test_train_layout_matches_lower_cell(row):
    arch, mesh, gb, no_tp, dp, accum = row
    shape = dict(zip(MESHES[mesh], mesh))
    got = dryrun.train_layout(get_config(arch), shape, gb)
    assert (got.no_tp, got.dp, got.accum) == (no_tp, dp, accum)
    assert got.tp == (1 if no_tp else shape["model"])
    assert _reference_accum_steps()(get_config(arch), gb, dp) == accum


def test_accum_steps_is_the_reference_function():
    ref = _reference_accum_steps()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for gb in (1, 3, 8, 12, 64, 100, 256, 1024):
            for dp in (1, 2, 4, 16, 32, 256):
                assert dryrun.accum_steps(cfg, gb, dp) == ref(cfg, gb, dp), \
                    (arch, gb, dp)


def test_overrides_and_the_no_tp_bounds(monkeypatch):
    """The reference lowering's REPRO_NO_TP / REPRO_ACCUM overrides do not
    move train_layout (its default choice); the no_tp bounds."""
    qwen = get_config("qwen1.5-0.5b")
    shape = {"data": 2, "model": 2}
    monkeypatch.setenv("REPRO_NO_TP", "0")
    monkeypatch.setenv("REPRO_ACCUM", "3")
    got = dryrun.train_layout(qwen, shape, 8)
    assert (got.no_tp, got.tp, got.dp, got.accum) == (True, 1, 4, 1)
    assert not dryrun.no_tp_default(qwen, "train", 6, 4)      # 4 does not divide
    assert not dryrun.no_tp_default(qwen, "prefill", 8, 4)
    big = dataclasses.replace(qwen, num_layers=200)
    assert big.num_params() >= dryrun.NO_TP_MAX_PARAMS
    assert not dryrun.no_tp_default(big, "train", 8, 4)


# --- the dry run's lowering: lower_cell, main, restat ---------------------------
#
# The dry run's c10d calls are the real step's: at world 4 under the fake
# backend (no memory, every collective returns at once) the recorder of
# analysis/audit.py counts, call for call, what it counts on rank 0 of a
# real gloo run of the same step and layout (chip_smoke.c10d_calls;
# reduced configs: one GQA, one MoE, one SSD; a train step and a decode
# step each). The same gloo ranks hold ctx.gather_weight's global "embed"
# size under no_tp (a port fault the dry run found, ROADMAP Queue 3).

import datetime  # noqa: E402
import os  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import op_stats, restat  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(arch, kind) for arch in ("qwen1.5-0.5b", "qwen3-moe-235b-a22b",
                                   "mamba2-130m")
         for kind in ("train", "decode")]
CELL_SHAPE = {"seq_len": 16, "global_batch": 8}
SPAWN_TIMEOUT_S = 240


def _cell(arch, kind):
    return get_config(arch).reduced(), ShapeConfig(f"t_{kind}", kind=kind,
                                                   **CELL_SHAPE)


def _fake_worker(rank, out):
    from repro_torch.runtime import spmd
    from repro_torch.runtime.mesh import ProcessMesh
    torch.set_num_threads(1)
    spmd.init_fake_group(4, 0)
    try:
        mesh = ProcessMesh(("data", "model"), (2, 2), "cpu")
        got = {}
        for arch, kind in CELLS:
            _, extra = dryrun.run_cell(*_cell(arch, kind), mesh)
            got[f"{arch}/{kind}"] = op_stats.collect_opcode_stats(
                extra["calls"])
        with open(out, "w") as f:
            json.dump(got, f)
    finally:
        spmd.destroy_group()


def _gloo_worker(rank, world, init_file, out):
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from repro_torch.runtime.mesh import ProcessMesh
    from repro_torch.sharding import ctx, make_rules
    from repro_torch.sharding.rules import local_slices
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = ProcessMesh(("data", "model"), (2, 2), "cpu")
        got = {}
        for arch, kind in CELLS:
            run, _, _ = dryrun.prepare_cell(*_cell(arch, kind), mesh)
            if rank == 0:
                got[f"{arch}/{kind}"] = chip_smoke.c10d_calls(torch, run)
            else:
                run()
        # no_tp splits an "embed" of 24 over ("data", "model"): blocks of 6
        rules = make_rules(mesh, "train", 8, no_tp=True)
        w = torch.arange(5 * 24, dtype=torch.float32).reshape(5, 24)
        spec = types.SimpleNamespace(axes=("vocab", "embed"), shape=(5, 24))
        block = w[local_slices(rules.param_pspec(spec), w.shape, mesh)]
        with ctx.sharding_ctx(rules, mesh, 24):
            whole = ctx.gather_weight(block, ("vocab", "embed"))
        got["embed"] = {"block": list(block.shape),
                        "equal": bool(torch.equal(whole, w))}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(got, f)
    finally:
        dist.destroy_process_group()


def _join(ctx):
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=2):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ranks did not finish")


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_counts")
    fake = mp.spawn(_fake_worker, args=(str(tmp / "fake.json"),), nprocs=1,
                    join=False)
    gloo = mp.spawn(_gloo_worker, args=(4, str(tmp / "rdzv"),
                                        str(tmp / "gloo.json")),
                    nprocs=4, join=False)
    _join(fake)
    _join(gloo)
    return (json.loads((tmp / "fake.json").read_text()),
            json.loads((tmp / "gloo.json").read_text()))


@pytest.mark.parametrize("arch,kind", CELLS)
def test_fake_backend_counts_equal_a_gloo_run(counted, arch, kind):
    fake, gloo = counted
    label = f"{arch}/{kind}"
    assert fake[label] == gloo[label]
    assert fake[label]["c10d::_allgather_base_"] > 0


def test_no_tp_gathers_the_global_embed(counted):
    """ctx.gather_weight under no_tp: a block's size fits both splits the
    rules choose between, so the context carries the model's d_model."""
    embed = counted[1]["embed"]
    assert embed == {"block": [5, 6], "equal": True}


def _dryrun(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--out", str(tmp_path / "rec"), "--calls", str(tmp_path / "calls"),
         *args], capture_output=True, text=True, env=env, timeout=600)


def test_main_writes_a_record_and_restat_recomputes_it(tmp_path):
    proc = _dryrun(tmp_path, "--arch", "mamba2-130m", "--shape",
                   "decode_32k", "--multi-pod", "0")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tag = "mamba2-130m__decode_32k__sp"
    rec = json.loads((tmp_path / "rec" / f"{tag}.json").read_text())
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["kind"]) == (
        "mamba2-130m", "decode_32k", "16x16", "decode")
    pd = rec["per_device"]
    assert pd["temp_bytes"] is None and "allocator" in \
        rec["notes"]["temp_bytes"]
    assert pd["flops"] > 0 and pd["param_bytes"] > 0
    assert pd["cache_bytes"] > 0 and pd["optimizer_bytes"] == 0
    assert pd["collective_count_by_kind"]["all-gather"] > 0
    assert pd["collective_bytes"] == sum(
        pd["collective_bytes_by_kind"].get(k, 0)
        for k in op_stats.COLLECTIVE_KINDS)
    calls, flops, _ = op_stats.load_calls(
        str(tmp_path / "calls" / f"{tag}.calls.json.gz"))
    again = restat.restat(json.loads(json.dumps(rec)), calls, flops)
    assert again == rec
    # a second run skips the cell
    proc = _dryrun(tmp_path, "--arch", "mamba2-130m", "--shape",
                   "decode_32k", "--multi-pod", "0")
    assert "[skip] " + tag in proc.stdout


def test_a_failing_cell_writes_err_and_exits_1(tmp_path):
    proc = _dryrun(tmp_path, "--arch", "mamba2-130m", "--shape",
                   "no_such_shape", "--multi-pod", "1")
    assert proc.returncode == 1
    err = (tmp_path / "rec" / "mamba2-130m__no_such_shape__mp.json.err")
    assert "KeyError: 'no_such_shape'" in err.read_text()


def test_importing_the_dry_run_sets_no_environment():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", "import os; before = dict(os.environ); "
         "import repro_torch.launch.dryrun; print(dict(os.environ) == "
         "before)"], capture_output=True, text=True, env=env, timeout=120)
    assert out.stdout.strip() == "True"
