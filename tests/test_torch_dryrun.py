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
