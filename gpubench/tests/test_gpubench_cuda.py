"""On the card (marked ``cuda``; each test looks for a device itself and
skips without one): a short run of each cell through ``gpubench/run.py``
comes out correct, and the control at a cell's own size does not.

    python -m pytest -q -m cuda gpubench/tests/test_gpubench_cuda.py
"""
import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

pytestmark = pytest.mark.cuda


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def run(*args, timeout=600):
    return subprocess.run([sys.executable, *args], cwd=ROOT, text=True,
                          capture_output=True, timeout=timeout)


@pytest.mark.parametrize("cell,seconds", [("rmat_s26_1c", 3),
                                          ("pba_r64_1c", 12)])
def test_a_short_run_is_correct(cell, seconds):
    needs_card()
    out = run("gpubench/run.py", "--workload", cell, "--seed", "2147483701",
              "--seconds", str(seconds), "--trace", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_the_control_fails_at_the_cells_size():
    needs_card()
    out = run("gpubench/control.py", "--workload", "rmat_s26_1c", "--seeds",
              "2147483713", "--graphs", "16")
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
