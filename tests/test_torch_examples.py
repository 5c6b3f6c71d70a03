"""The port's counterparts of the JAX package's examples
(``examples/torch_*.py``), each run at its reduced size on the CPU.
Where the output is deterministic (the quickstart's graphs: edge counts,
drops, max degrees and every statistic it prints), it must equal the JAX
example's printout."""
import contextlib
import importlib.util
import io
import math
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args)
    return ret, out.getvalue()


def _quickstart(tmp_path):
    _, got = _printed(_load("torch_quickstart").main, ["--device", "cpu"])
    old = sys.argv
    sys.argv = ["quickstart.py"]
    try:
        _, want = _printed(_load("quickstart").main)
    finally:
        sys.argv = old
    assert got == want
    assert "edges=128,000 (dropped 0)" in got


def _serve_decode(tmp_path):
    outs, got = _printed(_load("torch_serve_decode").main, [
        "--device", "cpu", "--batch", "2", "--prompt-len", "8",
        "--new-tokens", "4"])
    assert re.search(r"^\[serve\] qwen1.5-0.5b: [0-9,]+ params, slots=2, "
                     r"device=cpu$", got, re.M)
    assert re.search(r"^\[serve\] 2 completions, 8 tokens in ", got, re.M)
    assert sorted(c.rid for c in outs) == [0, 1]
    assert all(len(c.tokens) == 4 and all(0 <= t < 512 for t in c.tokens)
               for c in outs)


def _train_graph_lm(tmp_path):
    ck = tmp_path / "ck"
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--ckpt-dir", str(ck)]
    logged, got = _printed(_load("torch_train_graph_lm").main, argv)
    assert "[train] qwen1.5-0.5b: " in got and "restart" not in got
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000002"]
    assert [s for s, _ in logged] == [1]
    assert all(math.isfinite(loss) for _, loss in logged)
    # a rerun restarts from the step-2 checkpoint
    logged2, got2 = _printed(_load("torch_train_graph_lm").main, argv)
    assert "[train] restart from step 2" in got2 and logged2[0][0] == 3


@pytest.mark.parametrize("example", ["quickstart", "serve_decode",
                                     "train_graph_lm"])
def test_example_runs(example, tmp_path):
    {"quickstart": _quickstart, "serve_decode": _serve_decode,
     "train_graph_lm": _train_graph_lm}[example](tmp_path)


NEW_ENTRY_POINTS = ["examples/torch_quickstart.py",
                    "examples/torch_serve_decode.py",
                    "examples/torch_train_graph_lm.py",
                    "examples/torch_generate_massive.py",
                    "scripts/torch_collective_gate.py",
                    "src/repro_torch/launch/generate.py"]


@pytest.mark.parametrize("rel", NEW_ENTRY_POINTS)
def test_entry_point_imports_neither_jax_nor_the_jax_package(rel):
    import ast
    tree = ast.parse((REPO / rel).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and not n.level]
    assert mods
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "repro")], rel
