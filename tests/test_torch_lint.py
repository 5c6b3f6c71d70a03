"""spmdlint for the port (``repro_torch.analysis.linter`` / ``rules``).

The port lints clean; each rule TRP001-TRP006 is pinned by a broken
fixture (inline source linted as if it lived at a path the rule
polices) compared by exact finding identity (rule, path, line); the
engine's suppression comments, aliasing through imports, the config
table and the command line behave as the reference's.
"""
import pathlib

import pytest

from repro_torch.analysis import cli, linter, rules

REPO = pathlib.Path(__file__).resolve().parents[1]

# (relpath, source, expected {(rule, line)})
FIXTURES = {
    "TRP001": ("src/repro_torch/core/fixture.py", (
        "import torch.distributed as d\n"
        "from torch.distributed import all_to_all_single as a2a\n"
        "def f(x, out):\n"
        "    d.all_reduce(x)\n"
        "    a2a(out, x)\n"
        "    g = d.new_group([0, 1])\n"
        "    return d.get_rank()\n"),
        {("TRP001", 2), ("TRP001", 4), ("TRP001", 5), ("TRP001", 6)}),
    "TRP002": ("scripts/torch_fixture.py", (
        "import numpy as np\n"
        "import jax.numpy as jnp\n"
        "from repro.core import pba\n"
        "import importlib\n"
        "m = importlib.import_module('jax')\n"
        "import repro_torch\n"),
        {("TRP002", 2), ("TRP002", 3), ("TRP002", 5)}),
    "TRP003": ("src/repro_torch/core/fixture.py", (
        "import ctypes\n"
        "from repro_torch.kernels import _build\n"
        "lib = _build.library('gather')\n"
        "def g():\n"
        "    import triton\n"
        "    return triton.cdiv(3, 2)\n"),
        {("TRP003", 1), ("TRP003", 3), ("TRP003", 5), ("TRP003", 6)}),
    "TRP004": ("src/repro_torch/runtime/fixture.py", (
        "import random, time\n"
        "import numpy as np\n"
        "import torch\n"
        "def f(g):\n"
        "    a = torch.rand(4)\n"
        "    b = torch.randint(0, 5, (4,), generator=g)\n"
        "    c = torch.randperm(4)\n"
        "    seed = int(time.time())\n"
        "    time.perf_counter()\n"
        "    r = random.random()\n"
        "    s = np.random.rand(3)\n"
        "    t = np.random.default_rng()\n"
        "    u = np.random.default_rng(7)\n"
        "    return a, b, c, seed, r, s, t, u\n"),
        {("TRP004", 5), ("TRP004", 7), ("TRP004", 8), ("TRP004", 10),
         ("TRP004", 11), ("TRP004", 12)}),
    "TRP005": ("src/repro_torch/core/fixture.py", (
        "import numpy as np\n"
        "import torch\n"
        "def f(procs, edges_per_proc, x):\n"
        "    a = (procs * edges_per_proc).to(torch.int32)\n"
        "    b = torch.tensor(procs * edges_per_proc, dtype=torch.int32)\n"
        "    c = (x * edges_per_proc).int()\n"
        "    d = np.int32(procs * edges_per_proc)\n"
        "    return a, b, c, d\n"
        "def g(procs, edges_per_proc):\n"
        "    if procs * edges_per_proc > 2**31 - 1:\n"
        "        raise ValueError('too many')\n"
        "    return np.int32(procs * edges_per_proc)\n"),
        {("TRP005", 4), ("TRP005", 5), ("TRP005", 6), ("TRP005", 7)}),
    "TRP006": ("src/repro_torch/kernels/ops.py", (
        "def gather(src, idx):\n"
        "    if int(idx.max().item()) > 3:\n"
        "        return src.cpu()\n"
        "    return src[idx.tolist()]\n"
        "FALLBACK = [1].copy()\n"),
        {("TRP006", 2), ("TRP006", 3), ("TRP006", 4)}),
}


def test_the_port_lints_clean():
    cfg = linter.load_config(str(REPO))
    assert cfg == linter.LintConfig()           # no table of the port's yet
    assert linter.lint_repo(str(REPO)) == []
    files = list(linter.iter_python_files(str(REPO), cfg.paths))
    assert "chip_smoke.py" in files
    assert "src/repro_torch/kernels/ops.py" in files
    assert any(f.startswith("scripts/torch_") for f in files)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_fixture_gives_exactly_its_findings(rule):
    relpath, source, want = FIXTURES[rule]
    got = linter.lint_source(source, relpath, rules.all_rules())
    assert {(v.rule, v.line) for v in got} == want
    assert {v.path for v in got} == {relpath}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_scope(rule):
    """Each fixture outside its rule's scope gives nothing of that rule."""
    _, source, _ = FIXTURES[rule]
    outside = {"TRP001": "src/repro_torch/runtime/fixture.py",
               "TRP002": "scripts/lint.py",
               "TRP003": "src/repro_torch/kernels/fixture.py",
               "TRP004": "src/repro_torch/models/fixture.py",
               "TRP005": "tests/fixture.py",
               "TRP006": "src/repro_torch/kernels/ref.py"}[rule]
    got = linter.lint_source(source, outside, rules.all_rules())
    assert not [v for v in got if v.rule == rule]


def test_suppression_comment():
    src = ("import torch\n"
           "a = torch.rand(3)  # spmdlint: disable=TRP004\n"
           "b = torch.rand(3)\n")
    got = linter.lint_source(src, "src/repro_torch/core/x.py",
                             rules.all_rules())
    assert [(v.rule, v.line) for v in got] == [("TRP004", 3)]


def test_syntax_error_is_a_finding():
    got = linter.lint_source("def (:\n", "src/repro_torch/x.py",
                             rules.all_rules())
    assert [v.rule for v in got] == ["TRP000"]


def test_config_table_is_read(tmp_path):
    (tmp_path / "pyproject.toml").write_text(
        "[tool.spmdlint]\npaths = [\"elsewhere\"]\n\n"
        "[tool.spmdlint-torch]\npaths = [\"src/repro_torch\"]  # why\n"
        "disable = [\"TRP004\"]\n")
    cfg = linter.load_config(str(tmp_path))
    assert cfg.paths == ("src/repro_torch",) and cfg.disable == ("TRP004",)
    parsed = linter._parse_toml_fallback(
        (tmp_path / "pyproject.toml").read_text())
    assert parsed == {"paths": ["src/repro_torch"], "disable": ["TRP004"]}


def test_rules_and_not_ported_are_documented():
    ids = [r.id for r in rules.all_rules()]
    assert ids == [f"TRP00{i}" for i in range(1, 7)]
    doc = rules.__doc__
    for rid in ids + ["RPR003", "RPR006"]:
        assert rid in doc


def test_lint_command(capsys):
    assert cli.main([]) == 0
    assert cli.main(["lint"]) == 0
    assert "spmdlint: clean" in capsys.readouterr().out
    assert cli.main(["lint", "--list-rules"]) == 0
    assert "TRP006" in capsys.readouterr().out


def test_lint_command_fails_on_a_violation(tmp_path, capsys):
    (tmp_path / "pyproject.toml").write_text("")
    bad = tmp_path / "src" / "repro_torch" / "core"
    bad.mkdir(parents=True)
    (bad / "x.py").write_text("import jax\n")
    assert cli.main(["lint", "--root", str(tmp_path),
                     "--format", "github"]) == 1
    out = capsys.readouterr().out
    assert out.startswith("::error file=src/repro_torch/core/x.py,line=1")
