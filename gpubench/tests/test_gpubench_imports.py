"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (the port's name, ``repro_torch``, begins with
the JAX package's, ``repro``); the plain reference imports nothing of the
program either."""
import ast
import sys

import pytest

from conftest import BENCH

from gpubench import harness

JAX = {"jax", "jaxlib", "flax", "repro"}


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & (JAX | {"repro_torch"})
    assert imported(path) <= {"__future__", "numpy", "torch", "gpubench"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in JAX:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "repro"]


def test_a_run_that_loaded_jax_reports_no_result(run_tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "flax", object())
    with pytest.raises(harness.ForbiddenModules):
        run_tiny("rmat_t")
