"""spmdlint for the port: an AST lint pass over its source invariants.

The port of the JAX package's ``repro.analysis.linter``, stdlib ``ast``
only (this package keeps its own copy: the port imports nothing of
``repro``). The engine is the reference's: every file is parsed, names
are resolved through the module's import bindings to fully qualified
dotted paths (so ``import torch.distributed as d; d.all_to_all_single``
is seen through the alias), and each rule (:mod:`.rules`, ids
``TRP001..TRP006``) gets a :class:`LintContext`. A violation on a line
carrying ``# spmdlint: disable=TRPxxx`` is suppressed, as in the
reference; the port uses none.

Configuration is read from the ``[tool.spmdlint-torch]`` table of
``pyproject.toml`` (the reference's ``[tool.spmdlint]`` belongs to the
JAX package), with the same keys::

    [tool.spmdlint-torch]
    paths = ["src/repro_torch", "chip_smoke.py", "scripts"]
    exclude = []
    disable = []

and the defaults below when the table is absent. Rule scopes (which
paths a rule polices) are invariant definitions and stay in code.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Iterable, Iterator, Optional, Sequence

SUPPRESS_RE = re.compile(r"#\s*spmdlint:\s*disable=([A-Za-z0-9_,\s]+)")

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "scripts")
#: The pyproject.toml table this linter reads.
CONFIG_TABLE = "spmdlint-torch"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One lint finding, addressed by rule ID and repo-relative location."""

    rule: str
    path: str            # repo-relative, posix separators
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclasses.dataclass(frozen=True)
class LintConfig:
    paths: tuple = DEFAULT_PATHS
    exclude: tuple = ()
    disable: tuple = ()


class ImportTable:
    """Local-name -> fully-qualified dotted path bindings for one module.

    ``import a.b.c`` binds ``a -> a`` (attribute access resolves the rest),
    ``import a.b.c as x`` binds ``x -> a.b.c``, ``from a.b import c as d``
    binds ``d -> a.b.c``. Relative imports resolve against ``module_name``.
    The table over-approximates (local rebinding of an imported name is
    ignored), which is the right bias for a lint pass.
    """

    def __init__(self, module_name: str = ""):
        self.module_name = module_name
        self.bindings: dict[str, str] = {}

    # --- building -----------------------------------------------------------

    def collect(self, tree: ast.AST) -> "ImportTable":
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.bindings[alias.asname] = alias.name
                    else:
                        head = alias.name.split(".")[0]
                        self.bindings[head] = head
            elif isinstance(node, ast.ImportFrom):
                base = self._from_base(node)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    full = f"{base}.{alias.name}" if base else alias.name
                    self.bindings[alias.asname or alias.name] = full
        return self

    def _from_base(self, node: ast.ImportFrom) -> str:
        if not node.level:
            return node.module or ""
        # relative: drop (level) trailing components of this module's path
        parts = self.module_name.split(".")
        base_parts = parts[: max(len(parts) - node.level, 0)]
        if node.module:
            base_parts.append(node.module)
        return ".".join(base_parts)

    # --- resolution ---------------------------------------------------------

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted path of a Name/Attribute chain through the bindings,
        or None when the chain does not root in an imported name."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.bindings.get(node.id)
        if head is None:
            return None
        parts.append(head)
        return ".".join(reversed(parts))


@dataclasses.dataclass
class LintContext:
    """Everything a rule needs to check one parsed file."""

    tree: ast.AST
    relpath: str                       # repo-relative posix path
    module: str                        # dotted module name ('' if unknown)
    imports: ImportTable
    parents: dict                      # id(node) -> parent node
    lines: Sequence[str]

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(id(node))

    def outermost_attributes(self) -> Iterator[ast.AST]:
        """Name/Attribute nodes that head a load-context attribute chain
        (``jax.lax.psum`` yields once, for the full chain)."""
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.Name, ast.Attribute)):
                continue
            par = self.parent(node)
            if isinstance(par, ast.Attribute) and par.value is node:
                continue  # interior of a longer chain
            if isinstance(node, ast.Name) and not isinstance(
                    getattr(node, "ctx", ast.Load()), ast.Load):
                continue  # assignment targets are not uses
            yield node

    def enclosing_functions(self, node: ast.AST) -> list[ast.AST]:
        out = []
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self.parent(cur)
        return out


def module_name_for(relpath: str) -> str:
    """Dotted module path for a repo-relative file ('' for scripts)."""
    p = relpath.replace(os.sep, "/")
    if p.endswith(".py"):
        p = p[: -len(".py")]
    if p.startswith("src/"):
        p = p[len("src/"):]
        parts = p.split("/")
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)
    return p.split("/")[-1]


def _build_parents(tree: ast.AST) -> dict:
    parents: dict = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


def suppressed_rules(lines: Sequence[str], lineno: int) -> frozenset:
    """Rule IDs disabled on a 1-indexed source line."""
    if not (1 <= lineno <= len(lines)):
        return frozenset()
    m = SUPPRESS_RE.search(lines[lineno - 1])
    if not m:
        return frozenset()
    return frozenset(tok.strip().upper() for tok in m.group(1).split(",")
                     if tok.strip())


def lint_source(source: str, relpath: str, rules: Sequence,
                config: Optional[LintConfig] = None) -> list[Violation]:
    """Lint one file's source text as if it lived at ``relpath``.

    The relpath indirection is what lets the fixture corpus under
    tests exercise scoped rules: a fixture declares the path
    it should be linted as, without living there.
    """
    config = config or LintConfig()
    relpath = relpath.replace(os.sep, "/")
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as exc:
        return [Violation("TRP000", relpath, exc.lineno or 1, 0,
                          f"syntax error: {exc.msg}")]
    ctx = LintContext(
        tree=tree,
        relpath=relpath,
        module=module_name_for(relpath),
        imports=ImportTable(module_name_for(relpath)).collect(tree),
        parents=_build_parents(tree),
        lines=source.splitlines(),
    )
    out: list[Violation] = []
    seen: set = set()
    for rule in rules:
        if rule.id in config.disable or not rule.applies(relpath):
            continue
        for v in rule.check(ctx):
            key = (v.rule, v.path, v.line)
            if key in seen:
                continue  # one report per rule per line (aliased chains)
            if v.rule in suppressed_rules(ctx.lines, v.line):
                continue
            seen.add(key)
            out.append(v)
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def iter_python_files(root: str, paths: Sequence[str],
                      exclude: Sequence[str] = ()) -> Iterator[str]:
    """Repo-relative posix paths of the .py files under ``paths``."""
    for top in paths:
        base = os.path.join(root, top)
        if os.path.isfile(base) and base.endswith(".py"):
            yield os.path.relpath(base, root).replace(os.sep, "/")
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__",))
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn),
                                      root).replace(os.sep, "/")
                if any(rel == e or rel.startswith(e.rstrip("/") + "/")
                       for e in exclude):
                    continue
                yield rel


def lint_paths(root: str, paths: Optional[Sequence[str]] = None,
               rules: Optional[Sequence] = None,
               config: Optional[LintConfig] = None) -> list[Violation]:
    """Lint every python file under ``paths`` (repo-relative) in ``root``."""
    from repro_torch.analysis.rules import all_rules
    config = config or load_config(root)
    rules = list(rules) if rules is not None else all_rules()
    out: list[Violation] = []
    for rel in iter_python_files(root, paths or config.paths, config.exclude):
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            source = f.read()
        out.extend(lint_source(source, rel, rules, config))
    return out


def find_repo_root(start: Optional[str] = None) -> str:
    """Nearest ancestor (of ``start`` or this file) with a pyproject.toml."""
    cur = os.path.abspath(start or os.path.dirname(__file__))
    while True:
        if os.path.exists(os.path.join(cur, "pyproject.toml")):
            return cur
        nxt = os.path.dirname(cur)
        if nxt == cur:
            return os.path.abspath(start or os.getcwd())
        cur = nxt


def lint_repo(root: Optional[str] = None) -> list[Violation]:
    """Full configured lint of the repo (what ``python -m
    repro_torch.analysis lint`` and the tests run)."""
    root = root or find_repo_root()
    return lint_paths(root, config=load_config(root))


# --- pyproject configuration -------------------------------------------------

def _strip_toml_comment(value: str) -> str:
    """Drop a trailing ``# comment`` that is outside any quoted string.

    TOML and Python literals agree on enough here: a ``#`` inside single
    or double quotes is content, outside them it starts a comment. Without
    this, ``paths = ["src"]  # why`` fails literal_eval and the whole key
    silently vanished on 3.10.
    """
    quote = None
    for i, ch in enumerate(value):
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return value[:i]
    return value


def _parse_toml_fallback(text: str) -> dict:
    """[tool.spmdlint-torch] section only: ``key = "str" | [list, of,
    strs]``.

    Minimal on purpose — the CI floor is Python 3.10 (no tomllib), and the
    section this engine owns never needs more grammar than flat keys with
    string/list-of-string values (which are valid Python literals too,
    once trailing comments are stripped). Values the grammar does not
    cover (inline tables, dotted keys) are skipped, not mangled — the
    caller falls back to defaults for those keys.
    """
    out: dict = {}
    in_section = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            in_section = line == f"[tool.{CONFIG_TABLE}]"
            continue
        if not in_section or "=" not in line:
            continue
        key, _, value = line.partition("=")
        try:
            parsed = ast.literal_eval(_strip_toml_comment(value).strip())
        except (ValueError, SyntaxError):
            continue
        if isinstance(parsed, (str, bool, int)) or (
                isinstance(parsed, list)
                and all(isinstance(v, str) for v in parsed)):
            out[key.strip()] = parsed
    return out


def load_config(root: str) -> LintConfig:
    path = os.path.join(root, "pyproject.toml")
    if not os.path.exists(path):
        return LintConfig()
    with open(path, "rb") as f:
        raw = f.read()
    try:
        import tomllib
        section = tomllib.loads(raw.decode("utf-8")).get(
            "tool", {}).get(CONFIG_TABLE, {})
    except ImportError:
        section = _parse_toml_fallback(raw.decode("utf-8"))
    return LintConfig(
        paths=tuple(section.get("paths", DEFAULT_PATHS)),
        exclude=tuple(section.get("exclude", ())),
        disable=tuple(section.get("disable", ())),
    )
