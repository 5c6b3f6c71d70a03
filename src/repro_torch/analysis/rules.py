"""spmdlint rules for the port: its source invariants as visitor classes.

The port of the JAX package's ``repro.analysis.rules``. Rule ids are
stable (they appear in suppression comments and in CI output):

  TRP001  raw torch.distributed collective or group constructor outside
          repro_torch/runtime/ (the reference's RPR001 and RPR002: one
          runtime gateway for collectives)
  TRP002  repro_torch, chip_smoke.py or scripts/torch_*.py importing jax
          or the JAX package (the port's ground rule)
  TRP003  a kernel library loaded, or a ctypes or Triton entry called,
          outside repro_torch/kernels/ (RPR007's counterpart: every kernel
          sits behind the registry the kernel checker sweeps)
  TRP004  nondeterminism in generator code under core/ and runtime/:
          torch.rand* / randint / randperm without a generator=, the
          stdlib ``random``, the wall clock feeding a value, numpy's
          global or unseeded RNG (RPR004's counterpart)
  TRP005  an unguarded int32 cast (``.to(torch.int32)``, ``.int()``,
          ``np.int32``, ``.astype(np.int32)``) of an edge-count product
          (RPR005's counterpart, with its guard idioms)
  TRP006  a host sync (``.cpu()``, ``.item()``, ``.tolist()``) inside
          kernels/ops.py's entry points: it stalls the stream, and it is
          how a fallback to the plain version would read a size

Not ported: RPR003 (examples/, benchmarks/ and scripts/ enter the JAX
package through ``repro.api``): the port's drivers are ``chip_smoke.py``
and ``scripts/torch_*.py``, which drive its entry points and its phases
directly by design, and the port has no legacy entry points to retire.
RPR006 (a hard-coded ``interpret=``): a CUDA kernel has no interpret
mode; the route is the tensor's device (``kernels/dispatch.py``).

TRP001 polices ``src/repro_torch`` only: ``chip_smoke.py`` and
``scripts/torch_*.py`` are the callers that own the process group (the
API's contract: the caller sets it up), and they create and tear it down
themselves.

Each rule declares the repo-relative paths it polices (``include``, with
``fnmatch`` patterns) and its carve-outs (``exclude``).
"""
from __future__ import annotations

import ast
import fnmatch
import re
from typing import Iterable, Iterator, Optional

from repro_torch.analysis.linter import LintContext, Violation

INT32_MAX = 2**31 - 1


class Rule:
    id: str = "TRP000"
    title: str = ""
    include: tuple = ()
    exclude: tuple = ()

    def applies(self, relpath: str) -> bool:
        def under(prefix: str) -> bool:
            if any(c in prefix for c in "*?["):
                return fnmatch.fnmatch(relpath, prefix)
            p = prefix.rstrip("/")
            return relpath == p or relpath.startswith(p + "/")
        if any(under(e) for e in self.exclude):
            return False
        return any(under(i) for i in self.include)

    def check(self, ctx: LintContext) -> Iterable[Violation]:
        raise NotImplementedError

    def violation(self, ctx: LintContext, node: ast.AST, message: str
                  ) -> Violation:
        return Violation(self.id, ctx.relpath, getattr(node, "lineno", 1),
                         getattr(node, "col_offset", 0), message)


def _imported_paths(node: ast.AST) -> Iterator[str]:
    """Fully-qualified paths an Import/ImportFrom statement binds."""
    if isinstance(node, ast.Import):
        for alias in node.names:
            yield alias.name
    elif isinstance(node, ast.ImportFrom) and not node.level:
        base = node.module or ""
        for alias in node.names:
            if alias.name != "*":
                yield f"{base}.{alias.name}" if base else alias.name


def _matches(path: str, targets: Iterable[str]) -> bool:
    return any(path == t or path.startswith(t + ".") for t in targets)


class BannedPathRule(Rule):
    """Flag imports and uses resolving to banned dotted paths, through any
    aliasing the import table can see."""

    def banned(self, path: str) -> Optional[str]:
        raise NotImplementedError

    def check(self, ctx: LintContext) -> Iterable[Violation]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for full in _imported_paths(node):
                    msg = self.banned(full)
                    if msg:
                        yield self.violation(ctx, node,
                                             f"import of {full}: {msg}")
        for node in ctx.outermost_attributes():
            path = ctx.imports.resolve(node)
            if path is None:
                continue
            msg = self.banned(path)
            if msg:
                yield self.violation(ctx, node, f"{path}: {msg}")


class RawCollectiveRule(BannedPathRule):
    """TRP001: collectives and process groups are the runtime layer's job
    (``runtime/blocking.py``, ``runtime/mesh.py``, ``runtime/spmd.py``): a
    raw call elsewhere sidesteps the topology contract and the auditor's
    expectations."""

    id = "TRP001"
    title = "raw torch.distributed collective outside repro_torch/runtime"
    include = ("src/repro_torch",)
    exclude = ("src/repro_torch/runtime",)
    NAMES = ("all_to_all", "all_to_all_single", "all_reduce", "all_gather",
             "all_gather_into_tensor", "all_gather_single",
             "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
             "reduce_scatter_single", "broadcast", "broadcast_object_list",
             "gather", "gather_object", "scatter", "scatter_object_list",
             "reduce", "send", "recv", "isend", "irecv", "batch_isend_irecv",
             "barrier", "monitored_barrier", "new_group", "new_subgroups",
             "init_process_group", "destroy_process_group",
             "init_device_mesh")
    TARGETS = tuple(f"torch.distributed.{n}" for n in NAMES) + (
        "torch.distributed._functional_collectives",
        "torch.distributed.nn", "torch.distributed.device_mesh")

    def banned(self, path: str) -> Optional[str]:
        if _matches(path, self.TARGETS):
            return ("raw collective or group constructor outside "
                    "repro_torch/runtime: route it through the runtime "
                    "(blocking.py, mesh.py, spmd.py)")
        return None


class ForeignImportRule(Rule):
    """TRP002: the port imports torch, numpy and the standard library,
    never jax and nothing of the JAX package, not even its pure-Python
    modules (it keeps its own copies)."""

    id = "TRP002"
    title = "the port imports jax or the JAX package"
    include = ("src/repro_torch", "chip_smoke.py", "scripts/torch_*.py")
    TOPS = ("jax", "jaxlib", "repro")
    DYNAMIC = ("importlib.import_module", "__import__")

    def _foreign(self, module: str) -> bool:
        return module.split(".")[0] in self.TOPS

    def check(self, ctx: LintContext) -> Iterable[Violation]:
        for node in ast.walk(ctx.tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module or ""]
            elif isinstance(node, ast.Call) and node.args and isinstance(
                    node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str):
                fn = ctx.imports.resolve(node.func) or (
                    node.func.id if isinstance(node.func, ast.Name) else "")
                if fn in self.DYNAMIC:
                    mods = [node.args[0].value]
            for mod in mods:
                if self._foreign(mod):
                    yield self.violation(
                        ctx, node, f"import of {mod}: the port imports "
                        "neither jax nor the JAX package (keep a copy of "
                        "what it needs)")


class KernelSeamRule(BannedPathRule):
    """TRP003: kernel libraries are loaded and their entries called only in
    repro_torch/kernels/, behind the wrappers the registry lists, so the
    kernel checker and the launch counts see every launch."""

    id = "TRP003"
    title = "kernel library or ctypes/Triton entry outside kernels/"
    include = ("src/repro_torch", "chip_smoke.py", "scripts/torch_*.py")
    exclude = ("src/repro_torch/kernels",)
    TARGETS = ("ctypes", "triton", "torch.ops.load_library",
               "torch.utils.cpp_extension", "torch.cuda.jiterator",
               "repro_torch.kernels._build.library")

    def banned(self, path: str) -> Optional[str]:
        if _matches(path, self.TARGETS):
            return ("kernel library or entry outside repro_torch/kernels: "
                    "kernels live behind ops.py and the registry "
                    "(python -m repro_torch.analysis kernels)")
        return None


class DeterminismRule(Rule):
    """TRP004: generator code must reproduce from the spec's seed alone:
    counter-based draws (``core/rng.py``), seeded numpy generators on the
    host, explicit ``torch.Generator``s; no global RNG state, no clock."""

    id = "TRP004"
    title = "nondeterminism in generator paths"
    include = ("src/repro_torch/core", "src/repro_torch/runtime")
    TORCH_DRAWS = ("torch.rand", "torch.rand_like", "torch.randn",
                   "torch.randn_like", "torch.randint", "torch.randint_like",
                   "torch.randperm", "torch.normal", "torch.bernoulli",
                   "torch.multinomial", "torch.poisson")
    SEEDED_OK = frozenset({"numpy.random.default_rng",
                           "numpy.random.Generator",
                           "numpy.random.SeedSequence",
                           "numpy.random.PCG64", "numpy.random.Philox"})
    CLOCKS = ("time.time", "time.time_ns", "time.perf_counter",
              "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
              "time.process_time", "datetime.datetime.now")

    def check(self, ctx: LintContext) -> Iterable[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            path = ctx.imports.resolve(node.func)
            if path is None:
                continue
            n_args = len(node.args) + len(node.keywords)
            if path in self.TORCH_DRAWS:
                if not any(k.arg == "generator" for k in node.keywords):
                    yield self.violation(
                        ctx, node, f"{path}() without generator=: the "
                        "global torch RNG is process state; draw from "
                        "core/rng.py keys or a seeded torch.Generator")
            elif path in self.CLOCKS:
                if not isinstance(ctx.parent(node), ast.Expr):
                    yield self.violation(
                        ctx, node, f"{path}() feeds a value in generator "
                        "code: the clock breaks run-to-run determinism")
            elif path == "random" or path.startswith("random."):
                yield self.violation(
                    ctx, node, f"{path}(): the stdlib's global RNG is "
                    "unseeded process state; use "
                    "numpy.random.default_rng(seed)")
            elif path.startswith("numpy.random."):
                if path in self.SEEDED_OK and n_args >= 1:
                    continue
                if path in self.SEEDED_OK:
                    yield self.violation(
                        ctx, node, f"{path}() without a seed: pass the "
                        "spec's seed explicitly")
                else:
                    yield self.violation(
                        ctx, node, f"{path}(): numpy's global-state RNG; "
                        "use numpy.random.default_rng(seed)")


_EDGE_NAME_RE = re.compile(
    r"(?:^|_)(?:e|edges?|num_edges|requested|requested_edges|total_edges|"
    r"edges_per_vertex|edges_per_proc|k|degree)(?:_|$)")
_INT32_CTORS = ("numpy.int32", "torch.int32", "torch.int")
_ARRAY_CTORS = ("numpy.asarray", "numpy.array", "numpy.full",
                "torch.tensor", "torch.as_tensor", "torch.full")


def _identifier_texts(node: ast.AST) -> Iterator[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr


def _edge_count_product(node: ast.AST) -> Optional[str]:
    """A ``*``/``**`` BinOp over edge-count-named identifiers inside
    ``node`` (the overflow shape: P * vpp * k style products), or None."""
    for sub in ast.walk(node):
        if (isinstance(sub, ast.BinOp)
                and isinstance(sub.op, (ast.Mult, ast.Pow))):
            names = [t for t in _identifier_texts(sub)
                     if _EDGE_NAME_RE.search(t)]
            if names:
                return " * ".join(dict.fromkeys(names))
    return None


def _has_overflow_guard(scope_nodes: Iterable[ast.AST]) -> bool:
    for scope in scope_nodes:
        for sub in ast.walk(scope):
            if isinstance(sub, ast.Constant) and sub.value == INT32_MAX:
                return True
            if (isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Pow)
                    and isinstance(sub.left, ast.Constant)
                    and sub.left.value == 2
                    and isinstance(sub.right, ast.Constant)
                    and sub.right.value == 31):
                return True
            if isinstance(sub, ast.Compare):
                sides = [sub.left, *sub.comparators]
                if any("int32" in t.lower() or t.lower() == "imax"
                       for side in sides
                       for t in _identifier_texts(side)):
                    return True
            if isinstance(sub, ast.Call):
                fn = sub.func
                name = (fn.attr if isinstance(fn, ast.Attribute)
                        else fn.id if isinstance(fn, ast.Name) else "")
                if "check_int32" in name or name == "iinfo":
                    return True
    return False


class Int32OverflowRule(Rule):
    """TRP005: an edge-count product truncates silently when cast to int32
    (1B vertices x 5 edges overflows at P*vpp*k ~ 2.1e9): every such cast
    must sit in a scope that range-checks against 2**31 - 1 (or calls a
    *check_int32* helper / an iinfo bound)."""

    id = "TRP005"
    title = "unguarded int32 cast of an edge-count product"
    include = ("src/repro_torch",)

    def _is_int32(self, ctx: LintContext, node: ast.AST) -> bool:
        return (ctx.imports.resolve(node) in _INT32_CTORS
                or (isinstance(node, ast.Constant)
                    and node.value == "int32"))

    def _cast_subject(self, ctx: LintContext, node: ast.Call
                      ) -> Optional[ast.AST]:
        path = ctx.imports.resolve(node.func)
        if path == "numpy.int32" and node.args:
            return node.args[0]
        if path in _ARRAY_CTORS and node.args:
            dtype = next((kw.value for kw in node.keywords
                          if kw.arg == "dtype"),
                         node.args[1] if len(node.args) > 1 else None)
            if dtype is not None and self._is_int32(ctx, dtype):
                return node.args[0]
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "int" and not node.args and not node.keywords:
                return node.func.value
            if attr in ("astype", "to") and node.args and self._is_int32(
                    ctx, node.args[0]):
                return node.func.value
            if attr == "to" and any(k.arg == "dtype" and self._is_int32(
                    ctx, k.value) for k in node.keywords):
                return node.func.value
        return None

    def check(self, ctx: LintContext) -> Iterable[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            subject = self._cast_subject(ctx, node)
            if subject is None:
                continue
            product = _edge_count_product(subject)
            if product is None:
                continue
            scopes = ctx.enclosing_functions(node) or [ctx.tree]
            if _has_overflow_guard(scopes):
                continue
            yield self.violation(
                ctx, node, f"int32 cast of edge-count product ({product}) "
                "without an overflow guard: check against 2**31 - 1 first")


class HostSyncRule(Rule):
    """TRP006: the kernel entry points in kernels/ops.py stay asynchronous
    on the card: a ``.cpu()``, ``.item()`` or ``.tolist()`` there waits
    for the stream, and reading a size back is how a fallback to the plain
    version would start."""

    id = "TRP006"
    title = "host sync inside a kernels/ops.py entry point"
    include = ("src/repro_torch/kernels/ops.py",)
    SYNCS = ("cpu", "item", "tolist")

    def check(self, ctx: LintContext) -> Iterable[Violation]:
        for fn in ctx.tree.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in self.SYNCS):
                    yield self.violation(
                        ctx, node, f".{node.func.attr}() in {fn.name}(): a "
                        "host sync inside a kernel entry point")


def all_rules() -> list[Rule]:
    return [RawCollectiveRule(), ForeignImportRule(), KernelSeamRule(),
            DeterminismRule(), Int32OverflowRule(), HostSyncRule()]


def rules_by_id(ids: Iterable[str]) -> list[Rule]:
    table = {r.id: r for r in all_rules()}
    return [table[i] for i in ids]
