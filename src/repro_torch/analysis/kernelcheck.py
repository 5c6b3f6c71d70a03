"""The kernel checker: launch limits, parity and the differential over the
kernel registry (``python -m repro_torch.analysis kernels``).

The port of the JAX package's ``repro.analysis.kernelcheck``
(pallascheck). That module captures every ``pl.pallas_call`` under
``jax.eval_shape`` and proves its grid and BlockSpecs race-free and
inside the VMEM budget. A CUDA kernel has no BlockSpec to read: what the
port can see is the launch each wrapper makes (``kernels/geometry.py``'s
pure functions, the same ones the wrappers launch with), the compiled
kernels' attributes (``cudaFuncGetAttributes``) and the outputs
themselves. The codes keep their numbers where the meaning carries over:

  KC000 launch count   a case that launches no kernel, or another one
                       than its own (``ops.launch_counts()``; on the card).
  KC001 race           ``compute-sanitizer --tool racecheck`` reports a
                       hazard while the registry's cases run (in place of
                       the reference's non-consecutive revisit proof).
  KC003 out of bounds  ``compute-sanitizer --tool memcheck`` reports an
                       invalid access (in place of the reference's
                       index-map bound).
  KC004 launch limits  a case's launch outside the card's limits: more
                       than 1024 threads a block (or the kernel's compiled
                       maximum), grid y or z past 65535, dynamic plus
                       static shared memory past the opt-in maximum
                       (227 KB on an H100), a cluster past 8 (16 only with
                       the non-portable attribute, which no kernel sets).
                       In place of the reference's VMEM budget. On the CPU
                       against an H100's limits (``geometry.H100``) and
                       the sources' static shared memory; on the card
                       against the device's own limits and the compiled
                       attributes.
  KC005 parity         the wrapper's output and its plain version's
                       disagree on shape or dtype.
  KC006 differential   the wrapper's output and its plain version's differ
                       in a value. On the card every case runs through the
                       kernel, bit for bit, over an allocator cache filled
                       with a sentinel, so an output the kernel leaves
                       unwritten shows (the reference's KC002, output gap,
                       is this). On the CPU the wrapper runs its plain
                       version, and the differential that matters there,
                       the plain version against the JAX package's
                       ``repro.kernels.ref`` oracle on the registry's own
                       inputs, runs in the tests (this package never
                       imports ``repro``).

The sanitizer pass (:func:`sanitize`) reruns the executable cases under
``compute-sanitizer`` as a subprocess, one tool at a time:
``python -m repro_torch.analysis kernels --execute --sanitize``.

:func:`inventory` and :func:`structural_view` follow the reference: the
structural view (each case's launches, the limits, the entries' static
facts; on the card also the compiled attributes) is what
``results/torch_kernel_audit_baseline.json`` commits, so a change of
geometry is a reviewed re-commit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Iterable, Optional

KIND_TITLES = {
    "KC000": "launch count: no launch, or another kernel's",
    "KC001": "race reported by compute-sanitizer racecheck",
    "KC003": "out-of-bounds access reported by compute-sanitizer memcheck",
    "KC004": "launch outside the card's limits",
    "KC005": "shape/dtype parity mismatch vs the plain version",
    "KC006": "value mismatch vs the plain version",
}

#: The allocator is filled with this before a kernel's outputs are made,
#: so an output element the kernel never writes keeps it.
SENTINEL = 0x5A5A5A5A


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect, addressed by (kind, kernel, case, operand)."""

    kind: str          # KC000..KC006
    kernel: str        # registry entry name
    case: str          # case label, e.g. "m4097"
    operand: str       # "launch[0]" / "out[1]" / "" for call-level findings
    message: str

    def format(self) -> str:
        where = f"[{self.operand}]" if self.operand else ""
        return (f"{self.kernel}/{self.case}{where}: {self.kind} "
                f"{KIND_TITLES.get(self.kind, '')} - {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _base(kernel: str) -> str:
    return kernel.split("<")[0]


def check_launch(launch, limits, attributes: Optional[dict] = None
                 ) -> list[str]:
    """KC004: what is wrong with ``launch`` on a card of ``limits``.
    ``attributes``: compiled kernel name -> ``cudaFuncAttributes`` fields
    (every template instance of the launch's kernel is held); without
    them, the sources' static shared memory (``geometry.STATIC_SMEM``)."""
    from repro_torch.kernels.geometry import STATIC_SMEM
    out = []
    threads = launch.threads
    variants = {k: a for k, a in (attributes or {}).items()
                if _base(k) == _base(launch.kernel)}
    max_threads = min([limits.max_threads_per_block] +
                      [a["maxThreadsPerBlock"] for a in variants.values()])
    if threads > max_threads:
        out.append(f"{threads} threads a block, at most {max_threads}")
    for axis, (n, cap) in enumerate(zip(launch.grid, limits.max_grid)):
        if not 1 <= n <= cap:
            out.append(f"grid {'xyz'[axis]} = {n}, allowed [1, {cap}]")
    static = max([a["sharedSizeBytes"] for a in variants.values()]
                 or [STATIC_SMEM.get(_base(launch.kernel), 0)])
    if launch.smem + static > limits.smem_optin:
        out.append(f"{launch.smem} B dynamic + {static} B static shared "
                   f"memory, the opt-in maximum is {limits.smem_optin} B")
    if launch.cluster > limits.cluster_portable:
        out.append(f"cluster of {launch.cluster} blocks, the portable "
                   f"maximum is {limits.cluster_portable}")
    if launch.cluster > 1 and launch.grid[0] % launch.cluster:
        out.append(f"grid x = {launch.grid[0]} is not a multiple of the "
                   f"cluster ({launch.cluster})")
    return out


def _outputs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _fill_allocator(torch, device, nbytes: int) -> None:
    """Leave ``nbytes`` of the caching allocator's free blocks holding
    :data:`SENTINEL` (allocated, filled, freed)."""
    if nbytes <= 0:
        return
    t = torch.empty(-(-nbytes // 4), dtype=torch.int32, device=device)
    t.fill_(SENTINEL - (1 << 32) if SENTINEL >= 1 << 31 else SENTINEL)
    del t


def _differences(got, want) -> list[tuple[str, str, str]]:
    """(kind, operand, message) of each output that differs."""
    import torch
    got, want = _outputs(got), _outputs(want)
    if len(got) != len(want):
        return [("KC005", "", f"{len(got)} outputs, the plain version "
                              f"gives {len(want)}")]
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            out.append(("KC005", f"out[{i}]",
                        f"{tuple(g.shape)} {g.dtype}, the plain version "
                        f"{tuple(w.shape)} {w.dtype}"))
            continue
        g, w = g.cpu(), w.cpu()
        if not torch.equal(g, w):
            bad = (g != w).reshape(-1).nonzero()
            out.append(("KC006", f"out[{i}]",
                        f"{bad.numel()} of {g.numel()} elements differ, "
                        f"the first at flat index {int(bad[0])}: "
                        f"{g.reshape(-1)[bad[0]].item()} against "
                        f"{w.reshape(-1)[bad[0]].item()}"))
    return out


def check_case(kernel: str, case, limits, device=None,
               execute: bool = False, attributes: Optional[dict] = None,
               executable_only: bool = False) -> tuple[list, dict]:
    """Check one registry case; returns (findings, report).

    Every case: KC004 on its launches. With ``execute`` (and, on the CPU
    or with ``executable_only``, ``case.execute``): the wrapper against
    its plain version on ``device`` (KC005, KC006); on the card also its
    launch count (KC000)."""
    import torch

    from repro_torch.kernels import dispatch, ops
    findings: list = []
    launches = case.geometry(limits) if case.geometry else ()
    for i, launch in enumerate(launches):
        for msg in check_launch(launch, limits, attributes):
            findings.append(Finding("KC004", kernel, case.label,
                                    f"launch[{i}]", msg))
    if case.launches and case.launches not in ops.launch_counts():
        findings.append(Finding("KC000", kernel, case.label, "",
                                f"launch count {case.launches!r} is not "
                                "one of ops.launch_counts()'s"))
    report = {"launches": [launch.to_json() for launch in launches],
              "launch_count": case.launches, "execute": case.execute,
              "differential": None}
    dev = torch.device(device or "cpu")
    if not execute or (not case.execute and (dev.type == "cpu"
                                              or executable_only)):
        return findings, report
    args = case.tensors(dev)

    def fresh():
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)
    with dispatch.forced_mode("ref"):
        want = case.ref(*fresh())
    if dev.type == "cuda":
        out_bytes = sum(w.numel() * w.element_size() for w in _outputs(want))
        call_args = fresh()
        _fill_allocator(torch, dev, 2 * out_bytes)
        ops.reset_launch_counts()
        got = case.fn(*call_args)
        torch.cuda.synchronize(dev)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        if counts != {case.launches: 1}:
            findings.append(Finding(
                "KC000", kernel, case.label, "",
                f"launched {counts or 'nothing'}, expected "
                f"{{{case.launches!r}: 1}}"))
    else:
        got = case.fn(*fresh())
    diffs = _differences(got, want)
    for kind, operand, msg in diffs:
        findings.append(Finding(kind, kernel, case.label, operand, msg))
    report["differential"] = "equal" if not diffs else "differs"
    return findings, report


def check_entry(entry, limits, device=None, execute: bool = False,
                attributes: Optional[dict] = None,
                executable_only: bool = False) -> tuple[list, dict]:
    """Sweep one registry entry over its sizes."""
    findings: list = []
    cases: dict = {}
    for size in entry.sizes():
        case = entry.build(**size)
        f, cases[case.label] = check_case(entry.name, case, limits, device,
                                          execute, attributes,
                                          executable_only)
        findings.extend(f)
    return findings, {"meta": entry.meta() if entry.meta else {},
                      "cases": cases}


def card_facts(device) -> tuple:
    """(limits, compiled attributes by kernel) of a CUDA ``device``."""
    import torch

    from repro_torch.kernels import _build
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    attributes = {}
    with torch.cuda.device(index):
        _build.build()
        for name in _build.SOURCES:
            attributes.update(_build.kernel_attributes(name))
    return _build.device_limits(index), attributes


def run_registry(device=None, execute: bool = False,
                 entries: Optional[Iterable] = None,
                 executable_only: bool = False) -> tuple[list, dict]:
    """Check every registered kernel; returns (findings, inventory).

    ``device`` None is the current CUDA device (``RuntimeError`` when
    there is no card). A CUDA device: the card's own limits and compiled
    attributes, and with ``execute`` every case through its kernel. The
    CPU, asked for by name: KC004 against an H100's limits, and with
    ``execute`` the wrappers' CPU route against the plain versions."""
    import torch

    from repro_torch.kernels import geometry, ops, registry
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to check "
                               "the geometry against an H100's limits on "
                               "the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    limits, attributes = geometry.H100, None
    if dev.type == "cuda":
        limits, attributes = card_facts(dev)
    entries = tuple(entries) if entries is not None else registry()
    findings: list = []
    kernels: dict = {}
    for entry in entries:
        f, kernels[entry.name] = check_entry(entry, limits, dev, execute,
                                             attributes, executable_only)
        findings.extend(f)
    inv = {
        "schema": 1,
        "torch_version": torch.__version__,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "limits": dataclasses.asdict(limits),
        "compiled": attributes,
        "kernels": kernels,
        "fallback_events": ops.fallback_counts(),
        "findings": [f.to_json() for f in findings],
        "ok": not findings,
    }
    return findings, inv


# --- the sanitizer pass ------------------------------------------------------

SANITIZER_TOOLS = {"memcheck": "KC003", "racecheck": "KC001"}
_SUMMARY_RE = re.compile(r"ERROR SUMMARY:\s*(\d+) error")
_UNSUPPORTED_RE = re.compile(r"=+ Error: Device not supported")


def sanitizer_unsupported(text: str) -> bool:
    """Whether ``compute-sanitizer`` refused the device (it then reports
    the program's failed CUDA calls as errors: they are the tool's, not
    the kernels')."""
    return bool(_UNSUPPORTED_RE.search(text))


def compute_sanitizer() -> str:
    """Path of the CUDA toolkit's ``compute-sanitizer`` (on PATH, else
    under CUDA_HOME, default /usr/local/cuda). Raises when there is none."""
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "compute-sanitizer")
    if os.path.exists(path):
        return path
    raise RuntimeError("compute-sanitizer not found on PATH or under "
                       "CUDA_HOME")


def sanitize(timeout: float = 180.0, tools=tuple(SANITIZER_TOOLS)
             ) -> tuple[list, dict]:
    """Rerun the registry's executable cases on the card under each
    ``compute-sanitizer`` tool, one subprocess each, within ``timeout``
    seconds in all. Each error the tool reports is a finding (KC003 for
    memcheck, KC001 for racecheck); so is a tool that does not finish. A
    tool that refuses the device (:func:`sanitizer_unsupported`) is
    reported with ``"unsupported": true`` and no finding, and the pass
    stops there: the kernels were not checked."""
    import time
    exe = compute_sanitizer()
    findings: list = []
    report: dict = {}
    end = time.monotonic() + timeout
    for tool in tools:
        cmd = [exe, "--tool", tool, "--error-exitcode", "99",
               sys.executable, "-m", "repro_torch.analysis", "kernels",
               "--execute", "--device", "cuda", "--executable-only"]
        left = end - time.monotonic()
        t0 = time.monotonic()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            findings.append(Finding(SANITIZER_TOOLS[tool], "registry",
                                    tool, "", f"{tool} did not finish "
                                    f"within the {timeout:.0f} s limit"))
            report[tool] = {"timeout": True}
            continue
        text = proc.stdout + proc.stderr
        if sanitizer_unsupported(text):
            report[tool] = {"unsupported": True,
                            "seconds": time.monotonic() - t0,
                            "tail": text[:2000]}
            break
        m = _SUMMARY_RE.search(text)
        errors = int(m.group(1)) if m else None
        report[tool] = {"returncode": proc.returncode, "errors": errors,
                        "seconds": time.monotonic() - t0,
                        "tail": text[-2000:]}
        if errors is None or errors or proc.returncode not in (0,):
            findings.append(Finding(
                SANITIZER_TOOLS[tool], "registry", tool, "",
                f"{tool} reported {errors} error(s), exit code "
                f"{proc.returncode}: {text[-400:]}"))
    return findings, report


# --- baseline diffing --------------------------------------------------------

def structural_view(inv: dict) -> dict:
    """The reviewed subtree of an inventory: the limits, each case's
    launches and launch count, each entry's static facts and (from a card)
    the compiled attributes. Drops the volatile fields (versions, the
    differential's status, the findings)."""
    return {
        "limits": inv.get("limits", {}),
        "compiled": inv.get("compiled"),
        "kernels": {
            name: {"meta": k.get("meta", {}),
                   "cases": {label: {"launches": c.get("launches", []),
                                     "launch_count": c.get("launch_count")}
                             for label, c in k.get("cases", {}).items()}}
            for name, k in inv.get("kernels", {}).items()},
    }


def diff_paths(base: dict, new: dict, prefix: str = "") -> list:
    """Dotted paths at which two (JSON-shaped) structures disagree."""
    base = json.loads(json.dumps(base))
    new = json.loads(json.dumps(new))
    out: list = []

    def walk(a, b, path):
        if type(a) is not type(b):
            out.append(path or "<root>")
        elif isinstance(a, dict):
            for key in sorted(set(a) | set(b)):
                p = f"{path}.{key}" if path else str(key)
                if key not in a or key not in b:
                    out.append(p)
                else:
                    walk(a[key], b[key], p)
        elif isinstance(a, list):
            if len(a) != len(b):
                out.append(path or "<root>")
            else:
                for i, (x, y) in enumerate(zip(a, b)):
                    walk(x, y, f"{path}[{i}]")
        elif a != b:
            out.append(path or "<root>")

    walk(base, new, prefix)
    return out
