"""Command line of the port's analysis tools.

  python -m repro_torch.analysis [lint] [paths...] [--format F]
      spmdlint over the configured paths (exit 1 on any violation)

  python -m repro_torch.analysis audit [--ranks N] [--out FILE]
      spawn N gloo ranks on the CPU (default 2), run the gate programs
      under the c10d recorder and check their collectives (exit 1 on any
      problem)

  python -m repro_torch.analysis kernels [--device D] [--execute]
                                         [--sanitize] [--out FILE]
      the kernel checker over the registry: launch geometry against the
      card's own limits and the compiled attributes (against an H100's
      limits with --device cpu; exit 2 when there is no card and no
      --device cpu), with --execute each wrapper against its plain
      version, with --sanitize the executable cases again under
      compute-sanitizer memcheck and racecheck (exit 1 on any finding)

  python -m repro_torch.analysis flow [--ranks N] [--no-digest] [--out F]
      flowcheck: RNG lineage and axis roles on N gloo ranks (default 4),
      spec-digest soundness on the CPU (exit 1 on any finding)

Every subcommand takes ``--format text|json|github`` (the reference's
sarif log is not kept: no code-scanning upload reads the port's). The
port of the JAX package's ``repro.analysis.cli``, its exit codes kept: 0
clean, 1 findings, 2 a bad command line.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from repro_torch.analysis.linter import (Violation, find_repo_root,
                                         lint_paths, load_config)

FORMATS = ("text", "json", "github")


def format_violations(violations: Sequence[Violation], fmt: str) -> str:
    if fmt == "github":
        return "\n".join(
            f"::error file={v.path},line={v.line},col={v.col},"
            f"title={v.rule}::{v.message}" for v in violations)
    if fmt == "json":
        return json.dumps([vars(v) for v in violations], indent=2)
    return "\n".join(v.format() for v in violations)


def _validate_out(ap: argparse.ArgumentParser, out: Optional[str]) -> None:
    """Fail --out before any long run when it cannot be written."""
    if out is None:
        return
    import os
    path = os.path.abspath(out)
    parent = os.path.dirname(path)
    if not os.path.isdir(parent):
        ap.error(f"--out {out}: parent directory {parent} does not exist")
    if not os.access(parent, os.W_OK):
        ap.error(f"--out {out}: parent directory {parent} is not writable")
    if os.path.isdir(path):
        ap.error(f"--out {out}: is a directory, not a writable file path")
    if os.path.exists(path) and not os.access(path, os.W_OK):
        ap.error(f"--out {out}: existing file is not writable")


def _write(out: Optional[str], inv: dict, tool: str) -> None:
    if out:
        with open(out, "w") as f:
            json.dump(inv, f, indent=2, sort_keys=True)
        print(f"{tool}: wrote {out}", file=sys.stderr)


def _report(tool: str, findings: list, fmt: str, inv: dict) -> int:
    """Print the findings (``Finding.format()``; github annotations) and
    return the exit code."""
    if fmt == "json":
        print(json.dumps(inv, indent=2, sort_keys=True))
    elif fmt == "github":
        for f in findings:
            print(f"::error title={f.kind}::{f.format()}")
    for f in findings:
        print(f"{tool} FAIL {f.format()}", file=sys.stderr)
    if findings:
        print(f"{tool}: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    if fmt == "text":
        print(f"{tool}: clean")
    return 0


def lint_main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis lint",
        description="spmdlint for the port (rules TRP001..)")
    ap.add_argument("paths", nargs="*",
                    help="repo-relative paths (default: the configured)")
    ap.add_argument("--format", choices=FORMATS, default="text")
    ap.add_argument("--root", default=None,
                    help="repo root (default: nearest pyproject.toml)")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ns = ap.parse_args(argv)

    from repro_torch.analysis.rules import all_rules, rules_by_id
    if ns.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.title}")
        return 0
    root = ns.root or find_repo_root()
    rules = rules_by_id(ns.select.split(",")) if ns.select else None
    violations = lint_paths(root, paths=ns.paths or None, rules=rules,
                            config=load_config(root))
    if violations:
        print(format_violations(violations, ns.format))
        if ns.format != "json":
            print(f"spmdlint: {len(violations)} violation(s)",
                  file=sys.stderr)
        return 1
    print("[]" if ns.format == "json" else "spmdlint: clean")
    return 0


def audit_main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis audit",
        description="c10d collective audit over gloo ranks on the CPU")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="write the JSON inventory here")
    ap.add_argument("--format", choices=FORMATS, default="text")
    ns = ap.parse_args(argv)
    _validate_out(ap, ns.out)
    if ns.ranks < 1:
        ap.error("--ranks must be >= 1")

    from repro_torch.analysis import audit
    inv = audit.run_audit(ns.ranks)
    _write(ns.out, inv, "audit")
    rc = 0
    for label, a in sorted(inv["programs"].items()):
        if ns.format == "text":
            print(f"audit {'OK  ' if a['ok'] else 'FAIL'} {label}: "
                  f"{a['counts_by_kind']} all_to_alls={a['all_to_alls']}"
                  f"(expect {a['expected_all_to_alls']}) "
                  f"rounds={a['rounds']} uniform={a['uniform']}")
        elif ns.format == "github":
            for p in a["problems"]:
                print(f"::error title=SPMD-AUDIT::{label}: {p}")
        for p in a["problems"]:
            print(f"  problem: {label}: {p}", file=sys.stderr)
            rc = 1
    if ns.format == "json":
        print(json.dumps(inv, indent=2, sort_keys=True))
    return rc


def kernels_main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis kernels",
        description="the kernel checker over the registry")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's limits, the default) or cpu "
                         "(an H100's)")
    ap.add_argument("--execute", action="store_true",
                    help="run each wrapper against its plain version")
    ap.add_argument("--executable-only", action="store_true",
                    help="with --execute on the card, only the cases the "
                         "reference runs (the sanitizer's sizes)")
    ap.add_argument("--sanitize", action="store_true",
                    help="rerun the executable cases under "
                         "compute-sanitizer memcheck and racecheck")
    ap.add_argument("--out", default=None,
                    help="write the kernel inventory JSON here")
    ap.add_argument("--format", choices=FORMATS, default="text")
    ns = ap.parse_args(argv)
    _validate_out(ap, ns.out)
    import torch
    if torch.device(ns.device).type == "cuda" \
            and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to check the geometry "
                 "against an H100's limits on the CPU")

    from repro_torch.analysis import kernelcheck
    findings, inv = kernelcheck.run_registry(
        device=ns.device, execute=ns.execute,
        executable_only=ns.executable_only)
    if ns.sanitize:
        f, inv["sanitizer"] = kernelcheck.sanitize()
        findings += f
        inv["findings"] += [x.to_json() for x in f]
        inv["ok"] = not findings
    _write(ns.out, inv, "kernels")
    if ns.format == "text":
        n_cases = sum(len(k["cases"]) for k in inv["kernels"].values())
        n_launch = sum(len(c["launches"]) for k in inv["kernels"].values()
                       for c in k["cases"].values())
        ran = sum(c["differential"] is not None
                  for k in inv["kernels"].values()
                  for c in k["cases"].values())
        print(f"kernels: {len(inv['kernels'])} kernel(s), {n_cases} "
              f"case(s), {n_launch} launch(es) against {inv['device']}'s "
              f"limits ({inv['limits']['smem_optin']} B opt-in shared "
              f"memory), {ran} case(s) run against the plain version")
    return _report("kernels", findings, ns.format, inv)


def flow_main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis flow",
        description="flowcheck: RNG lineage, axis roles, digest soundness")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--no-digest", action="store_true",
                    help="skip FC003 (spec-digest soundness)")
    ap.add_argument("--out", default=None,
                    help="write the flow inventory JSON here")
    ap.add_argument("--format", choices=FORMATS, default="text")
    ns = ap.parse_args(argv)
    _validate_out(ap, ns.out)
    if ns.ranks < 1:
        ap.error("--ranks must be >= 1")

    from repro_torch.analysis import flowcheck
    findings, inv = flowcheck.run_flow(ns.ranks, digest=not ns.no_digest)
    _write(ns.out, inv, "flowcheck")
    if ns.format == "text":
        for label, p in sorted(inv["programs"].items()):
            draws = ",".join(f"{k}x{v[0]}" for k, v in
                             sorted(p.get("draws", {}).items()))
            print(f"flowcheck {'OK  ' if p.get('ok') else 'FAIL'} {label}: "
                  f"draws=[{draws}]")
        for topo, entries in sorted(inv["transposes"].items()):
            ok = all(e["ok"] for e in entries.values())
            print(f"flowcheck {'OK  ' if ok else 'FAIL'} {topo}: roles "
                  f"verified for {sorted(entries)}")
        if inv["digest_fields"]:
            print(f"flowcheck: digest soundness over "
                  f"{len(inv['digest_fields'])} GraphSpec field(s)")
    return _report("flowcheck", findings, ns.format, inv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    sub = {"audit": audit_main, "kernels": kernels_main, "flow": flow_main,
           "lint": lint_main}
    if argv and argv[0] in sub:
        return sub[argv[0]](argv[1:])
    return lint_main(argv)
