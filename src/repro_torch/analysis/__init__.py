"""Static analysis and run audits for the port's invariants.

The port of the JAX package's ``repro.analysis``: the same four layers,
the same subcommands, codes and JSON keys wherever the meaning carries
over. A JAX trace and its HLO have no torch counterpart; in their place
the layers read the port's source or observe its own runs:

  spmdlint (:mod:`.linter`, :mod:`.rules`): an AST pass over the source
  (TRP001..TRP006: one runtime gateway for collectives, no jax or JAX
  package import, kernels behind the registry, deterministic generator
  code, guarded int32 casts, no host sync in the kernel entry points).
  Pure stdlib; importing this package imports nothing else.

  audit (:mod:`.audit`): every c10d dispatcher op a program issues,
  recorded by a ``TorchDispatchMode`` on gloo ranks: all_to_all counts
  against the topology, the pods' hop spans, the same sequence on every
  rank.

  kernels (:mod:`.kernelcheck`): the kernel registry's launch geometry
  against the card's limits, each wrapper against its plain version (on
  the card, bit for bit, over a sentinel-filled allocator), launch
  counts, and ``compute-sanitizer``'s memcheck and racecheck.

  flow (:mod:`.flowcheck`): RNG lineage from tapped draws, the blocked
  transposes' axis roles from tagged tensors, and spec-digest soundness
  from perturbed fields.

CLI: ``python -m repro_torch.analysis [lint|audit|kernels|flow]``.
"""
from repro_torch.analysis.linter import (DEFAULT_PATHS, ImportTable,
                                         LintConfig, Violation,
                                         find_repo_root, lint_paths,
                                         lint_repo, lint_source,
                                         load_config)
from repro_torch.analysis.rules import all_rules, rules_by_id

__all__ = [
    "DEFAULT_PATHS", "ImportTable", "LintConfig", "Violation",
    "find_repo_root", "lint_paths", "lint_repo", "lint_source",
    "load_config", "all_rules", "rules_by_id",
]
