"""Static and dynamic analysis of the port (counterpart of ``metrics_tpu/analysis``).

Two static passes read the port's source:

* **hotlint** (:mod:`~metrics_tpu_torch.analysis.sync_rules`, HL001-HL006): host reads of the card in hot
  host code (``.item()``, ``bool(t)``, data-dependent output sizes), device truthiness, per-element loops,
  per-call compiles, unannotated synchronizes, host allocation in tick paths;
* **numlint** (:mod:`~metrics_tpu_torch.analysis.num_rules`, NL001-NL006): unguarded division,
  catastrophic cancellation, domain edges, narrow accumulators, fold demotion, undeclared reassociation.

Five runtime contracts run every registered class through an algebra, fault or precision check and ratchet
the verdicts against baselines in ``metrics_tpu_torch/analysis/baselines/``:
:mod:`~metrics_tpu_torch.analysis.merge_contracts`, :mod:`~metrics_tpu_torch.analysis.transfer_contracts`,
:mod:`~metrics_tpu_torch.analysis.precision_contracts`, :mod:`~metrics_tpu_torch.analysis.fleet_contracts`,
:mod:`~metrics_tpu_torch.analysis.chaos_contracts`. The rule-code tables, baseline format and suppression
grammar are the JAX package's.

Command line: ``python -m metrics_tpu_torch.analysis.cli [--pass <name> | --all | --list-rules]
[--format json] [--update-baseline] [--device cpu]``.
"""

from metrics_tpu_torch.analysis.contexts import (
    DIST_RULE_CODES,
    LINT_PREFIXES,
    MEM_RULE_CODES,
    NUM_RULE_CODES,
    RACE_RULE_CODES,
    RULE_CODES,
    SYNC_RULE_CODES,
    Suppressions,
    Violation,
)
from metrics_tpu_torch.analysis.engine import (
    LintResult,
    ModuleInfo,
    SourceMarkers,
    diff_against_baseline,
    lint_file,
    lint_paths,
    load_baseline,
    load_baseline_section,
    write_baseline,
    write_baseline_section,
)
from metrics_tpu_torch.analysis.num_rules import NUM_RULES, classify_precision
from metrics_tpu_torch.analysis.sync_rules import SYNC_RULES

__all__ = [
    "DIST_RULE_CODES",
    "LINT_PREFIXES",
    "LintResult",
    "MEM_RULE_CODES",
    "ModuleInfo",
    "NUM_RULES",
    "NUM_RULE_CODES",
    "RACE_RULE_CODES",
    "RULE_CODES",
    "SYNC_RULES",
    "SYNC_RULE_CODES",
    "SourceMarkers",
    "Suppressions",
    "Violation",
    "classify_precision",
    "diff_against_baseline",
    "lint_file",
    "lint_paths",
    "load_baseline",
    "load_baseline_section",
    "write_baseline",
    "write_baseline_section",
]
