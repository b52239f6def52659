"""Static and dynamic analysis of the port (counterpart of ``metrics_tpu/analysis``): jitlint, distlint, donlint,
hotlint, numlint and racelint, and the runtime contracts that hold each static verdict to what really runs.

Six static passes read the port's source:

* **jitlint** (:mod:`~metrics_tpu_torch.analysis.rules`, JL001-JL006): host reads of tensors in traced code
  (the bodies the fleet engine runs under ``torch.func.vmap``), ``torch.compile`` of free str/bool config
  params, the state contract, dtype promotion, side effects and namespace drift;
* **distlint** (:mod:`~metrics_tpu_torch.analysis.dist_rules`, DL001-DL005): undeclared reduction algebra,
  non-additive folds in ``update``, merge-fragile ``compute`` bodies, raw ``torch.distributed`` collectives
  outside the sync layer, and ``merge_state`` overrides that drop states;
* **donlint** (:mod:`~metrics_tpu_torch.analysis.mem_rules`, ML001-ML006): state tensors that escape
  ``update``/``compute`` without a clone, states bound to one tensor, shape-stackable list states,
  unjustified ``donate_states=False`` opt-outs, and ``reset`` overrides that re-bind shared defaults;
* **hotlint** (:mod:`~metrics_tpu_torch.analysis.sync_rules`, HL001-HL006): host reads of the card in hot
  host code (``.item()``, ``bool(t)``, data-dependent output sizes), device truthiness, per-element loops,
  per-call compiles, unannotated synchronizes, host allocation in tick paths;
* **numlint** (:mod:`~metrics_tpu_torch.analysis.num_rules`, NL001-NL006): unguarded division,
  catastrophic cancellation, domain edges, narrow accumulators, fold demotion, undeclared reassociation;
* **racelint** (:mod:`~metrics_tpu_torch.analysis.race_rules`, RC001-RC006): control-plane writes from more
  than one context, acks and watermarks not dominated by their fsync, staged or in-flight host buffers
  mutated, autonomic actions off the allowlist or gate, WAL appends blind to the replay latch, and
  iterate-while-mutate.

Nine runtime contracts run the registry through an algebra, fault, precision, lifecycle, build-cache or
ordering check and ratchet the verdicts against baselines in ``metrics_tpu_torch/analysis/baselines/``:
:mod:`~metrics_tpu_torch.analysis.abstract_contracts` (every functional kernel under ``FakeTensorMode``),
:mod:`~metrics_tpu_torch.analysis.merge_contracts`, :mod:`~metrics_tpu_torch.analysis.donation_contracts`,
:mod:`~metrics_tpu_torch.analysis.transfer_contracts`, :mod:`~metrics_tpu_torch.analysis.precision_contracts`,
:mod:`~metrics_tpu_torch.analysis.aot_contracts`, :mod:`~metrics_tpu_torch.analysis.fleet_contracts`,
:mod:`~metrics_tpu_torch.analysis.chaos_contracts`, :mod:`~metrics_tpu_torch.analysis.interleave_contracts`.
The rule-code tables, baseline format and suppression grammar are the JAX package's.

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
from metrics_tpu_torch.analysis.dist_rules import DIST_RULES
from metrics_tpu_torch.analysis.engine import (
    LintResult,
    SourceMarkers,
    diff_against_baseline,
    lint_file,
    lint_paths,
    load_baseline,
    load_baseline_section,
    write_baseline,
    write_baseline_section,
)
from metrics_tpu_torch.analysis.mem_rules import MEM_RULES
from metrics_tpu_torch.analysis.num_rules import NUM_RULES, classify_precision
from metrics_tpu_torch.analysis.race_rules import RACE_RULES
from metrics_tpu_torch.analysis.rules import ALL_RULES, ModuleInfo
from metrics_tpu_torch.analysis.sync_rules import SYNC_RULES

__all__ = [
    "ALL_RULES",
    "DIST_RULES",
    "DIST_RULE_CODES",
    "LINT_PREFIXES",
    "LintResult",
    "MEM_RULES",
    "MEM_RULE_CODES",
    "ModuleInfo",
    "NUM_RULES",
    "NUM_RULE_CODES",
    "RACE_RULES",
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
