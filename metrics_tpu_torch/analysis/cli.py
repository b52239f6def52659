"""Analysis command line: ``python -m metrics_tpu_torch.analysis.cli`` (counterpart of
``metrics_tpu/analysis/cli.py``).

Six static passes share one engine and one exit-code contract, each baselined in
``metrics_tpu_torch/analysis/baselines/``:

* ``jitlint``: tracer-safety and recompilation rules JL001-JL006 (``jitlint_baseline.json``);
* ``distlint``: merge-soundness and collective-safety rules DL001-DL005 (the ``entries`` section of
  ``distlint_baseline.json``);
* ``donlint``: state escape and alias rules ML001-ML006 (the ``entries`` section of ``donlint_baseline.json``);
* ``hotlint``: host-sync and dispatch-economy rules HL001-HL006 over the hot-path modules
  (``hotlint_baseline.json``);
* ``numlint``: numerical-soundness rules NL001-NL006 (the ``rules`` section of ``numlint_baseline.json``);
* ``racelint``: concurrency and ordering rules RC001-RC006 over the control plane (the ``rules`` section of
  ``racelint_baseline.json``).

Ten dynamic passes ride the same selection and exit codes, cheap first, each on ``--device`` (the card by
default):

* ``telemetry``: the disabled, watchdog and meter overhead budgets (:mod:`~metrics_tpu_torch.observe.overhead`);
* ``donation``: 3-update loops against the static donlint verdict and ``costs.py``'s eligibility
  (:mod:`~metrics_tpu_torch.analysis.donation_contracts`, the ``donation`` section of ``donlint_baseline.json``);
* ``interleave``: the real server, engine, producer and autonomic stack through 1,100 schedules
  (:mod:`~metrics_tpu_torch.analysis.interleave_contracts`, the ``interleave`` section of
  ``racelint_baseline.json``);
* ``merge``: split-update-merge against the single stream (:mod:`~metrics_tpu_torch.analysis.merge_contracts`);
* ``transfer``: steady update loops and fleet ticks under a host-read guard
  (:mod:`~metrics_tpu_torch.analysis.transfer_contracts`);
* ``precision``: float32 streams against a float64 oracle and five adversarial regimes
  (:mod:`~metrics_tpu_torch.analysis.precision_contracts`);
* ``aot``: the kernel libraries each update loads, reloaded from their manifests with no build
  (:mod:`~metrics_tpu_torch.analysis.aot_contracts`, ``aot_baseline.json``);
* ``fleet``: a churning 4-slot ``StreamEngine`` bucket per class (:mod:`~metrics_tpu_torch.analysis.fleet_contracts`);
* ``chaos``: fault injection into updates, fleets, sharded fleets and the front door
  (:mod:`~metrics_tpu_torch.analysis.chaos_contracts`);
* ``perf``: cost profiles of the registry and the fleet smoke against their ratchet
  (:mod:`~metrics_tpu_torch.observe.profile`).

Select passes with ``--pass <name>`` or run everything with ``--all``; ``--format json`` (or ``--json``) prints
one machine-readable document. Exit codes: 0 clean (or fully baselined), 1 new violations or regressions in any
selected pass, 2 usage or parse error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from metrics_tpu_torch.analysis.contexts import (
    DIST_RULE_CODES,
    MEM_RULE_CODES,
    NUM_RULE_CODES,
    RACE_RULE_CODES,
    RULE_CODES,
    SYNC_RULE_CODES,
)
from metrics_tpu_torch.analysis.engine import (
    PACKAGE_DIR,
    REPO_ROOT,
    diff_against_baseline,
    lint_paths,
    load_baseline,
    write_baseline,
)

__all__ = [
    "main",
    "main_chaoslint",
    "main_distlint",
    "main_donlint",
    "main_hotlint",
    "main_numlint",
    "main_racelint",
]

BASELINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines")

# "section" names the baseline section the static pass owns (numlint and racelint share their files with a
# dynamic pass)
_PASSES: Dict[str, Dict[str, Any]] = {
    "jitlint": {"rules": RULE_CODES, "baseline": os.path.join(BASELINE_DIR, "jitlint_baseline.json")},
    "distlint": {"rules": DIST_RULE_CODES, "baseline": os.path.join(BASELINE_DIR, "distlint_baseline.json")},
    "donlint": {"rules": MEM_RULE_CODES, "baseline": os.path.join(BASELINE_DIR, "donlint_baseline.json")},
    "hotlint": {"rules": SYNC_RULE_CODES, "baseline": os.path.join(BASELINE_DIR, "hotlint_baseline.json")},
    "numlint": {"rules": NUM_RULE_CODES, "baseline": os.path.join(BASELINE_DIR, "numlint_baseline.json"),
                "section": "rules"},
    "racelint": {"rules": RACE_RULE_CODES, "baseline": os.path.join(BASELINE_DIR, "racelint_baseline.json"),
                 "section": "rules"},
}

# dynamic passes, cheap first for --all (the JAX package's order, with merge before transfer)
_DYNAMIC = ("telemetry", "donation", "interleave", "merge", "transfer", "precision", "aot", "fleet", "chaos", "perf")


def _dynamic_runner(name: str) -> Callable[..., int]:
    """A dynamic pass's ``run_*_check``, imported on use (each builds the metric registry)."""
    if name == "telemetry":
        from metrics_tpu_torch.observe.overhead import run_telemetry_check

        return run_telemetry_check
    if name == "donation":
        from metrics_tpu_torch.analysis.donation_contracts import run_donation_check

        return run_donation_check
    if name == "interleave":
        from metrics_tpu_torch.analysis.interleave_contracts import run_interleave_check

        return run_interleave_check
    if name == "aot":
        from metrics_tpu_torch.analysis.aot_contracts import run_aot_check

        return run_aot_check
    if name == "perf":
        from metrics_tpu_torch.observe.profile import run_perf_check

        return run_perf_check
    if name == "merge":
        from metrics_tpu_torch.analysis.merge_contracts import run_merge_check

        return run_merge_check
    if name == "transfer":
        from metrics_tpu_torch.analysis.transfer_contracts import run_transfer_check

        return run_transfer_check
    if name == "precision":
        from metrics_tpu_torch.analysis.precision_contracts import run_precision_check

        return run_precision_check
    if name == "fleet":
        from metrics_tpu_torch.analysis.fleet_contracts import run_fleet_check

        return run_fleet_check
    from metrics_tpu_torch.analysis.chaos_contracts import run_chaos_check

    return run_chaos_check


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="metrics_tpu_torch.analysis.cli",
        description="Static and dynamic analysis of metrics_tpu_torch: jitlint (JL001-JL006), distlint "
                    "(DL001-DL005), donlint (ML001-ML006), hotlint (HL001-HL006), numlint (NL001-NL006), "
                    "racelint (RC001-RC006), and the dynamic contracts.",
    )
    p.add_argument("targets", nargs="*", default=None,
                   help="files or directories to lint (default: the metrics_tpu_torch package)")
    p.add_argument("--root", default=None, help="root the lint paths are relative to (default: the repository)")
    p.add_argument("--pass", dest="passes", action="append", choices=sorted([*_PASSES, *_DYNAMIC]),
                   help="which pass to run (repeatable; default: jitlint)")
    p.add_argument("--all", action="store_true", dest="run_all", help="run every pass in one invocation")
    p.add_argument("--list-rules", action="store_true", dest="list_rules",
                   help="print every rule code with its one-line summary (and the dynamic passes) and exit 0")
    p.add_argument("--rules", default=None, help="comma-separated rule codes to run (overrides --pass)")
    p.add_argument("--baseline", default=None, help="baseline JSON path override (one selected pass only)")
    p.add_argument("--no-baseline", action="store_true", help="ignore the static baselines")
    p.add_argument("--update-baseline", action="store_true",
                   help="write the current violations as the new baseline(s) and exit 0")
    p.add_argument("--device", default="cuda", help="where the dynamic passes run (default: the card)")
    p.add_argument("--format", choices=("text", "json"), default="text", dest="fmt")
    p.add_argument("--json", action="store_const", const="json", dest="fmt", help="shorthand for --format json")
    p.add_argument("-q", "--quiet", action="store_true", help="suppress the summary lines")
    return p


def _selected_passes(args: argparse.Namespace) -> List[str]:
    if args.run_all:
        return sorted(_PASSES) + list(_DYNAMIC)
    if args.passes:
        return list(dict.fromkeys(args.passes))
    return ["jitlint"]


def _pass_rules(name: str, explicit: Optional[List[str]]) -> List[str]:
    codes = list(_PASSES[name]["rules"])
    return codes if explicit is None else [c for c in explicit if c in codes]


def _list_rules(fmt: str) -> int:
    from metrics_tpu_torch.analysis import dist_rules, mem_rules, num_rules, race_rules, rules, sync_rules

    summaries = {"jitlint": rules.SUMMARIES, "distlint": dist_rules.SUMMARIES, "donlint": mem_rules.SUMMARIES,
                 "hotlint": sync_rules.SUMMARIES, "numlint": num_rules.SUMMARIES, "racelint": race_rules.SUMMARIES}
    if fmt == "json":
        print(json.dumps({"passes": summaries, "dynamic": list(_DYNAMIC)}, indent=2))
        return 0
    for name in sorted(_PASSES):
        for code in _PASSES[name]["rules"]:
            print(f"{code}  [{name}]  {summaries[name].get(code, '(no summary)')}")
    print(f"dynamic passes (no rule codes): {', '.join(_DYNAMIC)}")
    return 0


def _run_static(name: str, rules: List[str], targets: List[str], root: str, args: argparse.Namespace,
                report: Dict[str, Any], t_start: float) -> Optional[int]:
    """One static pass; its exit code, or None for a pass that only wrote its baseline."""
    result = lint_paths(targets, root=root, rules=rules)
    if result.parse_errors:
        for err in result.parse_errors:
            print(f"{name}: parse error: {err}", file=sys.stderr)
        return 2
    baseline_path = args.baseline or str(_PASSES[name]["baseline"])
    section = str(_PASSES[name].get("section", "entries"))
    if args.update_baseline:
        entries = write_baseline(baseline_path, result.violations, section=section)
        if not args.quiet:
            print(f"{name}: baseline written to {baseline_path} ({len(entries)} keys, "
                  f"{sum(entries.values())} violations)")
        return None
    baseline = {} if args.no_baseline else load_baseline(baseline_path, section=section)
    new, baselined, stale = diff_against_baseline(result.violations, baseline)
    if args.fmt == "json":
        report[name] = {
            "status": "fail" if new else "ok",
            "files_scanned": result.files_scanned,
            "by_rule": result.by_rule(),
            "new": [v.__dict__ for v in new],
            "baselined": baselined,
            "inline_suppressed": result.suppressed,
            "stale_baseline_keys": stale,
            "wall_s": round(time.perf_counter() - t_start, 3),
        }
    else:
        for v in new:
            print(v.render())
        for key in stale:
            print(f"{name}: stale baseline entry (no longer matches): {key}")
        if not args.quiet:
            by_rule: Dict[str, int] = {}
            for v in new:
                by_rule[v.rule] = by_rule.get(v.rule, 0) + 1
            detail = ", ".join(f"{k}={n}" for k, n in sorted(by_rule.items())) or "none"
            print(f"{name}: {result.files_scanned} files, {len(new)} new violation(s) [{detail}], "
                  f"{baselined} baselined, {result.suppressed} inline-suppressed")
    return 1 if new else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        return _list_rules(args.fmt)
    root = os.path.abspath(args.root or REPO_ROOT)
    targets = [t if os.path.isabs(t) else os.path.join(root, t) for t in (args.targets or [PACKAGE_DIR])]
    missing = [t for t in targets if not os.path.exists(t)]
    if missing:
        print(f"lint: no such file or directory: {', '.join(missing)}", file=sys.stderr)
        return 2
    explicit_rules: Optional[List[str]] = None
    if args.rules:
        explicit_rules = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
    passes = _selected_passes(args)
    if explicit_rules is not None and not args.passes and not args.run_all:
        passes = [name for name in sorted(_PASSES) if _pass_rules(name, explicit_rules)]
        if not passes:
            print(f"lint: no known rule codes in --rules={args.rules}", file=sys.stderr)
            return 2
    if args.baseline and len(passes) > 1:
        print("lint: --baseline requires a single selected pass", file=sys.stderr)
        return 2

    exit_code = 0
    report: Dict[str, Any] = {}
    for name in passes:
        t_start = time.perf_counter()
        if name in _DYNAMIC:
            if explicit_rules is not None:
                continue  # dynamic passes have no rule codes
            pass_report: Optional[Dict[str, Any]] = {} if args.fmt == "json" else None
            rc = _dynamic_runner(name)(
                root, baseline_path=args.baseline if len(passes) == 1 else None,
                update_baseline=args.update_baseline, quiet=args.quiet, report=pass_report, device=args.device,
            )
            if pass_report is not None:
                pass_report["status"] = "fail" if rc else "ok"
                pass_report["wall_s"] = round(time.perf_counter() - t_start, 3)
                report[name] = pass_report
            exit_code = exit_code or (1 if rc else 0)
            continue
        rules = _pass_rules(name, explicit_rules)
        if not rules:
            continue
        rc = _run_static(name, rules, targets, root, args, report, t_start)
        if rc == 2:
            return 2
        if rc:
            exit_code = 1
    if args.fmt == "json" and not args.update_baseline:
        if len(report) == 1:
            print(json.dumps(next(iter(report.values())), indent=2))
        else:
            print(json.dumps({"passes": report, "exit_code": exit_code}, indent=2))
    return exit_code


def main_distlint(argv: Optional[Sequence[str]] = None) -> int:
    """The DL rules."""
    return main(["--pass", "distlint", *(sys.argv[1:] if argv is None else argv)])


def main_donlint(argv: Optional[Sequence[str]] = None) -> int:
    """The ML rules and the donation cross-check."""
    return main(["--pass", "donlint", "--pass", "donation", *(sys.argv[1:] if argv is None else argv)])


def main_hotlint(argv: Optional[Sequence[str]] = None) -> int:
    """The HL rules and the transfer cross-check."""
    return main(["--pass", "hotlint", "--pass", "transfer", *(sys.argv[1:] if argv is None else argv)])


def main_numlint(argv: Optional[Sequence[str]] = None) -> int:
    """The NL rules and the precision cross-check."""
    return main(["--pass", "numlint", "--pass", "precision", *(sys.argv[1:] if argv is None else argv)])


def main_racelint(argv: Optional[Sequence[str]] = None) -> int:
    """The RC rules and the interleaving harness."""
    return main(["--pass", "racelint", "--pass", "interleave", *(sys.argv[1:] if argv is None else argv)])


def main_chaoslint(argv: Optional[Sequence[str]] = None) -> int:
    """The fault-injection pass."""
    return main(["--pass", "chaos", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
