"""Perf-baseline ratchet over the cost report (counterpart of ``metrics_tpu/observe/profile.py``).

``metrics_tpu_torch/observe/perf_baseline.json`` pins, per exported metric class
that the report profiles, the cost of one update (FLOPs, bytes accessed; see
:mod:`metrics_tpu_torch.observe.costs` for their torch meaning) and its sharing
behavior (``shareable`` + observed ``compile_count`` for two config-equal
instances, 0 for an eager update). The check ratchets as the JAX package's does:

* a class whose FLOPs or bytes grow beyond ``tolerance``× its baseline — or
  whose update stops sharing one compiled executable across instances, stops
  persisting through the AOT disk cache (``aot_cacheable`` True→False), or
  starts paying cold-start compiles a warmed cache used to absorb
  (``cold_start_compile_count`` 0→N) — is a **regression**
  (exit 1);
* a class that *improved* beyond tolerance, or vanished from the registry, is
  reported **stale** so the baseline ratchets down over time (exit 0);
* classes with no baseline entry are reported as **new** (exit 0; record them
  with ``--update-baseline``).

FLOPs and bytes are counted over the ops one update dispatches, the same on the
CPU and on the card, so the baseline written on the CPU serves both; the default
1.5× tolerance absorbs op-level drift across torch versions while still failing a
genuinely doubled update. Peak memory (on a CUDA device only) is recorded for
attribution but not ratcheted.

CLI: ``python -m metrics_tpu_torch.observe.profile [--device cpu]`` (the card
unless named); ``--update-baseline`` rewrites the baseline.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from metrics_tpu_torch.observe._baseline import load_baseline_section, write_baseline_section
from metrics_tpu_torch.observe.costs import CostReport, collect_cost_report

__all__ = [
    "DEFAULT_TOLERANCE",
    "diff_cost_baseline",
    "load_cost_baseline",
    "main",
    "run_perf_check",
    "write_cost_baseline",
]

DEFAULT_TOLERANCE = 1.5
_DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "perf_baseline.json")
_RATCHETED = ("flops", "bytes_accessed")


def report_to_dict(results: Sequence[CostReport]) -> Dict[str, Dict[str, Any]]:
    """``{class name: cost dict}`` for the successful cases (the baseline shape)."""
    return {r.case.name: dict(r.cost) for r in results if r.ok}


def load_cost_baseline(path: str) -> Dict[str, Dict[str, Any]]:
    return {str(k): dict(v) for k, v in load_baseline_section(path, "cost").items()}


def write_cost_baseline(path: str, results: Sequence[CostReport]) -> Dict[str, Dict[str, Any]]:
    cost = dict(sorted(report_to_dict(results).items()))
    write_baseline_section(
        path,
        "cost",
        cost,
        "perf baseline — the cost of one metric update (metrics_tpu_torch.observe.costs), keyed by "
        "exported class name. Regenerate with `python -m metrics_tpu_torch.observe.profile --device cpu "
        "--update-baseline`.",
        seed={"tolerance": DEFAULT_TOLERANCE},
    )
    return cost


def diff_cost_baseline(
    results: Sequence[CostReport],
    baseline: Dict[str, Dict[str, Any]],
    tolerance: float = DEFAULT_TOLERANCE,
) -> Tuple[List[str], List[str], List[str]]:
    """Split into (regressions, stale_keys, new_keys); regressions fail the run."""
    regressions: List[str] = []
    new: List[str] = []
    observed = report_to_dict(results)
    for name, cost in sorted(observed.items()):
        base = baseline.get(name)
        if base is None:
            new.append(name)
            continue
        for field in _RATCHETED:
            cur, ref = float(cost.get(field, 0.0)), float(base.get(field, 0.0))
            if ref > 0 and cur > ref * tolerance:
                regressions.append(f"{name}: {field} {cur:.0f} > {tolerance}x baseline {ref:.0f}")
            elif ref == 0 and cur > 0 and field == "flops":
                regressions.append(f"{name}: {field} appeared ({cur:.0f}) where baseline had none")
        if base.get("shareable") and not cost.get("shareable"):
            regressions.append(f"{name}: update no longer shareable (jit-cache key became unhashable)")
        if base.get("donation_eligible") and cost.get("donation_eligible") is False:
            regressions.append(
                f"{name}: update no longer donation-eligible — every jitted step "
                "reallocates the state pytree instead of aliasing it in place"
            )
        # compile_count 0 means the class updates eagerly by design (e.g. the
        # aggregation metrics' host-scalar path) — starting to compile is not a
        # sharing regression, so only ratchet from a baseline of >= 1
        base_compiles = base.get("compile_count")
        cur_compiles = cost.get("compile_count")
        if base_compiles and cur_compiles is not None and cur_compiles > base_compiles:
            regressions.append(
                f"{name}: {cur_compiles} compiles for two config-equal instances "
                f"(baseline {base_compiles}) — jit-cache sharing broke"
            )
        # cold-start ratchet: a baseline of 0 means a warmed AOT
        # cache fully absorbs this class's first-update compile in a fresh
        # process; any compile reappearing there is disk reuse breaking. The
        # == 0 comparison (not falsy) keeps pre-AOT baselines exempt.
        cur_cold = cost.get("cold_start_compile_count")
        if base.get("cold_start_compile_count") == 0 and cur_cold:
            regressions.append(
                f"{name}: {cur_cold} cold-start compile(s) where the baseline had 0 "
                "— AOT disk executable reuse broke"
            )
        if base.get("aot_cacheable") and cost.get("aot_cacheable") is False:
            regressions.append(
                f"{name}: no longer AOT-cacheable — every new process pays this "
                "class's cold-start compile again"
            )
    stale: List[str] = []
    for name, base in sorted(baseline.items()):
        cost = observed.get(name)
        if cost is None:
            stale.append(f"{name}: in baseline but not profiled (class removed or now ineligible)")
            continue
        for field in _RATCHETED:
            cur, ref = float(cost.get(field, 0.0)), float(base.get(field, 0.0))
            if cur > 0 and ref > cur * tolerance:
                stale.append(f"{name}: {field} improved {ref:.0f} -> {cur:.0f}; ratchet the baseline down")
    return regressions, stale, new


def run_perf_check(
    root: str,
    baseline_path: Optional[str] = None,
    tolerance: float = DEFAULT_TOLERANCE,
    include_memory: bool = False,
    update_baseline: bool = False,
    quiet: bool = False,
    report: Optional[Dict[str, Any]] = None,
    device: Union[str, Any, None] = None,
) -> int:
    """Profile on ``device`` (the card unless named), ratchet, one verdict line.

    ``root`` is where a relative ``baseline_path`` is read from. With ``report``
    given, findings are collected into it instead of printed — the caller owns
    the one JSON document on stdout.
    """
    from metrics_tpu_torch.engine.smoke import (  # noqa: PLC0415 — pulls in the registry
        diff_fleet_baseline,
        load_fleet_baseline,
        run_fleet_smoke,
        write_fleet_baseline,
    )

    path = os.path.join(root, baseline_path) if baseline_path else _DEFAULT_BASELINE
    results = collect_cost_report(include_memory=include_memory, device=device)
    failures = [r for r in results if not r.ok]
    fleet_obs = run_fleet_smoke(device=device)
    if update_baseline:
        cost = write_cost_baseline(path, results)
        fleet = write_fleet_baseline(path, fleet_obs)
        if not quiet:
            print(f"perf: baseline written to {path} ({len(cost)} classes + {len(fleet)} fleet keys)")
        return 0
    regressions, stale, new = diff_cost_baseline(results, load_cost_baseline(path), tolerance)
    f_reg, f_stale, f_new = diff_fleet_baseline(fleet_obs, load_fleet_baseline(path))
    regressions += f_reg
    stale += f_stale
    new += f_new
    if report is not None:
        report.update({
            "profiled": sum(1 for r in results if r.ok),
            "cases": len(results),
            "fleet": fleet_obs,
            "regressions": regressions,
            "stale": stale,
            "new": new,
            "skipped": {r.case.name: r.error for r in failures},
        })
        return 1 if regressions else 0
    for line in regressions:
        print(f"perf: REGRESSION {line}")
    if not quiet:
        for line in stale:
            print(f"perf: stale baseline entry: {line}")
        for name in new:
            print(f"perf: new class not in baseline: {name} (record with --update-baseline)")
        for r in failures:
            print(f"perf: skipped {r.case.name}: {r.error}")
        ok = sum(1 for r in results if r.ok)
        print(f"perf: {ok}/{len(results)} classes profiled, {len(regressions)} regression(s), "
              f"{len(stale)} stale, {len(new)} new; fleet smoke: "
              f"{fleet_obs['streams']} streams / {fleet_obs['buckets']} buckets, "
              f"{fleet_obs['dispatches_per_shard_tick']} dispatch(es)/tick, "
              f"{fleet_obs['update_compiles']} update compile(s), "
              f"{fleet_obs['poll_dispatches_per_poll']} compute dispatch(es)/poll")
    return 1 if regressions else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m metrics_tpu_torch.observe.profile",
        description="Cost profiling of metric updates (FLOPs / bytes accessed / peak memory / sharing), "
                    "ratcheted against metrics_tpu_torch/observe/perf_baseline.json.",
    )
    p.add_argument("--root", default=None, help="where a relative --baseline is read from (default: cwd)")
    p.add_argument("--baseline", default=None, help="perf baseline JSON path")
    p.add_argument("--update-baseline", action="store_true",
                   help="record the current cost report as the new baseline and exit 0")
    p.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                   help=f"allowed growth factor per ratcheted field (default {DEFAULT_TOLERANCE})")
    p.add_argument("--classes", default=None,
                   help="comma-separated class names to profile (default: the full registry)")
    p.add_argument("--no-memory", action="store_true",
                   help="no peak-memory column (it exists on a CUDA device only)")
    p.add_argument("--static-only", action="store_true",
                   help="leave out the compile, cache and cold-start keys (no compile_count column)")
    p.add_argument("--device", default=None,
                   help="device to profile on: 'cuda' (the default, which needs a card) or 'cpu'")
    p.add_argument("--format", choices=("text", "json"), default="text", dest="fmt")
    p.add_argument("-q", "--quiet", action="store_true", help="suppress the report body and summary")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root or os.getcwd())
    baseline_path = os.path.join(root, args.baseline) if args.baseline else _DEFAULT_BASELINE

    from metrics_tpu_torch.observe.costs import PROFILE_CASES

    cases = list(PROFILE_CASES)
    if args.classes:
        wanted = {c.strip() for c in args.classes.split(",") if c.strip()}
        cases = [c for c in cases if c.name in wanted]
        missing = wanted - {c.name for c in cases}
        if missing:
            print(f"profile-metrics: unknown class(es): {', '.join(sorted(missing))}")
            return 2
    results = collect_cost_report(
        cases, include_memory=not args.no_memory, dynamic=not args.static_only, device=args.device
    )

    from metrics_tpu_torch.engine.smoke import (  # noqa: PLC0415
        diff_fleet_baseline,
        load_fleet_baseline,
        run_fleet_smoke,
        write_fleet_baseline,
    )

    # the fleet smoke rides along except under a --classes filter (whose point
    # is profiling a handful of updates quickly)
    fleet_obs = None if args.classes else run_fleet_smoke(device=args.device)

    if args.update_baseline:
        cost = write_cost_baseline(baseline_path, results)
        if fleet_obs is not None:
            write_fleet_baseline(baseline_path, fleet_obs)
        if not args.quiet:
            print(f"profile-metrics: baseline written to {baseline_path} ({len(cost)} classes)")
        return 0

    baseline = load_cost_baseline(baseline_path)
    regressions, stale, new = diff_cost_baseline(results, baseline, args.tolerance)
    if fleet_obs is not None:
        f_reg, f_stale, f_new = diff_fleet_baseline(fleet_obs, load_fleet_baseline(baseline_path))
        regressions += f_reg
        stale += f_stale
        new += f_new
    failures = [r for r in results if not r.ok]

    if args.fmt == "json":
        print(json.dumps({
            "cost": report_to_dict(results),
            "fleet": fleet_obs,
            "errors": {r.case.name: r.error for r in failures},
            "regressions": regressions,
            "stale": stale,
            "new": new,
        }, indent=2, sort_keys=True))
        return 1 if regressions else 0

    if not args.quiet:
        header = f"{'class':<40} {'flops':>12} {'bytes':>12} {'peak_mem':>10} {'compiles':>8} {'shared':>6}"
        print(header)
        print("-" * len(header))
        for r in sorted(results, key=lambda r: r.case.name):
            if not r.ok:
                print(f"{r.case.name:<40} SKIP: {r.error}")
                continue
            c = r.cost
            print(f"{r.case.name:<40} {c.get('flops', 0):>12.0f} {c.get('bytes_accessed', 0):>12.0f} "
                  f"{c.get('peak_memory_bytes', '-'):>10} {c.get('compile_count', '-'):>8} "
                  f"{str(c.get('shareable', '-')):>6}")
    for line in regressions:
        print(f"REGRESSION {line}")
    if not args.quiet:
        for line in stale:
            print(f"stale: {line}")
        for name in new:
            print(f"new (not in baseline): {name}")
        ok = sum(1 for r in results if r.ok)
        print(f"profile-metrics: {ok}/{len(results)} classes profiled, {len(regressions)} regression(s), "
              f"{len(stale)} stale, {len(new)} new")
    return 1 if regressions else 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
