"""Disabled-mode telemetry overhead smoke (counterpart of ``metrics_tpu/observe/overhead.py``).

The flight recorder's contract is that *disabled* telemetry, with no profiler
recording, costs one module-flag check per counter hook and one flag check plus
one profiler check per span site — ``span()`` returns the preallocated no-op
span singleton, ``record_complete`` returns before touching anything.
This pass pins the *budget*: the instrumentation a real 1k-step update loop
passes through must cost under :data:`MAX_OVERHEAD_PCT` of the loop's own step
time.

The check is built bottom-up, as the JAX package's is:

* microbenchmark the two disabled primitives — a null ``with span(...)`` and a
  ``record_complete`` early return — min-of-repeats over a tight loop, with the
  empty loop's own cost subtracted;
* measure the real per-step cost of a 1k-step ``MulticlassAccuracy.update``
  loop on the metric's device (the card unless named; a timed loop on the card
  ends in ``torch.cuda.synchronize()``), after a warm-up;
* charge :data:`SPANS_PER_STEP` null spans plus :data:`CHECKS_PER_STEP` flag
  checks per step and require ``budget / step_time < MAX_OVERHEAD_PCT``.

The *enabled*-watchdog budget charges one ``poke_watchdog()`` per step plus the
amortized share of a real ``Watchdog.sample()`` per ``min_interval_s``; the
*enabled*-meter budget charges the costlier of a step's share of one
``note_dispatch`` over a wave and one ``note_loose_update``, plus the
rate-limited ``poll_quota`` fast path and the amortized share of one full quota
scan per ``poll_interval_s``. Each must be under the same
:data:`MAX_OVERHEAD_PCT`.

The verdict is an absolute threshold, not a baseline ratchet.
``--update-baseline`` records the measured numbers under a ``telemetry``
section of ``metrics_tpu_torch/observe/telemetry_baseline.json``.

CLI: ``python -m metrics_tpu_torch.observe.overhead [--device cpu]``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Union

__all__ = [
    "CHECKS_PER_STEP",
    "MAX_OVERHEAD_PCT",
    "SPANS_PER_STEP",
    "main",
    "measure_disabled_costs",
    "measure_metering_costs",
    "measure_step_cost",
    "measure_watchdog_costs",
    "run_telemetry_check",
]

MAX_OVERHEAD_PCT = 2.0
# What one disabled MulticlassAccuracy.update() of the loop below crosses, counted
# (tests/test_torch_observe_spans.py): 3 null spans (its validation's
# ``validate:`` and the ``host_read:`` of its integer preds and its target) and
# 4 flag-class checks (the update's recorder flag and profiler check, and the
# recorder flag of each host read's transfer count).
SPANS_PER_STEP = 3
CHECKS_PER_STEP = 4
_DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "telemetry_baseline.json")

_MICRO_ITERS = 20_000
_MICRO_REPEATS = 5
_LOOP_STEPS = 1000
_LOOP_REPEATS = 3
# The verdict re-measures before failing: a single scheduler hiccup during a
# microbenchmark window should not fail CI.
_VERDICT_ATTEMPTS = 3


def measure_disabled_costs(iters: int = _MICRO_ITERS, repeats: int = _MICRO_REPEATS) -> Dict[str, float]:
    """Per-call cost (seconds) of the disabled instrumentation primitives.

    Returns ``{"span_s": ..., "check_s": ...}`` — min over ``repeats`` runs of
    ``iters`` calls each, measured with telemetry disabled (asserts it is).
    """
    from metrics_tpu_torch.observe import recorder, tracing

    if recorder.ENABLED:
        raise RuntimeError("measure_disabled_costs requires telemetry disabled")

    span = tracing.span
    record_complete = tracing.record_complete
    best_span = float("inf")
    best_check = float("inf")
    best_empty = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            pass
        best_empty = min(best_empty, (time.perf_counter() - t0) / iters)
        t0 = time.perf_counter()
        for _ in range(iters):
            with span("bench", "overhead"):
                pass
        best_span = min(best_span, (time.perf_counter() - t0) / iters)
        t0 = time.perf_counter()
        for _ in range(iters):
            record_complete("bench", "overhead", 0.0, 0.0)
        best_check = min(best_check, (time.perf_counter() - t0) / iters)
    # the loop statement itself is not instrumentation cost
    return {
        "span_s": max(0.0, best_span - best_empty),
        "check_s": max(0.0, best_check - best_empty),
    }


def measure_watchdog_costs(iters: int = 4000, repeats: int = _MICRO_REPEATS) -> Dict[str, float]:
    """Enabled-watchdog hot-path costs (seconds): the per-step poke, one sample.

    Runs inside its own enabled ``observe.scope()`` with a default-interval
    watchdog installed. ``poke_s`` is the min-over-repeats per-call cost of
    ``poke_watchdog()`` (rate-limit fast path — the charge every instrumented
    tick pays); ``sample_s`` is the mean cost of a full ``Watchdog.sample()``
    (host-twin folds + SLO evaluation), which the rate limiter amortizes over
    ``min_interval_s`` of steps.
    """
    from metrics_tpu_torch import observe
    from metrics_tpu_torch.observe import recorder

    with observe.scope(reset=True):
        wd = observe.Watchdog()  # default min_interval_s
        observe.install_watchdog(wd)
        try:
            poke = recorder.poke_watchdog
            poke()  # first poke eats the initial sample outside the window
            best_poke = float("inf")
            best_empty = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                for _ in range(iters):
                    pass
                best_empty = min(best_empty, (time.perf_counter() - t0) / iters)
                t0 = time.perf_counter()
                for _ in range(iters):
                    poke()
                best_poke = min(best_poke, (time.perf_counter() - t0) / iters)
            n_samples = 5
            t0 = time.perf_counter()
            for _ in range(n_samples):
                wd.sample()
            sample_s = (time.perf_counter() - t0) / n_samples
        finally:
            observe.uninstall_watchdog()
    return {
        "poke_s": max(0.0, best_poke - best_empty),
        "sample_s": sample_s,
        "min_interval_s": wd.min_interval_s,
    }


def measure_metering_costs(iters: int = 4000, repeats: int = _MICRO_REPEATS, wave: int = 32) -> Dict[str, float]:
    """Enabled-meter hot-path costs (seconds) per primitive.

    Runs inside its own enabled ``observe.scope()`` with a
    :class:`~metrics_tpu_torch.observe.metering.FleetMeter` installed.
    ``dispatch_s`` is the min-over-repeats cost of one ``note_dispatch`` for a
    ``wave``-session wave *including* the key-list build the engine pays
    (indexing the bucket's cached ``slot_skeys`` — ``per_session_s`` is the
    amortized per-session share); ``loose_s`` the per-call cost of
    ``note_loose_update``; ``poll_fast_s`` the per-call cost of the
    rate-limited ``poll_quota`` fast path (the charge every tick pays — one
    clock read) and ``poll_scan_s`` the mean cost of a full ledger scan,
    which the rate limiter amortizes over ``poll_interval_s``.
    """
    from metrics_tpu_torch import observe

    with observe.scope(reset=True):
        mt = observe.install_meter(
            top_k=64,
            policy=observe.MeterPolicy(max_updates=1 << 60, cooldown_s=3600.0),
        )
        try:
            # the engine indexes the bucket's cached slot_skeys per wave; the
            # list build below mirrors that (slots in a wave are a subset)
            skeys = [str(i) for i in range(wave)]
            best_dispatch = float("inf")
            best_loose = float("inf")
            best_empty = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                for _ in range(iters):
                    pass
                best_empty = min(best_empty, (time.perf_counter() - t0) / iters)
                t0 = time.perf_counter()
                for _ in range(iters):
                    mt.note_dispatch("bench", [skeys[i] for i in range(wave)], 1e-9)
                best_dispatch = min(best_dispatch, (time.perf_counter() - t0) / iters)
                t0 = time.perf_counter()
                for _ in range(iters):
                    mt.note_loose_update("0")
                best_loose = min(best_loose, (time.perf_counter() - t0) / iters)
            best_poll = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                for _ in range(iters):
                    mt.poll_quota()  # rate-limited: the per-tick fast path
                best_poll = min(best_poll, (time.perf_counter() - t0) / iters)
            n_scans = 20
            t0 = time.perf_counter()
            for i in range(n_scans):
                mt.poll_quota(now=1e9 + i)  # distinct clocks force full scans
            poll_scan_s = (time.perf_counter() - t0) / n_scans
        finally:
            observe.uninstall_meter()
    dispatch_s = max(0.0, best_dispatch - best_empty)
    return {
        "dispatch_s": dispatch_s,
        "per_session_s": dispatch_s / wave,
        "loose_s": max(0.0, best_loose - best_empty),
        "poll_fast_s": max(0.0, best_poll - best_empty),
        "poll_scan_s": poll_scan_s,
        "poll_interval_s": mt.poll_interval_s,
        "wave": float(wave),
    }


def measure_step_cost(
    steps: int = _LOOP_STEPS, repeats: int = _LOOP_REPEATS, device: Union[str, Any, None] = None
) -> float:
    """Steady-state per-step seconds of a 1k-step update loop on ``device`` (the card unless named).

    Runs ``MulticlassAccuracy.update`` on fixed small batches (the shape of a
    per-step training-loop metric call), warms up first, and returns the
    min-over-repeats mean step time; a timed loop on the card ends in
    ``torch.cuda.synchronize()``.
    """
    import torch

    from metrics_tpu_torch.classification.accuracy import MulticlassAccuracy

    metric = MulticlassAccuracy(num_classes=8, device=device)
    dev = metric.device
    preds = torch.arange(32, device=dev) % 8
    target = (torch.arange(32, device=dev) + 1) % 8

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(3):  # warm-up: first-call costs out of the window
        metric.update(preds, target)
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps):
            metric.update(preds, target)
        sync()
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def _measure(device: Union[str, Any, None] = None) -> Dict[str, Any]:
    micro = measure_disabled_costs()
    step_s = measure_step_cost(device=device)
    budget_s = SPANS_PER_STEP * micro["span_s"] + CHECKS_PER_STEP * micro["check_s"]
    overhead_pct = 100.0 * budget_s / step_s if step_s > 0 else float("inf")
    return {
        "span_ns": round(micro["span_s"] * 1e9, 1),
        "check_ns": round(micro["check_s"] * 1e9, 1),
        "step_us": round(step_s * 1e6, 2),
        "charged_spans": SPANS_PER_STEP,
        "charged_checks": CHECKS_PER_STEP,
        "overhead_pct": round(overhead_pct, 4),
        "max_overhead_pct": MAX_OVERHEAD_PCT,
    }


def _measure_watchdog(step_s: float) -> Dict[str, Any]:
    wd = measure_watchdog_costs()
    # per-step charge: one poke (rate-limit fast path) + the amortized share
    # of one full sample per min_interval_s window of steps
    amortized_s = wd["sample_s"] * step_s / wd["min_interval_s"] if wd["min_interval_s"] > 0 else wd["sample_s"]
    budget_s = wd["poke_s"] + amortized_s
    overhead_pct = 100.0 * budget_s / step_s if step_s > 0 else float("inf")
    return {
        "poke_ns": round(wd["poke_s"] * 1e9, 1),
        "sample_us": round(wd["sample_s"] * 1e6, 2),
        "min_interval_s": wd["min_interval_s"],
        "overhead_pct": round(overhead_pct, 4),
        "max_overhead_pct": MAX_OVERHEAD_PCT,
    }


def _measure_metering(step_s: float) -> Dict[str, Any]:
    m = measure_metering_costs()
    # per-step charge: a step rides EITHER the bucketed path (its wave share
    # of one note_dispatch) OR the eager path (one note_loose_update) —
    # charge the costlier — plus the per-tick poll, itself split into the
    # rate-limited fast path (one clock read per tick, amortized over the
    # wave the tick serves) and the amortized share of one full quota scan
    # per poll_interval_s of steps
    amortized_scan_s = (
        m["poll_scan_s"] * step_s / m["poll_interval_s"]
        if m["poll_interval_s"] > 0
        else m["poll_scan_s"]
    )
    budget_s = (
        max(m["per_session_s"], m["loose_s"])
        + m["poll_fast_s"] / m["wave"]
        + amortized_scan_s
    )
    overhead_pct = 100.0 * budget_s / step_s if step_s > 0 else float("inf")
    return {
        "dispatch_us": round(m["dispatch_s"] * 1e6, 3),
        "per_session_ns": round(m["per_session_s"] * 1e9, 1),
        "loose_ns": round(m["loose_s"] * 1e9, 1),
        "poll_fast_ns": round(m["poll_fast_s"] * 1e9, 1),
        "poll_scan_us": round(m["poll_scan_s"] * 1e6, 2),
        "poll_interval_s": m["poll_interval_s"],
        "wave": int(m["wave"]),
        "overhead_pct": round(overhead_pct, 4),
        "max_overhead_pct": MAX_OVERHEAD_PCT,
    }


def run_telemetry_check(
    root: str,
    baseline_path: Optional[str] = None,
    update_baseline: bool = False,
    quiet: bool = False,
    report: Optional[Dict[str, Any]] = None,
    device: Union[str, Any, None] = None,
) -> int:
    """Dynamic ``telemetry`` pass: disabled-mode + enabled-watchdog +
    enabled-meter budgets on ``device`` (the card unless named; exit 0/1).
    ``root`` is where a relative ``baseline_path`` is written."""
    from metrics_tpu_torch.observe import recorder

    was_enabled = recorder.ENABLED
    recorder.ENABLED = False
    try:
        measured = _measure(device)
        attempts = 1
        while measured["overhead_pct"] >= MAX_OVERHEAD_PCT and attempts < _VERDICT_ATTEMPTS:
            measured = _measure(device)  # re-measure before failing: absorb one-off jitter
            attempts += 1
    finally:
        recorder.ENABLED = was_enabled
    step_s = measured["step_us"] * 1e-6
    wd_measured = _measure_watchdog(step_s)
    wd_attempts = 1
    while wd_measured["overhead_pct"] >= MAX_OVERHEAD_PCT and wd_attempts < _VERDICT_ATTEMPTS:
        wd_measured = _measure_watchdog(step_s)
        wd_attempts += 1
    wd_measured["attempts"] = wd_attempts
    measured["attempts"] = attempts
    mt_measured = _measure_metering(step_s)
    mt_attempts = 1
    while mt_measured["overhead_pct"] >= MAX_OVERHEAD_PCT and mt_attempts < _VERDICT_ATTEMPTS:
        mt_measured = _measure_metering(step_s)
        mt_attempts += 1
    mt_measured["attempts"] = mt_attempts
    ok = (
        measured["overhead_pct"] < MAX_OVERHEAD_PCT
        and wd_measured["overhead_pct"] < MAX_OVERHEAD_PCT
        and mt_measured["overhead_pct"] < MAX_OVERHEAD_PCT
    )

    if update_baseline:
        from metrics_tpu_torch.analysis.engine import write_baseline_section

        path = os.path.join(root, baseline_path) if baseline_path else _DEFAULT_BASELINE
        write_baseline_section(
            path,
            "telemetry",
            {
                "disabled_mode": measured,
                "enabled_watchdog": wd_measured,
                "enabled_metering": mt_measured,
            },
            "telemetry overhead record — disabled-mode instrumentation cost vs a "
            "1k-step update loop. Informational (the pass verdict is the absolute "
            f"{MAX_OVERHEAD_PCT}% threshold); regenerate with "
            "`python -m metrics_tpu_torch.observe.overhead --update-baseline`.",
        )
        if not quiet:
            print(f"telemetry: baseline written to {path}")

    if report is not None:
        report["disabled_mode"] = measured
        report["enabled_watchdog"] = wd_measured
        report["enabled_metering"] = mt_measured
    if not quiet and report is None:  # with a report the caller owns stdout (one JSON document)
        verdict = "ok" if ok else "FAIL"
        print(
            f"telemetry: disabled-mode overhead {measured['overhead_pct']:.3f}% "
            f"of a {measured['step_us']:.0f}us step "
            f"(null span {measured['span_ns']:.0f}ns x{SPANS_PER_STEP}, "
            f"flag check {measured['check_ns']:.0f}ns x{CHECKS_PER_STEP}; "
            f"budget {MAX_OVERHEAD_PCT}%); "
            f"watchdog overhead {wd_measured['overhead_pct']:.3f}% "
            f"(poke {wd_measured['poke_ns']:.0f}ns, sample "
            f"{wd_measured['sample_us']:.0f}us per {wd_measured['min_interval_s']:g}s); "
            f"metering overhead {mt_measured['overhead_pct']:.3f}% "
            f"(dispatch {mt_measured['dispatch_us']:.1f}us/{mt_measured['wave']}-wave, "
            f"loose {mt_measured['loose_ns']:.0f}ns, poll "
            f"{mt_measured['poll_scan_us']:.0f}us per {mt_measured['poll_interval_s']:g}s) "
            f"— {verdict}"
        )
    return 0 if ok else 1


def main(argv: Optional[Any] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Disabled-mode telemetry overhead smoke.")
    p.add_argument("--root", default=None)
    p.add_argument("--baseline", default=None)
    p.add_argument("--update-baseline", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--device", default=None, help="device of the step loop: 'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root or os.getcwd())
    return run_telemetry_check(
        root,
        baseline_path=args.baseline,
        update_baseline=args.update_baseline,
        quiet=args.quiet,
        device=args.device,
    )


if __name__ == "__main__":
    raise SystemExit(main())
