"""Dynamic precision-contract harness: numlint's verdicts, proven against a float64 oracle (counterpart of
``metrics_tpu/analysis/precision_contracts.py``).

For every jit-eligible class of the profile registry this replays one stream twice: through the default
float32 path (the probe) and through the float64 regime (the oracle: ``torch.set_default_dtype(float64)``,
the port's counterpart of the JAX package's x64 switch, with the float batches widened, so every float
state the regime governs is float64). It cross-checks three verdicts on one question: *does this class's
accumulation stay sound over the stream?*

1. **static**: :func:`metrics_tpu_torch.analysis.num_rules.classify_precision`;
2. **declared**: the per-state ``precision=`` contracts of :meth:`Metric.add_state`
   (``Metric._precision``);
3. **runtime**: the relative error of the float32 result against the float64 oracle.

On top of the registry sweep, five adversarial regimes drive the failure modes the static rules exist for:
a large-offset mean (the compensated path must beat the plain float32 fold by at least 10^3x), a long
float32 sum above the ulp, a variance at offset 1e8, counters past 2^31, and a long-horizon decay fold.
Disagreements are baselined in the ``precision`` section of
``metrics_tpu_torch/analysis/baselines/numlint_baseline.json`` (expected empty).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "PrecisionResult",
    "check_precision_case",
    "check_regime",
    "collect_precision_report",
    "diff_precision_baseline",
    "precision_cases",
    "main",
    "run_precision_check",
]

Device = Union[str, torch.device]
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines", "numlint_baseline.json")
_STEPS = 4  # stream length of the registry sweep (per leg)
# float32-vs-float64 stability tolerance for the registry sweep: far above honest float32 roundoff over 4
# batches, far below the O(1) error of a catastrophic cancellation or a wrapped counter
_TOL = 5e-2


@dataclasses.dataclass(frozen=True)
class PrecisionResult:
    name: str
    static_clean: bool
    static_detail: str
    declared: str  # comma-joined states with a precision= contract ("" = none)
    runtime: str  # STABLE | DRIFT:<relerr> | ERROR:<why>
    agree: bool
    detail: str = ""

    def render(self) -> str:
        mark = "ok " if self.agree else "DISAGREE"
        return (
            f"{mark} {self.name}: static={'clean' if self.static_clean else 'hazard'} "
            f"declared={self.declared or '-'} runtime={self.runtime}"
            + (f" ({self.detail})" if self.detail else "")
        )


def precision_cases() -> List[Any]:
    """The jit-eligible slice of the profile registry (the transfer contract's)."""
    from metrics_tpu_torch.analysis.transfer_contracts import transfer_cases

    return transfer_cases()


# ------------------------------------------------------------------ streams
@contextlib.contextmanager
def float64_regime() -> Iterator[None]:
    """torch's default float type float64 for the extent: the port's float64 regime."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _host_batches(case: Any, n: int) -> List[Tuple[Any, ...]]:
    """``n`` batches as host numpy: the single source both legs replay."""
    from metrics_tpu_torch.observe.costs import _rng

    rng = _rng(case)
    return [tuple(a.numpy() if isinstance(a, torch.Tensor) else a for a in case.batch(rng)) for _ in range(n)]


def _widen_batch(batch: Tuple[Any, ...]) -> Tuple[Any, ...]:
    """Float arrays cast to float64 for the oracle (exact: float32 is a subset of float64)."""
    return tuple(
        np.asarray(a, dtype=np.float64)
        if isinstance(a, (np.ndarray, np.generic)) and np.issubdtype(np.asarray(a).dtype, np.floating) else a
        for a in batch
    )


def _leaves(value: Any) -> List[np.ndarray]:
    from torch.utils._pytree import tree_leaves

    return [v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in tree_leaves(value)]


def _max_rel_err(oracle: Sequence[Any], probe: Sequence[Any]) -> float:
    """Max elementwise relative error of ``probe`` against ``oracle`` leaves."""
    if len(oracle) != len(probe):
        raise ValueError(f"compute trees differ: {len(oracle)} vs {len(probe)} leaves")
    worst = 0.0
    for a, b in zip(oracle, probe):
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if a.shape != b.shape:
            raise ValueError(f"compute leaf shapes differ: {a.shape} vs {b.shape}")
        both_nan = np.isnan(a) & np.isnan(b)
        if (np.isnan(a) ^ np.isnan(b)).any():
            return math.inf
        mask = ~both_nan
        if not mask.any():
            continue
        err = np.abs(a[mask] - b[mask]) / np.maximum(np.abs(a[mask]), 1e-6)
        worst = max(worst, float(err.max()) if err.size else 0.0)
    return worst


def _operand(a: Any, device: Device) -> Any:
    if isinstance(a, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(a), device=device)
    return a


def _run_stream(ctor: Callable[[Device], Any], batches: Sequence[Tuple[Any, ...]], x64: bool,
                device: Device = "cuda") -> List[np.ndarray]:
    """Replay ``batches`` through a fresh metric; its compute's leaves. ``x64=False`` is the default float32
    path, ``x64=True`` the float64 oracle (the regime, the float batches widened)."""
    if x64:
        with float64_regime():
            m = ctor(device)
            for batch in batches:
                m.update(*(_operand(a, device) for a in _widen_batch(batch)))
            return _leaves(m.compute())
    m = ctor(device)
    for batch in batches:
        m.update(*(_operand(a, device) for a in batch))
    return _leaves(m.compute())


def _declared_contracts(m: Any) -> str:
    return ",".join(sorted(n for n, v in getattr(m, "_precision", {}).items() if v))


def _agreement(static_clean: bool, declared: str, runtime: str) -> bool:
    """The three-way contract: hazards and drift both need a declaration."""
    if runtime.startswith("ERROR"):
        return False
    if not static_clean and not declared:
        return False
    if runtime == "STABLE":
        return True
    return bool(declared)


def check_precision_case(case: Any, device: Device = "cuda") -> PrecisionResult:
    """One class: the float32 stream against the float64 oracle; never raises."""
    from metrics_tpu_torch.analysis.num_rules import classify_precision

    try:
        m = case.ctor(device)
        static_clean, static_detail = classify_precision(type(m))
        declared = _declared_contracts(m)
        batches = _host_batches(case, _STEPS)
        oracle = _run_stream(case.ctor, batches, x64=True, device=device)
        probe = _run_stream(case.ctor, batches, x64=False, device=device)
        err = _max_rel_err(oracle, probe)
        runtime = "STABLE" if err <= _TOL else f"DRIFT:{err:.1e}"
        detail = f"relerr={err:.1e}" if err > 0 else ""
    except Exception as exc:  # noqa: BLE001 — every failure is a reportable verdict
        return PrecisionResult(case.name, False, "", "", f"ERROR:{type(exc).__name__}", False, str(exc)[:200])
    return PrecisionResult(case.name, static_clean, static_detail, declared, runtime,
                           _agreement(static_clean, declared, runtime), detail)


# ----------------------------------------------------------------- regimes
def _regime_mean_large_offset(device: Device) -> Tuple[str, str]:
    """Mean at offset 1e8, spread 1e-1: the compensated path must beat the plain fold by >= 10^3x."""
    from metrics_tpu_torch.aggregation import MeanMetric

    rng = np.random.RandomState(0x5EED)
    batches = [(np.float32(1e8 + rng.standard_normal(32) * 1e-1),) for _ in range(512)]
    oracle = float(np.mean(np.concatenate([np.float64(b[0]) for b in batches])))
    plain = _run_stream(lambda d: MeanMetric(nan_strategy="disable", device=d), batches, False, device)
    comp = _run_stream(lambda d: MeanMetric(nan_strategy="disable", compensated=True, device=d), batches, False,
                       device)
    err_plain = abs(float(plain[0]) - oracle) / abs(oracle)
    err_comp = abs(float(comp[0]) - oracle) / abs(oracle)
    ratio = err_plain / max(err_comp, 1e-18)
    detail = f"plain={err_plain:.1e} compensated={err_comp:.1e} ratio={ratio:.1e}"
    if err_comp < 1e-7 or ratio >= 1e3:
        return "STABLE", detail
    return f"DRIFT:{err_comp:.1e}", detail + " (ratio < 1e3)"


def _regime_sum_long_horizon(device: Device) -> Tuple[str, str]:
    """2,048 adds of 1.0 on a 1e8 total (each below ulp(1e8) = 8): plain drops them, Neumaier keeps them."""
    from metrics_tpu_torch.aggregation import SumMetric

    n = 2048
    batches = [(np.float32(1e8),)] + [(np.float32(1.0),) for _ in range(n)]
    oracle = 1e8 + float(n)
    plain = _run_stream(lambda d: SumMetric(nan_strategy="disable", device=d), batches, False, device)
    comp = _run_stream(lambda d: SumMetric(nan_strategy="disable", compensated=True, device=d), batches, False,
                       device)
    err_plain = abs(float(plain[0]) - oracle) / oracle
    err_comp = abs(float(comp[0]) - oracle) / oracle
    detail = f"plain={err_plain:.1e} compensated={err_comp:.1e}"
    if err_comp < 1e-7 and err_comp < err_plain:
        return "STABLE", detail
    return f"DRIFT:{err_comp:.1e}", detail


def _regime_variance_cancellation(device: Device) -> Tuple[str, str]:
    """ExplainedVariance at offset 1e8: its shifted moments must track the float64 oracle."""
    from metrics_tpu_torch.regression import ExplainedVariance

    rng = np.random.RandomState(0xCA11)
    batches = []
    for _ in range(64):
        target = 1e8 + rng.standard_normal(64) * 1e-1
        preds = target + rng.standard_normal(64) * 1e-2
        batches.append((np.float32(preds), np.float32(target)))
    ctor = lambda d: ExplainedVariance(device=d)  # noqa: E731
    oracle = _run_stream(ctor, batches, True, device)
    probe = _run_stream(ctor, batches, False, device)
    err = _max_rel_err(oracle, probe)
    finite = bool(np.isfinite(np.asarray(probe[0])).all())
    detail = f"relerr={err:.1e} score={float(np.asarray(probe[0])):.4f}"
    if finite and err <= 1e-2:
        return "STABLE", detail
    return f"DRIFT:{err:.1e}", detail


def _regime_counter_overflow(device: Device) -> Tuple[str, str]:
    """Counters injected at 2^31 - 3 must cross the boundary without wrapping (``count_dtype()`` is int64)."""
    from metrics_tpu_torch.classification.confusion_matrix import BinaryConfusionMatrix

    with float64_regime():
        m = BinaryConfusionMatrix(normalize=None, validate_args=False, device=device)
        if m.confmat.dtype != torch.int64:
            return f"DRIFT:dtype={m.confmat.dtype}", "confmat not int64: counter still pinned narrow"
        seed = 2**31 - 3
        seeded = torch.full((2, 2), seed, dtype=torch.int64, device=device)
        m.__dict__["_state"]["confmat"] = seeded  # donlint: disable=ML001 — a fresh tensor, held by nothing else
        preds = torch.tensor([0, 1, 1, 0, 1, 0, 1, 1], device=device)
        target = torch.tensor([0, 1, 0, 0, 1, 1, 1, 0], device=device)
        m.update(preds, target)
        out = m.confmat.cpu().numpy().astype(np.int64)
        total = int(out.sum())
        expected = 4 * seed + int(preds.shape[0])
        detail = f"max_cell={int(out.max())} total-4*seed={total - 4 * seed}"
        if (out >= seed).all() and total == expected and int(out.max()) >= 2**31:
            return "STABLE", detail
        return "DRIFT:wrapped", detail


def _regime_decay_long_horizon(device: Device) -> Tuple[str, str]:
    """A long decay fold on a large total with a coarse clock (a step every 256 observations): the dominant
    error is the adds the plain float32 fold drops below ulp(total), which the Neumaier residual recovers."""
    from metrics_tpu_torch.aggregation import SumMetric
    from metrics_tpu_torch.windows import TimeDecayed

    half_life = 1e4
    n = 2048
    batches = [(np.float32(0.0), np.float32(1e8))] + [
        (np.float32(float(i // 256)), np.float32(1.0)) for i in range(1, n + 1)
    ]

    def _ctor(compensated: bool) -> Callable[[Device], Any]:
        return lambda d: TimeDecayed(SumMetric(nan_strategy="disable", device=d), half_life_s=half_life,
                                     compensated=compensated)

    oracle = _run_stream(_ctor(False), batches, True, device)
    plain = _run_stream(_ctor(False), batches, False, device)
    comp = _run_stream(_ctor(True), batches, False, device)
    ref = float(oracle[0])
    err_plain = abs(float(plain[0]) - ref) / abs(ref)
    err_comp = abs(float(comp[0]) - ref) / abs(ref)
    detail = f"plain={err_plain:.1e} compensated={err_comp:.1e}"
    if err_comp <= 1e-5 and err_comp <= err_plain:
        return "STABLE", detail
    return f"DRIFT:{err_comp:.1e}", detail


_REGIMES = {
    "regime:mean_large_offset": _regime_mean_large_offset,
    "regime:sum_long_horizon": _regime_sum_long_horizon,
    "regime:variance_cancellation": _regime_variance_cancellation,
    "regime:counter_overflow": _regime_counter_overflow,
    "regime:decay_long_horizon": _regime_decay_long_horizon,
}


def _regime_subject(name: str, device: Device) -> Any:
    """The class each regime exercises, for the static and declared legs."""
    from metrics_tpu_torch.aggregation import MeanMetric, SumMetric
    from metrics_tpu_torch.classification.confusion_matrix import BinaryConfusionMatrix
    from metrics_tpu_torch.regression import ExplainedVariance
    from metrics_tpu_torch.windows import TimeDecayed

    return {
        "regime:mean_large_offset": lambda: MeanMetric(nan_strategy="disable", compensated=True, device=device),
        "regime:sum_long_horizon": lambda: SumMetric(nan_strategy="disable", compensated=True, device=device),
        "regime:variance_cancellation": lambda: ExplainedVariance(device=device),
        "regime:counter_overflow": lambda: BinaryConfusionMatrix(validate_args=False, device=device),
        "regime:decay_long_horizon": lambda: TimeDecayed(
            SumMetric(nan_strategy="disable", device=device), half_life_s=1e5, compensated=True),
    }[name]()


def check_regime(name: str, device: Device = "cuda") -> PrecisionResult:
    """One adversarial regime through all three legs; never raises."""
    from metrics_tpu_torch.analysis.num_rules import classify_precision

    try:
        subject = _regime_subject(name, device)
        static_clean, static_detail = classify_precision(type(subject))
        declared = _declared_contracts(subject)
        runtime, detail = _REGIMES[name](device)
    except Exception as exc:  # noqa: BLE001
        return PrecisionResult(name, False, "", "", f"ERROR:{type(exc).__name__}", False, str(exc)[:200])
    return PrecisionResult(name, static_clean, static_detail, declared, runtime,
                           _agreement(static_clean, declared, runtime), detail)


def collect_precision_report(cases: Optional[Sequence[Any]] = None, device: Device = "cuda") -> List[PrecisionResult]:
    results = [check_precision_case(c, device) for c in (cases if cases is not None else precision_cases())]
    results.extend(check_regime(name, device) for name in _REGIMES)
    return results


# ------------------------------------------------------------------- baseline
def load_precision_baseline(path: str) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import load_baseline_section

    return {str(k): str(v) for k, v in load_baseline_section(path, "precision").items()}


def write_precision_baseline(path: str, results: Sequence[PrecisionResult]) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import write_baseline_section

    precision = {
        r.name: f"UNJUSTIFIED: static={r.static_clean} declared={r.declared or '-'} runtime={r.runtime}"
        for r in sorted(results, key=lambda r: r.name)
        if not r.agree
    }
    write_baseline_section(
        path, "precision", precision,  # type: ignore[arg-type]
        "numlint baseline: static numerical-soundness exceptions under `rules` (path::rule::context -> count "
        "and reason), float64-oracle cross-check disagreements under `precision` (case -> justification; "
        "expected empty). Regenerate with `python -m metrics_tpu_torch.analysis.cli --pass numlint --pass "
        "precision --update-baseline`.",
        seed={"rules": {}},
    )
    return precision


def diff_precision_baseline(
    results: Sequence[PrecisionResult], baseline: Dict[str, str]
) -> Tuple[List[PrecisionResult], List[str]]:
    """Split into (failures, stale_baseline_keys): unbaselined disagreements fail."""
    failures = [r for r in results if not r.agree and r.name not in baseline]
    observed = {r.name for r in results}
    disagreeing = {r.name for r in results if not r.agree}
    stale = sorted(name for name in baseline if name not in disagreeing or name not in observed)
    return failures, stale


def run_precision_check(
    root: str,
    baseline_path: Optional[str] = None,
    update_baseline: bool = False,
    quiet: bool = False,
    report: Optional[Dict[str, Any]] = None,
    device: Device = "cuda",
) -> int:
    """The ``precision`` pass: oracle, cross-check, verdict."""
    path = baseline_path or DEFAULT_BASELINE
    results = collect_precision_report(device=device)
    if update_baseline:
        precision = write_precision_baseline(path, results)
        if not quiet:
            print(f"precision: baseline written to {path} ({len(precision)} disagreement(s))")
        return 0
    failures, stale = diff_precision_baseline(results, load_precision_baseline(path))
    if report is not None:
        report.update({
            "cases": len(results),
            "failures": [r.render() for r in failures],
            "baselined": sum(1 for r in results if not r.agree) - len(failures),
            "stale_baseline_keys": stale,
            "runtime_verdicts": {r.name: r.runtime for r in results},
        })
        return 1 if failures else 0
    for r in failures:
        print(f"precision: {r.render()}")
    if not quiet:
        for key in stale:
            print(f"precision: stale baseline entry: {key}")
        agreed = sum(1 for r in results if r.agree)
        stable = sum(1 for r in results if r.runtime == "STABLE")
        print(f"precision: {agreed}/{len(results)} cases agree ({stable} oracle-stable at runtime), "
              f"{len(failures)} failure(s), {len(stale)} stale")
    return 1 if failures else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="precision-contracts", description=__doc__.splitlines()[0])
    p.add_argument("--baseline", default=None, help="numlint baseline JSON path")
    p.add_argument("--update-baseline", action="store_true")
    p.add_argument("--device", default="cuda", help="where the metrics run (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true", help="print every case verdict")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    if args.verbose:
        for r in collect_precision_report(device=args.device):
            print(r.render())
    return run_precision_check(os.getcwd(), baseline_path=args.baseline, update_baseline=args.update_baseline,
                               quiet=args.quiet, device=args.device)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
