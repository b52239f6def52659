"""Admission control for the serve front door: an explicit verdict table (counterpart of
``metrics_tpu/serve/admission.py``).

Every remote arrival (and, for the hard-reject rows, every remote record)
is judged against a small, ordered table of rules over *live* fleet signals
— bucket occupancy, durability (WAL) lag, the installed watchdog's verdict,
and the meter's quota-pressure gauge. The table is data, not code: each row
names the signal, the comparison, the threshold, and the verdict, so an
operator can read the whole policy in one screen and tests can pin it.

Verdicts, gentlest-first:

* ``accept`` — apply the record normally (the default when no row trips);
* ``defer`` — do not apply; ack ``status="defer"`` with a ``retry_after_s``
  hint, and the producer's credit-window buffer retries it;
* ``shed`` — admit the arrival, but shed loose sessions first to make room
  (the autonomic ladder's cheapest eviction: loose rows cost no bucket
  state change and no recompile);
* ``reject`` — refuse permanently; the producer records the refusal and
  does not retry.

Signal reads are batched: the server refreshes one signal snapshot per
poll pass, so per-record admission is a few dict lookups.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.observe.watchdog import installed_watchdog

__all__ = [
    "ADMISSION_VERDICTS",
    "AdmissionController",
    "AdmissionDecision",
    "AdmissionRule",
    "DEFAULT_ADMISSION_TABLE",
]

ADMISSION_VERDICTS = ("accept", "defer", "shed", "reject")


class AdmissionRule(NamedTuple):
    """One table row: ``verdict`` when ``signal op threshold`` holds."""

    name: str
    signal: str
    op: str  # ">=" or "<="
    threshold: float
    verdict: str
    retry_after_s: Optional[float] = None  # only meaningful for "defer"
    arrivals_only: bool = True  # False: the row also judges submit/expire/reset

    def tripped(self, signals: Dict[str, float]) -> bool:
        value = signals.get(self.signal)
        if value is None:
            return False
        return value >= self.threshold if self.op == ">=" else value <= self.threshold


class AdmissionDecision(NamedTuple):
    verdict: str
    rule: Optional[str]  # the table row that tripped, None for default-accept
    retry_after_s: Optional[float]


_ACCEPT = AdmissionDecision("accept", None, None)

# Ordered: the first tripped row wins. Hard protection (journal backlog)
# outranks health-based deferral, which outranks occupancy-based responses —
# and the shed row sits *below* reject so a fleet drowning in replay debt
# refuses work outright instead of thrashing its loose sessions.
DEFAULT_ADMISSION_TABLE: Tuple[AdmissionRule, ...] = (
    AdmissionRule("wal_backlog", "wal_lag_records", ">=", 100_000.0, "reject", None, False),
    AdmissionRule("watchdog_degraded", "watchdog_degraded", ">=", 1.0, "defer", 1.0),
    AdmissionRule("occupancy_full", "occupancy_pct", ">=", 97.0, "shed", None),
    AdmissionRule("quota_pressure", "quota_sessions_over", ">=", 1.0, "defer", 0.5),
    AdmissionRule("occupancy_high", "occupancy_pct", ">=", 90.0, "defer", 0.25),
)


class AdmissionController:
    """Evaluate the admission table; keep per-verdict counts for telemetry."""

    def __init__(self, table: Sequence[AdmissionRule] = DEFAULT_ADMISSION_TABLE) -> None:
        for rule in table:
            if rule.verdict not in ADMISSION_VERDICTS:
                raise ValueError(f"admission rule {rule.name!r} has unknown verdict {rule.verdict!r}")
            if rule.op not in (">=", "<="):
                raise ValueError(f"admission rule {rule.name!r} has unknown op {rule.op!r}")
        self.table: Tuple[AdmissionRule, ...] = tuple(table)
        self.counts: Dict[str, int] = {v: 0 for v in ADMISSION_VERDICTS}

    def signals(self, engine: Any) -> Dict[str, float]:
        """One snapshot of the live signals the table reads.

        ``occupancy_pct`` and ``wal_lag_records`` come from the engine's own
        ``stats()``; ``watchdog_degraded`` is 1.0 when an installed watchdog's
        ``health()`` verdict is degraded; ``quota_sessions_over`` reads the
        meter-maintained recorder gauge (0 when no meter or telemetry off).
        """
        stats = engine.stats()
        occupancy = stats.get("occupancy_pct")
        signals: Dict[str, float] = {
            "occupancy_pct": float(occupancy) if occupancy is not None else 0.0,
            "wal_lag_records": float(stats.get("wal_lag_records", 0)),
            "sessions": float(stats.get("sessions", 0)),
            "watchdog_degraded": 0.0,
            "quota_sessions_over": 0.0,
        }
        wd = installed_watchdog()
        if wd is not None and wd.health()["verdict"] == "degraded":
            signals["watchdog_degraded"] = 1.0
        if _observe.ENABLED:
            signals["quota_sessions_over"] = float(
                _observe.RECORDER.gauges.get(("quota_sessions_over", "meter"), 0.0)
            )
        return signals

    def decide(self, kind: str, signals: Dict[str, float]) -> AdmissionDecision:
        """First tripped row wins; records for live sessions (submit/expire/
        reset) are only subject to rows marked ``arrivals_only=False`` — an
        admitted session keeps flowing under pressure that merely defers new
        arrivals."""
        arrival = kind == "add"
        for rule in self.table:
            if not arrival and rule.arrivals_only:
                continue
            if rule.tripped(signals):
                decision = AdmissionDecision(rule.verdict, rule.name, rule.retry_after_s)
                break
        else:
            decision = _ACCEPT
        self.counts[decision.verdict] += 1
        return decision
