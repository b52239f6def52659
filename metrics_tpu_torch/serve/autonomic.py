"""The autonomic observe-to-act loop: fleet signals become rate-limited reflexes (counterpart of
``metrics_tpu/serve/autonomic.py``).

Every rung already exists below this module — it only closes the loop:

* **double** — occupancy pressure (the watchdog's ``occupancy_psi`` signal
  when one is installed, raw occupancy otherwise) triggers pre-emptive
  capacity doubling via ``preexpand()``: exactly one compile per grown
  bucket, already pinned by the padded-capacity program-cache key, paid
  *before* the arrival burst empties a free-list mid-wave.
* **demote** — sustained ``quota_exceeded`` breaches drive the meter's
  existing ``pending_demotions()`` / ``confirm_demotion()`` handshake, so
  quota offenders walk down the gentlest blast-radius rung (loose, never
  failed) even when the owning engine is idle between ticks.
* **resize** — sharded fleets whose session populations skew past
  ``imbalance_ratio`` get a rendezvous-free elastic resize (every session
  re-enters through the normal arrival path; journals rebuilt).
* **shed** — overload (occupancy at the shed threshold, or the server's
  admission table saying so) expires loose sessions first: zero bucket
  state change, zero recompiles, smallest possible blast radius.

Every action is rate-limited per type, logged as a structured
``autonomic_action`` observe event + counter, and dry-runnable: a
``dry_run=True`` controller decides, logs and counts, but never mutates
the fleet — the operator reads exactly what the reflexes *would* do.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Hashable, List, NamedTuple, Optional

from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.observe.metering import installed_meter
from metrics_tpu_torch.observe.watchdog import installed_watchdog

__all__ = [
    "AUTONOMIC_ACTIONS",
    "AUTONOMIC_ENGINE_ALLOWLIST",
    "AutonomicAction",
    "AutonomicController",
    "shed_loose",
]

AUTONOMIC_ACTIONS = ("double", "demote", "resize", "shed")

# The declared action surface: the ONLY engine entry points a reflex may
# mutate through, so widening the autonomic blast radius is always an
# explicit, reviewable diff on this line.
AUTONOMIC_ENGINE_ALLOWLIST = ("preexpand", "resize", "expire", "_demote_by_meter")


class AutonomicAction(NamedTuple):
    action: str
    reason: str
    detail: Dict[str, Any]
    dry_run: bool
    executed: bool


def shed_loose(engine: Any, n: int = 1, reason: str = "overload") -> List[Hashable]:
    """Expire up to ``n`` loose/quarantined sessions — the shed ladder's first
    rung. Returns the session ids shed (possibly empty: an all-bucketed fleet
    has nothing cheap to shed, and this helper never escalates on its own)."""
    shed: List[Hashable] = []
    for sid in engine.loose_session_ids():
        if len(shed) >= n:
            break
        engine.expire(sid)
        shed.append(sid)
        _observe.note_serve_shed(str(sid), reason)
    return shed


class AutonomicController:
    """Observe fleet signals, act through existing primitives, rate-limited.

    ``step()`` is cheap enough to call every server poll / engine tick: each
    reflex first checks its own rate limit (one clock read), then its trip
    condition, and only then pays for the action. ``history`` keeps the last
    256 actions for the operator; ``counts`` feeds ``fleet_top``.
    """

    def __init__(
        self,
        engine: Any,
        *,
        dry_run: bool = False,
        psi_high: float = 0.25,
        occupancy_high_pct: float = 85.0,
        shed_occupancy_pct: float = 97.0,
        max_shed_per_step: int = 4,
        imbalance_ratio: float = 4.0,
        max_shards: Optional[int] = None,
        min_interval_s: Optional[Dict[str, float]] = None,
    ) -> None:
        self.engine = engine
        self.dry_run = bool(dry_run)
        self.psi_high = float(psi_high)
        self.occupancy_high_pct = float(occupancy_high_pct)
        self.shed_occupancy_pct = float(shed_occupancy_pct)
        self.max_shed_per_step = int(max_shed_per_step)
        self.imbalance_ratio = float(imbalance_ratio)
        self.max_shards = max_shards
        intervals = {"double": 2.0, "demote": 0.25, "resize": 30.0, "shed": 0.5}
        if min_interval_s:
            intervals.update(min_interval_s)
        self.min_interval_s = intervals
        self._last: Dict[str, float] = {}
        self.counts: Dict[str, int] = {a: 0 for a in AUTONOMIC_ACTIONS}
        self.history: Deque[AutonomicAction] = deque(maxlen=256)

    # ---------------------------------------------------------------- observe
    def observe(self) -> Dict[str, Any]:
        """One snapshot of every signal the reflexes read."""
        stats = self.engine.stats()
        signals: Dict[str, Any] = {
            "occupancy_pct": stats.get("occupancy_pct"),
            "sessions": stats.get("sessions", 0),
            "occupancy_psi": None,
            "quota_pending": 0,
            "shard_sessions": None,
        }
        wd = installed_watchdog()
        if wd is not None:
            signals["occupancy_psi"] = wd.health()["signals"].get("occupancy_psi")
        mt = installed_meter()
        if mt is not None and mt.policy is not None:
            mt.poll_quota()
            signals["quota_pending"] = len(mt.pending_demotions())
        shards = stats.get("shards")
        if shards is not None:
            signals["shard_sessions"] = [s["sessions"] for s in shards]
        return signals

    # ---------------------------------------------------------------- act
    def _allowed(self, action: str, now: float) -> bool:
        last = self._last.get(action)
        return last is None or now - last >= self.min_interval_s[action]

    def _record(
        self, action: str, reason: str, detail: Dict[str, Any], executed: bool, now: float
    ) -> AutonomicAction:
        self._last[action] = now
        self.counts[action] += 1
        act = AutonomicAction(action, reason, detail, self.dry_run, executed)
        self.history.append(act)
        _observe.note_autonomic_action(action, self.dry_run)
        _observe.record_event(
            "autonomic_action", action=action, reason=reason,
            dry_run=self.dry_run, executed=executed, **detail,
        )
        return act

    def step(self, now: Optional[float] = None) -> List[AutonomicAction]:
        """One observe→decide→act pass; returns the actions taken (or, under
        ``dry_run``, the actions that would have been taken)."""
        t = _observe.clock() if now is None else now
        signals = self.observe()
        actions: List[AutonomicAction] = []

        # double: occupancy pressure → pre-emptive capacity growth
        if self._allowed("double", t):
            psi = signals["occupancy_psi"]
            occ = signals["occupancy_pct"]
            psi_hot = psi is not None and psi >= self.psi_high
            occ_hot = occ is not None and occ >= self.occupancy_high_pct
            if psi_hot or occ_hot:
                reason = "occupancy_psi" if psi_hot else "occupancy"
                if self.dry_run:
                    actions.append(self._record("double", reason, {"occupancy_pct": occ, "psi": psi}, False, t))
                else:
                    grown = self.engine.preexpand(self.occupancy_high_pct)
                    if grown:
                        actions.append(self._record("double", reason, {"buckets": grown}, True, t))

        # demote: sustained quota breaches → the existing meter handshake
        if signals["quota_pending"] and self._allowed("demote", t):
            mt = installed_meter()
            if self.dry_run:
                actions.append(self._record(
                    "demote", "quota_exceeded", {"pending": list(mt.pending_demotions())}, False, t,
                ))
            else:
                demoted = self._drive_demotions(mt)
                if demoted:
                    actions.append(self._record("demote", "quota_exceeded", {"sessions": demoted}, True, t))

        # resize: shard population skew → rendezvous-free elastic resize
        shard_sessions = signals["shard_sessions"]
        if shard_sessions and len(shard_sessions) > 1 and self._allowed("resize", t):
            hi, lo = max(shard_sessions), min(shard_sessions)
            n = len(shard_sessions)
            room = self.max_shards is None or n < int(self.max_shards)
            if hi >= self.imbalance_ratio * max(1, lo) and room:
                detail = {"shard_sessions": shard_sessions, "to_shards": n + 1}
                if self.dry_run:
                    actions.append(self._record("resize", "shard_imbalance", detail, False, t))
                else:
                    self.engine.resize(n + 1)
                    actions.append(self._record("resize", "shard_imbalance", detail, True, t))

        # shed: overload → loose sessions first
        occ = signals["occupancy_pct"]
        if occ is not None and occ >= self.shed_occupancy_pct and self._allowed("shed", t):
            if self.dry_run:
                candidates = self.engine.loose_session_ids()[: self.max_shed_per_step]
                actions.append(self._record(
                    "shed", "occupancy", {"candidates": [str(s) for s in candidates]}, False, t,
                ))
            else:
                shed = shed_loose(self.engine, self.max_shed_per_step, "occupancy")
                if shed:
                    actions.append(self._record(
                        "shed", "occupancy", {"sessions": [str(s) for s in shed]}, True, t,
                    ))
        return actions

    def shed(self, n: int = 1, reason: str = "admission") -> List[Hashable]:
        """Shed on demand (the server's shed-loose-first admission verdict).

        Rate-limited like the autonomous shed reflex; a dry-run controller
        refuses (returns []) so admission under dry-run stays observe-only.
        """
        t = _observe.clock()
        if not self._allowed("shed", t):
            return []
        if self.dry_run:
            candidates = self.engine.loose_session_ids()[:n]
            self._record("shed", reason, {"candidates": [str(s) for s in candidates]}, False, t)
            return []
        shed = shed_loose(self.engine, n, reason)
        if shed:
            self._record("shed", reason, {"sessions": [str(s) for s in shed]}, True, t)
        return shed

    def _drive_demotions(self, mt: Any) -> List[str]:
        """Walk the meter's pending-demotion queue through the owning engines."""
        engines = getattr(self.engine, "_shards", None) or [self.engine]
        demoted: List[str] = []
        for skey in mt.pending_demotions():
            for eng in engines:
                before = skey in (str(s) for s in eng._sessions)
                if before:
                    eng._demote_by_meter(mt, skey)
                    demoted.append(skey)
                    break
            else:
                # the offender expired between breach and reflex: close the
                # handshake so the queue cannot wedge on a ghost
                mt.confirm_demotion(skey)
        return demoted
