"""Fleet metering: per-session / per-bucket / per-shard cost & memory attribution (counterpart of
``metrics_tpu/observe/metering.py``).

A fleet engine drives many tenants' sessions through *shared* dispatches: one
program per bucket per tick serves every resident session at once. That
economy erases the per-tenant cost signal; this module is the host-side
cost-attribution ledger that restores it. The JAX package's stream engines
feed it from their hot paths behind the recorder's single ``ENABLED`` check;
the port's engine will, and until then a caller charges it directly.

**Amortization rule.** Each successful bucket dispatch is measured once (host
wall clock around the call) and charged to the wave's active rows in equal
shares: a wave of *n* sessions costing *w* seconds charges *w/n* to each. A
static FLOPs/bytes estimate of the bucket's program (resolved once per
``cost_key`` by the caller's ``cost_fn``) amortizes over the *active* wave the
same way, so active sessions pay for the padding they force the program to
carry. Wall time that buys no attribution (a dispatch that died mid-flight)
still accrues to ``measured_dispatch_s`` but never to a session, so
``attributed_s / measured_dispatch_s`` is a conservation check.

**Bounded memory.** Exact :class:`SessionLedger` rows are kept for at most
``top_k`` sessions (first-come admission); every session beyond that folds
into a mergeable weighted :class:`SpaceSaving` heavy-hitter sketch keyed on
dispatch-seconds, with the classic guarantee
``|estimate - true| ≤ total_weight / capacity``. Host memory is therefore
``O(top_k + sketch_capacity)`` regardless of fleet size.

**Merge discipline.** :meth:`FleetMeter.export_state` /
:meth:`FleetMeter.sync_telemetry` fold shard meters exactly the way
``HostDDSketch`` and the watchdog fold: exact ledgers merge field-wise,
overflow demotes the smallest back into the sketch, and sketches merge by
pointwise counter sum + top-``capacity`` truncation (merged error ≤ combined
weight / capacity).

**Quota semantics.** :class:`MeterPolicy` is an opt-in *soft* quota: a breach
fires a ``quota_exceeded`` event + the watchdog-visible
``quota_sessions_over`` gauge, and — only when ``action="demote"`` — queues
the session for demotion by its owning engine. Nothing is ever failed or
dropped.

:func:`program_cost` stands in for the JAX package's static cost from XLA's
cost analysis of the lowered update: FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` over one row's update, and the
bytes of the row's states and operands, times the capacity. Its only caller is
the stream engine's meter hook. Everything else here is stdlib only.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

from metrics_tpu_torch.observe import recorder as _rec

__all__ = [
    "FleetMeter",
    "MeterPolicy",
    "SessionLedger",
    "SpaceSaving",
    "install_meter",
    "installed_meter",
    "program_cost",
    "uninstall_meter",
]

DEFAULT_TOP_K = 64
DEFAULT_SKETCH_CAPACITY = 256

# per-session resource fields carried by an exact ledger; merge = field-wise +
_LEDGER_FIELDS = (
    "updates", "dispatch_s", "est_flops", "est_bytes",
    "loose_updates", "quarantines", "wal_bytes", "ckpt_bytes",
)


class SessionLedger:
    """One session's exact resource account (all fields merge by ``+``)."""

    __slots__ = _LEDGER_FIELDS

    def __init__(self) -> None:
        self.updates = 0
        self.dispatch_s = 0.0
        self.est_flops = 0.0
        self.est_bytes = 0.0
        self.loose_updates = 0
        self.quarantines = 0
        self.wal_bytes = 0
        self.ckpt_bytes = 0.0

    def merge(self, other: "SessionLedger") -> None:
        for f in _LEDGER_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def as_dict(self) -> Dict[str, Any]:
        return {f: getattr(self, f) for f in _LEDGER_FIELDS}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SessionLedger":
        led = cls()
        for f in _LEDGER_FIELDS:
            if f in d:
                setattr(led, f, d[f])
        return led


class SpaceSaving:
    """Weighted SpaceSaving heavy-hitter sketch (Metwally et al.), mergeable.

    Holds at most ``capacity`` counters. :meth:`offer` of a tracked key adds
    its weight exactly; an untracked key evicts the minimum counter *m* and
    inherits its count (``m + w``) with error ``m`` — so every estimate is an
    overestimate by at most its recorded error, and both the error and the
    gap to the true count are bounded by ``total / capacity``. Merge is the
    mergeable-summaries fold: pointwise counter sum (errors add), truncate to
    the top ``capacity`` by count — the merged sketch keeps the combined
    bound ``(total_a + total_b) / capacity``.
    """

    __slots__ = ("capacity", "total", "_counts")

    def __init__(self, capacity: int = DEFAULT_SKETCH_CAPACITY) -> None:
        if capacity < 1:
            raise ValueError(f"SpaceSaving capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.total = 0.0
        self._counts: Dict[str, List[float]] = {}  # key -> [count, error]

    def __len__(self) -> int:
        return len(self._counts)

    def offer(self, key: str, weight: float = 1.0) -> None:
        w = float(weight)
        if w <= 0.0:
            return
        self.total += w
        entry = self._counts.get(key)
        if entry is not None:
            entry[0] += w
            return
        if len(self._counts) < self.capacity:
            self._counts[key] = [w, 0.0]
            return
        evict_key = min(self._counts, key=lambda k: self._counts[k][0])
        floor = self._counts.pop(evict_key)[0]
        self._counts[key] = [floor + w, floor]

    def estimate(self, key: str) -> Optional[Tuple[float, float]]:
        """(count, error) for a tracked key — ``true ∈ [count - error, count]``
        — or None when the key holds no counter."""
        entry = self._counts.get(key)
        return None if entry is None else (entry[0], entry[1])

    def error_bound(self) -> float:
        """Worst-case gap between any estimate and its true weight."""
        return self.total / self.capacity

    def items(self) -> List[Tuple[str, float, float]]:
        """``(key, count, error)`` rows, heaviest first."""
        return sorted(
            ((k, c, e) for k, (c, e) in self._counts.items()),
            key=lambda row: -row[1],
        )

    def merge(self, other: "SpaceSaving") -> None:
        merged: Dict[str, List[float]] = {k: list(v) for k, v in self._counts.items()}
        for k, (c, e) in other._counts.items():
            entry = merged.get(k)
            if entry is None:
                merged[k] = [c, e]
            else:
                entry[0] += c
                entry[1] += e
        if len(merged) > self.capacity:
            keep = sorted(merged, key=lambda k: -merged[k][0])[: self.capacity]
            merged = {k: merged[k] for k in keep}
        self._counts = merged
        self.total += other.total

    # -------------------------------------------------------------- export
    def state(self) -> Dict[str, Any]:
        return {
            "capacity": self.capacity,
            "total": self.total,
            "entries": [[k, c, e] for k, (c, e) in self._counts.items()],
        }

    def merge_state(self, state: Mapping[str, Any]) -> None:
        self.merge(SpaceSaving.from_state(state))

    @classmethod
    def from_state(cls, state: Mapping[str, Any]) -> "SpaceSaving":
        sk = cls(int(state["capacity"]))
        sk.total = float(state.get("total", 0.0))
        sk._counts = {str(k): [float(c), float(e)] for k, c, e in state.get("entries", [])}
        return sk


class MeterPolicy:
    """Opt-in soft quota over the meter's exact ledgers.

    Limits are checked against exact ledgers only (a session the meter never
    admitted exactly cannot be precisely accused). ``max_dispatch_share`` is
    a fraction of fleet-wide attributed dispatch seconds and is only
    evaluated once ``min_total_dispatch_s`` of work has been attributed, so
    the first session of a quiet fleet (share = 100%) never trips it.
    ``action="observe"`` fires events/gauges only; ``action="demote"`` also
    queues the session for demote-to-loose by its owning engine — the
    gentlest blast-radius rung: the tenant keeps computing, it just stops
    sharing the fleet's compiled dispatch.
    """

    __slots__ = (
        "max_dispatch_share", "max_updates", "max_wal_bytes",
        "min_total_dispatch_s", "action", "cooldown_s",
    )

    def __init__(
        self,
        max_dispatch_share: Optional[float] = None,
        max_updates: Optional[int] = None,
        max_wal_bytes: Optional[int] = None,
        min_total_dispatch_s: float = 0.0,
        action: str = "observe",
        cooldown_s: float = 60.0,
    ) -> None:
        if action not in ("observe", "demote"):
            raise ValueError(f"MeterPolicy action must be 'observe' or 'demote', got {action!r}")
        if max_dispatch_share is not None and not 0.0 < max_dispatch_share <= 1.0:
            raise ValueError(f"max_dispatch_share must be in (0, 1], got {max_dispatch_share}")
        self.max_dispatch_share = max_dispatch_share
        self.max_updates = max_updates
        self.max_wal_bytes = max_wal_bytes
        self.min_total_dispatch_s = float(min_total_dispatch_s)
        self.action = action
        self.cooldown_s = float(cooldown_s)

    def breaches(self, skey: str, led: SessionLedger, total_dispatch_s: float) -> List[Tuple[str, float, float]]:
        """``(reason, value, limit)`` rows for every limit this ledger exceeds."""
        out: List[Tuple[str, float, float]] = []
        if (
            self.max_dispatch_share is not None
            and total_dispatch_s >= self.min_total_dispatch_s
            and total_dispatch_s > 0.0
            and led.dispatch_s / total_dispatch_s > self.max_dispatch_share
        ):
            out.append(("dispatch_share", led.dispatch_s / total_dispatch_s, self.max_dispatch_share))
        if self.max_updates is not None and led.updates > self.max_updates:
            out.append(("updates", float(led.updates), float(self.max_updates)))
        if self.max_wal_bytes is not None and led.wal_bytes > self.max_wal_bytes:
            out.append(("wal_bytes", float(led.wal_bytes), float(self.max_wal_bytes)))
        return out


def _nbytes(v: Any) -> int:
    return int(v.numel() * v.element_size()) if hasattr(v, "element_size") else int(getattr(v, "nbytes", 0))


def program_cost(template: Any, capacity: int, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one bucket's program: one row's update, times ``capacity``.

    The stand-in for the JAX package's lowering of the per-row update (the
    vmapped program computes every row, padding included): the row is the
    stacked operands' first row and the template's default state, the FLOPs
    are what ``torch.utils.flop_counter.FlopCounterMode`` counts over the row's
    update (matrix products and convolutions; elementwise work counts zero),
    and the bytes are each operand read once plus each state read and written
    once. Any failure gives (0, 0): cost attribution is best-effort, and
    wall-time attribution never depends on it.
    """
    try:
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        def row(v: Any) -> Any:
            if isinstance(v, torch.Tensor) and v.ndim >= 1:
                return v[0]
            if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1:
                return torch.as_tensor(v[0], device=template.device)
            return v

        state = template._fresh_state()
        row_args = tuple(row(a) for a in args)
        row_kwargs = {k: row(v) for k, v in kwargs.items()}
        rep = template.clone()
        with FlopCounterMode(display=False) as counter:
            rep._functional_update(state, *row_args, **row_kwargs)
        flops = float(counter.get_total_flops())
        nbytes = 2 * sum(_nbytes(v) for v in state.values() if not isinstance(v, list))
        nbytes += sum(_nbytes(v) for v in list(row_args) + list(row_kwargs.values()))
        return max(0.0, flops) * capacity, float(nbytes) * capacity
    except Exception:  # noqa: BLE001 — cost attribution is strictly best-effort
        return 0.0, 0.0


class FleetMeter:
    """Host-side fleet cost/memory-attribution ledger (install via :func:`install_meter`).

    Every public note hook is a dict update + a few float adds under one lock.
    Session keys are ``str(session_id)`` throughout (JSON-able exports; stable
    across processes for the shard fold).
    """

    def __init__(
        self,
        top_k: int = DEFAULT_TOP_K,
        sketch_capacity: int = DEFAULT_SKETCH_CAPACITY,
        policy: Optional[MeterPolicy] = None,
        max_program_costs: int = 512,
        poll_interval_s: float = 0.25,
    ) -> None:
        if top_k < 1:
            raise ValueError(f"FleetMeter top_k must be >= 1, got {top_k}")
        self.top_k = int(top_k)
        self.sketch_capacity = int(sketch_capacity)
        self.policy = policy
        # quota polls rate-limit like watchdog pokes: engines call poll_quota
        # every tick, the full ledger scan runs at most once per interval
        self.poll_interval_s = float(poll_interval_s)
        self._last_poll = float("-inf")
        self._lock = threading.Lock()
        self._exact: Dict[str, SessionLedger] = {}
        self._sketch = SpaceSaving(sketch_capacity)
        self._measured_dispatch_s = 0.0  # every dispatch attempt's wall, success or not
        self._attributed_s = 0.0  # wall actually charged to sessions (exact + sketch)
        # lazy per-(bucket label, capacity, submission signature) static program
        # cost; one cost_fn call per entry, off the steady-state path, bounded LRU
        self._program_costs: "OrderedDict[Any, Tuple[float, float]]" = OrderedDict()
        self._max_program_costs = int(max_program_costs)
        # (engine name, bucket label) -> memory ledger row; engine name is the
        # shard-unique "<fleet>/shardN" for sharded fleets, so rows never collide
        self._memory: Dict[Tuple[str, str], Dict[str, float]] = {}
        # soft-quota bookkeeping: last fire clock per (skey, reason) for the
        # cooldown, plus the demote handshake sets (engine claims ownership)
        self._quota_fired_at: Dict[Tuple[str, str], float] = {}
        self._quota_exceeded_total = 0
        self._pending_demote: set = set()
        self._demoted: set = set()
        # per-producer network-ingest ledger (the serve front door):
        # producer name -> {"records", "bytes", "dedup_skipped"}; producers are
        # operator-named connections, so cardinality is fleet-operator-bounded
        self._ingest: Dict[str, Dict[str, int]] = {}

    # ------------------------------------------------------------------ charging
    def _ledger(self, skey: str) -> Optional[SessionLedger]:
        led = self._exact.get(skey)
        if led is None and len(self._exact) < self.top_k:
            led = self._exact[skey] = SessionLedger()
        return led

    def _resolve_cost(self, cost_key: Any, cost_fn: Optional[Callable[[], Tuple[float, float]]]) -> Tuple[float, float]:
        if cost_key is None:
            return 0.0, 0.0
        with self._lock:
            cached = self._program_costs.get(cost_key)
        if cached is not None:
            return cached
        cost = cost_fn() if cost_fn is not None else (0.0, 0.0)
        with self._lock:
            self._program_costs[cost_key] = cost
            while len(self._program_costs) > self._max_program_costs:
                self._program_costs.popitem(last=False)
        return cost

    def note_dispatch(
        self,
        label: str,
        session_keys: List[str],
        wall_s: float,
        cost_key: Any = None,
        cost_fn: Optional[Callable[[], Tuple[float, float]]] = None,
    ) -> None:
        """Charge one successful bucket dispatch to its wave's sessions.

        ``wall_s`` (and the program's static FLOPs/bytes, resolved lazily per
        ``cost_key`` — first sight pays one ``cost_fn`` call) amortize in equal
        shares over ``session_keys``. Sessions without an exact ledger fold
        their dispatch-seconds share into the SpaceSaving sketch.
        """
        n = len(session_keys)
        if n == 0:
            with self._lock:
                self._measured_dispatch_s += wall_s
            return
        flops, nbytes = self._resolve_cost(cost_key, cost_fn)
        share_s = wall_s / n
        share_flops = flops / n
        share_bytes = nbytes / n
        # hot path: inline the admission check and bind lookups once — this
        # runs per dispatch inside the engine's tick
        with self._lock:
            self._measured_dispatch_s += wall_s
            self._attributed_s += wall_s  # n equal shares, summed exactly
            exact = self._exact
            top_k = self.top_k
            sketch_offer = self._sketch.offer
            for skey in session_keys:
                led = exact.get(skey)
                if led is None:
                    if len(exact) < top_k:
                        led = exact[skey] = SessionLedger()
                    else:
                        sketch_offer(skey, share_s)
                        continue
                led.updates += 1
                led.dispatch_s += share_s
                led.est_flops += share_flops
                led.est_bytes += share_bytes

    def note_failed_dispatch(self, label: str, wall_s: float) -> None:
        """Wall time a dying dispatch burned: measured, attributable to no one."""
        with self._lock:
            self._measured_dispatch_s += wall_s

    def note_loose_update(self, skey: str) -> None:
        # hot path (one call per eager update): admission inlined, no helper
        with self._lock:
            led = self._exact.get(skey)
            if led is None:
                if len(self._exact) >= self.top_k:
                    return
                led = self._exact[skey] = SessionLedger()
            led.updates += 1
            led.loose_updates += 1

    def note_quarantine(self, skey: str) -> None:
        with self._lock:
            led = self._ledger(skey)
            if led is not None:
                led.quarantines += 1

    def note_wal_bytes(self, skey: str, nbytes: int) -> None:
        with self._lock:
            led = self._ledger(skey)
            if led is not None:
                led.wal_bytes += int(nbytes)

    def note_ckpt_bytes(self, session_keys: List[str], nbytes: int) -> None:
        """Amortize one bucket checkpoint blob over its resident sessions."""
        if not session_keys:
            return
        share = nbytes / len(session_keys)
        with self._lock:
            for skey in session_keys:
                led = self._ledger(skey)
                if led is not None:
                    led.ckpt_bytes += share

    def note_ingest(self, producer: str, records: int = 0, nbytes: int = 0, dedup_skipped: int = 0) -> None:
        """Charge one front-door poll's intake to its producer connection."""
        with self._lock:
            row = self._ingest.get(producer)
            if row is None:
                row = self._ingest[producer] = {"records": 0, "bytes": 0, "dedup_skipped": 0}
            row["records"] += int(records)
            row["bytes"] += int(nbytes)
            row["dedup_skipped"] += int(dedup_skipped)

    def ingest_ledger(self) -> Dict[str, Any]:
        """Per-producer ingest rows plus fleet-wide totals."""
        with self._lock:
            rows = {p: dict(row) for p, row in sorted(self._ingest.items())}
        totals = {"records": 0, "bytes": 0, "dedup_skipped": 0}
        for row in rows.values():
            for f in totals:
                totals[f] += row[f]
        return {"producers": rows, "totals": totals}

    # ------------------------------------------------------------------ memory ledger
    def note_bucket_memory(self, engine: str, label: str, capacity: int, active: int, row_bytes: int) -> None:
        """Refresh one bucket's memory ledger row (from its state avals).

        ``live_bytes`` is what active sessions actually use, ``pad_waste``
        what the padded capacity burns on top, ``peak_capacity_bytes`` the
        historical high-water of the stacked allocation, and ``projected_2x``
        what the next :meth:`_Bucket.grow` doubling would allocate — the
        number a sharded-state layout needs per bucket.
        """
        key = (engine, label)
        stacked = capacity * row_bytes
        with self._lock:
            prev_peak = self._memory.get(key, {}).get("peak_capacity_bytes", 0)
            self._memory[key] = {
                "capacity": capacity,
                "active": active,
                "row_bytes": row_bytes,
                "live_bytes": active * row_bytes,
                "pad_waste_bytes": (capacity - active) * row_bytes,
                "peak_capacity_bytes": max(prev_peak, stacked),
                "projected_2x_bytes": 2 * stacked,
            }

    def drop_bucket_memory(self, engine: str, label: str) -> None:
        with self._lock:
            self._memory.pop((engine, label), None)

    def memory_ledger(self) -> Dict[str, Any]:
        """Per-bucket rows plus per-engine (per-shard) and fleet-wide totals."""
        with self._lock:
            rows = {f"{eng}::{lbl}": dict(row) for (eng, lbl), row in sorted(self._memory.items())}
            per_engine: Dict[str, Dict[str, float]] = {}
            for (eng, _lbl), row in self._memory.items():
                agg = per_engine.setdefault(
                    eng, {"live_bytes": 0, "pad_waste_bytes": 0, "peak_capacity_bytes": 0, "projected_2x_bytes": 0}
                )
                for f in agg:
                    agg[f] += row[f]
        totals = {"live_bytes": 0, "pad_waste_bytes": 0, "peak_capacity_bytes": 0, "projected_2x_bytes": 0}
        for agg in per_engine.values():
            for f in totals:
                totals[f] += agg[f]
        return {"buckets": rows, "engines": {k: per_engine[k] for k in sorted(per_engine)}, "totals": totals}

    # ------------------------------------------------------------------ readout
    def totals(self) -> Dict[str, float]:
        with self._lock:
            return {
                "measured_dispatch_s": self._measured_dispatch_s,
                "attributed_s": self._attributed_s,
                "attribution_pct": (
                    100.0 * self._attributed_s / self._measured_dispatch_s
                    if self._measured_dispatch_s > 0.0
                    else None
                ),
                "sessions_exact": len(self._exact),
                "sessions_sketched": len(self._sketch),
                "sketch_total_s": self._sketch.total,
                "sketch_error_bound_s": self._sketch.error_bound(),
                "quota_exceeded_total": self._quota_exceeded_total,
            }

    def top_sessions(self, n: int = 10) -> List[Dict[str, Any]]:
        """The ``n`` heaviest sessions by dispatch-seconds, exact rows first-class.

        Exact ledgers rank by their precise ``dispatch_s`` and carry every
        field; sketch entries rank by their (over-)estimate and carry the
        error bar instead — a heavy tenant that arrived after the exact set
        filled still surfaces here.
        """
        with self._lock:
            rows: List[Dict[str, Any]] = [
                {"session": skey, "source": "exact", "dispatch_s": led.dispatch_s, "error_s": 0.0, **led.as_dict()}
                for skey, led in self._exact.items()
            ]
            sketch_rows = self._sketch.items()
        rows.extend(
            {"session": skey, "source": "sketch", "dispatch_s": est, "error_s": err}
            for skey, est, err in sketch_rows
        )
        rows.sort(key=lambda r: -r["dispatch_s"])
        return rows[:n]

    def explain_session(self, session_id: Any) -> Dict[str, Any]:
        """Everything the meter knows about one session (never raises)."""
        skey = str(session_id)
        with self._lock:
            led = self._exact.get(skey)
            total = self._attributed_s
            if led is not None:
                out = {"session": skey, "tracked": "exact", **led.as_dict()}
                out["dispatch_share_pct"] = 100.0 * led.dispatch_s / total if total > 0.0 else None
                return out
            est = self._sketch.estimate(skey)
        if est is not None:
            count, err = est
            return {
                "session": skey, "tracked": "sketch",
                "dispatch_s": count, "error_s": err,
                "dispatch_share_pct": 100.0 * count / total if total > 0.0 else None,
            }
        return {"session": skey, "tracked": None}

    # ------------------------------------------------------------------ soft quota
    def poll_quota(self, now: Optional[float] = None) -> None:
        """Evaluate the policy over the exact ledgers (engine ticks call this).

        Each breach (per session, per reason, rate-limited by the policy
        cooldown) lands a ``quota_exceeded`` event + counter; the
        ``quota_sessions_over`` gauge — watchdog-visible like any other
        recorder gauge, so an :class:`SloRule` can alert on it — tracks how
        many sessions are currently over. ``action="demote"`` additionally
        queues the session; the engine that owns it picks it up via
        :meth:`pending_demotions` / :meth:`confirm_demotion`.

        The full ledger scan rate-limits to ``poll_interval_s`` (watchdog-poke
        discipline): the per-tick fast path is one clock read.
        """
        pol = self.policy
        if pol is None:
            return
        t = _rec.clock() if now is None else now
        if t - self._last_poll < self.poll_interval_s:
            return
        self._last_poll = t
        fired: List[Tuple[str, str, float, float]] = []
        with self._lock:
            total = self._attributed_s
            over = 0
            for skey, led in self._exact.items():
                rows = pol.breaches(skey, led, total)
                if rows:
                    over += 1
                    if pol.action == "demote" and skey not in self._demoted:
                        self._pending_demote.add(skey)
                for reason, value, limit in rows:
                    last = self._quota_fired_at.get((skey, reason))
                    if last is not None and t - last < pol.cooldown_s:
                        continue
                    self._quota_fired_at[(skey, reason)] = t
                    self._quota_exceeded_total += 1
                    fired.append((skey, reason, value, limit))
        if _rec.ENABLED:
            _rec.RECORDER.set_gauge("quota_sessions_over", "meter", float(over))
            for skey, reason, value, limit in fired:
                _rec.RECORDER.add_count("quota_exceeded", reason)
                _rec.RECORDER.add_event(
                    "quota_exceeded", session=skey, reason=reason, value=value, limit=limit,
                    action=pol.action,
                )

    def pending_demotions(self) -> List[str]:
        with self._lock:
            return sorted(self._pending_demote)

    def confirm_demotion(self, skey: str) -> None:
        """The owning engine demoted this session (or verified it is no longer
        demotable); stop asking."""
        with self._lock:
            self._pending_demote.discard(skey)
            self._demoted.add(skey)

    # ------------------------------------------------------------------ shard fold
    def export_state(self) -> Dict[str, Any]:
        """JSON-able mergeable meter state (the watchdog/HostDDSketch discipline)."""
        with self._lock:
            return {
                "schema": 1,
                "top_k": self.top_k,
                "measured_dispatch_s": self._measured_dispatch_s,
                "attributed_s": self._attributed_s,
                "quota_exceeded_total": self._quota_exceeded_total,
                "exact": {skey: led.as_dict() for skey, led in self._exact.items()},
                "sketch": self._sketch.state(),
                "memory": [
                    [eng, lbl, dict(row)] for (eng, lbl), row in sorted(self._memory.items())
                ],
                "ingest": {p: dict(row) for p, row in sorted(self._ingest.items())},
            }

    def sync_telemetry(self, peer_states: Iterable[Mapping[str, Any]]) -> "FleetMeter":
        """Fold peer shards' exported states into this meter (local first).

        Exact ledgers merge field-wise; if the union exceeds ``top_k``, the
        lightest (by dispatch-seconds) demote into the sketch — their exact
        dispatch total becomes a zero-error sketch entry, so the heavy-hitter
        ranking survives the fold within the SpaceSaving bound. Sketches and
        memory rows merge by their own algebras (counter sum / field sum with
        peak = max).
        """
        with self._lock:
            for state in peer_states:
                self._measured_dispatch_s += float(state.get("measured_dispatch_s", 0.0))
                self._attributed_s += float(state.get("attributed_s", 0.0))
                self._quota_exceeded_total += int(state.get("quota_exceeded_total", 0))
                for skey, row in (state.get("exact") or {}).items():
                    led = self._exact.get(skey)
                    if led is None:
                        self._exact[skey] = SessionLedger.from_dict(row)
                    else:
                        led.merge(SessionLedger.from_dict(row))
                sketch_state = state.get("sketch")
                if sketch_state:
                    self._sketch.merge_state(sketch_state)
                for producer, row in (state.get("ingest") or {}).items():
                    mine_row = self._ingest.setdefault(
                        producer, {"records": 0, "bytes": 0, "dedup_skipped": 0}
                    )
                    for f in mine_row:
                        mine_row[f] += int(row.get(f, 0))
                for eng, lbl, row in state.get("memory") or []:
                    key = (str(eng), str(lbl))
                    mine = self._memory.get(key)
                    if mine is None:
                        self._memory[key] = dict(row)
                    else:
                        for f in ("capacity", "active", "live_bytes", "pad_waste_bytes", "projected_2x_bytes"):
                            mine[f] = mine.get(f, 0) + row.get(f, 0)
                        mine["peak_capacity_bytes"] = max(
                            mine.get("peak_capacity_bytes", 0), row.get("peak_capacity_bytes", 0)
                        )
                        mine["row_bytes"] = max(mine.get("row_bytes", 0), row.get("row_bytes", 0))
            if len(self._exact) > self.top_k:
                ranked = sorted(self._exact, key=lambda k: -self._exact[k].dispatch_s)
                for skey in ranked[self.top_k :]:
                    led = self._exact.pop(skey)
                    self._sketch.offer(skey, led.dispatch_s)
        return self

    # ------------------------------------------------------------------ export surfaces
    def snapshot_payload(self, top_n: int = 10) -> Dict[str, Any]:
        """The ``snapshot()["metering"]`` section (recorder calls this lazily)."""
        totals = self.totals()
        return {
            "installed": True,
            "top_k": self.top_k,
            "sketch_capacity": self.sketch_capacity,
            "totals": totals,
            "top_sessions": self.top_sessions(top_n),
            "memory": self.memory_ledger(),
            "ingest": self.ingest_ledger(),
            "policy": None if self.policy is None else {
                "action": self.policy.action,
                "max_dispatch_share": self.policy.max_dispatch_share,
                "max_updates": self.policy.max_updates,
                "max_wal_bytes": self.policy.max_wal_bytes,
            },
        }

    def prometheus_lines(self, prom_name: Callable[[str], str], prom_label: Callable[[str], str]) -> List[str]:
        """Metering families for the recorder's exposition dump.

        Cardinality is bounded by construction: per-session families emit
        only the exact ledgers (≤ ``top_k`` label values regardless of fleet
        size — sketch entries are aggregates, never labels), per-bucket
        families only live buckets.
        """
        lines: List[str] = []

        def _family(prom: str, kind: str, help_text: str) -> None:
            lines.append(f"# HELP {prom} {help_text}")
            lines.append(f"# TYPE {prom} {kind}")

        with self._lock:
            exact = [(skey, led.as_dict()) for skey, led in sorted(self._exact.items())]
            memory = [(eng, lbl, dict(row)) for (eng, lbl), row in sorted(self._memory.items())]
            measured = self._measured_dispatch_s
            attributed = self._attributed_s
            sketch_total = self._sketch.total
            sketch_bound = self._sketch.error_bound()
        for field, kind, help_text in (
            ("dispatch_s", "counter", "attributed dispatch wall seconds per session (top-K exact ledgers)"),
            ("updates", "counter", "engine updates applied per session (top-K exact ledgers)"),
            ("est_flops", "counter", "estimated FLOPs attributed per session (static cost model)"),
            ("est_bytes", "counter", "estimated bytes-accessed attributed per session (static cost model)"),
            ("wal_bytes", "counter", "WAL bytes journaled per session (top-K exact ledgers)"),
        ):
            prom = prom_name(f"meter_session_{field}") + "_total"
            _family(prom, kind, f"metrics_tpu fleet metering: {help_text}.")
            for skey, row in exact:
                lines.append(f'{prom}{{session="{prom_label(skey)}"}} {row[field]}')
        for field in ("live_bytes", "pad_waste_bytes", "peak_capacity_bytes", "projected_2x_bytes"):
            prom = prom_name(f"meter_bucket_{field}")
            _family(prom, "gauge", f"metrics_tpu fleet metering: per-bucket memory ledger {field}.")
            for eng, lbl, row in memory:
                sel = f'engine="{prom_label(eng)}",bucket="{prom_label(lbl)}"'
                lines.append(f"{prom}{{{sel}}} {row[field]}")
        for name, value, help_text in (
            ("meter_measured_dispatch_seconds", measured, "dispatch wall seconds the meter measured"),
            ("meter_attributed_dispatch_seconds", attributed, "dispatch wall seconds attributed to sessions"),
            ("meter_sketch_weight_seconds", sketch_total, "dispatch seconds folded into the heavy-hitter sketch"),
            ("meter_sketch_error_bound_seconds", sketch_bound, "SpaceSaving worst-case estimate error"),
        ):
            prom = prom_name(name)
            _family(prom, "gauge", f"metrics_tpu fleet metering: {help_text}.")
            lines.append(f"{prom} {value:.9f}")
        return lines


# ----------------------------------------------------------------- installation

_ACTIVE: Optional[FleetMeter] = None


def install_meter(meter: Optional[FleetMeter] = None, **kwargs: Any) -> FleetMeter:
    """Register a process-wide fleet meter; engine hot paths feed it.

    Pass an instance, or keyword args forwarded to :class:`FleetMeter`. Like
    the watchdog, the meter is held on the recorder module (one attribute
    read per hot path) but is process-local state independent of the
    recorder instance — a swapped-in probe recorder still feeds the same
    installed meter.
    """
    global _ACTIVE
    mt = meter if meter is not None else FleetMeter(**kwargs)
    _ACTIVE = mt
    _rec._set_meter(mt)
    return mt


def uninstall_meter() -> None:
    global _ACTIVE
    _ACTIVE = None
    _rec._set_meter(None)


def installed_meter() -> Optional[FleetMeter]:
    return _ACTIVE
