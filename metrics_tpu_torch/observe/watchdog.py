"""Self-monitoring watchdog: our own metric designs over our own telemetry (counterpart of
``metrics_tpu/observe/watchdog.py``).

The recorder and the flight recorder *emit* counters, spans and latency
sketches, but nothing watches them. This module closes the loop by running
host-side twins of the package's own streaming-metric designs on the
telemetry stream itself:

* :class:`HostTimeDecayedRate` — the ``windows.TimeDecayed`` fold (state ·
  2^(−Δt/half_life) + batch) as two plain floats, giving exponentially
  time-decayed compile/eviction/fallback/rollback rates;
* :class:`HostCUSUM` — Page's two-sided CUSUM in the exact ``(total,
  statistic, max-prefix, watermark)`` segment-compose form of
  ``ops/decay.cusum_compose``, so per-shard watchdog states merge to the
  single-stream trajectory bit-for-bit (local segment first, peer appended);
* :func:`host_psi` — the ``drift.PSI`` formula (Σ (p_live − p_ref) ·
  ln(p_live / p_ref), probabilities clipped at 1e-6) over the fleet
  occupancy histogram, referenced against the first populated sample;
* latency quantiles read straight from the recorder's per-(phase, label)
  :class:`~metrics_tpu_torch.observe.latency.HostDDSketch` instances (merged
  across labels — duck-typed, so this module stays stdlib-only).

Each :meth:`Watchdog.sample` turns recorder counter/gauge deltas into a
``signals`` dict, publishes every numeric signal as a ``watchdog_signal``
gauge, and evaluates the declarative :class:`SloRule` list: a rule fires
after ``for_ticks`` *consecutive* breaching samples (``slo_fired`` event +
counter, ``slo_firing`` gauge → 1) and resolves on the first healthy sample
(``slo_resolved``, gauge → 0). Everything lands in the ordinary recorder
surfaces, so ``observe.snapshot()`` / ``observe.prometheus()`` carry the alert
state — and nothing on this path touches the device.

The signals are the JAX package's, plus one: ``update_p99_s``, the windowed
p99 of the ``update`` phase, which is the port's hot path until its stream
engine (whose ticks feed ``tick_p99_s``) lands.

Wiring: :func:`install_watchdog` registers the instance with the recorder;
``recorder.poke_watchdog`` samples it at most once per ``min_interval_s``;
loops without an engine call ``observe.poke_watchdog()`` or
:meth:`Watchdog.sample` themselves. Cross-process fleets merge shard watchdogs
through :meth:`Watchdog.export_state` / :meth:`Watchdog.sync_telemetry`.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from metrics_tpu_torch.observe import recorder as _rec

__all__ = [
    "DEFAULT_SLOS",
    "HostCUSUM",
    "HostTimeDecayedRate",
    "SloRule",
    "Watchdog",
    "host_psi",
    "install_watchdog",
    "installed_watchdog",
    "uninstall_watchdog",
]

# counter families summed into each decayed rate / hit-rate signal — the same
# names the recorder's note_* hooks use, across all compiled-program caches
_COMPILE_COUNTERS = ("jit_compile", "jit_compile_unshared", "fleet_compile", "replica_compile", "fused_compile")
_EVICT_COUNTERS = ("jit_cache_eviction", "fleet_evict", "replica_evict")
_FALLBACK_COUNTERS = ("eager_fallback", "fleet_fallback", "replica_fallback", "fused_fallback")
_HIT_COUNTERS = ("jit_cache_hit", "fleet_hit", "replica_hit", "fused_hit")

_PSI_BINS = 10
_PSI_EPS = 1e-6  # probability clip — mirrors drift/histogram.py's _EPS


# ------------------------------------------------------------------ host twins

class HostTimeDecayedRate:
    """Host twin of ``windows.TimeDecayed`` over an event-count stream.

    Two floats fold the decayed event mass and the decayed observed seconds::

        w = 2^(−Δt / half_life_s);  sum ← sum·w + n;  norm ← norm·w + Δt

    ``rate()`` is events/second over the effective window (None until any
    time has elapsed). ``merge_state`` aligns the peer to the newer
    timestamp, *sums* the event mass and takes the *max* of the time norms:
    two shards watch the same wall clock, so equal windows merge to the sum
    of their rates, not the average.
    """

    __slots__ = ("half_life_s", "_sum", "_norm", "_t")

    def __init__(self, half_life_s: float = 30.0) -> None:
        if not half_life_s > 0.0:
            raise ValueError(f"`half_life_s` must be > 0, got {half_life_s}")
        self.half_life_s = float(half_life_s)
        self._sum = 0.0
        self._norm = 0.0
        self._t: Optional[float] = None

    def observe(self, n: float, now: float) -> None:
        if self._t is None:
            self._sum = float(n)
            self._norm = 0.0
            self._t = float(now)
            return
        dt = max(0.0, float(now) - self._t)
        w = 2.0 ** (-dt / self.half_life_s)
        self._sum = self._sum * w + float(n)
        self._norm = self._norm * w + dt
        self._t = float(now)

    def rate(self) -> Optional[float]:
        if self._norm <= 0.0:
            return None
        return self._sum / self._norm

    def state(self) -> Dict[str, Any]:
        return {"half_life_s": self.half_life_s, "sum": self._sum, "norm": self._norm, "t": self._t}

    @classmethod
    def from_state(cls, state: Mapping[str, Any]) -> "HostTimeDecayedRate":
        out = cls(state["half_life_s"])
        out._sum = float(state["sum"])
        out._norm = float(state["norm"])
        out._t = None if state["t"] is None else float(state["t"])
        return out

    def merge_state(self, state: Mapping[str, Any]) -> None:
        peer = self.from_state(state)
        if peer._t is None:
            return
        if self._t is None:
            self._sum, self._norm, self._t = peer._sum, peer._norm, peer._t
            return
        old, new = (self, peer) if peer._t >= self._t else (peer, self)
        w = 2.0 ** (-(new._t - old._t) / self.half_life_s)  # type: ignore[operator]
        self._sum = old._sum * w + new._sum
        self._norm = max(old._norm * w, new._norm)
        self._t = new._t


def _cusum_compose(a: Tuple[float, float, float, float], b: Tuple[float, float, float, float]) -> Tuple[float, float, float, float]:
    # float mirror of ops/decay.cusum_compose: a strictly before b in stream order
    ta, sa, pa, ma = a
    tb, sb, pb, mb = b
    return (ta + tb, max(sb, sa + tb), max(pa, ta + pb), max(ma, mb, sa + pb))


class HostCUSUM:
    """Host twin of ``drift.CUSUM``: Page's two-sided recursion in segment form.

    Each side holds the ``(total, statistic, max-prefix, watermark)`` summary
    of ``ops/decay.cusum_compose``; one observation composes a single-element
    segment, so the running ``statistic()`` equals the sequential recursion
    S ← max(0, S + contribution) exactly, and :meth:`merge_state` (local
    segment first, peer appended after — the fleet's stream order) is the
    same order-sensitive fold ``drift.CUSUM._merge_state_dicts`` declares.

    The watchdog alarms on the *current* statistic, not the watermark: an
    alert must resolve once the storm stops, while the watermark — the
    highest the statistic ever got — stays up by construction.
    """

    __slots__ = ("target", "k", "pos", "neg")

    def __init__(self, target: float, k: float = 0.5) -> None:
        if not float(k) >= 0.0:
            raise ValueError(f"`k` must be >= 0, got {k}")
        self.target = float(target)
        self.k = float(k)
        self.pos = (0.0, 0.0, 0.0, 0.0)
        self.neg = (0.0, 0.0, 0.0, 0.0)

    @staticmethod
    def _segment(c: float) -> Tuple[float, float, float, float]:
        up = max(0.0, c)
        return (c, up, up, up)

    def observe(self, x: float) -> None:
        v = float(x)
        if not math.isfinite(v):
            return
        self.pos = _cusum_compose(self.pos, self._segment(v - self.target - self.k))
        self.neg = _cusum_compose(self.neg, self._segment(self.target - self.k - v))

    def statistic(self) -> float:
        return max(self.pos[1], self.neg[1])

    def watermark(self) -> float:
        return max(self.pos[3], self.neg[3])

    def state(self) -> Dict[str, Any]:
        return {"target": self.target, "k": self.k, "pos": list(self.pos), "neg": list(self.neg)}

    @classmethod
    def from_state(cls, state: Mapping[str, Any]) -> "HostCUSUM":
        out = cls(state["target"], state["k"])
        out.pos = tuple(float(v) for v in state["pos"])  # type: ignore[assignment]
        out.neg = tuple(float(v) for v in state["neg"])  # type: ignore[assignment]
        return out

    def merge_state(self, state: Mapping[str, Any]) -> None:
        peer = self.from_state(state)
        self.pos = _cusum_compose(self.pos, peer.pos)
        self.neg = _cusum_compose(self.neg, peer.neg)


def host_psi(ref: Sequence[float], live: Sequence[float], eps: float = _PSI_EPS) -> Optional[float]:
    """Population-stability index between two count histograms.

    The float mirror of ``drift.PSI``: normalize both to probabilities, clip
    at ``eps``, sum ``(p_live − p_ref) · ln(p_live / p_ref)``. None when
    either histogram is empty.
    """
    tr = float(sum(ref))
    tl = float(sum(live))
    if tr <= 0.0 or tl <= 0.0 or len(ref) != len(live):
        return None
    total = 0.0
    for r, l in zip(ref, live):
        pr = max(r / tr, eps)
        pl = max(l / tl, eps)
        total += (pl - pr) * math.log(pl / pr)
    return total


def _occupancy_hist(fractions: Iterable[float]) -> List[float]:
    counts = [0.0] * _PSI_BINS
    for f in fractions:
        idx = int(max(0.0, min(1.0, f)) * _PSI_BINS)
        counts[min(idx, _PSI_BINS - 1)] += 1.0
    return counts


# ------------------------------------------------------------------- SLO rules

_OPS: Dict[str, Callable[[float, float], bool]] = {
    "<=": lambda v, t: v <= t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    ">": lambda v, t: v > t,
}


class SloRule:
    """One declarative objective: ``signal op threshold`` must hold.

    A sample *breaches* when the signal exists and the comparison fails;
    ``for_ticks`` consecutive breaches fire the alert, the first healthy
    sample resolves it. A missing signal (None — e.g. no AOT lookups this
    window) neither breaches nor resolves: the streak and firing state are
    simply carried.
    """

    __slots__ = ("name", "signal", "op", "threshold", "for_ticks")

    def __init__(self, name: str, signal: str, op: str, threshold: float, for_ticks: int = 1) -> None:
        if op not in _OPS:
            raise ValueError(f"`op` must be one of {sorted(_OPS)}, got {op!r}")
        if int(for_ticks) < 1:
            raise ValueError(f"`for_ticks` must be >= 1, got {for_ticks}")
        self.name = str(name)
        self.signal = str(signal)
        self.op = str(op)
        self.threshold = float(threshold)
        self.for_ticks = int(for_ticks)

    def healthy(self, value: float) -> bool:
        return _OPS[self.op](float(value), self.threshold)

    def __repr__(self) -> str:
        return (f"SloRule({self.name!r}, {self.signal!r}, {self.op!r}, "
                f"{self.threshold!r}, for_ticks={self.for_ticks})")


#: Steady-state objectives for a healthy fleet. ``dispatch_economy`` pins the
#: one-dispatch-per-flushed-bucket contract, the hit-rate floors catch cache
#: thrash, ``recompile_storm`` is the CUSUM change detector on per-sample
#: compile deltas (statistic decays by ``k`` per clean sample, so the alert
#: resolves after the storm), and the latency/lag ceilings bound the tick
#: path and durability debt.
DEFAULT_SLOS: Tuple[SloRule, ...] = (
    SloRule("dispatch_economy", "dispatches_per_bucket_per_tick", "<=", 1.0, for_ticks=3),
    SloRule("jit_hit_rate_floor", "jit_hit_rate", ">=", 0.5, for_ticks=3),
    SloRule("aot_hit_rate_floor", "aot_hit_rate", ">=", 0.5, for_ticks=3),
    SloRule("tick_latency_p99", "tick_p99_s", "<=", 0.25, for_ticks=3),
    SloRule("wal_lag", "wal_lag_records", "<=", 10_000.0, for_ticks=3),
    SloRule("recompile_storm", "recompile_cusum_stat", "<=", 3.0, for_ticks=2),
)


# -------------------------------------------------------------------- watchdog

class Watchdog:
    """Samples recorder deltas into host-side metric twins and evaluates SLOs.

    One instance is cheap and lock-protected; :meth:`sample` is a pure host
    computation over recorder counters/gauges/latency sketches — no device
    work. Signals (None when undefined this window):

    ========================================  =====================================
    signal                                    meaning
    ========================================  =====================================
    ``compile_rate_per_s``                    time-decayed program compiles
    ``eviction_rate_per_s``                   time-decayed cache evictions
    ``fallback_rate_per_s``                   time-decayed eager fallbacks
    ``rollback_rate_per_s``                   time-decayed rolled-back updates
    ``compiles_delta``                        raw compiles since last sample
    ``recompile_cusum_stat``                  CUSUM statistic on compiles_delta
    ``dispatches_per_bucket_per_tick``        Δfleet_dispatch / Δfleet_flush
    ``dispatch_economy_cusum_stat``           CUSUM statistic on the above
    ``jit_hit_rate``                          windowed hits/(hits+compiles)
    ``jit_hit_cusum_stat``                    CUSUM (downward) on jit_hit_rate
    ``aot_hit_rate``                          windowed AOT hits/lookups
    ``aot_hit_cusum_stat``                    CUSUM (downward) on aot_hit_rate
    ``tick_p99_s``                            windowed DDSketch p99, phase "tick"
    ``dispatch_p99_s``                        windowed DDSketch p99, phase "dispatch"
    ``update_p99_s``                          windowed DDSketch p99, phase "update"
    ``wal_lag_records``                       summed durability-lag gauge
    ``occupancy_psi``                         PSI of the bucket-occupancy histogram
    ``serve_ingest_rate_per_s``               time-decayed front-door record ingest
    ``serve_shed_rate_per_s``                 time-decayed loose-first sheds
    ``serve_queue_depth``                     front-door decoded-not-yet-applied gauge
    ========================================  =====================================

    The three ``serve_*`` signals and ``update_p99_s`` are additive — no
    default SLO reads them; a caller pins its own :class:`SloRule` rows on
    them.
    """

    def __init__(
        self,
        rules: Optional[Sequence[SloRule]] = None,
        half_life_s: float = 30.0,
        min_interval_s: float = 0.25,
    ) -> None:
        self.rules: List[SloRule] = list(DEFAULT_SLOS if rules is None else rules)
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._rates = {
            "compile": HostTimeDecayedRate(half_life_s),
            "eviction": HostTimeDecayedRate(half_life_s),
            "fallback": HostTimeDecayedRate(half_life_s),
            "rollback": HostTimeDecayedRate(half_life_s),
            "serve_ingest": HostTimeDecayedRate(half_life_s),
            "serve_shed": HostTimeDecayedRate(half_life_s),
        }
        self._cusums = {
            "recompile": HostCUSUM(target=0.0, k=1.0),
            "dispatch_economy": HostCUSUM(target=1.0, k=0.25),
            "jit_hit": HostCUSUM(target=1.0, k=0.25),
            "aot_hit": HostCUSUM(target=1.0, k=0.25),
        }
        self._prev: Dict[str, float] = {}
        self._prev_sketch: Dict[str, Any] = {}  # phase -> cumulative merged sketch
        self._psi_ref: Optional[List[float]] = None
        self._rule_state: Dict[str, Dict[str, Any]] = {
            r.name: {"streak": 0, "firing": False} for r in self.rules
        }
        self._samples = 0
        self._last_signals: Dict[str, Optional[float]] = {}
        self._last_sample_t: Optional[float] = None

    # ---------------------------------------------------------------- sampling
    def maybe_sample(self) -> None:
        """Rate-limited :meth:`sample` — the engine-tick poke entry point."""
        if not _rec.ENABLED:
            return
        now = _rec.clock()
        if self._last_sample_t is not None and now - self._last_sample_t < self.min_interval_s:
            return
        self.sample(now)

    def _read_raw(self) -> Dict[str, Any]:
        rec = _rec.RECORDER
        with rec._lock:
            sums: Dict[str, float] = {}
            for (name, _label), v in rec.counters.items():
                sums[name] = sums.get(name, 0.0) + v
            active: Dict[str, float] = {}
            capacity: Dict[str, float] = {}
            wal_lag = 0.0
            serve_queue = 0.0
            for (name, label), v in rec.gauges.items():
                if name == "fleet_rows_active":
                    active[label] = v
                elif name == "fleet_rows_capacity":
                    capacity[label] = v
                elif name == "wal_lag_records":
                    wal_lag += v
                elif name == "serve_queue_depth":
                    serve_queue += v
            tick_sketches = [sk.copy() for (ph, _l), sk in rec.latency.items() if ph == "tick"]
            dispatch_sketches = [sk.copy() for (ph, _l), sk in rec.latency.items() if ph == "dispatch"]
            update_sketches = [sk.copy() for (ph, _l), sk in rec.latency.items() if ph == "update"]
        fractions = [active.get(lbl, 0.0) / cap for lbl, cap in capacity.items() if cap > 0]
        return {
            "sums": sums,
            "wal_lag_records": wal_lag,
            "serve_queue_depth": serve_queue,
            "occupancy_fractions": fractions,
            "tick_sketches": tick_sketches,
            "dispatch_sketches": dispatch_sketches,
            "update_sketches": update_sketches,
        }

    def _windowed_p99(self, phase: str, sketches: List[Any]) -> Optional[float]:
        """p99 of the durations recorded *since the previous sample*.

        The recorder's sketches are cumulative, so an expensive warmup tick
        would otherwise poison the p99 for the process lifetime. The sketch's
        bucket counts are monotone under merge, which makes the cumulative
        sketch differencable: subtract the previous sample's merged buckets
        and read the quantile off the window. None when the window recorded
        nothing (or the recorder was reset — counts go negative and the new
        cumulative state re-seeds the baseline). The first sample only seeds
        the baseline, mirroring the counter deltas.
        """
        if not sketches:
            return None
        merged = sketches[0]
        for sk in sketches[1:]:
            merged.merge(sk)
        prev = self._prev_sketch.get(phase)
        self._prev_sketch[phase] = merged.copy()
        if prev is None:
            return None
        merged.pos = merged.pos - prev.pos
        merged.neg = merged.neg - prev.neg
        merged.zero -= prev.zero
        merged.count -= prev.count
        if merged.count <= 0 or merged.pos.min() < 0 or merged.neg.min() < 0:
            return None
        return float(merged.quantile(0.99))

    def sample(self, now: Optional[float] = None) -> Optional[Dict[str, Optional[float]]]:
        """One watchdog evaluation; returns the signals dict (None if disabled)."""
        if not _rec.ENABLED:
            return None
        t = _rec.clock() if now is None else float(now)
        raw = self._read_raw()
        sums = raw["sums"]

        def family(names: Tuple[str, ...]) -> float:
            return float(sum(sums.get(n, 0.0) for n in names))

        fired: List[Tuple[SloRule, float]] = []
        resolved: List[Tuple[SloRule, float]] = []
        with self._lock:
            self._last_sample_t = t

            def delta(key: str, total: float) -> float:
                # first sample seeds the baseline: history that predates the
                # watchdog (e.g. warmup compiles) is not a storm
                prev = self._prev.get(key)
                self._prev[key] = total
                if prev is None:
                    return 0.0
                return max(0.0, total - prev)

            d_compiles = delta("compiles", family(_COMPILE_COUNTERS))
            d_evicts = delta("evictions", family(_EVICT_COUNTERS))
            d_fallbacks = delta("fallbacks", family(_FALLBACK_COUNTERS))
            d_rollbacks = delta("rollbacks", float(sums.get("update_rolled_back", 0.0)))
            d_hits = delta("hits", family(_HIT_COUNTERS))
            d_aot_hits = delta("aot_hits", float(sums.get("aot_hit", 0.0)))
            d_aot_misses = delta("aot_misses", float(sums.get("aot_miss", 0.0)))
            d_dispatches = delta("dispatches", float(sums.get("fleet_dispatch", 0.0)))
            d_flushes = delta("flushes", float(sums.get("fleet_flush", 0.0)))
            d_serve_frames = delta("serve_frames", float(sums.get("serve_frames", 0.0)))
            d_serve_shed = delta("serve_shed", float(sums.get("serve_shed_sessions", 0.0)))

            self._rates["compile"].observe(d_compiles, t)
            self._rates["eviction"].observe(d_evicts, t)
            self._rates["fallback"].observe(d_fallbacks, t)
            self._rates["rollback"].observe(d_rollbacks, t)
            self._rates["serve_ingest"].observe(d_serve_frames, t)
            self._rates["serve_shed"].observe(d_serve_shed, t)

            self._cusums["recompile"].observe(d_compiles)
            per_bucket = (d_dispatches / d_flushes) if d_flushes > 0 else None
            if per_bucket is not None:
                self._cusums["dispatch_economy"].observe(per_bucket)
            jit_lookups = d_hits + d_compiles
            jit_hit_rate = (d_hits / jit_lookups) if jit_lookups > 0 else None
            if jit_hit_rate is not None:
                self._cusums["jit_hit"].observe(jit_hit_rate)
            aot_lookups = d_aot_hits + d_aot_misses
            aot_hit_rate = (d_aot_hits / aot_lookups) if aot_lookups > 0 else None
            if aot_hit_rate is not None:
                self._cusums["aot_hit"].observe(aot_hit_rate)

            psi = None
            fractions = raw["occupancy_fractions"]
            if fractions:
                live_hist = _occupancy_hist(fractions)
                if self._psi_ref is None:
                    self._psi_ref = live_hist
                psi = host_psi(self._psi_ref, live_hist)

            signals: Dict[str, Optional[float]] = {
                "compile_rate_per_s": self._rates["compile"].rate(),
                "eviction_rate_per_s": self._rates["eviction"].rate(),
                "fallback_rate_per_s": self._rates["fallback"].rate(),
                "rollback_rate_per_s": self._rates["rollback"].rate(),
                "compiles_delta": d_compiles,
                "recompile_cusum_stat": self._cusums["recompile"].statistic(),
                "dispatches_per_bucket_per_tick": per_bucket,
                "dispatch_economy_cusum_stat": self._cusums["dispatch_economy"].statistic(),
                "jit_hit_rate": jit_hit_rate,
                "jit_hit_cusum_stat": self._cusums["jit_hit"].statistic(),
                "aot_hit_rate": aot_hit_rate,
                "aot_hit_cusum_stat": self._cusums["aot_hit"].statistic(),
                "tick_p99_s": self._windowed_p99("tick", raw["tick_sketches"]),
                "dispatch_p99_s": self._windowed_p99("dispatch", raw["dispatch_sketches"]),
                "update_p99_s": self._windowed_p99("update", raw["update_sketches"]),
                "wal_lag_records": raw["wal_lag_records"],
                "occupancy_psi": psi,
                "serve_ingest_rate_per_s": self._rates["serve_ingest"].rate(),
                "serve_shed_rate_per_s": self._rates["serve_shed"].rate(),
                "serve_queue_depth": raw["serve_queue_depth"],
            }

            for rule in self.rules:
                value = signals.get(rule.signal)
                state = self._rule_state[rule.name]
                if value is None:
                    continue
                if rule.healthy(value):
                    state["streak"] = 0
                    if state["firing"]:
                        state["firing"] = False
                        resolved.append((rule, value))
                else:
                    state["streak"] += 1
                    if state["streak"] >= rule.for_ticks and not state["firing"]:
                        state["firing"] = True
                        fired.append((rule, value))
            firing_now = {r.name: self._rule_state[r.name]["firing"] for r in self.rules}
            self._samples += 1
            self._last_signals = signals

        rec = _rec.RECORDER
        rec.add_count("watchdog_sample", "watchdog")
        for name, value in signals.items():
            if value is not None:
                rec.set_gauge("watchdog_signal", name, float(value))
        for rule_name, firing in firing_now.items():
            rec.set_gauge("slo_firing", rule_name, 1.0 if firing else 0.0)
        for rule, value in fired:
            rec.add_count("slo_fired", rule.name)
            rec.add_event(
                "slo_fired", rule=rule.name, signal=rule.signal, value=float(value),
                op=rule.op, threshold=rule.threshold, for_ticks=rule.for_ticks,
            )
        for rule, value in resolved:
            rec.add_count("slo_resolved", rule.name)
            rec.add_event(
                "slo_resolved", rule=rule.name, signal=rule.signal, value=float(value),
                op=rule.op, threshold=rule.threshold,
            )
        return signals

    # ------------------------------------------------------------------ verdict
    def health(self) -> Dict[str, Any]:
        """Fleet-health verdict from the last evaluated sample."""
        with self._lock:
            firing = sorted(n for n, st in self._rule_state.items() if st["firing"])
            return {
                "ok": not firing,
                "verdict": "degraded" if firing else "healthy",
                "firing": firing,
                "samples": self._samples,
                "signals": dict(self._last_signals),
            }

    # ---------------------------------------------------------- shard mergeability
    def export_state(self) -> Dict[str, Any]:
        """JSON-able mergeable watchdog state (rates + CUSUM segments + PSI ref)."""
        with self._lock:
            return {
                "schema": 1,
                "samples": self._samples,
                "rates": {k: r.state() for k, r in self._rates.items()},
                "cusums": {k: c.state() for k, c in self._cusums.items()},
                "psi_ref": None if self._psi_ref is None else list(self._psi_ref),
            }

    def sync_telemetry(self, peer_states: Iterable[Mapping[str, Any]]) -> "Watchdog":
        """Fold peer shards' exported states into this watchdog (local first,
        each peer appended in iteration order — the CUSUM stream order)."""
        with self._lock:
            for state in peer_states:
                for key, rate in self._rates.items():
                    peer = (state.get("rates") or {}).get(key)
                    if peer is not None:
                        rate.merge_state(peer)
                for key, cusum in self._cusums.items():
                    peer = (state.get("cusums") or {}).get(key)
                    if peer is not None:
                        cusum.merge_state(peer)
                if self._psi_ref is None and state.get("psi_ref"):
                    self._psi_ref = [float(v) for v in state["psi_ref"]]
                self._samples += int(state.get("samples", 0))
        return self


# ----------------------------------------------------------------- installation

_ACTIVE: Optional[Watchdog] = None


def install_watchdog(watchdog: Optional[Watchdog] = None, **kwargs: Any) -> Watchdog:
    """Register a process-wide watchdog.

    Pass an instance, or keyword args forwarded to :class:`Watchdog`. The
    recorder's ``poke_watchdog`` (the JAX package's stream engines call it
    every tick while telemetry is enabled) rate-limits sampling to
    ``min_interval_s``; loops without an engine call ``observe.poke_watchdog()``
    themselves or ``sample()`` directly.
    """
    global _ACTIVE
    wd = watchdog if watchdog is not None else Watchdog(**kwargs)
    _ACTIVE = wd
    _rec._set_watchdog(wd)
    return wd


def uninstall_watchdog() -> None:
    global _ACTIVE
    _ACTIVE = None
    _rec._set_watchdog(None)


def installed_watchdog() -> Optional[Watchdog]:
    return _ACTIVE
