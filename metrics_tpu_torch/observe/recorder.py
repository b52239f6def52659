"""Near-zero-overhead runtime telemetry (counterpart of ``metrics_tpu/observe/recorder.py``).

The runtime's hot paths report into one process-wide :class:`Recorder`:

* **counters** — monotonically increasing ``(name, label)`` integers: per-path
  update counts, cached computes, merges, syncs and their retries, checkpoint
  saves and restores, guard quarantines;
* **timers** — ``(name, label)`` wall-time aggregates (count/total/min/max)
  over host-side ``update``/``compute``/``sync``/``merge`` calls;
* **events** — a bounded structured log (ring buffer) carrying the *causes*:
  which exception rolled an update back, which sync attempt was retried.

Overhead contract: with observability **disabled (the default)** every
counter hook pays a single module-flag check (``ENABLED``) and allocates
nothing; a span site (:mod:`metrics_tpu_torch.observe.tracing`) adds one check
of whether a ``torch.profiler`` capture records. Timers measure *host-side* wall time around the call, which
on a CUDA device is the time to enqueue its kernels, not their device time: no
timed section synchronizes with the card.

The schema of :func:`snapshot` is the JAX package's, ``SCHEMA_VERSION``
included, so that one consumer reads both. The port updates eagerly, so its
jit and fused-update counters have no producer and read zero; the engines'
compiles, hits and evictions report through ``note_engine_*``.

Everything here is stdlib only, so the core runtime can import it
unconditionally.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

__all__ = [
    "RECORDER",
    "Recorder",
    "SCHEMA_VERSION",
    "disable",
    "enable",
    "enabled",
    "note_aot_hit",
    "note_aot_miss",
    "note_aot_stale",
    "note_aot_store",
    "note_autonomic_action",
    "note_compile_miss",
    "note_eager_fallback",
    "note_engine_compile",
    "note_engine_dispatch",
    "note_engine_evict",
    "note_engine_hit",
    "note_fleet_fallback",
    "note_fleet_flush",
    "note_fleet_loose_update",
    "note_fleet_quarantine",
    "note_fleet_restore",
    "note_fleet_row_replay",
    "note_fleet_sample",
    "note_fleet_session",
    "note_fleet_tick",
    "note_replica_dispatch",
    "note_replica_fallback",
    "note_serve_admission",
    "note_serve_bytes",
    "note_serve_connect",
    "note_serve_dedup",
    "note_serve_disconnect",
    "note_serve_frame",
    "note_serve_protocol_error",
    "note_serve_shed",
    "note_wal_append",
    "note_wal_gauges",
    "note_wal_replay",
    "note_wal_truncate",
    "poke_watchdog",
    "prometheus",
    "record_event",
    "reset",
    "scope",
    "set_fleet_gauges",
    "set_serve_gauges",
    "snapshot",
    "snapshot_json",
]

# Module-level fast flag: hot paths read this ONE attribute and skip all
# instrumentation when False. Mutated only via enable()/disable().
ENABLED = False

# snapshot() schema generation, the JAX package's: bumped whenever the
# top-level or derived key set changes, so that consumers can tell which
# contract a serialized snapshot file carries. 4 = schema_version, watchdog,
# SLO, compile-explain, metering, sync-bytes, serve and autonomic deriveds.
SCHEMA_VERSION = 4

# process-wide watchdog (observe/watchdog.py) registered via _set_watchdog;
# held here — not in the watchdog module — so engine hot paths can poke it
# through this already-imported module with one attribute read
_WATCHDOG: Optional[Any] = None

# process-wide fleet meter (observe/metering.py) registered via _set_meter —
# same pattern as the watchdog: engine hot paths reach it with one attribute
# read, and it survives a swapped-in probe Recorder (bench configs)
_METER: Optional[Any] = None

clock: Callable[[], float] = time.perf_counter

# one reading of the hot path's clock and of the Unix clock, taken together (at import, and again by
# enable()): the span export maps a clock() reading t to Unix nanoseconds as unix_ns + (t - perf) * 1e9
_CLOCK_ANCHOR: Tuple[float, int] = (clock(), time.time_ns())

# one warning per metric class across the process, independent of ENABLED —
# losing compiled updates is user-facing even when telemetry is off
_FALLBACK_WARNED: set = set()


class Recorder:
    """Holds all telemetry. Internal containers start empty and stay empty while
    disabled (the zero-allocation half of the overhead contract)."""

    __slots__ = (
        "counters", "timers", "events", "gauges", "spans", "series", "latency",
        "max_events", "max_spans", "_seq", "_span_total", "_lock",
    )

    def __init__(self, max_events: int = 1024, max_spans: int = 4096) -> None:
        self.counters: Dict[Tuple[str, str], int] = {}
        self.timers: Dict[Tuple[str, str], List[float]] = {}  # [count, total, min, max]
        self.events: Deque[Dict[str, Any]] = deque(maxlen=max_events)
        self.gauges: Dict[Tuple[str, str], float] = {}  # last-write-wins levels
        # flight recorder: bounded span ring (observe/tracing.py),
        # rolling fleet time-series samples, and per-(phase, label) DDSketch
        # latency histograms (observe/latency.py HostDDSketch instances)
        self.spans: Deque[Dict[str, Any]] = deque(maxlen=max_spans)
        self.series: Deque[Dict[str, Any]] = deque(maxlen=512)
        self.latency: Dict[Tuple[str, str], Any] = {}
        self.max_events = max_events
        self.max_spans = max_spans
        self._seq = 0
        self._span_total = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ primitives
    def add_count(self, name: str, label: str, n: int = 1) -> None:
        key = (name, label)
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def set_gauge(self, name: str, label: str, value: float) -> None:
        with self._lock:
            self.gauges[(name, label)] = value

    def add_time(self, name: str, label: str, seconds: float) -> None:
        key = (name, label)
        with self._lock:
            agg = self.timers.get(key)
            if agg is None:
                self.timers[key] = [1, seconds, seconds, seconds]
            else:
                agg[0] += 1
                agg[1] += seconds
                agg[2] = min(agg[2], seconds)
                agg[3] = max(agg[3], seconds)

    def add_event(self, kind: str, **fields: Any) -> None:
        with self._lock:
            self._seq += 1
            self.events.append({"seq": self._seq, "kind": kind, **fields})

    def clear(self) -> None:
        with self._lock:
            self.counters.clear()
            self.timers.clear()
            self.events.clear()
            self.gauges.clear()
            self.spans.clear()
            self.series.clear()
            self.latency.clear()
            self._seq = 0
            self._span_total = 0
        # the recompile-attribution key history resets with the telemetry it
        # explains (scope/test isolation)
        explain = sys.modules.get("metrics_tpu_torch.observe.explain")
        if explain is not None:
            explain.clear_history()



RECORDER = Recorder()


# ---------------------------------------------------------------------- lifecycle
def enable(max_events: int = 1024, reset: bool = False, max_spans: int = 4096) -> None:
    """Turn telemetry collection on (counters/timers/events start accumulating).

    ``enable()`` alone keeps whatever was already recorded — re-enabling
    mid-run must not destroy data. Pass ``reset=True`` to start from zero
    counters in one call (the shape every counter-asserting test fixture
    wants; stale counters from a previous test otherwise satisfy or break
    assertions at random). ``max_spans`` bounds the flight-recorder span ring
    (observe/tracing.py) the same way ``max_events`` bounds the event log.
    """
    global ENABLED, _CLOCK_ANCHOR
    if reset:
        RECORDER.clear()
    _CLOCK_ANCHOR = (clock(), time.time_ns())
    RECORDER.max_events = max_events
    if RECORDER.events.maxlen != max_events:
        RECORDER.events = deque(RECORDER.events, maxlen=max_events)
    RECORDER.max_spans = max_spans
    if RECORDER.spans.maxlen != max_spans:
        RECORDER.spans = deque(RECORDER.spans, maxlen=max_spans)
    ENABLED = True


def disable() -> None:
    """Turn telemetry collection off (recorded data is kept until :func:`reset`)."""
    global ENABLED
    ENABLED = False


class scope:
    """``with observe.scope(reset=True): ...`` — telemetry on for one block.

    The context-manager form of the ``enable(reset=True)`` / ``disable()`` /
    ``reset(include_warnings=True)`` dance every test fixture used to spell by
    hand. Enter clears recorded data (when ``reset``, re-arming the one-time
    fallback warnings too) and enables collection; exit restores the prior
    enabled state and clears again so nothing recorded inside leaks into the
    next test. Pass ``reset=False`` to accumulate into existing data and keep
    it on exit (the mid-run inspection shape).
    """

    __slots__ = ("_reset", "_max_events", "_max_spans", "_prior")

    def __init__(self, reset: bool = True, max_events: int = 1024, max_spans: int = 4096) -> None:
        self._reset = reset
        self._max_events = max_events
        self._max_spans = max_spans
        self._prior: Optional[bool] = None

    def __enter__(self) -> "Recorder":
        self._prior = ENABLED
        if self._reset:
            RECORDER.clear()
            _FALLBACK_WARNED.clear()
        enable(max_events=self._max_events, max_spans=self._max_spans)
        return RECORDER

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        global ENABLED
        ENABLED = bool(self._prior)
        if self._reset:
            RECORDER.clear()
            _FALLBACK_WARNED.clear()
        return False


def enabled() -> bool:
    return ENABLED


def clock_anchor() -> Tuple[float, int]:
    """``(clock(), time.time_ns())`` read together at the last :func:`enable` (or at import)."""
    return _CLOCK_ANCHOR


def reset(include_warnings: bool = False) -> None:
    """Drop all recorded telemetry; optionally re-arm the one-time fallback warnings."""
    RECORDER.clear()
    if include_warnings:
        _FALLBACK_WARNED.clear()


def record_event(kind: str, **fields: Any) -> None:
    """Append a structured event to the log (no-op while disabled)."""
    if ENABLED:
        RECORDER.add_event(kind, **fields)


# ------------------------------------------------------------------- runtime hooks
# Called by metric.py / collections.py / parallel/sync.py. All are no-ops while
# disabled except note_eager_fallback's one-time user warning.
def note_explicit_transfer(site: str) -> None:
    """One intentional device-to-host transfer executed.

    Each site that reads the card on purpose (the collection's one read that
    settles its compute groups, a guard's ``raise_on_host`` check, each
    ``host_read:<site>`` span of the validations, the curves' computes and the
    gather's size table) bumps this counter when it actually moves data, so the
    snapshot carries the run's explicit-transfer budget; a transfer not counted
    here is implicit.
    """
    if ENABLED:
        RECORDER.add_count("explicit_transfer", site)






def note_compile_miss(kind: str, label: str, components: Any) -> None:
    """Attribute one compiled-cache miss to the key component that changed.

    ``kind`` names the cache ("shared_jit" / "fleet" / "replica" / "fused" /
    "aot"); ``components`` is the decomposed cache key as ``(name, value)``
    pairs. The diff against the nearest prior key of the same kind
    (observe/explain.py) lands in the event log as a ``compile_explain``
    event plus ``compile_explain`` (per cache) and ``compile_cause`` (per
    cause) counters, which :func:`~metrics_tpu_torch.observe.explain.render_report`
    renders. Call sites only build the component tuple when ``ENABLED`` is
    already true. The eager port has no compiled-program cache yet, so nothing
    calls this until the stream engine's captured programs do.
    """
    if not ENABLED:
        return
    # lazy: explain.py is stdlib-only, but this module must stay importable
    # without it for the disabled fast path's sake
    from metrics_tpu_torch.observe import explain as _explain

    cause, changed, detail = _explain.attribute(kind, components)
    RECORDER.add_count("compile_explain", kind)
    RECORDER.add_count("compile_cause", cause)
    RECORDER.add_event(
        "compile_explain", cache=kind, label=label, cause=cause,
        changed=list(changed), detail=detail,
    )


def _set_watchdog(watchdog: Optional[Any]) -> None:
    """Register (or clear) the process-wide watchdog; observe/watchdog.py owns this."""
    global _WATCHDOG
    _WATCHDOG = watchdog


def _set_meter(meter: Optional[Any]) -> None:
    """Register (or clear) the process-wide fleet meter; observe/metering.py owns this."""
    global _METER
    _METER = meter


def poke_watchdog() -> None:
    """Give the installed watchdog a sampling opportunity (rate-limited).

    Engine ticks call this from their already-ENABLED-guarded telemetry
    branch; with no watchdog installed it is one module-attribute read.
    """
    wd = _WATCHDOG
    if wd is not None and ENABLED:
        wd.maybe_sample()


def note_eager_fallback(metric: str, exc: BaseException) -> None:
    """A metric lost its compiled update: warn ONCE per class (always), and
    record the triggering exception class in the event log (when enabled).

    The port updates eagerly and never calls this; it stays for the schema's
    ``eager_fallback`` counter."""
    if metric not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add(metric)
        from metrics_tpu_torch.utils.prints import rank_zero_warn

        rank_zero_warn(
            f"Metric {metric!r} could not be compiled ({type(exc).__name__}) and has "
            "latched eager-mode updates for this instance's lifetime. See "
            "`metrics_tpu_torch.observe.snapshot()` for details.",
            UserWarning,
        )
    if ENABLED:
        RECORDER.add_count("eager_fallback", metric)
        RECORDER.add_event("eager_fallback", metric=metric, error=type(exc).__name__, detail=str(exc)[:200])


# AOT disk-cache hooks (aot/cache.py + aot/runtime.py)
def note_aot_hit(label: str) -> None:
    """A serialized executable was loaded from disk instead of compiling."""
    if ENABLED:
        RECORDER.add_count("aot_hit", label)


def note_aot_miss(label: str) -> None:
    if ENABLED:
        RECORDER.add_count("aot_miss", label)


def note_aot_stale(label: str, reason: str) -> None:
    """An entry was found but unusable (version/backend drift or corruption);
    it is latched and rewritten by the next store, not re-tried every lookup."""
    if ENABLED:
        RECORDER.add_count("aot_stale", label)
        RECORDER.add_event("aot_stale", metric=label, reason=reason[:200])


def note_aot_store(label: str, nbytes: int) -> None:
    if ENABLED:
        RECORDER.add_count("aot_store", label)
        RECORDER.add_event("aot_store", metric=label, bytes=nbytes)






# engine hooks (engine/core.py ProgramCache + its two users): kind is
# "replica" (label "<InnerClass>x<N>", wrappers/replicated.py) or "fleet"
# (label "<Class>@<fingerprint8>", engine/stream.py buckets)
def note_engine_compile(kind: str, label: str, n_rows: int) -> None:
    if ENABLED:
        RECORDER.add_count(f"{kind}_compile", label)
        RECORDER.add_event(f"{kind}_compile", engine=label, rows=n_rows)


def note_engine_hit(kind: str, label: str) -> None:
    if ENABLED:
        RECORDER.add_count(f"{kind}_hit", label)


def note_engine_evict(kind: str, label: str) -> None:
    if ENABLED:
        RECORDER.add_count(f"{kind}_evict", label)
        RECORDER.add_event(f"{kind}_evict", engine=label)


def note_engine_dispatch(kind: str, label: str) -> None:
    if ENABLED:
        RECORDER.add_count(f"{kind}_dispatch", label)


# replica-shaped conveniences kept for the wrapper call sites
def note_replica_dispatch(label: str) -> None:
    note_engine_dispatch("replica", label)


def note_replica_fallback(label: str, exc: BaseException) -> None:
    if ENABLED:
        RECORDER.add_count("replica_fallback", label)
        RECORDER.add_event("replica_fallback", engine=label, error=type(exc).__name__, detail=str(exc)[:200])


# fleet StreamEngine hooks (engine/stream.py): bucket label is "<Class>@<fp8>"
def note_fleet_tick(n_dispatches: int) -> None:
    if ENABLED:
        RECORDER.add_count("fleet_tick", "engine")
        RECORDER.add_count("fleet_tick_dispatches", "engine", n_dispatches)


def note_fleet_flush(label: str) -> None:
    if ENABLED:
        RECORDER.add_count("fleet_flush", label)


def note_fleet_session(label: str, change: str) -> None:
    """``change`` is "add" or "expire"; counts arrivals/expiries per bucket."""
    if ENABLED:
        RECORDER.add_count(f"fleet_session_{change}", label)


def note_fleet_loose_update(label: str) -> None:
    if ENABLED:
        RECORDER.add_count("fleet_loose_update", label)


def note_fleet_fallback(label: str, exc: BaseException) -> None:
    if ENABLED:
        RECORDER.add_count("fleet_fallback", label)
        RECORDER.add_event("fleet_fallback", engine=label, error=type(exc).__name__, detail=str(exc)[:200])


def note_fleet_fused_fallback(label: str, exc: BaseException) -> None:
    """The fused whole-tick program failed (trace refusal or a runtime death
    with buffers intact) and the flush fell back to per-bucket dispatches —
    where the per-wave/per-row ladder isolates the actual poison."""
    if ENABLED:
        RECORDER.add_count("fleet_fused_fallback", label)
        RECORDER.add_event("fleet_fused_fallback", engine=label, error=type(exc).__name__, detail=str(exc)[:200])


def note_fleet_quarantine(label: str, reason: str, exc: Optional[BaseException] = None) -> None:
    """One session was individually quarantined out of its bucket (blast-radius
    isolation): ``reason`` is "update_error", "nan_guard" or "probation"."""
    if ENABLED:
        RECORDER.add_count("fleet_quarantine", label)
        RECORDER.add_event(
            "fleet_quarantine", engine=label, reason=reason,
            error=type(exc).__name__ if exc is not None else None,
            detail=str(exc)[:200] if exc is not None else None,
        )


def note_fleet_row_replay(label: str, n: int = 1) -> None:
    """Rows replayed eagerly inside a surviving bucket after a dispatch death."""
    if ENABLED:
        RECORDER.add_count("fleet_row_replay", label, n)


def note_fleet_restore(label: str, n_sessions: int, n_replayed: int) -> None:
    """A StreamEngine was rebuilt from a fleet checkpoint (+ WAL replay)."""
    if ENABLED:
        RECORDER.add_count("fleet_restore", label)
        RECORDER.add_event("fleet_restore", engine=label, sessions=n_sessions, replayed=n_replayed)


# ingest write-ahead-log hooks (engine/durability.py IngestWAL)
def note_wal_append(label: str, n: int = 1) -> None:
    if ENABLED:
        RECORDER.add_count("wal_append", label, n)


def note_wal_replay(label: str, n: int) -> None:
    if ENABLED:
        RECORDER.add_count("wal_replay", label, n)
        RECORDER.add_event("wal_replay", engine=label, records=n)


def note_wal_truncate(label: str, kept: int) -> None:
    if ENABLED:
        RECORDER.add_count("wal_truncate", label)
        RECORDER.add_event("wal_truncate", engine=label, kept=kept)


def note_wal_torn_tail(label: str, frame_index: int, byte_offset: int) -> None:
    """WAL replay stopped at a damaged frame: the crash tore the journal's
    tail. ``frame_index`` is how many intact frames were recovered before the
    damage; ``byte_offset`` where in the file the scan stopped. Everything
    before the tear replayed normally — this event is the difference between
    "clean recovery" and "a synced-but-torn suffix was dropped"."""
    if ENABLED:
        RECORDER.add_count("wal_torn_tail", label)
        RECORDER.add_event("wal_torn_tail", engine=label, frame=frame_index, offset=byte_offset)


# sharded fleet hooks (engine/sharded.py ShardedStreamEngine): label is the
# inner engine name "<fleet>/shardN"
def set_shard_gauges(
    label: str,
    sessions: int,
    rows_active: int,
    rows_capacity: int,
    wal_lag_records: int,
    wal_lag_bytes: int,
    healthy: bool,
) -> None:
    """Publish one shard's occupancy/lag/health levels (refreshed per tick)."""
    if ENABLED:
        RECORDER.set_gauge("shard_sessions", label, sessions)
        RECORDER.set_gauge("shard_rows_active", label, rows_active)
        RECORDER.set_gauge("shard_rows_capacity", label, rows_capacity)
        RECORDER.set_gauge("shard_wal_lag_records", label, wal_lag_records)
        RECORDER.set_gauge("shard_wal_lag_bytes", label, wal_lag_bytes)
        RECORDER.set_gauge("shard_healthy", label, 1.0 if healthy else 0.0)


def note_shard_demoted(label: str, reason: str) -> None:
    """One shard walked the last rung of the blast-radius ladder: its bucketed
    sessions now run as eager loose sessions while every other shard keeps its
    one-dispatch-per-bucket-per-tick economy."""
    if ENABLED:
        RECORDER.add_count("shard_demoted", label)
        RECORDER.add_event("shard_demoted", engine=label, reason=reason[:200])


def note_shard_restore(label: str, n_sessions: int, n_replayed: int, recovered: bool) -> None:
    """One shard was rebuilt from its own checkpoint file + journal — the other
    shards were not touched. ``recovered=False`` means the shard's files were
    unrecoverable and it came back empty/demoted."""
    if ENABLED:
        RECORDER.add_count("shard_restore", label)
        RECORDER.add_event(
            "shard_restore", engine=label, sessions=n_sessions, replayed=n_replayed, recovered=recovered
        )


# serve front-door hooks (the JAX package's serve/server.py and serve/autonomic.py):
# network ingest, admission verdicts, and the autonomic observe→act loop
def note_serve_connect(producer: str) -> None:
    if ENABLED:
        RECORDER.add_count("serve_connect", producer)
        RECORDER.add_event("serve_connect", producer=producer)


def note_serve_disconnect(producer: str, reason: str) -> None:
    if ENABLED:
        RECORDER.add_count("serve_disconnect", producer)
        RECORDER.add_event("serve_disconnect", producer=producer, reason=reason[:200])


def note_serve_frame(kind: str) -> None:
    if ENABLED:
        RECORDER.add_count("serve_frames", kind)


def note_serve_bytes(n: int) -> None:
    if ENABLED:
        RECORDER.add_count("serve_bytes_in", "serve", n)


def note_serve_admission(verdict: str, rule: Optional[str] = None) -> None:
    """One admission decision; non-accept verdicts also land an event naming
    the table row that tripped."""
    if ENABLED:
        RECORDER.add_count("serve_admission", verdict)
        if verdict != "accept":
            RECORDER.add_event("serve_admission", verdict=verdict, rule=rule)


def note_serve_dedup(producer: str) -> None:
    """A resent record was squelched by the target shard's producer watermark
    — at-least-once delivery collapsed to exactly-once application."""
    if ENABLED:
        RECORDER.add_count("serve_dedup_skipped", producer)


def note_serve_protocol_error(reason: str) -> None:
    if ENABLED:
        RECORDER.add_count("serve_protocol_errors", "serve")
        RECORDER.add_event("serve_protocol_error", reason=reason[:200])


def note_serve_shed(session: str, reason: str) -> None:
    """One loose session was shed under overload (the gentlest eviction)."""
    if ENABLED:
        RECORDER.add_count("serve_shed_sessions", "serve")
        RECORDER.add_event("serve_shed", session=session, reason=reason[:200])


def note_autonomic_action(action: str, dry_run: bool = False) -> None:
    """One autonomic reflex fired (or, dry-run, would have): double / demote /
    resize / shed. The structured ``autonomic_action`` event carries the why."""
    if ENABLED:
        RECORDER.add_count("autonomic_actions", f"dry:{action}" if dry_run else action)


def set_serve_gauges(producers: int, queue_depth: int) -> None:
    """Publish the front door's live levels: authenticated producer
    connections and the ingest queue depth (decoded records not yet applied)."""
    if ENABLED:
        RECORDER.set_gauge("serve_producers", "serve", producers)
        RECORDER.set_gauge("serve_queue_depth", "serve", queue_depth)


def set_fleet_gauges(
    label: str, active: int, capacity: int, fragmented: int, bytes_stacked: int, bytes_active: int
) -> None:
    """Publish one bucket's occupancy levels (refreshed on tick/expire/stats)."""
    if ENABLED:
        RECORDER.set_gauge("fleet_rows_active", label, active)
        RECORDER.set_gauge("fleet_rows_capacity", label, capacity)
        RECORDER.set_gauge("fleet_rows_fragmented", label, fragmented)
        RECORDER.set_gauge("fleet_bytes_stacked", label, bytes_stacked)
        RECORDER.set_gauge("fleet_bytes_active", label, bytes_active)


def note_wal_gauges(label: str, lag_records: int, lag_bytes: int, ckpt_age_s: Optional[float]) -> None:
    """Publish one engine's durability lag: WAL records/bytes accumulated since
    the last fleet checkpoint, and that checkpoint's age (omitted when the
    engine has never checkpointed)."""
    if ENABLED:
        RECORDER.set_gauge("wal_lag_records", label, lag_records)
        RECORDER.set_gauge("wal_lag_bytes", label, lag_bytes)
        if ckpt_age_s is not None:
            RECORDER.set_gauge("last_ckpt_age_s", label, ckpt_age_s)


def note_fleet_sample(**fields: Any) -> None:
    """Append one tick sample to the rolling fleet time-series ring.

    The StreamEngine calls this once per tick (telemetry on) with its health
    levels — sessions, occupancy, dispatches, WAL lag, quarantine count — so
    ``tools/fleet_top.py`` can render rates from consecutive samples without
    an external scrape loop. The ring is bounded (512 samples)."""
    if ENABLED:
        with RECORDER._lock:
            RECORDER.series.append({"t": clock(), **fields})


# resilience hooks (metric.py transactional updates, resilience/, parallel/sync.py)
def note_update_rollback(metric: str, exc: BaseException) -> None:
    if ENABLED:
        RECORDER.add_count("update_rolled_back", metric)
        RECORDER.add_event("update_rolled_back", metric=metric, error=type(exc).__name__, detail=str(exc)[:200])


def note_checkpoint_save(label: str, path: str, nbytes: int) -> None:
    if ENABLED:
        RECORDER.add_count("ckpt_save", label)
        RECORDER.add_event("ckpt_save", target=label, path=path, bytes=nbytes)


def note_checkpoint_restore(label: str, path: str) -> None:
    if ENABLED:
        RECORDER.add_count("ckpt_restore", label)
        RECORDER.add_event("ckpt_restore", target=label, path=path)


def note_sync_retry(label: str, attempt: int, exc: BaseException) -> None:
    if ENABLED:
        RECORDER.add_count("sync_retry", label)
        RECORDER.add_event("sync_retry", metric=label, attempt=attempt, error=type(exc).__name__)


def note_sync_degraded(label: str, exc: BaseException, n_survivors: int) -> None:
    if ENABLED:
        RECORDER.add_count("sync_degraded", label)
        RECORDER.add_event(
            "sync_degraded", metric=label, error=type(exc).__name__, survivors=n_survivors, detail=str(exc)[:200]
        )


def note_guard_quarantined(metric: str, n_batches: int) -> None:
    if ENABLED:
        RECORDER.add_count("guard_quarantined", metric)
        RECORDER.add_event("guard_quarantined", metric=metric, batches=n_batches)


# ------------------------------------------------------------------ export surfaces
def snapshot() -> Dict[str, Any]:
    """One JSON-able dict of everything recorded so far.

    Schema (stable, the JAX package's; tests/test_torch_observe.py pins it)::

        {"enabled": bool,
         "schema_version": int,   # SCHEMA_VERSION, bumped with any key change
         "counters": {name: {label: int}},
         "timers":   {name: {label: {"count", "total_s", "mean_s", "min_s", "max_s"}}},
         "events":   [{"seq", "kind", ...}, ...],
         "gauges":   {name: {label: float}},
         "latency":  {phase: {label: {"count", "total_s", "mean_s", "min_s",
                      "max_s", "p50_s", "p90_s", "p99_s", "p999_s"}}},
         "series":   [{"t", ...fleet sample fields...}, ...],
         "metering": {"installed": bool, ...FleetMeter.snapshot_payload()...},
         "derived":  {"jit_cache_hit_rate": float|None,
                      "jit_compiles_total": int, "jit_cache_hits_total": int,
                      "jit_cache_evictions_total": int, "eager_fallbacks_total": int,
                      "updates_rolled_back_total": int, "ckpt_saves_total": int,
                      "ckpt_restores_total": int, "sync_retries_total": int,
                      "sync_degraded_total": int, "guard_quarantined_total": int,
                      "fleet_sessions_total": int, "fleet_capacity_total": int,
                      "fleet_occupancy_pct": float|None,
                      "fleet_pad_waste_pct": float|None,
                      "fleet_dispatches_total": int,
                      "fleet_dispatches_per_flush": float|None,
                      "fleet_quarantined_total": int,
                      "fleet_restores_total": int,
                      "wal_appends_total": int,
                      "wal_records_replayed_total": int,
                      "aot_hits_total": int, "aot_misses_total": int,
                      "aot_stale_total": int, "aot_stores_total": int,
                      "aot_hit_rate": float|None,
                      "spans_total": int,
                      "wal_lag_records": int, "wal_lag_bytes": int,
                      "wal_torn_tails_total": int,
                      "fleet_shards_total": int, "fleet_shards_demoted": int,
                      "shard_occupancy_pct": float|None,
                      "shard_wal_lag_records": int,
                      "shard_wal_lag_bytes": int,
                      "compile_explains_total": int,
                      "watchdog_samples_total": int,
                      "slo_alerts_fired_total": int,
                      "slo_alerts_resolved_total": int,
                      "slo_alerts_firing": int,
                      "meter_sessions_tracked": int,
                      "meter_attributed_dispatch_s": float,
                      "meter_attribution_pct": float|None,
                      "meter_live_bytes": int,
                      "meter_pad_waste_bytes": int,
                      "meter_quota_exceeded_total": int,
                      "sync_bytes_total": int,
                      "serve_producers_connected": int,
                      "serve_frames_total": int,
                      "serve_bytes_in_total": int,
                      "serve_admitted_total": int,
                      "serve_deferred_total": int,
                      "serve_shed_total": int,
                      "serve_rejected_total": int,
                      "serve_dedup_skipped_total": int,
                      "serve_protocol_errors_total": int,
                      "autonomic_actions_total": int}}

    The ``fleet_*`` totals aggregate the StreamEngine gauges/counters across
    buckets: occupancy is live rows over padded capacity, pad waste is the
    byte-weighted share of stacked state bytes held by padding rows, and
    dispatches-per-flush is the engine's per-bucket-per-tick dispatch economy
    (1.0 = every flushed bucket cost exactly one dispatch). ``latency`` is
    the flight recorder's DDSketch-backed per-(phase, label) summaries
    (observe/latency.py) and ``series`` the rolling fleet sample ring;
    ``spans_total`` counts every span ever recorded (the span ring itself is
    bounded and exported by ``observe.timeline()``, not here). The
    ``wal_lag_*`` deriveds sum the durability-lag gauges across engines. The
    ``shard_*`` / ``fleet_shards_*`` deriveds aggregate the per-shard gauges a
    :class:`ShardedStreamEngine` publishes: shard count and how many shards are
    currently demoted to eager loose sessions, fleet-wide shard occupancy, and
    the summed per-shard journal replay debt. The watchdog rung
    adds attributed compile-miss counts (``compile_explains_total``), watchdog
    sample counts and the SLO alert totals, with ``slo_alerts_firing`` the
    number of rules currently in the firing state (the ``slo_firing`` gauges).
    The metering rung adds the installed :class:`FleetMeter`'s
    full payload under ``metering`` (``{"installed": False}`` when none is
    installed), per-tenant attribution deriveds (``meter_*``), and the
    summed per-state collective traffic from ``parallel/sync.py``
    (``sync_bytes_total``). The serve rung adds front-door
    deriveds: live producer connections, total frames/bytes ingested, the
    four admission verdict totals, watermark-dedup squelches, protocol
    errors, loose-first sheds, and the autonomic reflex action total
    (dry-run decisions count — they carry a ``dry:`` label prefix in the
    raw ``autonomic_actions`` counter but roll into the same derived).
    """
    if RECORDER.latency:
        # lazy: latency.py pulls in numpy, which this stdlib-only module must not
        from metrics_tpu_torch.observe.latency import snapshot_latency

        latency = snapshot_latency()
    else:
        latency = {}
    with RECORDER._lock:
        counters: Dict[str, Dict[str, int]] = {}
        for (name, label), v in RECORDER.counters.items():
            counters.setdefault(name, {})[label] = v
        timers: Dict[str, Dict[str, Dict[str, float]]] = {}
        for (name, label), (count, total, mn, mx) in RECORDER.timers.items():
            timers.setdefault(name, {})[label] = {
                "count": int(count),
                "total_s": total,
                "mean_s": total / count if count else 0.0,
                "min_s": mn,
                "max_s": mx,
            }
        events = list(RECORDER.events)
        gauges: Dict[str, Dict[str, float]] = {}
        for (name, label), g in RECORDER.gauges.items():
            gauges.setdefault(name, {})[label] = g
        series = list(RECORDER.series)
        span_total = RECORDER._span_total
    compiles = sum(counters.get("jit_compile", {}).values())
    hits = sum(counters.get("jit_cache_hit", {}).values())
    lookups = compiles + hits
    fleet_active = sum(gauges.get("fleet_rows_active", {}).values())
    fleet_capacity = sum(gauges.get("fleet_rows_capacity", {}).values())
    fleet_bytes = sum(gauges.get("fleet_bytes_stacked", {}).values())
    fleet_bytes_active = sum(gauges.get("fleet_bytes_active", {}).values())
    fleet_dispatches = sum(counters.get("fleet_dispatch", {}).values())
    fleet_flushes = sum(counters.get("fleet_flush", {}).values())
    aot_hits = sum(counters.get("aot_hit", {}).values())
    aot_misses = sum(counters.get("aot_miss", {}).values())
    aot_lookups = aot_hits + aot_misses
    shard_active = sum(gauges.get("shard_rows_active", {}).values())
    shard_capacity = sum(gauges.get("shard_rows_capacity", {}).values())
    mt = _METER
    if mt is not None:
        metering = mt.snapshot_payload()
        meter_totals = metering["totals"]
        meter_memory = metering["memory"]["totals"]
    else:
        metering = {"installed": False}
        meter_totals = {}
        meter_memory = {}
    return {
        "enabled": ENABLED,
        "schema_version": SCHEMA_VERSION,
        "counters": {k: dict(sorted(v.items())) for k, v in sorted(counters.items())},
        "timers": {k: dict(sorted(v.items())) for k, v in sorted(timers.items())},
        "events": events,
        "gauges": {k: dict(sorted(v.items())) for k, v in sorted(gauges.items())},
        "latency": latency,
        "series": series,
        "metering": metering,
        "derived": {
            "jit_cache_hit_rate": (hits / lookups) if lookups else None,
            "jit_compiles_total": compiles,
            "jit_cache_hits_total": hits,
            "jit_cache_evictions_total": sum(counters.get("jit_cache_eviction", {}).values()),
            "eager_fallbacks_total": sum(counters.get("eager_fallback", {}).values()),
            "updates_rolled_back_total": sum(counters.get("update_rolled_back", {}).values()),
            "ckpt_saves_total": sum(counters.get("ckpt_save", {}).values()),
            "ckpt_restores_total": sum(counters.get("ckpt_restore", {}).values()),
            "sync_retries_total": sum(counters.get("sync_retry", {}).values()),
            "sync_degraded_total": sum(counters.get("sync_degraded", {}).values()),
            "guard_quarantined_total": sum(counters.get("guard_quarantined", {}).values()),
            "fleet_sessions_total": int(fleet_active),
            "fleet_capacity_total": int(fleet_capacity),
            "fleet_occupancy_pct": (100.0 * fleet_active / fleet_capacity) if fleet_capacity else None,
            "fleet_pad_waste_pct": (100.0 * (fleet_bytes - fleet_bytes_active) / fleet_bytes) if fleet_bytes else None,
            "fleet_dispatches_total": fleet_dispatches,
            "fleet_dispatches_per_flush": (fleet_dispatches / fleet_flushes) if fleet_flushes else None,
            "fleet_quarantined_total": sum(counters.get("fleet_quarantine", {}).values()),
            "fleet_restores_total": sum(counters.get("fleet_restore", {}).values()),
            "wal_appends_total": sum(counters.get("wal_append", {}).values()),
            "wal_records_replayed_total": sum(counters.get("wal_replay", {}).values()),
            "aot_hits_total": aot_hits,
            "aot_misses_total": aot_misses,
            "aot_stale_total": sum(counters.get("aot_stale", {}).values()),
            "aot_stores_total": sum(counters.get("aot_store", {}).values()),
            "aot_hit_rate": (aot_hits / aot_lookups) if aot_lookups else None,
            "spans_total": span_total,
            "wal_lag_records": int(sum(gauges.get("wal_lag_records", {}).values())),
            "wal_lag_bytes": int(sum(gauges.get("wal_lag_bytes", {}).values())),
            "wal_torn_tails_total": sum(counters.get("wal_torn_tail", {}).values()),
            "fleet_shards_total": len(gauges.get("shard_healthy", {})),
            "fleet_shards_demoted": sum(1 for v in gauges.get("shard_healthy", {}).values() if not v),
            "shard_occupancy_pct": (100.0 * shard_active / shard_capacity) if shard_capacity else None,
            "shard_wal_lag_records": int(sum(gauges.get("shard_wal_lag_records", {}).values())),
            "shard_wal_lag_bytes": int(sum(gauges.get("shard_wal_lag_bytes", {}).values())),
            "compile_explains_total": sum(counters.get("compile_explain", {}).values()),
            "watchdog_samples_total": sum(counters.get("watchdog_sample", {}).values()),
            "slo_alerts_fired_total": sum(counters.get("slo_fired", {}).values()),
            "slo_alerts_resolved_total": sum(counters.get("slo_resolved", {}).values()),
            "slo_alerts_firing": sum(1 for v in gauges.get("slo_firing", {}).values() if v),
            "meter_sessions_tracked": int(meter_totals.get("sessions_exact", 0))
            + int(meter_totals.get("sessions_sketched", 0)),
            "meter_attributed_dispatch_s": float(meter_totals.get("attributed_s", 0.0)),
            "meter_attribution_pct": meter_totals.get("attribution_pct"),
            "meter_live_bytes": int(meter_memory.get("live_bytes", 0)),
            "meter_pad_waste_bytes": int(meter_memory.get("pad_waste_bytes", 0)),
            "meter_quota_exceeded_total": sum(counters.get("quota_exceeded", {}).values()),
            "sync_bytes_total": sum(counters.get("sync_bytes", {}).values()),
            "serve_producers_connected": int(sum(gauges.get("serve_producers", {}).values())),
            "serve_frames_total": sum(counters.get("serve_frames", {}).values()),
            "serve_bytes_in_total": sum(counters.get("serve_bytes_in", {}).values()),
            "serve_admitted_total": counters.get("serve_admission", {}).get("accept", 0),
            "serve_deferred_total": counters.get("serve_admission", {}).get("defer", 0),
            "serve_shed_total": counters.get("serve_admission", {}).get("shed", 0),
            "serve_rejected_total": counters.get("serve_admission", {}).get("reject", 0),
            "serve_dedup_skipped_total": sum(counters.get("serve_dedup_skipped", {}).values()),
            "serve_protocol_errors_total": sum(counters.get("serve_protocol_errors", {}).values()),
            "autonomic_actions_total": sum(counters.get("autonomic_actions", {}).values()),
        },
    }


def _prom_name(name: str) -> str:
    return "metrics_tpu_" + "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_label(label: str) -> str:
    # exposition-format label escaping: backslash first, then quote, and
    # newline as the literal two characters ``\n`` — replacing it with a space
    # (the old behavior) silently aliased distinct label values
    return label.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus() -> str:
    """Prometheus text-exposition dump of counters, gauges, timers and latency.

    Counters render as ``*_total`` counter families; gauges as gauge families;
    timers as summary-style ``*_seconds_count`` / ``*_seconds_sum`` pairs; and
    the flight recorder's DDSketch phase latencies as full summary families
    with ``quantile`` labels (p50/p90/p99/p999). Every family carries
    ``# HELP``/``# TYPE`` headers — ready for a textfile collector or a
    scrape handler. With a fleet meter installed (observe/metering.py) the
    ``metrics_tpu_meter_*`` families ride along, cardinality-bounded by
    construction: at most ``top_k`` session label values regardless of how
    many sessions the fleet has served.
    """
    snap = snapshot()
    lines: List[str] = []

    def _family(prom: str, kind: str, help_text: str) -> None:
        lines.append(f"# HELP {prom} {help_text}")
        lines.append(f"# TYPE {prom} {kind}")

    for name, by_label in snap["counters"].items():
        prom = _prom_name(name) + "_total"
        _family(prom, "counter", f"metrics_tpu runtime counter: {name} occurrences per label.")
        for label, v in by_label.items():
            lines.append(f'{prom}{{metric="{_prom_label(label)}"}} {v}')
    for name, by_label in snap["gauges"].items():
        prom = _prom_name(name)
        _family(prom, "gauge", f"metrics_tpu runtime gauge: last observed {name} level per label.")
        for label, v in by_label.items():
            lines.append(f'{prom}{{metric="{_prom_label(label)}"}} {v}')
    for name, by_label in snap["timers"].items():
        prom = _prom_name(name) + "_seconds"
        _family(prom, "summary", f"metrics_tpu host wall time over {name} dispatch.")
        for label, agg in by_label.items():
            sel = f'{{metric="{_prom_label(label)}"}}'
            lines.append(f"{prom}_count{sel} {agg['count']}")
            lines.append(f"{prom}_sum{sel} {agg['total_s']:.9f}")
    for phase, by_label in snap["latency"].items():
        prom = _prom_name(f"phase_{phase}") + "_seconds"
        _family(
            prom, "summary",
            f"metrics_tpu flight-recorder span latency for phase {phase} (DDSketch, rel. error <= 2%).",
        )
        for label, agg in by_label.items():
            esc = _prom_label(label)
            for key, value in agg.items():
                if key.startswith("p") and key.endswith("_s"):
                    q = "0." + key[1:-2]
                    lines.append(f'{prom}{{label="{esc}",quantile="{q}"}} {value:.9f}')
            lines.append(f'{prom}_count{{label="{esc}"}} {agg["count"]}')
            lines.append(f'{prom}_sum{{label="{esc}"}} {agg["total_s"]:.9f}')
    mt = _METER
    if mt is not None:
        lines.extend(mt.prometheus_lines(_prom_name, _prom_label))
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_json(**dump_kwargs: Any) -> str:
    """:func:`snapshot` serialized to a JSON string (convenience for logging)."""
    return json.dumps(snapshot(), **dump_kwargs)
