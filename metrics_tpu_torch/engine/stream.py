"""Multi-tenant fleet runtime: thousands of live metric streams, one batched dispatch per shard tick
(counterpart of ``metrics_tpu/engine/stream.py``).

The serving-fleet workload is a heterogeneous, churning population of live
``Metric`` instances: user sessions, each with its own accuracy / AUROC /
error tracker, arriving and expiring mid-stream. Updating each instance on
its own is a Python interpreter crawl, with a kernel launch per session.
:class:`StreamEngine` makes fleet cost independent of fleet size and churn:

* **Bucketing.** Sessions whose metrics share ``(class, config key, device,
  state avals)`` land in one *bucket* and share one program, as config-equal
  replicas do in ``wrappers/replicated.py``. The device is part of the key
  (``config_fingerprint`` leaves it out on purpose, so that a checkpoint moves
  between devices): a bucket's states and programs live on one device.
* **Padded stacked states.** Each bucket stacks its rows' states into one
  dict of tensors with a leading row axis, padded to a power-of-two capacity.
  Rows are claimed from a LIFO free-list (an expiring session's row is
  recycled by the next arrival) and never moved, so arrival and expiry within
  capacity change *data*, not *shapes*: no new program. Only a capacity
  doubling builds one new program per bucket.
* **Masked dispatch.** A tick flushes every bucket's ingest queue as ONE call
  of a fused program (``engine/core.py``), one ``torch.func.vmap`` per wave:
  rows without a submission carry ``keep=False`` and pass their state through
  bit-exactly, so padding never contaminates live rows. The kernels run
  batched through their custom ops' ``vmap`` rules: one launch per wave.
  Compute vmaps over the whole bucket once and the host slices out live rows.
* **Host-side ingest queue.** ``submit()`` only appends ``(slot, batch)`` to
  the bucket's queue; ``tick()`` coalesces the queue into (capacity, ...)
  staging tensors on the bucket's device and flushes. Submissions with
  distinct batch signatures, or repeat submissions for one slot, split into
  ordered waves, so per-session ordering is preserved.
* **Blast-radius isolation.** A wave that ``vmap`` refuses demotes only the
  sessions in that wave to loose mode (their rows materialize back, their
  pending submissions replay eagerly); the rest of the bucket keeps its rows
  and its program. A wave whose dispatch fails otherwise (states intact)
  replays each row eagerly: surviving rows scatter back in, and a row whose
  update raises is individually **quarantined** (rolled back, ejected to loose
  mode, ``health == "quarantined"``). The opt-in ``nan_guard`` quarantines
  sessions submitting non-finite batches at staging time.
* **Durability.** With ``wal_path=`` set, every ``add_session`` / ``submit``
  / ``expire`` / ``reset`` appends a CRC-framed record to an ingest
  write-ahead journal (``engine/durability.py``) before it takes effect, and
  the journal is fsynced at each flush boundary. ``checkpoint()`` writes an
  incremental fleet snapshot through the MTCKPT container and truncates the
  journal; :meth:`StreamEngine.restore` rebuilds the fleet from checkpoint +
  journal replay, bit-exact versus a never-crashed engine, on the device the
  caller names.

Sessions whose metrics cannot ride a bucket (list states, host-side updates,
``jit_update=False``, unhashable config, ineligible batch values) run as
*loose* sessions: same API, per-instance eager updates, counted by the
``fleet_loose_update`` counter.
"""

from __future__ import annotations

import contextlib
import itertools
import warnings
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Iterator, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.engine.core import (
    _FLEET_JIT_CACHE,
    TRACER_ERRORS,
    DispatchConsumedError,
    FusedEntry,
    _as_operand,
    _consumed,
    _dtype_name,
    engine_compute,
    engine_update,
    engine_update_fused,
)
from metrics_tpu_torch.metric import _REDUCE_ALIASES, Metric, _squeeze_if_scalar
from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.observe import tracing as _trace
from metrics_tpu_torch.resilience.checkpoint import _host
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

__all__ = ["StreamEngine"]


def _bucket_label(metric: Metric) -> str:
    fp = metric.config_fingerprint()
    return f"{type(metric).__name__}@{fp[:8] if fp else 'unshared'}"


def _device_key(device: torch.device) -> str:
    """A device's bucket-key spelling: ``"cuda"`` is the current CUDA device."""
    if device.type == "cuda" and device.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


def _metering_cost(template: Metric, capacity: int, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Tuple[float, float]:
    """(FLOPs, bytes) of a bucket's program for the fleet meter (lazy)."""
    from metrics_tpu_torch.observe.metering import program_cost

    return program_cost(template, capacity, args, kwargs)


def _submission_sig(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Tuple[Any, ...]:
    """Groupability key for one submission: array leaves by (shape, dtype), scalars by value.

    Two submissions coalesce into one dispatch only when every array argument agrees on (shape, dtype)
    (they share staging tensors; a tensor and a numpy array of one dtype name agree) and every non-array
    argument agrees on its exact value (it enters the batched body once for the whole wave).
    """

    def leaf(v: Any) -> Tuple[Any, ...]:
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            return ("arr", tuple(v.shape), _dtype_name(v.dtype))
        return ("val", v)

    kw_names = tuple(sorted(kwargs))
    return (len(args), kw_names, tuple(leaf(a) for a in args), tuple(leaf(kwargs[k]) for k in kw_names))


# the transfer guard a running transfer contract installed (``analysis/transfer_contracts.py``): every
# annotated site lifts it for its own extent, as the JAX package's sites scope ``transfer_guard("allow")``
_TRANSFER_GUARD: Optional[Any] = None


@contextlib.contextmanager
def _transfer_scope(site: str) -> Iterator[None]:
    """An intentional host/device transfer: counted by the ``explicit_transfer`` observe counter, so that
    a fleet's transfer budget is visible, and allowed under a transfer contract's guard."""
    guard = _TRANSFER_GUARD
    if guard is None:
        yield
    else:
        with guard.allow(site):
            yield
    _observe.note_explicit_transfer(site)


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _host_fetch(tree: Any, site: str) -> Any:
    """One explicit device-to-host fetch of every tensor of a tree: CPU copies come back, never views of the
    engine's tensors (which later adoptions write in place)."""
    with _transfer_scope(site):
        return _tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _host_value(v: Any) -> Any:
    """Journal-able host form of one submission argument: a tensor becomes a numpy array."""
    if isinstance(v, torch.Tensor):
        with _transfer_scope("wal_journal"):
            return _host(v)
    return v


def _eager_update(metric: Metric, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
    """One submission applied through the metric's own update: host rows (numpy arrays, as a served or
    replayed submission carries them) become tensors on the metric's device first."""
    metric.update(*(_as_operand(a, metric.device) for a in args),
                  **{k: _as_operand(v, metric.device) for k, v in kwargs.items()})


class _Session:
    """One live stream: its metric instance plus where its state lives."""

    __slots__ = ("sid", "metric", "bucket", "slot", "base_count", "engine_count", "queue", "health")

    def __init__(self, sid: Hashable, metric: Metric, bucket: Optional["_Bucket"], slot: int) -> None:
        self.sid = sid
        self.metric = metric
        self.bucket = bucket
        self.slot = slot
        self.base_count = metric._update_count  # updates accumulated before adoption
        self.engine_count = 0  # engine dispatches applied to this row since
        # loose sessions queue (seq, args, kwargs); bucketed queues live on the bucket
        self.queue: List[Tuple[int, Tuple[Any, ...], Dict[str, Any]]] = []
        self.health = "healthy" if bucket is not None else "loose"


# Process-wide bucket creation order: the fused dispatch plan sorts dirty buckets by it, so the fused cache
# key's entry order is stable across ticks no matter which session submitted first.
_BUCKET_SERIAL = itertools.count()


class _Bucket:
    """All sessions sharing one program: a padded dict of stacked state tensors on one device."""

    __slots__ = (
        "key", "label", "template", "capacity", "stacked", "slot_sids",
        "slot_skeys", "free",
        "high_water", "queue", "version", "computed", "computed_version",
        "compute_eager", "row_bytes", "faults", "order",
        "fold_eligible", "partial", "partial_version", "partial_slots",
        "values_dev", "values_dev_version", "values_np", "values_np_version",
    )

    def __init__(self, template: Metric, label: str, key: Any, capacity: int) -> None:
        self.key = key
        self.label = label
        self.template = template  # pristine clone: the batched representative and the defaults' source
        self.capacity = capacity
        self.stacked = self._tiled_defaults(capacity)
        self.slot_sids: List[Optional[Hashable]] = [None] * capacity
        # meter keys (str(sid)) cached per slot so the dispatch path never re-stringifies a wave's session ids
        self.slot_skeys: List[Optional[str]] = [None] * capacity
        # LIFO free-list, initialized so pop() hands out slot 0 first; recycled slots are appended and
        # therefore reused before untouched ones
        self.free: List[int] = list(range(capacity - 1, -1, -1))
        self.high_water = -1  # highest slot ever occupied (fragmentation horizon)
        self.queue: List[Tuple[int, int, Tuple[Any, ...], Dict[str, Any]]] = []  # (slot, seq, args, kwargs)
        self.version = 0  # bumped on every state change; invalidates cached computes
        self.computed: Any = None
        self.computed_version = -1
        self.compute_eager = False  # latched when the vmapped compute is refused
        self.faults = 0  # wave fallbacks + quarantines this bucket has absorbed
        self.order = next(_BUCKET_SERIAL)
        # --- incremental-fold poll caches, all version-stale ---
        # None = not yet probed: all-sum merge algebra + a compute that runs batched
        self.fold_eligible: Optional[bool] = None
        self.partial: Optional[Dict[str, Any]] = None  # live-masked per-state column sums
        self.partial_version = -1
        self.partial_slots: Tuple[int, ...] = ()  # slots live at fold time
        self.values_dev: Any = None  # per-row computes emitted by the fused tick
        self.values_dev_version = -1
        self.values_np: Any = None  # host mirror of the per-row values (one fetch)
        self.values_np_version = -1
        self.row_bytes = sum(int(d.numel() * d.element_size()) for d in template._defaults.values())

    def _tiled_defaults(self, rows: int) -> Dict[str, torch.Tensor]:
        # padding rows hold the per-state defaults (not zeros): a virgin slot is indistinguishable from a
        # freshly reset metric, so a fresh arrival into one needs no scatter at all
        return {k: d.unsqueeze(0).repeat((rows,) + (1,) * d.ndim) for k, d in self.template._defaults.items()}

    def grow(self) -> None:
        """Double the padded capacity (the only shape change a bucket ever makes)."""
        old = self.capacity
        self.capacity = old * 2
        pad = self._tiled_defaults(old)
        self.stacked = {k: torch.cat([v, pad[k]], dim=0) for k, v in self.stacked.items()}
        self.slot_sids.extend([None] * old)
        self.slot_skeys.extend([None] * old)
        self.free.extend(range(self.capacity - 1, old - 1, -1))
        self.version += 1

    def active(self) -> int:
        return self.capacity - len(self.free)

    def fragmented(self) -> int:
        """Free slots below the high-water mark: holes a dispatch still pays for."""
        return sum(1 for s in self.free if s <= self.high_water)

    def health(self) -> str:
        """"healthy" while every dispatch path is intact; "degraded" once the bucket has latched eager
        compute or absorbed a fault (a demoted wave or quarantined row)."""
        return "degraded" if (self.compute_eager or self.faults) else "healthy"


class _BucketPlan:
    """One bucket's flush plan: its popped queue coalesced into ordered waves, nan-guard swept, with the
    staging tensors assembled: everything a fused dispatch (or the per-wave fallback) needs."""

    __slots__ = ("bucket", "queue", "waves", "subs", "sigs", "staged", "done", "dead_slots")

    def __init__(self, bucket: _Bucket, queue: List[Tuple[int, int, Tuple[Any, ...], Dict[str, Any]]]) -> None:
        self.bucket = bucket
        self.queue = queue
        self.waves: List[Tuple[Any, List[int]]] = []  # (signature, queue indices), wave order
        self.subs: List[List[Tuple[int, int, Tuple[Any, ...], Dict[str, Any]]]] = []
        self.sigs: List[Any] = []
        self.staged: List[Tuple[Tuple[Any, ...], Dict[str, Any], Any]] = []
        self.done: Set[int] = set()
        self.dead_slots: Set[int] = set()  # slots whose sessions left the bucket mid-flush


class StreamEngine:
    """Drive an arbitrary, churning population of live metrics as a bucketed fleet.

    ::

        engine = StreamEngine(wal_path="fleet.wal")
        sid = engine.add_session(MulticlassAccuracy(num_classes=10))
        engine.submit(sid, preds, target)     # host-side enqueue, no dispatch
        engine.tick()                         # ONE dispatch for every touched bucket
        value = engine.compute(sid)           # vmapped compute, host-sliced
        engine.checkpoint("fleet.ckpt")       # incremental snapshot + WAL truncate
        metric = engine.expire(sid)           # state materialized back out

        # after a crash: checkpoint + journal replay, bit-exact
        engine = StreamEngine.restore("fleet.ckpt", wal_path="fleet.wal")

    ``add_session`` adopts the instance (including any state it already accumulated); until ``expire``
    hands it back, route updates through ``submit``. After :meth:`restore`, bucketed sessions hold fresh
    instances cloned from the bucket template; ``expire`` materializes the recovered state into them. A
    bucketed session's ``compute`` comes back as a host (CPU) tensor sliced from the bucket's values; a
    loose session's is its metric's own ``compute()``.
    """

    def __init__(
        self,
        initial_capacity: int = 8,
        wal_path: Optional[str] = None,
        nan_guard: bool = False,
        name: str = "engine",
    ) -> None:
        if initial_capacity < 1:
            raise TPUMetricsUserError("StreamEngine initial_capacity must be >= 1")
        # ``name`` labels this engine's observe events, gauges and spans; a sharded fleet names each inner
        # engine "<fleet>/shardN" so per-shard telemetry never collides
        self._name = str(name)
        self._initial_capacity = 1 << (int(initial_capacity) - 1).bit_length()
        self._buckets: "OrderedDict[Any, _Bucket]" = OrderedDict()
        self._sessions: Dict[Hashable, _Session] = {}
        # dirty sets (insertion-ordered dicts used as sets): an idle tick is O(pending)
        self._dirty_buckets: Dict[Any, None] = {}
        self._dirty_loose: Dict[Hashable, None] = {}
        # str(sid) -> sid, so the meter's quota-demotion handshake resolves in O(1)
        self._skey_index: Dict[str, Hashable] = {}
        self._next_auto = 0
        self._ticks = 0
        self._nan_guard = bool(nan_guard)
        # --- durability bookkeeping (engine/durability.py) ---
        self._seq = 0  # last ingest sequence number handed out
        self._applied_seq = 0  # contiguous applied watermark: every seq <= this landed
        self._applied_above: Set[int] = set()  # applied out of order, above the watermark
        self._replaying = False  # WAL replay in flight: do not re-journal
        self._ckpt_cache: Dict[Any, Tuple[int, bytes]] = {}  # bucket key -> (version, node bytes)
        self._ckpt_applied_seq = 0  # applied watermark covered by the last checkpoint
        self._last_ckpt_time: Optional[float] = None  # observe.clock() at last save/restore
        self._wal = None
        self._wal_path = wal_path
        # (frame_index, byte_offset) of the torn tail the last WAL replay hit, or None
        self._wal_torn: Optional[Tuple[int, int]] = None
        # serve/ front door: per-producer ingest watermarks, journaled as "serve_mark" records and carried
        # by checkpoints, so a restore can tell a remote producer's resent record from a fresh one
        self._serve_marks: Dict[str, int] = {}
        if wal_path is not None:
            from metrics_tpu_torch.engine.durability import IngestWAL

            self._wal = IngestWAL(wal_path)

    # ------------------------------------------------------------------ sequencing
    def _log(self, kind: str, sid: Optional[Hashable], payload: Any = None) -> int:
        """Assign the next ingest sequence number; journal the record first (strictly write-ahead)."""
        self._seq += 1
        if self._wal is not None and not self._replaying:
            nbytes = self._wal.append(kind, self._seq, sid, payload)
            _observe.note_wal_append(self._name)
            if sid is not None and _observe.ENABLED:
                mt = _observe._METER
                if mt is not None:
                    mt.note_wal_bytes(str(sid), nbytes)
        return self._seq

    def _mark_applied(self, seq: int) -> None:
        if seq == self._applied_seq + 1:
            self._applied_seq = seq
            while self._applied_seq + 1 in self._applied_above:
                self._applied_seq += 1
                self._applied_above.discard(self._applied_seq)
        elif seq > self._applied_seq:
            self._applied_above.add(seq)

    def _is_applied(self, seq: int) -> bool:
        return seq <= self._applied_seq or seq in self._applied_above

    # ------------------------------------------------------------------ sessions
    def __len__(self) -> int:
        return len(self._sessions)

    def session_ids(self) -> List[Hashable]:
        return list(self._sessions)

    def session_health(self, session_id: Hashable) -> str:
        """"healthy" (bucketed), "loose" (eager fallback) or "quarantined"."""
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"unknown or expired session {session_id!r}")
        return sess.health

    def add_session(self, metric: Metric, session_id: Optional[Hashable] = None) -> Hashable:
        """Adopt a live metric instance into the fleet; returns its session id."""
        if not isinstance(metric, Metric):
            raise TPUMetricsUserError(
                f"StreamEngine.add_session expects a Metric instance, got {type(metric).__name__}"
            )
        refusal = type(metric).__fleet_refusal__
        if refusal is not None:
            raise TPUMetricsUserError(f"{type(metric).__name__} cannot join a StreamEngine fleet: {refusal}")
        if session_id is None:
            sid = self._next_auto
            self._next_auto += 1
        else:
            sid = session_id
        if sid in self._sessions:
            raise TPUMetricsUserError(f"session {sid!r} is already live in this engine")
        seq = self._log("add", sid, metric)
        self._apply_add(sid, metric)
        self._mark_applied(seq)
        return sid

    def _apply_add(self, sid: Hashable, metric: Metric) -> None:
        # an arrival's configuration tensors (a curve's thresholds on the card) are read once to key its bucket
        with _transfer_scope("arrival_key"):
            key = self._bucket_key(metric)
        self._skey_index[str(sid)] = sid
        if key is None:
            self._sessions[sid] = _Session(sid, metric, None, -1)
            _observe.note_fleet_session("loose", "add")
            return
        bucket = self._buckets.get(key)
        if bucket is None:
            template = metric.clone()
            template.reset()
            with _transfer_scope("arrival_key"):
                label = _bucket_label(metric)
            if self._name != "engine":
                # per-engine label namespace: two shards holding the same class must not fight over one gauge
                label = f"{self._name}/{label}"
            bucket = _Bucket(template, label, key, self._initial_capacity)
            self._buckets[key] = bucket
        if not bucket.free:
            bucket.grow()
        slot = bucket.free.pop()
        virgin = slot > bucket.high_water
        bucket.high_water = max(bucket.high_water, slot)
        bucket.slot_sids[slot] = sid
        bucket.slot_skeys[slot] = str(sid)
        state = metric.__dict__["_state"]
        fresh = metric._update_count == 0 and all(state[k] is metric._defaults[k] for k in metric._defaults)
        if not (virgin and fresh):
            # recycled rows hold the previous tenant's leftovers, and adopted instances may carry
            # accumulated state: write the real row in (the stacked tensors are the engine's own)
            with _transfer_scope("adopt_state"):
                for k in metric._defaults:
                    bucket.stacked[k][slot] = state[k]
            bucket.version += 1
        self._sessions[sid] = _Session(sid, metric, bucket, slot)
        _observe.note_fleet_session(bucket.label, "add")

    def _bucket_key(self, metric: Metric) -> Optional[Any]:
        """(config key, device, state avals) when the metric can ride a bucket, else None."""
        cfg = metric._config_key()
        if cfg is None or not metric._jit_eligible((), {}):
            return None
        avals = metric.state_avals()
        state = metric.__dict__["_state"]
        for name, shape, dtype in avals:
            live = state[name]
            if not isinstance(live, torch.Tensor) or tuple(live.shape) != shape or _dtype_name(live.dtype) != dtype:
                return None  # live state drifted off the registered avals
        return (cfg, _device_key(metric.device), avals)

    # ------------------------------------------------------------------ ingest
    def submit(self, session_id: Hashable, *args: Any, **kwargs: Any) -> None:
        """Queue one update batch for a session (no device work until tick/compute)."""
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"unknown or expired session {session_id!r}")
        seq = self._log(
            "submit",
            session_id,
            (tuple(_host_value(a) for a in args), {k: _host_value(v) for k, v in kwargs.items()})
            if self._wal is not None and not self._replaying
            else None,
        )
        self._route(sess, seq, args, kwargs)

    def _route(self, sess: _Session, seq: int, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
        bucket = sess.bucket
        if bucket is not None and not bucket.template._jit_eligible(args, kwargs):
            # this batch cannot enter a batched dispatch: hand the session its row back and go loose
            self._demote_session(sess)
            bucket = None
        if bucket is None:
            sess.queue.append((seq, args, kwargs))
            self._dirty_loose[sess.sid] = None
        else:
            bucket.queue.append((sess.slot, seq, args, kwargs))
            self._dirty_buckets[bucket.key] = None

    def tick(self) -> int:
        """Flush every pending queue; returns the number of update dispatches (0 or 1)."""
        with _trace.span("tick", self._name):
            dispatches = self._flush_pending()
        self._tick_epilogue(dispatches)
        return dispatches

    def _tick_epilogue(self, dispatches: int) -> None:
        """Per-tick bookkeeping shared by :meth:`tick` and the sharded fleet's stage/dispatch walk."""
        self._ticks += 1
        _observe.note_fleet_tick(dispatches)
        self._publish_gauges()
        if _observe.ENABLED:
            self._record_sample(dispatches)
            _observe.poke_watchdog()
            mt = _observe._METER
            if mt is not None and mt.policy is not None:
                mt.poll_quota()
                for skey in mt.pending_demotions():
                    self._demote_by_meter(mt, skey)

    def _demote_by_meter(self, mt: Any, skey: str) -> None:
        """Demote the session whose ``str(sid)`` matches a quota breach (an O(1) index lookup)."""
        sid = self._skey_index.get(skey)
        if sid is None or sid not in self._sessions:
            return
        sess = self._sessions[sid]
        if sess.bucket is not None:
            self._demote_session(sess)
            _observe.record_event("quota_demoted", session=skey, engine=self._name)
        mt.confirm_demotion(skey)

    def _record_sample(self, dispatches: int) -> None:
        """One rolling time-series sample of fleet health (telemetry on only)."""
        active = sum(b.active() for b in self._buckets.values())
        capacity = sum(b.capacity for b in self._buckets.values())
        lag_records, lag_bytes = self._wal_lag()
        _observe.note_fleet_sample(
            tick=self._ticks,
            sessions=len(self._sessions),
            rows_active=active,
            rows_capacity=capacity,
            occupancy_pct=100.0 * active / capacity if capacity else None,
            dispatches=dispatches,
            wal_lag_records=lag_records,
            wal_lag_bytes=lag_bytes,
            quarantined=sum(1 for s in self._sessions.values() if s.health == "quarantined"),
        )

    def _flush_pending(self) -> int:
        staged = self._stage_flush()
        return self._dispatch_flush(staged)

    def _stage_flush(self) -> Optional[Tuple[List["_BucketPlan"], List[Hashable]]]:
        """Host half of a flush: WAL sync, plan the dirty buckets, assemble every wave's staging tensors.
        No update is dispatched here, so a sharded fleet can overlap this work with another shard's
        dispatch."""
        if not self._dirty_buckets and not self._dirty_loose:
            return None
        if self._wal is not None and not self._replaying:
            # durability point: every record whose effect is about to land must be on disk first
            with _trace.span("wal", "sync"):
                self._wal.sync()
        # plan in bucket-creation order (not dirty-marking order) so the fused program's key is stable
        keys = sorted((k for k in self._dirty_buckets if k in self._buckets), key=lambda k: self._buckets[k].order)
        self._dirty_buckets.clear()
        plans: List[_BucketPlan] = []
        for key in keys:
            bucket = self._buckets[key]
            if not bucket.queue:
                continue
            with _trace.span("flush", bucket.label):
                plan = self._plan_bucket(bucket)
                self._stage_plan(plan)
            if plan.staged:
                plans.append(plan)
        loose_sids = list(self._dirty_loose)
        self._dirty_loose.clear()
        return plans, loose_sids

    def _dispatch_flush(self, staged: Optional[Tuple[List["_BucketPlan"], List[Hashable]]]) -> int:
        if staged is None:
            return 0
        plans, loose_sids = staged
        dispatches = self._flush_fleet(plans)
        for sid in loose_sids:
            sess = self._sessions.get(sid)
            if sess is not None and sess.bucket is None and sess.queue:
                self._flush_loose(sess)
        return dispatches

    def _meter_loose(self, sess: _Session) -> None:
        """Charge one eagerly applied update to the session's meter ledger."""
        mt = _observe._METER if _observe.ENABLED else None
        if mt is not None:
            mt.note_loose_update(str(sess.sid))

    def _flush_loose(self, sess: _Session) -> None:
        pending, sess.queue = sess.queue, []
        for i, (seq, args, kwargs) in enumerate(pending):
            try:
                _eager_update(sess.metric, args, kwargs)
            except BaseException:
                # the metric rolled itself back (transactional update); the failed submission is consumed,
                # the rest stay queued for the next flush
                self._mark_applied(seq)
                sess.queue = pending[i + 1 :] + sess.queue
                if sess.queue:
                    self._dirty_loose[sess.sid] = None
                raise
            self._mark_applied(seq)
            _observe.note_fleet_loose_update(type(sess.metric).__name__)
            self._meter_loose(sess)

    def _poisoned(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> bool:
        """Finiteness sweep over the float array leaves of one batch (one host read per tensor)."""
        for v in list(args) + list(kwargs.values()):
            if isinstance(v, torch.Tensor):
                if (v.is_floating_point() or v.is_complex()) and v.numel():
                    with _transfer_scope("nan_guard"):
                        if not bool(torch.isfinite(v).all()):
                            return True
            elif isinstance(v, np.ndarray):
                if v.dtype.kind in "fc" and v.size and not np.isfinite(v).all():
                    return True
        return False

    def _flush_bucket(self, bucket: _Bucket) -> int:
        """Flush one bucket's queue outside the tick (demotions, expiry): same plan, fused dispatch and
        fallback ladder, for a fleet of one."""
        self._dirty_buckets.pop(bucket.key, None)
        with _trace.span("flush", bucket.label):
            plan = self._plan_bucket(bucket)
            self._stage_plan(plan)
        return self._flush_fleet([plan]) if plan.staged else 0

    def _plan_bucket(self, bucket: _Bucket) -> "_BucketPlan":
        """Coalesce the bucket's queue into ordered waves and run the nan-guard sweep.

        A NaN-guarded poisoned submission quarantines exactly the session involved before it can enter any
        dispatch, and its not-yet-flushed tail replays eagerly in order.
        """
        queue, bucket.queue = bucket.queue, []
        _observe.note_fleet_flush(bucket.label)
        # wave = how many earlier submissions this slot already has in the queue; grouping on
        # (wave, signature) keeps per-session order while every first submission per slot coalesces
        with _trace.span("ingest", bucket.label):
            seen: Dict[int, int] = {}
            groups: "OrderedDict[Tuple[int, Any], List[int]]" = OrderedDict()
            for idx, (slot, _seq, args, kwargs) in enumerate(queue):
                wave = seen.get(slot, 0)
                seen[slot] = wave + 1
                groups.setdefault((wave, _submission_sig(args, kwargs)), []).append(idx)
        plan = _BucketPlan(bucket, queue)
        for (_wave, sig), idxs in sorted(groups.items(), key=lambda kv: kv[0][0]):
            live = [i for i in idxs if i not in plan.done and queue[i][0] not in plan.dead_slots]
            if self._nan_guard:
                clean: List[int] = []
                for i in live:
                    if i in plan.done or queue[i][0] in plan.dead_slots:
                        continue  # a tail replay above consumed it
                    slot, seq, args, kwargs = queue[i]
                    if self._poisoned(args, kwargs):
                        sess = self._sessions[bucket.slot_sids[slot]]
                        self._quarantine(sess, "nan_guard")
                        self._mark_applied(seq)  # the poisoned batch is consumed (dropped)
                        plan.done.add(i)
                        plan.dead_slots.add(slot)
                        self._replay_tail(queue, plan.done, slot, sess)
                    else:
                        clean.append(i)
                live = [i for i in clean if i not in plan.done and queue[i][0] not in plan.dead_slots]
            if live:
                plan.waves.append((sig, live))
        return plan

    def _stage_plan(self, plan: "_BucketPlan") -> None:
        """Assemble every planned wave's (capacity, ...) staging tensors."""
        bucket = plan.bucket
        with _trace.span("wave_assembly", bucket.label):
            for sig, live in plan.waves:
                subs = [plan.queue[i] for i in live]
                plan.subs.append(subs)
                plan.sigs.append(sig)
                plan.staged.append(self._stage(bucket, subs))

    def _fold_eligible(self, bucket: _Bucket) -> bool:
        """May the fused tick maintain this bucket's incremental-fold caches?

        True only when every declared state reduces by ``dim_zero_sum`` with an associative merge (the
        partial IS the column sum) AND the bucket's compute runs under ``torch.func.vmap`` (probed once on
        the stacked states). The probe is silent and latched: False keeps the bucket on the cached
        full-recompute path; it is not a fault.
        """
        if bucket.compute_eager:
            return False
        if bucket.fold_eligible is None:
            tmpl = bucket.template
            reds = getattr(tmpl, "_reductions", {})
            assoc = getattr(tmpl, "_merge_associative", {})
            sum_fn = _REDUCE_ALIASES["sum"]
            ok = bool(reds) and all(fn is sum_fn for fn in reds.values()) and all(assoc.get(k, False) for k in reds)
            if ok:
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        torch.func.vmap(lambda st: _squeeze_if_scalar(tmpl._functional_compute(st)))(bucket.stacked)
                except Exception:  # noqa: BLE001 — any refusal means "recompute path"
                    ok = False
            bucket.fold_eligible = ok
        return bucket.fold_eligible

    def _live_mask(self, bucket: _Bucket) -> np.ndarray:
        return np.fromiter((sid is not None for sid in bucket.slot_sids), dtype=bool, count=len(bucket.slot_sids))

    def _flush_fleet(self, plans: List["_BucketPlan"]) -> int:
        """Dispatch every planned bucket's every wave as ONE call of the fused program.

        The fused body chains each bucket's waves in order and, for fold-eligible buckets, emits per-row
        values and the live-masked partial aggregate in the same call, so a steady-state tick is exactly one
        dispatch and a dashboard poll runs no compute.

        Blast-radius ladder: a refused or failed fused dispatch (states intact) falls back to the per-bucket
        masked dispatches, where the per-wave demotion and per-row quarantine isolate exactly the rows
        involved; a CUDA error that poisoned the card raises ``DispatchConsumedError`` for the durability
        and shard-ladder rungs.
        """
        plans = [p for p in plans if p.staged]
        if not plans:
            return 0
        mt = _observe._METER if _observe.ENABLED else None
        entries: List[FusedEntry] = []
        for p in plans:
            b = p.bucket
            fold = self._fold_eligible(b)
            entries.append(
                FusedEntry(
                    template=b.template,
                    n=b.capacity,
                    stacked=b.stacked,
                    groups=[(a, k, m) for (a, k, m) in p.staged],
                    want_values=fold,
                    live=self._live_mask(b) if fold else None,
                    label=b.label,
                )
            )
        label = plans[0].bucket.label if len(plans) == 1 else "+".join(p.bucket.label for p in plans)
        m_t0: Optional[float] = None
        try:
            if mt is not None:
                m_t0 = _observe.clock()
            with _trace.span("dispatch", label):
                results = engine_update_fused(entries, cache=_FLEET_JIT_CACHE, label=label)
        except TRACER_ERRORS as exc:
            if mt is not None and m_t0 is not None:
                mt.note_failed_dispatch(label, _observe.clock() - m_t0)
            # a refusal leaves every stacked state intact: re-run per bucket so the per-wave ladder
            # isolates the refused wave
            _observe.note_fleet_fused_fallback(label, exc)
            return sum(self._flush_plan_fallback(p) for p in plans)
        except Exception as exc:  # noqa: BLE001 — fused dispatch death
            if mt is not None and m_t0 is not None:
                mt.note_failed_dispatch(label, _observe.clock() - m_t0)
            consumed = [p.bucket.label for p in plans if _consumed(exc, [p.bucket.stacked])]
            if consumed:
                raise DispatchConsumedError(
                    f"fused fleet dispatch {label!r} died with a CUDA error that leaves the stacked states of "
                    f"{', '.join(consumed)} unreadable; in-memory recovery is impossible. Recover via "
                    "StreamEngine.restore(checkpoint, wal_path=...)."
                ) from exc
            # states intact: the per-bucket fallback finds the failing bucket and walks it down to per-row
            # replay and per-row quarantine
            _observe.note_fleet_fused_fallback(label, exc)
            return sum(self._flush_plan_fallback(p) for p in plans)
        for p, (new_stacked, values, partial) in zip(plans, results):
            b = p.bucket
            b.stacked = new_stacked
            b.version += 1
            for subs in p.subs:
                for slot, seq, _a, _k in subs:
                    self._sessions[b.slot_sids[slot]].engine_count += 1
                    self._mark_applied(seq)
            if values is not None:
                # the tick program already computed this version's per-row values and running partial:
                # polls now run no compute
                b.values_dev = values
                b.values_dev_version = b.version
                b.values_np_version = -1
                b.partial = partial
                b.partial_version = b.version
                # the partial folded exactly these live rows
                b.partial_slots = tuple(i for i, sid in enumerate(b.slot_sids) if sid is not None)
        if mt is not None:
            # amortization rule: one fused dispatch's measured wall + the summed static cost of every wave
            # program, split equally over every submission that rode it
            skeys = [p.bucket.slot_skeys[s] for p in plans for subs in p.subs for s, _q, _a, _k in subs]
            cost_items = [(p.bucket.template, p.bucket.capacity, a, k) for p in plans for (a, k, _m) in p.staged]

            def cost_fn(items: Any = tuple(cost_items)) -> Tuple[float, float]:
                flops = traffic = 0.0
                for tmpl, cap, a, k in items:
                    cf, cb = _metering_cost(tmpl, cap, a, k)
                    flops += cf
                    traffic += cb
                return flops, traffic

            mt.note_dispatch(
                label,
                skeys,
                _observe.clock() - m_t0,
                cost_key=("fused", tuple((p.bucket.label, p.bucket.capacity, sig) for p in plans for sig in p.sigs)),
                cost_fn=cost_fn,
            )
        _observe.note_engine_dispatch("fleet", label)
        return 1

    def _flush_plan_fallback(self, plan: "_BucketPlan") -> int:
        """One masked dispatch per wave: isolates which bucket and wave failed the fused program."""
        bucket, queue = plan.bucket, plan.queue
        done, dead_slots = plan.done, plan.dead_slots
        mt = _observe._METER if _observe.ENABLED else None
        dispatches = 0
        with _trace.span("flush", bucket.label):
            for _sig, live0 in plan.waves:
                # earlier waves may have demoted sessions: re-filter, re-stage
                live = [i for i in live0 if i not in done and queue[i][0] not in dead_slots]
                if not live:
                    continue
                subs = [queue[i] for i in live]
                m_t0: Optional[float] = None
                try:
                    with _trace.span("wave_assembly", bucket.label):
                        stacked_args, stacked_kwargs, mask = self._stage(bucket, subs)
                    if mt is not None:
                        m_t0 = _observe.clock()
                    with _trace.span("dispatch", bucket.label):
                        new_stacked = engine_update(
                            bucket.template, bucket.capacity, bucket.stacked,
                            stacked_args, stacked_kwargs, mask=mask,
                            cache=_FLEET_JIT_CACHE, label=bucket.label,
                        )
                    if mt is not None:
                        mt.note_dispatch(
                            bucket.label,
                            [bucket.slot_skeys[s] for s, _q, _a, _k in subs],
                            _observe.clock() - m_t0,
                            cost_key=(bucket.label, bucket.capacity, _sig),
                            cost_fn=lambda b=bucket, a=stacked_args, k=stacked_kwargs: _metering_cost(
                                b.template, b.capacity, a, k
                            ),
                        )
                except TRACER_ERRORS as exc:
                    if mt is not None and m_t0 is not None:
                        mt.note_failed_dispatch(bucket.label, _observe.clock() - m_t0)
                    # a refusal leaves the stacked states intact: demote ONLY this wave's sessions to loose
                    # and replay their submissions eagerly; the rest of the bucket keeps its rows
                    _observe.note_fleet_fallback(bucket.label, exc)
                    bucket.faults += 1
                    for i in live:
                        slot, seq, args, kwargs = queue[i]
                        sess = self._sessions[bucket.slot_sids[slot]]
                        self._materialize(sess)
                        self._release_slot(sess)
                        sess.health = "loose"
                        done.add(i)
                        dead_slots.add(slot)
                        _eager_update(sess.metric, args, kwargs)
                        self._mark_applied(seq)
                        _observe.note_fleet_loose_update(type(sess.metric).__name__)
                        self._meter_loose(sess)
                        self._replay_tail(queue, done, slot, sess)
                    if bucket.active() == 0:
                        self._drop_bucket(bucket)
                    continue
                except Exception as exc:  # noqa: BLE001 — dispatch death
                    if mt is not None and m_t0 is not None:
                        mt.note_failed_dispatch(bucket.label, _observe.clock() - m_t0)
                    if _consumed(exc, [bucket.stacked]):
                        raise DispatchConsumedError(
                            f"fleet bucket {bucket.label!r}: dispatch died with a CUDA error that leaves its "
                            "stacked states unreadable; in-memory recovery is impossible. Recover via "
                            "StreamEngine.restore(checkpoint, wal_path=...)."
                        ) from exc
                    self._replay_wave_rows(bucket, queue, live, done, dead_slots)
                    continue
                bucket.stacked = new_stacked
                bucket.version += 1
                for slot, seq, _a, _k in subs:
                    self._sessions[bucket.slot_sids[slot]].engine_count += 1
                    self._mark_applied(seq)
                done.update(live)
                _observe.note_engine_dispatch("fleet", bucket.label)
                dispatches += 1
        return dispatches

    def _replay_wave_rows(
        self, bucket: _Bucket, queue: List[Tuple[int, int, Tuple[Any, ...], Dict[str, Any]]],
        live: List[int], done: Set[int], dead_slots: Set[int],
    ) -> None:
        """A wave's dispatch failed with the stacked states intact: re-run each row's update eagerly through
        the pure per-row update. Surviving rows are written back; a row whose update raises is individually
        quarantined with its state rolled back (untouched)."""
        for i in live:
            slot, seq, args, kwargs = queue[i]
            sess = self._sessions[bucket.slot_sids[slot]]
            row = {k: v[slot] for k, v in bucket.stacked.items()}
            try:
                new_row = bucket.template._functional_update(
                    row,
                    *(_as_operand(a, bucket.template.device) for a in args),
                    **{k: _as_operand(v, bucket.template.device) for k, v in kwargs.items()},
                )
            except Exception as row_exc:  # noqa: BLE001 — this row is the poison
                self._quarantine(sess, "update_error", row_exc)
                dead_slots.add(slot)
                done.add(i)
                self._mark_applied(seq)  # the failed submission is consumed (dropped)
                self._replay_tail(queue, done, slot, sess)
                continue
            with _transfer_scope("row_replay"):
                for k in bucket.stacked:
                    bucket.stacked[k][slot] = new_row[k]
            bucket.version += 1
            sess.engine_count += 1
            done.add(i)
            self._mark_applied(seq)
            _observe.note_fleet_row_replay(bucket.label)
            self._meter_loose(sess)  # eager per-row replay: host work, not a shared dispatch

    def _replay_tail(
        self, queue: List[Tuple[int, int, Tuple[Any, ...], Dict[str, Any]]],
        done: Set[int], slot: int, sess: _Session,
    ) -> None:
        """Eagerly apply every not-yet-flushed queued submission of a session that just left the bucket,
        preserving its per-session order."""
        for j, (qslot, seq, args, kwargs) in enumerate(queue):
            if j in done or qslot != slot:
                continue
            done.add(j)
            _eager_update(sess.metric, args, kwargs)
            self._mark_applied(seq)
            _observe.note_fleet_loose_update(type(sess.metric).__name__)
            self._meter_loose(sess)

    def _stage(
        self, bucket: _Bucket, subs: List[Tuple[int, int, Tuple[Any, ...], Dict[str, Any]]]
    ) -> Tuple[Tuple[Any, ...], Dict[str, Any], Any]:
        """Scatter one wave's batches into (capacity, ...) staging tensors on the bucket's device.

        Submissions already on that device are stacked there (no host round trip); host rows (numpy
        arrays, CPU tensors for a card bucket) are stacked on the host and copied over once per column, from
        pinned memory to a card so that the copy does not wait for it (a served fleet's rows are numpy).
        """
        capacity = bucket.capacity
        device = bucket.template.device
        dkey = _device_key(device)
        slots = [s for s, _q, _a, _k in subs]
        args0, kwargs0 = subs[0][2], subs[0][3]
        kw_names = sorted(kwargs0)
        with _transfer_scope("wave_assembly"):
            index = torch.tensor(slots, dtype=torch.int64, device=device)

            def stage(rows: List[Any], first: Any) -> Any:
                if not hasattr(first, "shape"):
                    return first  # signature grouping guarantees value equality
                if all(isinstance(r, torch.Tensor) and _device_key(r.device) == dkey for r in rows):
                    col = torch.stack(rows, dim=0)
                else:
                    col = torch.as_tensor(
                        np.stack([r.detach().cpu().numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
                                  for r in rows], axis=0)
                    )
                    col = col.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else col.to(device)
                buf = torch.zeros((capacity,) + tuple(col.shape[1:]), dtype=col.dtype, device=device)
                return buf.index_copy_(0, index, col)

            stacked_args = tuple(stage([sub[2][i] for sub in subs], a) for i, a in enumerate(args0))
            stacked_kwargs = {k: stage([sub[3][k] for sub in subs], kwargs0[k]) for k in kw_names}
            mask = torch.zeros(capacity, dtype=torch.bool, device=device).index_fill_(0, index, True)
        return stacked_args, stacked_kwargs, mask

    # ------------------------------------------------------------------ fallback
    def _materialize(self, sess: _Session) -> None:
        """Copy a session's engine-resident row back into its metric instance."""
        bucket, slot, m = sess.bucket, sess.slot, sess.metric
        with _transfer_scope("expire_slice"):
            for k in m._defaults:
                # a copy: the stacked tensors stay the engine's own, written in place by later adoptions
                m.__dict__["_state"][k] = bucket.stacked[k][slot].clone()
        m._update_count = sess.base_count + sess.engine_count
        m._computed = None

    def _release_slot(self, sess: _Session) -> None:
        bucket = sess.bucket
        bucket.slot_sids[sess.slot] = None
        bucket.slot_skeys[sess.slot] = None
        bucket.free.append(sess.slot)
        sess.bucket = None
        sess.slot = -1

    def _quarantine(self, sess: _Session, reason: str, exc: Optional[BaseException] = None) -> None:
        """Individually eject one session: its row is materialized back (rolled back for a failed update:
        the stacked row was never touched), its slot recycles, and it runs loose from here on with
        ``health == "quarantined"``. The bucket keeps every other row."""
        bucket = sess.bucket
        self._materialize(sess)
        self._release_slot(sess)
        sess.health = "quarantined"
        bucket.faults += 1
        _observe.note_fleet_quarantine(bucket.label, reason, exc)
        mt = _observe._METER if _observe.ENABLED else None
        if mt is not None:
            mt.note_quarantine(str(sess.sid))

    def _demote_session(self, sess: _Session) -> None:
        """Convert one bucketed session to a loose one (row handed back)."""
        bucket = sess.bucket
        if bucket.queue:
            self._flush_bucket(bucket)  # ordering: queued updates land first
        if sess.bucket is None:
            return  # the flush itself demoted this session
        self._materialize(sess)
        self._release_slot(sess)
        sess.health = "loose"

    def _drop_bucket(self, bucket: _Bucket) -> None:
        """Remove an emptied bucket (every session demoted or quarantined away)."""
        self._buckets.pop(bucket.key, None)
        self._ckpt_cache.pop(bucket.key, None)
        self._dirty_buckets.pop(bucket.key, None)
        _observe.set_fleet_gauges(bucket.label, 0, 0, 0, 0, 0)
        mt = _observe._METER if _observe.ENABLED else None
        if mt is not None:
            mt.drop_bucket_memory(self._name, bucket.label)

    # ------------------------------------------------------------------ readout
    def compute(self, session_id: Hashable) -> Any:
        """Flush pending work, then return this session's metric value."""
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"unknown or expired session {session_id!r}")
        self._flush_pending()
        if sess.bucket is None:
            return sess.metric.compute()
        values = self._bucket_values_np(sess.bucket)
        if values is None:
            return self._row_value(sess.bucket, sess.slot)
        return _tree_map(lambda a: a[sess.slot], values)

    def compute_all(self) -> Dict[Hashable, Any]:
        """Flush pending work, then compute every live session.

        O(1) device work per bucket per poll: fold-eligible buckets were already computed inside the tick's
        fused program, every other bucket's vmapped compute is cached by state version, and either way the
        whole bucket's values come to the host in ONE fetch, with per-session rows sliced from the host copy.
        A poll with no state change since the last one touches no device at all.
        """
        self._flush_pending()
        out: Dict[Hashable, Any] = {}
        for sid, sess in self._sessions.items():
            if sess.bucket is None:
                out[sid] = sess.metric.compute()
                continue
            values = self._bucket_values_np(sess.bucket)
            if values is None:
                out[sid] = self._row_value(sess.bucket, sess.slot)
            else:
                out[sid] = _tree_map(lambda a, s=sess.slot: a[s], values)
        return out

    def _bucket_values_np(self, bucket: _Bucket) -> Any:
        """Host-cached per-row values for the whole bucket; None means eager rows.

        One batched device-to-host fetch per bucket per state version, of the fused tick's values
        (fold-eligible buckets: no compute at poll time) or of the cached vmapped compute.
        """
        if bucket.values_np_version == bucket.version:
            return bucket.values_np
        if bucket.values_dev_version == bucket.version:
            values = bucket.values_dev
        else:
            values = self._bucket_values(bucket)
        if values is None:
            return None
        bucket.values_np = _host_fetch(values, "poll_readout")
        bucket.values_np_version = bucket.version
        return bucket.values_np

    def _bucket_values(self, bucket: _Bucket) -> Any:
        """Whole-bucket vmapped compute, cached by state version; None means eager rows."""
        if bucket.computed_version == bucket.version:
            return bucket.computed
        if not bucket.compute_eager:
            try:
                with _trace.span("fleet_compute", bucket.label):
                    values = engine_compute(
                        bucket.template, bucket.capacity, bucket.stacked,
                        cache=_FLEET_JIT_CACHE, label=f"{bucket.label}:compute",
                    )
            except TRACER_ERRORS as exc:
                bucket.compute_eager = True
                _observe.note_fleet_fallback(f"{bucket.label}:compute", exc)
            else:
                # separate counter family: fleet_dispatch stays a pure update-dispatch count
                _observe.note_engine_dispatch("fleet_compute", bucket.label)
                bucket.computed = values
                bucket.computed_version = bucket.version
                return values
        return None

    def _row_value(self, bucket: _Bucket, slot: int) -> Any:
        row = {k: v[slot].clone() for k, v in bucket.stacked.items()}
        return _squeeze_if_scalar(bucket.template._functional_compute(row))

    # ------------------------------------------------------------------ lifecycle
    def expire(self, session_id: Hashable) -> Metric:
        """Retire a session: flush its pending updates, materialize its state back into the metric
        instance, recycle its row, and hand the metric back."""
        if session_id not in self._sessions:
            raise KeyError(f"unknown or expired session {session_id!r}")
        seq = self._log("expire", session_id)
        with _trace.span("expire", self._name):
            metric = self._apply_expire(session_id)
        self._mark_applied(seq)
        return metric

    def _apply_expire(self, session_id: Hashable) -> Metric:
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"unknown or expired session {session_id!r}")
        if sess.bucket is not None and sess.bucket.queue:
            self._flush_bucket(sess.bucket)
        if sess.bucket is not None:
            label = sess.bucket.label
            self._materialize(sess)
            self._release_slot(sess)
        else:
            label = "loose"
            self._flush_loose(sess)
        del self._sessions[session_id]
        if self._skey_index.get(str(session_id)) == session_id:
            del self._skey_index[str(session_id)]
        self._dirty_loose.pop(session_id, None)
        _observe.note_fleet_session(label, "expire")
        self._publish_gauges()
        return sess.metric

    def reset(self, session_id: Optional[Hashable] = None) -> None:
        """Reset one session's row (or, with no id, the whole fleet) to defaults.

        Pending queued submissions for the reset scope are discarded: a reset row starts from zero, exactly
        like ``Metric.reset()``.
        """
        if session_id is not None and session_id not in self._sessions:
            raise KeyError(f"unknown or expired session {session_id!r}")
        seq = self._log("reset", session_id)
        self._apply_reset(session_id)
        self._mark_applied(seq)

    def _apply_reset(self, session_id: Optional[Hashable]) -> None:
        if session_id is None:
            for bucket in self._buckets.values():
                bucket.stacked = bucket._tiled_defaults(bucket.capacity)
                for _slot, qseq, _a, _k in bucket.queue:
                    self._mark_applied(qseq)  # discarded, never to be replayed
                bucket.queue = []
                bucket.version += 1
            for sess in self._sessions.values():
                sess.metric.reset()
                sess.base_count = 0
                sess.engine_count = 0
                for qseq, _a, _k in sess.queue:
                    self._mark_applied(qseq)
                sess.queue = []
            self._publish_gauges()
            return
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"unknown or expired session {session_id!r}")
        sess.metric.reset()
        sess.base_count = 0
        sess.engine_count = 0
        bucket = sess.bucket
        if bucket is None:
            for qseq, _a, _k in sess.queue:
                self._mark_applied(qseq)
            sess.queue = []
            return
        kept = []
        for entry in bucket.queue:
            if entry[0] == sess.slot:
                self._mark_applied(entry[1])
            else:
                kept.append(entry)
        bucket.queue = kept
        with _transfer_scope("reset_row"):
            for k, d in bucket.template._defaults.items():
                bucket.stacked[k][sess.slot] = d
        bucket.version += 1

    # ------------------------------------------------------------------ serve front door
    def serve_mark(self, producer: str, pseq: int) -> None:
        """Record that remote ``producer``'s record ``pseq`` was applied here.

        Write-ahead like every other ingest record: the mark is journaled (kind ``serve_mark``) before the
        in-memory watermark moves, so a restore replays exactly the marks whose data records it replays.
        """
        seq = self._log("serve_mark", str(producer), int(pseq))
        self._serve_marks[str(producer)] = max(self._serve_marks.get(str(producer), 0), int(pseq))
        self._mark_applied(seq)

    def serve_watermark(self, producer: str) -> int:
        """Highest remote pseq applied through this engine for ``producer``."""
        return self._serve_marks.get(str(producer), 0)

    def serve_watermarks(self) -> Dict[str, int]:
        return dict(self._serve_marks)

    def loose_session_ids(self) -> List[Hashable]:
        """Sessions running off the bucketed path (loose or quarantined): the cheapest rows to shed."""
        return [sid for sid, sess in self._sessions.items() if sess.bucket is None]

    def preexpand(self, occupancy_pct: float = 85.0) -> List[str]:
        """Pre-emptively double every bucket at or above ``occupancy_pct`` full.

        Growing before the free-list empties means the new program for the doubled capacity (exactly one)
        is built on the operator's schedule instead of inside an arrival burst. Returns the labels of the
        buckets grown.
        """
        grown: List[str] = []
        for bucket in self._buckets.values():
            if bucket.capacity and 100.0 * bucket.active() / bucket.capacity >= occupancy_pct:
                bucket.grow()
                grown.append(bucket.label)
        if grown:
            self._publish_gauges()
        return grown

    # ------------------------------------------------------------------ durability
    def checkpoint(self, path: str) -> str:
        """Write an incremental fleet snapshot (dirty buckets only) and truncate the ingest journal down to
        the records the snapshot does not yet cover. ``resilience.checkpoint.save_checkpoint(engine, path)``
        is equivalent."""
        from metrics_tpu_torch.engine.durability import save_fleet_checkpoint

        return save_fleet_checkpoint(self, path)

    @classmethod
    def restore(
        cls,
        path: str,
        wal_path: Optional[str] = None,
        initial_capacity: int = 8,
        nan_guard: bool = False,
        name: str = "engine",
        device: Optional[Union[str, torch.device]] = None,
    ) -> "StreamEngine":
        """Rebuild a fleet from a checkpoint, then replay the ingest journal.

        The checkpoint is fully validated before anything is installed; journal records already covered by
        the snapshot's applied watermark are skipped, the rest re-enter through the normal ingest path in
        sequence order (so wave grouping, and therefore the recovered states, are bit-exact versus an engine
        that never crashed). Replayed submissions sit in the ingest queues; the next ``tick()``/``compute()``
        applies them. ``device`` moves every metric of the snapshot and the journal there (a fleet saved on
        the card restores on the CPU with ``device="cpu"``); by default each keeps the device it was saved on.
        """
        from metrics_tpu_torch.engine.durability import restore_fleet_checkpoint

        engine = cls(initial_capacity=initial_capacity, nan_guard=nan_guard, name=name)
        restore_fleet_checkpoint(engine, path, wal_path=wal_path, device=device)
        return engine

    # ------------------------------------------------------------------ telemetry
    def _wal_lag(self) -> Tuple[int, int]:
        """(records, bytes) of durability lag: ingest records sequenced beyond the last checkpoint's applied
        watermark, and the journal bytes a restore would replay; (0, 0) without a journal."""
        if self._wal is None:
            return 0, 0
        records = max(0, self._seq - self._ckpt_applied_seq)
        return records, self._wal.size_bytes()

    def _last_ckpt_age_s(self) -> Optional[float]:
        """Seconds since the last checkpoint save/restore; None if never."""
        if self._last_ckpt_time is None:
            return None
        return max(0.0, _observe.clock() - self._last_ckpt_time)

    def stats(self) -> Dict[str, Any]:
        """Occupancy, fragmentation, pad waste and health per bucket plus fleet totals and durability lag
        (``wal_lag_records``/``wal_lag_bytes``/``last_ckpt_age_s``), also pushed as ``fleet_*``/``wal_*``
        observe gauges when telemetry is enabled."""
        buckets: Dict[str, Dict[str, Any]] = {}
        tot_active = tot_capacity = tot_bytes = tot_bytes_active = 0
        for bucket in self._buckets.values():
            active = bucket.active()
            bytes_stacked = bucket.capacity * bucket.row_bytes
            bytes_active = active * bucket.row_bytes
            buckets[bucket.label] = {
                "capacity": bucket.capacity,
                "active": active,
                "fragmented": bucket.fragmented(),
                "pending": len(bucket.queue),
                "row_bytes": bucket.row_bytes,
                "bytes_stacked": bytes_stacked,
                "occupancy_pct": 100.0 * active / bucket.capacity,
                "pad_waste_pct": 100.0 * (bytes_stacked - bytes_active) / bytes_stacked if bytes_stacked else 0.0,
                "health": bucket.health(),
                "faults": bucket.faults,
            }
            tot_active += active
            tot_capacity += bucket.capacity
            tot_bytes += bytes_stacked
            tot_bytes_active += bytes_active
        loose = sum(1 for s in self._sessions.values() if s.bucket is None)
        quarantined = sum(1 for s in self._sessions.values() if s.health == "quarantined")
        lag_records, lag_bytes = self._wal_lag()
        self._publish_gauges()
        return {
            "name": self._name,
            "buckets": buckets,
            "sessions": len(self._sessions),
            "loose_sessions": loose,
            "quarantined_sessions": quarantined,
            "ticks": self._ticks,
            "seq": self._seq,
            "applied_seq": self._applied_seq,
            "rows_active": tot_active,
            "rows_capacity": tot_capacity,
            "occupancy_pct": 100.0 * tot_active / tot_capacity if tot_capacity else None,
            "pad_waste_pct": 100.0 * (tot_bytes - tot_bytes_active) / tot_bytes if tot_bytes else None,
            "wal_lag_records": lag_records,
            "wal_lag_bytes": lag_bytes,
            "wal_torn_tail": self._wal_torn,
            "last_ckpt_age_s": self._last_ckpt_age_s(),
        }

    def _publish_gauges(self) -> None:
        if not _observe.ENABLED:
            return
        mt = _observe._METER
        for bucket in self._buckets.values():
            active = bucket.active()
            _observe.set_fleet_gauges(
                bucket.label,
                active,
                bucket.capacity,
                bucket.fragmented(),
                bucket.capacity * bucket.row_bytes,
                active * bucket.row_bytes,
            )
            if mt is not None:
                mt.note_bucket_memory(self._name, bucket.label, bucket.capacity, active, bucket.row_bytes)
        lag_records, lag_bytes = self._wal_lag()
        _observe.note_wal_gauges(self._name, lag_records, lag_bytes, self._last_ckpt_age_s())
