"""Horizontally sharded fleet: StreamEngines across devices (counterpart of ``metrics_tpu/engine/sharded.py``).

A single :class:`~metrics_tpu_torch.engine.stream.StreamEngine` caps the fleet at one
device's memory and one dispatch queue, and its durability is one monolithic
WAL + checkpoint: a lost host takes the whole fleet down and recovery replays
everything. :class:`ShardedStreamEngine` removes both ceilings by partitioning
the session population across ``n_shards`` inner engines:

* **Routing.** ``shard_of(session_id) = crc32(repr(session_id)) % n_shards``
  — process-stable (never Python's salted ``hash``), so the same session lands
  on the same shard across restarts, and a *resized* fleet re-routes every
  session deterministically through the normal arrival path.
* **Per-shard dispatch on devices.** Each shard is a full StreamEngine whose
  buckets pad/stack/mask exactly as before; shard ``k`` is pinned to
  ``devices[k % len(devices)]`` (every CUDA device by default; without one
  the caller passes ``devices=["cpu"]``): a session joining shard ``k`` moves its metric there, so the
  fused dispatches of different shards land on different devices. Shards
  sharing a metric class, config and device share ONE program (the program
  cache keys on the template, not on the shard), so sharding builds no extra
  programs.
* **Hierarchical merge.** :meth:`aggregate` folds matching sessions through
  the metric's *declared* merge algebra (``Metric._merge_state_dicts``):
  rows → shard partial → intra-group fold ("intra-host") → cross-group fold
  ("cross-host"). With ``mesh=`` given (a ``torch.distributed`` process
  group, or ``True`` for the default group) and every state's algebra a safe
  builtin (sum/min/max), the cross-group stage runs as ``all_reduce``
  collectives over that group, each rank contributing its own fleet.
* **Shard-local durability.** Each shard journals to its own WAL file
  (``shard-NNN.wal``) and checkpoints to its own generation-named MTCKPT file;
  a tiny CRC-validated **manifest** (``MANIFEST.mtman``,
  ``resilience/checkpoint.py``) written atomically LAST is the durability
  point. A lost host therefore restores and replays *only its own shard's*
  journal — recovery cost scales with shard size, not fleet size — and
  ``n_shards`` may grow or shrink between restores (:meth:`restore` re-hashes
  every session through the normal arrival path; one compile per resized
  bucket capacity, never a full-fleet replay).
* **Blast-radius ladder, one rung further.** poisoned session → row → bucket
  → **shard**: a dispatch that dies after consuming its donated buffers
  (:class:`~metrics_tpu_torch.engine.core.DispatchConsumedError`) triggers a
  *shard-local self-heal* (restore just that shard from its own checkpoint
  file + journal, the other shards never stop ticking); a shard that dies
  again before its next clean tick — or whose files are unrecoverable under
  ``on_lost_shard="demote"`` — is **demoted**: its sessions run as eager
  loose sessions while every other shard keeps the one-dispatch-per-bucket-
  per-tick economy.

::

    fleet = ShardedStreamEngine(n_shards=8, wal_dir="fleet.d")
    sid = fleet.add_session(MulticlassAccuracy(num_classes=10))
    fleet.submit(sid, preds, target)
    fleet.tick()                          # one dispatch per touched bucket per shard
    fleet.checkpoint("fleet.d")           # per-shard files + atomic manifest
    fleet = ShardedStreamEngine.restore("fleet.d")            # same topology
    fleet = ShardedStreamEngine.restore("fleet.d", n_shards=12)  # elastic resize
"""

from __future__ import annotations

import contextlib
import os
import re
import zlib
from typing import Any, Dict, Hashable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.engine.core import DispatchConsumedError
from metrics_tpu_torch.engine.durability import (
    IngestWAL,
    replay_wal,
    restore_fleet_checkpoint,
    save_fleet_checkpoint,
)
from metrics_tpu_torch.engine.stream import StreamEngine, _device_key
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.observe import tracing as _trace
from metrics_tpu_torch.parallel.sync import _all_reduce_in_place
from metrics_tpu_torch.resilience.checkpoint import (
    CheckpointError,
    CorruptCheckpointError,
    IncompatibleCheckpointError,
    file_crc32,
    load_manifest,
    save_manifest,
)
from metrics_tpu_torch.utils.compute import acc_dtype
from metrics_tpu_torch.utils.data import dim_zero_max, dim_zero_min, dim_zero_sum
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

__all__ = ["MANIFEST_NAME", "ShardedStreamEngine", "shard_of"]

MANIFEST_NAME = "MANIFEST.mtman"
_CKPT_RE = re.compile(r"^g(\d{8})-shard(\d{3})\.mtckpt$")

# cross-shard reductions that are count-independent, associative and
# commutative: the only algebras the collective fold accepts; mean and
# custom folds take the count-weighted host path instead
_MESH_OPS = {dim_zero_sum: "SUM", dim_zero_max: "MAX", dim_zero_min: "MIN"}


def _default_devices() -> List[torch.device]:
    """Every CUDA device; without one the caller must pass ``devices=["cpu"]``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ShardedStreamEngine places its shards on the CUDA devices by default, and none is available."
            " Pass devices=['cpu'] to run the shards on the CPU."
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_of(session_id: Hashable, n_shards: int) -> int:
    """Stable shard routing: ``crc32(repr(sid)) % n_shards``.

    ``repr`` + CRC32 is process-stable and restart-stable, unlike Python's
    salted ``hash()`` — the whole durability story (a shard's WAL must keep
    describing the same session population across restores) depends on it.
    """
    return zlib.crc32(repr(session_id).encode("utf-8")) % n_shards


class ShardedStreamEngine:
    """Drive a churning metric-stream population as ``n_shards`` StreamEngines
    partitioned over the local devices, with shard-local durability."""

    def __init__(
        self,
        n_shards: Optional[int] = None,
        initial_capacity: int = 8,
        wal_dir: Optional[str] = None,
        nan_guard: bool = False,
        name: str = "fleet",
        devices: Optional[List[Any]] = None,
    ) -> None:
        self._devices = [torch.device(d) for d in devices] if devices is not None else _default_devices()
        if n_shards is None:
            n_shards = max(1, len(self._devices))
        if int(n_shards) < 1:
            raise TPUMetricsUserError("ShardedStreamEngine needs n_shards >= 1")
        self.n_shards = int(n_shards)
        self._name = str(name)
        self._initial_capacity = int(initial_capacity)
        self._nan_guard = bool(nan_guard)
        self._wal_dir = os.fspath(wal_dir) if wal_dir is not None else None
        if self._wal_dir is not None:
            os.makedirs(self._wal_dir, exist_ok=True)
        self._shards: List[StreamEngine] = [
            StreamEngine(
                initial_capacity=initial_capacity,
                wal_path=self._shard_wal_path(k),
                nan_guard=nan_guard,
                name=f"{self._name}/shard{k}",
            )
            for k in range(self.n_shards)
        ]
        self._next_auto = 0  # fleet-level so auto session ids are unique across shards
        self._ticks = 0
        self._generation = 0  # checkpoint generation (monotonic across restores)
        self._ckpt_dir: Optional[str] = None  # last manifest dir (enables self-heal)
        self._demoted: Dict[int, str] = {}  # shard index -> demotion reason
        self._heal_suspect: set = set()  # shards healed but not yet cleanly ticked

    def _shard_wal_path(self, k: int) -> Optional[str]:
        if self._wal_dir is None:
            return None
        return os.path.join(self._wal_dir, f"shard-{k:03d}.wal")

    def _shard_device(self, k: int) -> torch.device:
        return self._devices[k % len(self._devices)]

    def _on_shard(self, k: int):
        """Device-pinning context: shard ``k``'s work runs with ``devices[k % len(devices)]`` current."""
        device = self._shard_device(k)
        return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()

    def shard_of(self, session_id: Hashable) -> int:
        return shard_of(session_id, self.n_shards)

    # ------------------------------------------------------------------ sessions
    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def session_ids(self) -> List[Hashable]:
        out: List[Hashable] = []
        for shard in self._shards:
            out.extend(shard.session_ids())
        return out

    def session_health(self, session_id: Hashable) -> str:
        return self._shards[self.shard_of(session_id)].session_health(session_id)

    def add_session(self, metric: Metric, session_id: Optional[Hashable] = None) -> Hashable:
        """Adopt a live metric into the fleet; hashes its id onto a shard."""
        if session_id is None:
            sid = self._next_auto
            self._next_auto += 1
        else:
            sid = session_id
            if isinstance(sid, int) and sid >= self._next_auto:
                self._next_auto = sid + 1  # auto ids must never collide with explicit ints
        k = self.shard_of(sid)
        shard = self._shards[k]
        device = self._shard_device(k)
        if _device_key(metric.device) != _device_key(device):
            metric.to_device(device)  # the session follows its shard
        with self._on_shard(k):
            shard.add_session(metric, sid)
            if k in self._demoted:
                # a demoted shard's vmapped path is distrusted: new arrivals run
                # loose immediately so they never enter a bucket dispatch
                sess = shard._sessions[sid]
                if sess.bucket is not None:
                    shard._demote_session(sess)
        return sid

    def submit(self, session_id: Hashable, *args: Any, **kwargs: Any) -> None:
        self._shards[self.shard_of(session_id)].submit(session_id, *args, **kwargs)

    def expire(self, session_id: Hashable) -> Metric:
        k = self.shard_of(session_id)
        with self._on_shard(k):
            return self._shards[k].expire(session_id)

    def reset(self, session_id: Optional[Hashable] = None) -> None:
        if session_id is None:
            for k, shard in enumerate(self._shards):
                with self._on_shard(k):
                    shard.reset()
            return
        k = self.shard_of(session_id)
        with self._on_shard(k):
            self._shards[k].reset(session_id)

    # ------------------------------------------------------------------ serve front door
    def serve_mark(self, producer: str, pseq: int, session_id: Hashable) -> None:
        """Journal a remote producer watermark on the shard that applied the
        record (routing is the stable crc32 hash, so a resent record lands on
        the same shard and meets the same watermark)."""
        self._shards[self.shard_of(session_id)].serve_mark(producer, pseq)

    def serve_watermark(self, producer: str, session_id: Optional[Hashable] = None) -> int:
        """With ``session_id``: the watermark on that id's target shard (the
        dedup authority for a record). Without: the fleet-wide max — an upper
        bound handed to reconnecting producers as informational only, since a
        crash can leave shards at different durable prefixes."""
        if session_id is not None:
            return self._shards[self.shard_of(session_id)].serve_watermark(producer)
        return max((s.serve_watermark(producer) for s in self._shards), default=0)

    def serve_watermarks(self) -> Dict[str, int]:
        marks: Dict[str, int] = {}
        for shard in self._shards:
            for p, v in shard._serve_marks.items():
                marks[p] = max(marks.get(p, 0), v)
        return marks

    def loose_session_ids(self) -> List[Hashable]:
        out: List[Hashable] = []
        for shard in self._shards:
            out.extend(shard.loose_session_ids())
        return out

    def preexpand(self, occupancy_pct: float = 85.0) -> List[str]:
        """Pre-emptively double near-full buckets on every shard (pinned to
        each shard's device); returns the labels grown fleet-wide."""
        grown: List[str] = []
        for k, shard in enumerate(self._shards):
            with self._on_shard(k):
                grown.extend(shard.preexpand(occupancy_pct))
        return grown

    def resize(self, n_shards: int) -> "ShardedStreamEngine":
        """Rendezvous-free elastic resize, in place: every session re-enters a
        fresh ``n_shards`` topology through the normal arrival path (pending
        submissions preserved in order, journals rebuilt self-sufficient).
        The last manifest describes the old topology, so ``_ckpt_dir`` resets
        until the next :meth:`checkpoint`. Returns ``self``.
        """
        new_n = int(n_shards)
        if new_n < 1:
            raise TPUMetricsUserError("ShardedStreamEngine.resize needs n_shards >= 1")
        if new_n == self.n_shards:
            return self
        fleet = type(self)._rehash(
            self, new_n, self._wal_dir, self._initial_capacity, self._nan_guard, self._devices
        )
        self.__dict__.update(fleet.__dict__)
        _observe.record_event(
            "fleet_resized", name=self._name, shards=self.n_shards, sessions=len(self)
        )
        return self

    # ------------------------------------------------------------------ dispatch
    def tick(self) -> int:
        """Flush every shard — ONE fused dispatch per touched shard per tick.

        The walk is software-pipelined (double-buffered ingest): each shard's
        host-side wave assembly (:meth:`StreamEngine._stage_flush` — WAL sync,
        queue planning, staging-buffer stacking) runs *before* the previous
        shard's staged program is dispatched, so the host assembles shard
        ``k+1``'s waves while shard ``k``'s fused program is still in
        flight on its device. Blast radius is unchanged: dispatch errors are
        attributed to exactly one shard.

        A shard whose dispatch dies after consuming its donated buffers
        (:class:`DispatchConsumedError`) is *self-healed* from its own
        checkpoint file + journal when a manifest is known — the other shards
        are never touched. A shard that dies again before its next clean tick
        is demoted to eager loose sessions instead (last ladder rung).
        """
        total = 0
        pending: Optional[Tuple[int, Any]] = None  # (shard idx, staged host buffers)
        for k, shard in enumerate(self._shards):
            with _trace.span("shard_stage", shard._name):
                with self._on_shard(k):
                    staged = shard._stage_flush()
            if pending is not None:
                total += self._dispatch_shard(*pending)
            pending = (k, staged)
        if pending is not None:
            total += self._dispatch_shard(*pending)
        self._ticks += 1
        if _observe.ENABLED:
            self._publish_shard_gauges()
            # demoted shards skip their inner StreamEngine.tick poke, so the
            # sharded rung pokes once more per fleet tick (rate-limited inside)
            _observe.poke_watchdog()
        return total

    def _dispatch_shard(self, k: int, staged: Any) -> int:
        """Issue one shard's staged fused program and run its tick epilogue.

        Exactly the dispatch half of :meth:`StreamEngine.tick`, pinned to the
        shard's device, with the per-shard consumed-buffer ladder around it."""
        shard = self._shards[k]
        with _trace.span("shard_tick", shard._name):
            try:
                with self._on_shard(k):
                    dispatches = shard._dispatch_flush(staged)
                    shard._tick_epilogue(dispatches)
            except DispatchConsumedError as exc:
                self._on_dead_dispatch(k, exc)
                return 0
        self._heal_suspect.discard(k)  # a clean tick clears heal probation
        return dispatches

    def _on_dead_dispatch(self, k: int, exc: DispatchConsumedError) -> None:
        shard = self._shards[k]
        if self._ckpt_dir is None or k in self._heal_suspect:
            # no durability to heal from, or the heal itself did not survive a
            # tick: walk the last rung — if the buffers are consumed nothing is
            # left to demote, so without a heal the error must surface
            if self._ckpt_dir is None:
                raise exc
            self._heal_shard(k, exc)  # fresh buffers so demotion can materialize rows
            self.demote_shard(k, f"dispatch death loop: {exc}")
            return
        self._heal_shard(k, exc)
        self._heal_suspect.add(k)

    def _heal_shard(self, k: int, exc: BaseException) -> None:
        """Rebuild shard ``k`` alone from the last manifest's per-shard files."""
        manifest = load_manifest(os.path.join(self._ckpt_dir, MANIFEST_NAME))
        if int(manifest.get("n_shards", -1)) != self.n_shards:
            raise DispatchConsumedError(
                f"shard {k} died ({exc}) and the last manifest describes a different "
                f"topology ({manifest.get('n_shards')} shards vs {self.n_shards}); "
                "checkpoint the resized fleet before relying on shard self-healing"
            ) from exc
        entry = manifest["shards"][k]
        old = self._shards[k]
        if old._wal is not None:
            old._wal.close()  # the replacement engine takes over the journal file
        if _observe.ENABLED:
            # the dead engine's buckets never see _drop_bucket: retire their
            # meter memory rows here or the ledger reports phantom live bytes
            mt = _observe._METER
            if mt is not None:
                for bucket in old._buckets.values():
                    mt.drop_bucket_memory(old._name, bucket.label)
        fresh = StreamEngine(
            initial_capacity=self._initial_capacity,
            nan_guard=self._nan_guard,
            name=old._name,
        )
        wal = self._resolve_wal(self._ckpt_dir, entry, self._wal_dir)
        restore_fleet_checkpoint(
            fresh, os.path.join(self._ckpt_dir, entry["ckpt"]), wal_path=wal, device=self._shard_device(k)
        )
        self._shards[k] = fresh
        _observe.note_shard_restore(fresh._name, len(fresh._sessions), 0, True)

    def demote_shard(self, k: int, reason: str = "manual") -> None:
        """Last rung of the blast-radius ladder: every bucketed session of shard
        ``k`` is converted to an eager loose session (rows materialized back,
        queued submissions preserved in per-session order) and the shard is
        marked demoted — its sessions keep accepting updates, they just no
        longer ride a vmapped dispatch. The other shards are untouched."""
        shard = self._shards[k]
        # queued bucket submissions move to their sessions so nothing dispatches
        # through the distrusted vmapped path and nothing is lost
        for bucket in list(shard._buckets.values()):
            for slot, seq, args, kwargs in bucket.queue:
                shard._sessions[bucket.slot_sids[slot]].queue.append((seq, args, kwargs))
            bucket.queue = []
        for sess in list(shard._sessions.values()):
            if sess.bucket is not None:
                shard._materialize(sess)
                shard._release_slot(sess)
                if sess.health == "healthy":
                    sess.health = "loose"
        for bucket in list(shard._buckets.values()):
            shard._drop_bucket(bucket)
        self._demoted[k] = str(reason)
        self._heal_suspect.discard(k)
        _observe.note_shard_demoted(shard._name, str(reason))

    # ------------------------------------------------------------------ readout
    def compute(self, session_id: Hashable) -> Any:
        k = self.shard_of(session_id)
        with self._on_shard(k):
            return self._shards[k].compute(session_id)

    def compute_all(self) -> Dict[Hashable, Any]:
        out: Dict[Hashable, Any] = {}
        for k, shard in enumerate(self._shards):
            with self._on_shard(k):
                out.update(shard.compute_all())
        return out

    def aggregate(
        self,
        template: Metric,
        group_size: Optional[int] = None,
        mesh: Optional[Any] = None,
    ) -> Optional[Metric]:
        """Fleet-wide hierarchical merge of every session matching ``template``.

        Sessions whose metric shares ``template``'s class and config
        fingerprint contribute their state through the *declared* merge algebra
        (``Metric._merge_state_dicts`` — the same count-weighted fold
        ``Metric.merge_state`` and the distributed sync use): rows fold into a
        per-shard partial, shard partials fold within groups of ``group_size``
        consecutive shards (the intra-host stage; default one group), and the
        group partials fold across groups (the cross-host stage). With
        ``mesh=`` a ``torch.distributed`` process group (``True``: the default
        group) that is initialized, the cross-group stage instead runs as
        ``all_reduce`` collectives over it, each rank contributing its own
        fleet's fold, when every state's algebra is a count-independent builtin
        (sum/min/max); other algebras keep the host fold, which is always
        correct. Returns a fresh metric carrying the merged state, or ``None``
        when no session matches (on every rank, with a group).
        """
        fp = template.config_fingerprint()
        partials: List[Tuple[Dict[str, Any], int]] = []
        for k, shard in enumerate(self._shards):
            with self._on_shard(k):
                shard._flush_pending()
                p = self._shard_partial(shard, template, fp)
            if p is not None:
                partials.append(p)
        collective = mesh is not None and dist.is_available() and dist.is_initialized() and self._mesh_safe(template)
        if not partials and not collective:
            return None
        group = max(1, len(partials)) if not group_size else max(1, int(group_size))
        grouped = [
            self._fold(template, partials[i : i + group])
            for i in range(0, len(partials), group)
        ]
        if collective:
            merged = self._all_reduce(template, grouped, None if mesh is True else mesh)
            if merged is None:
                return None
        else:
            merged = self._fold(template, grouped)
        out = template.clone()
        out.reset()
        out.__dict__["_state"].update(merged[0])
        out._update_count = merged[1]
        out.__dict__["_state_escaped"] = True  # merged leaves are caller-visible
        out._computed = None
        return out

    def _mesh_safe(self, template: Metric) -> bool:
        return all(fx in _MESH_OPS for fx in template._reductions.values())

    def _all_reduce(
        self, template: Metric, grouped: List[Tuple[Dict[str, Any], int]], group: Any
    ) -> Optional[Tuple[Dict[str, Any], int]]:
        """The cross-group stage as collectives: this rank's groups fold locally, then every state is
        all-reduced by its own builtin (a rank with no matching session contributes the identity of that
        reduction, its template's defaults for a sum), and so is the update count."""
        local = self._fold(template, grouped) if grouped else None
        device = template.device
        count = torch.tensor([local[1] if local else 0], dtype=torch.int64, device=device)
        _all_reduce_in_place(count, "SUM", group)
        state: Dict[str, Any] = {}
        for k, fx in template._reductions.items():
            op = _MESH_OPS[fx]
            if local is not None:
                v = torch.as_tensor(local[0][k]).to(device).clone()
            elif op == "SUM":
                v = torch.zeros_like(template._defaults[k])
            else:
                d = template._defaults[k]
                fill = (torch.finfo(d.dtype) if d.is_floating_point() else torch.iinfo(d.dtype))
                v = torch.full_like(d, fill.min if op == "MAX" else fill.max)
            _all_reduce_in_place(v, op, group)
            state[k] = v
        # hotlint: intentional-transfer: the folded session count, read once after the all-reduce
        n = int(count.item())
        if n == 0:
            return None
        return state, n

    @staticmethod
    def _fold(template: Metric, parts: List[Tuple[Dict[str, Any], int]]) -> Tuple[Dict[str, Any], int]:
        state, count = parts[0]
        for other, n in parts[1:]:
            state = template._merge_state_dicts(state, other, count, n)
            count += n
        return state, count

    @staticmethod
    def _bucket_fold_fresh(bucket: Any) -> bool:
        """May ``aggregate`` use the bucket's tick-maintained partial verbatim?

        Requires the running fold to cover exactly the current state version
        AND the current occupancy — expiry after a tick releases a slot without
        touching device state, which would leave the departed row inside the
        column sum."""
        if bucket.partial is None or bucket.partial_version != bucket.version:
            return False
        live = tuple(i for i, sid in enumerate(bucket.slot_sids) if sid is not None)
        return live == bucket.partial_slots

    @staticmethod
    def _shard_partial(
        shard: StreamEngine, template: Metric, fp: Optional[str]
    ) -> Optional[Tuple[Dict[str, Any], int]]:
        cls = type(template)
        parts: List[Tuple[Dict[str, Any], int]] = []
        # both caches are per-bucket, keyed by identity: the freshness probe
        # scans the whole slot table and the fingerprint hashes the config, so
        # neither may run once per SESSION (100k sessions x 16k slots walked
        # the table 1.6B times before these memos)
        fold_fresh: Dict[int, bool] = {}
        fp_match: Dict[int, bool] = {}
        for sess in shard._sessions.values():
            # bucketed rows live in the stacked pytree (the session's own metric
            # instance is stale there); loose sessions carry their own state
            rep = sess.bucket.template if sess.bucket is not None else sess.metric
            if type(rep) is not cls:
                continue
            if fp is not None:
                ok = fp_match.get(id(rep))
                if ok is None:
                    ok = fp_match[id(rep)] = rep.config_fingerprint() == fp
                if not ok:
                    continue
            if sess.bucket is not None:
                bucket = sess.bucket
                fresh = fold_fresh.get(id(bucket))
                if fresh is None:
                    fresh = fold_fresh[id(bucket)] = (
                        ShardedStreamEngine._bucket_fold_fresh(bucket)
                    )
                    if fresh:
                        # O(1) per bucket: the fused tick already folded every
                        # live row's all-sum state into ``bucket.partial`` on
                        # device — contribute the whole bucket once instead of
                        # slicing rows
                        count = sum(
                            shard._sessions[sid].base_count
                            + shard._sessions[sid].engine_count
                            for sid in bucket.slot_sids
                            if sid is not None
                        )
                        parts.append((dict(bucket.partial), count))
                if fresh:
                    continue
                row = {k: v[sess.slot].clone() for k, v in bucket.stacked.items()}
                parts.append((row, sess.base_count + sess.engine_count))
            else:
                parts.append((dict(sess.metric.__dict__["_state"]), sess.metric._update_count))
        if not parts:
            return None
        return ShardedStreamEngine._fold(template, parts)

    # ------------------------------------------------------------------ durability
    def checkpoint(self, path: str) -> str:
        """Per-shard checkpoint files under one atomically-written manifest.

        Ordering is the durability contract: every shard's MTCKPT file is
        written (atomic + fsync) FIRST, the CRC-validated manifest naming them
        is written LAST, and only then is each shard's journal truncated — a
        crash at any point leaves either the old manifest (whose files and
        journals are all still intact) or the new one. Older generations are
        garbage-collected after the new manifest lands. Returns the manifest
        path.
        """
        path = os.fspath(path)
        os.makedirs(path, exist_ok=True)
        gen = self._generation + 1
        with _trace.span("ckpt", "fleet_save"):
            entries: List[Dict[str, Any]] = []
            for k, shard in enumerate(self._shards):
                fname = f"g{gen:08d}-shard{k:03d}.mtckpt"
                fpath = os.path.join(path, fname)
                with self._on_shard(k):
                    save_fleet_checkpoint(shard, fpath, truncate_wal=False)
                entries.append(
                    {
                        "shard": k,
                        "ckpt": fname,
                        "bytes": os.path.getsize(fpath),
                        "crc32": file_crc32(fpath),
                        "wal": os.path.basename(shard._wal_path) if shard._wal_path else None,
                        "applied_seq": int(shard._applied_seq) + len(shard._applied_above),
                        "sessions": len(shard._sessions),
                        "demoted": self._demoted.get(k),
                    }
                )
            save_manifest(
                os.path.join(path, MANIFEST_NAME),
                {
                    "kind": "fleet_sharded",
                    "format": 1,
                    "name": self._name,
                    "n_shards": self.n_shards,
                    "generation": gen,
                    "acc_dtype": str(acc_dtype()),
                    "next_auto": int(self._next_auto),
                    "shards": entries,
                },
            )
            # the manifest is durable: journals may now drop what the snapshot covers
            for shard in self._shards:
                if shard._wal is not None:
                    kept = shard._wal.truncate(lambda seq, s=shard: not s._is_applied(seq))
                    _observe.note_wal_truncate(shard._name, kept)
        self._generation = gen
        self._ckpt_dir = path
        self._gc_generations(path, gen)
        return os.path.join(path, MANIFEST_NAME)

    @staticmethod
    def _gc_generations(path: str, current: int) -> None:
        for fname in os.listdir(path):
            m = _CKPT_RE.match(fname)
            if m and int(m.group(1)) < current:
                try:
                    os.remove(os.path.join(path, fname))
                except OSError:
                    pass  # GC is best-effort; a leaked old generation is harmless

    @staticmethod
    def _resolve_wal(path: str, entry: Dict[str, Any], wal_dir: Optional[str] = None) -> Optional[str]:
        if entry.get("wal") is None:
            return None
        return os.path.join(wal_dir if wal_dir is not None else path, entry["wal"])

    @classmethod
    def restore(
        cls,
        path: str,
        wal_dir: Optional[str] = None,
        n_shards: Optional[int] = None,
        on_lost_shard: str = "raise",
        initial_capacity: int = 8,
        nan_guard: bool = False,
        devices: Optional[List[Any]] = None,
    ) -> "ShardedStreamEngine":
        """Rebuild a sharded fleet from its manifest directory.

        Every shard restores from its OWN checkpoint file (CRC-verified against
        the manifest) and replays its OWN journal — a shard's recovery never
        reads another shard's files, so recovery time scales with shard size,
        not fleet size. A shard whose checkpoint file is missing or damaged:

        * rebuilds from journal alone (bit-exact) when the manifest shows the
          snapshot covered nothing (``applied_seq == 0``) and the journal is
          intact;
        * otherwise raises (``on_lost_shard="raise"``, default) or — under
          ``on_lost_shard="demote"`` — comes back empty and demoted while
          every other shard restores normally.

        Passing ``n_shards`` different from the manifest's performs an elastic
        resize: the old topology is restored in full, then every session
        re-enters through the normal arrival path of a fresh fleet (its pending
        submissions preserved in order). Fresh journals are self-sufficient
        from that moment; the cost is one compile per resized bucket capacity,
        never a full-fleet replay. Each shard restores onto its pinned device,
        ``devices[k % len(devices)]``: a fleet saved on the card restores on the
        CPU with ``devices=["cpu"]``.
        """
        if on_lost_shard not in ("raise", "demote"):
            raise TPUMetricsUserError(
                f"on_lost_shard must be 'raise' or 'demote', got {on_lost_shard!r}"
            )
        path = os.fspath(path)
        manifest = load_manifest(os.path.join(path, MANIFEST_NAME))
        if manifest.get("kind") != "fleet_sharded":
            raise IncompatibleCheckpointError(
                f"{path}: manifest holds kind={manifest.get('kind')!r}, expected 'fleet_sharded'"
            )
        stored = manifest.get("acc_dtype")
        if stored is not None and stored != str(acc_dtype()):
            raise IncompatibleCheckpointError(
                f"{path}: manifest was written with accumulators in {stored} but this "
                f"process accumulates in {acc_dtype()}"
            )
        old_n = int(manifest.get("n_shards", 0))
        entries = manifest.get("shards", [])
        if old_n < 1 or len(entries) != old_n:
            raise CorruptCheckpointError(
                f"{path}: manifest names {len(entries)} shard entries for n_shards={old_n}"
            )
        with _trace.span("ckpt", "fleet_restore"):
            fleet = cls(
                n_shards=old_n,
                initial_capacity=initial_capacity,
                wal_dir=None,  # per-shard journals attach below, straight from the manifest
                nan_guard=nan_guard,
                name=manifest.get("name", "fleet"),
                devices=devices,
            )
            fleet._wal_dir = wal_dir if wal_dir is not None else path
            for k, entry in enumerate(entries):
                if int(entry.get("shard", -1)) != k:
                    raise CorruptCheckpointError(f"{path}: manifest shard entry {k} is out of order")
                shard = fleet._shards[k]
                fpath = os.path.join(path, entry["ckpt"])
                wal = cls._resolve_wal(path, entry, wal_dir)
                try:
                    if not os.path.exists(fpath):
                        raise CheckpointError(f"{fpath}: shard checkpoint file is missing")
                    if file_crc32(fpath) != int(entry["crc32"]):
                        raise CorruptCheckpointError(
                            f"{fpath}: shard checkpoint CRC does not match its manifest entry "
                            "(bit-flipped or torn shard file)"
                        )
                    with fleet._on_shard(k):
                        restore_fleet_checkpoint(shard, fpath, wal_path=wal, device=fleet._shard_device(k))
                except CheckpointError as exc:
                    recoverable = (
                        int(entry.get("applied_seq", 0)) == 0
                        and wal is not None
                        and os.path.exists(wal)
                    )
                    if recoverable:
                        # the snapshot covered nothing: the journal IS the full
                        # history, so an empty engine + replay is bit-exact
                        with fleet._on_shard(k):
                            n = replay_wal(shard, wal, device=fleet._shard_device(k))
                            shard._wal = IngestWAL(wal)
                            shard._wal_path = wal
                            shard._wal.truncate(lambda seq, s=shard: not s._is_applied(seq))
                        _observe.note_shard_restore(shard._name, len(shard._sessions), n, True)
                    elif on_lost_shard == "demote":
                        # shard state is gone; come back empty + demoted so the
                        # rest of the fleet restores and keeps ticking
                        if wal is not None:
                            if os.path.exists(wal):
                                os.remove(wal)  # its records reference lost sessions
                            shard._wal = IngestWAL(wal)
                            shard._wal_path = wal
                        fleet._demoted[k] = f"unrecoverable shard files: {exc}"
                        _observe.note_shard_restore(shard._name, 0, 0, False)
                        _observe.note_shard_demoted(shard._name, fleet._demoted[k])
                    else:
                        raise
                else:
                    if entry.get("demoted"):
                        fleet._demoted[k] = str(entry["demoted"])
            fleet._next_auto = int(manifest.get("next_auto", 0))
            fleet._generation = int(manifest.get("generation", 0))
            fleet._ckpt_dir = path
            target_n = old_n if n_shards is None else int(n_shards)
            if target_n != old_n:
                fleet = cls._rehash(
                    fleet, target_n, wal_dir if wal_dir is not None else path,
                    initial_capacity, nan_guard, devices,
                )
                # the old manifest describes a topology that no longer exists
                # (and _rehash replaced the journal files it referenced): write
                # a fresh generation immediately so the manifest on disk always
                # matches the live fleet and shard self-healing stays armed
                fleet.checkpoint(path)
        _observe.record_event(
            "fleet_sharded_restore", name=fleet._name, shards=fleet.n_shards,
            sessions=len(fleet), demoted=len(fleet._demoted),
        )
        return fleet

    @classmethod
    def _rehash(
        cls,
        old: "ShardedStreamEngine",
        new_n: int,
        wal_dir: Optional[str],
        initial_capacity: int,
        nan_guard: bool,
        devices: Optional[List[Any]],
    ) -> "ShardedStreamEngine":
        """Elastic resize: every session re-enters a fresh ``new_n``-shard fleet
        through the normal arrival path, pending submissions preserved in
        per-session order. The old journals are consumed (deleted) — the new
        fleet's journals are self-sufficient from the first re-add."""
        # collect pending submissions per session BEFORE expiring, then clear
        # the queues so expire materializes state without flushing them
        pending: Dict[Hashable, List[Tuple[int, Tuple[Any, ...], Dict[str, Any]]]] = {}
        health: Dict[Hashable, str] = {}
        order: List[Tuple[Hashable, Metric]] = []
        # remote-producer watermarks (serve/): the fold below is a
        # clean topology change — every processed record is fully applied
        # before it starts — so the fleet-wide max per producer is exact here
        # (unlike crash recovery, where shards may hold different durable
        # prefixes) and every new shard can be seeded with it
        serve_marks: Dict[str, int] = {}
        for shard in old._shards:
            for p, v in shard._serve_marks.items():
                serve_marks[p] = max(serve_marks.get(p, 0), v)
        for shard in old._shards:
            for bucket in shard._buckets.values():
                for slot, seq, args, kwargs in bucket.queue:
                    pending.setdefault(bucket.slot_sids[slot], []).append((seq, args, kwargs))
                bucket.queue = []
            for sess in shard._sessions.values():
                for seq, args, kwargs in sess.queue:
                    pending.setdefault(sess.sid, []).append((seq, args, kwargs))
                sess.queue = []
                health[sess.sid] = sess.health
            if shard._wal is not None:
                shard._wal.close()
                shard._wal = None  # expiries below must not journal to doomed files
            for sid in list(shard._sessions):
                order.append((sid, shard.expire(sid)))
        for k in range(old.n_shards):
            p = old._shard_wal_path(k)
            if p is None and wal_dir is not None:
                p = os.path.join(wal_dir, f"shard-{k:03d}.wal")
            if p is not None and os.path.exists(p):
                os.remove(p)
        fleet = cls(
            n_shards=new_n,
            initial_capacity=initial_capacity,
            wal_dir=wal_dir,
            nan_guard=nan_guard,
            name=old._name,
            devices=devices,
        )
        fleet._next_auto = old._next_auto
        fleet._generation = old._generation
        # the last manifest describes the OLD topology: self-healing needs a
        # fresh checkpoint of the resized fleet before it can trust the dir
        fleet._ckpt_dir = None
        for shard in fleet._shards:
            for p, v in serve_marks.items():
                shard.serve_mark(p, v)
        for sid, metric in order:
            fleet.add_session(metric, sid)
            if health.get(sid, "healthy") != "healthy":
                k = fleet.shard_of(sid)
                sess = fleet._shards[k]._sessions[sid]
                if sess.bucket is not None:
                    fleet._shards[k]._demote_session(sess)
                sess.health = health[sid]
        for sid, subs in pending.items():
            for _seq, args, kwargs in sorted(subs, key=lambda t: t[0]):
                fleet.submit(sid, *args, **kwargs)
        return fleet

    # ------------------------------------------------------------------ telemetry
    def shard_stats(self) -> List[Dict[str, Any]]:
        """Per-shard occupancy / WAL lag / health, the ladder's shard rung view."""
        out: List[Dict[str, Any]] = []
        for k, shard in enumerate(self._shards):
            lag_records, lag_bytes = shard._wal_lag()
            active = sum(b.active() for b in shard._buckets.values())
            capacity = sum(b.capacity for b in shard._buckets.values())
            out.append(
                {
                    "shard": k,
                    "name": shard._name,
                    "sessions": len(shard._sessions),
                    "loose_sessions": sum(1 for s in shard._sessions.values() if s.bucket is None),
                    "rows_active": active,
                    "rows_capacity": capacity,
                    "occupancy_pct": 100.0 * active / capacity if capacity else None,
                    "wal_lag_records": lag_records,
                    "wal_lag_bytes": lag_bytes,
                    "wal_torn_tail": shard._wal_torn,
                    "health": "demoted" if k in self._demoted else "healthy",
                    "demoted_reason": self._demoted.get(k),
                }
            )
        return out

    def stats(self) -> Dict[str, Any]:
        """Fleet totals plus the per-shard breakdown (also pushed as ``shard_*``
        observe gauges when telemetry is enabled)."""
        shards = self.shard_stats()
        active = sum(s["rows_active"] for s in shards)
        capacity = sum(s["rows_capacity"] for s in shards)
        self._publish_shard_gauges()
        return {
            "name": self._name,
            "n_shards": self.n_shards,
            "generation": self._generation,
            "ticks": self._ticks,
            "sessions": len(self),
            "rows_active": active,
            "rows_capacity": capacity,
            "occupancy_pct": 100.0 * active / capacity if capacity else None,
            "wal_lag_records": sum(s["wal_lag_records"] for s in shards),
            "wal_lag_bytes": sum(s["wal_lag_bytes"] for s in shards),
            "demoted_shards": sorted(self._demoted),
            "shards": shards,
        }

    def _publish_shard_gauges(self) -> None:
        if not _observe.ENABLED:
            return
        for k, shard in enumerate(self._shards):
            lag_records, lag_bytes = shard._wal_lag()
            active = sum(b.active() for b in shard._buckets.values())
            capacity = sum(b.capacity for b in shard._buckets.values())
            _observe.set_shard_gauges(
                shard._name,
                len(shard._sessions),
                active,
                capacity,
                lag_records,
                lag_bytes,
                k not in self._demoted,
            )
