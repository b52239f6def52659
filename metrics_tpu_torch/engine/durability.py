"""Fleet durability: incremental StreamEngine checkpoints + the ingest WAL (counterpart of
``metrics_tpu/engine/durability.py``).

Two complementary persistence layers make a fleet crash-recoverable bit-exact:

**Fleet checkpoints** extend the MTCKPT container (``resilience/checkpoint.py``) with a ``root_kind ==
"fleet"`` payload: the engine's sequencing watermarks plus per-bucket snapshots (template metric, stacked
states as numpy arrays, slot map, free-list) and the session registry (sid to class, config fingerprint,
row, health; loose sessions carry their full packed metric). Writes are *incremental*: each bucket's node is
pickled to bytes and cached on the engine keyed by ``(bucket key) -> (version, bytes)``, so a bucket whose
state version has not moved since the last checkpoint is re-emitted as cached bytes, with no device read.

**The ingest WAL** is a redo journal: every ``add_session`` / ``submit`` / ``expire`` / ``reset`` appends one
CRC-framed record *before* the engine applies its effect, and the buffer is fsynced at each flush boundary,
so submitted-but-unticked waves survive a crash. The file starts with ``MTWAL001``; frames are
``u32 len | u32 crc32`` (big-endian) + a pickled ``(kind, seq, sid, payload)`` tuple, the JAX package's
framing. A crash can only tear a *suffix*, and replay stops cleanly at the first torn or bit-flipped frame.

Payloads hold numpy arrays, never tensors: a submission's tensors are read to the host once when journaled,
and a metric (the ``add`` record, a bucket template, a loose session) is pickled with each tensor as a numpy
array and each ``torch.device`` as its name (:func:`pack_metric`). :func:`unpack_metric` rebuilds it on its
own device, or on the ``device`` the caller names: a journal or checkpoint written on the card replays and
restores on the CPU, as a metric checkpoint does.

**Recovery** (:func:`restore_fleet_checkpoint`, surfaced as ``StreamEngine.restore``) validates the whole
checkpoint tree (container CRCs, template classes and config fingerprints, stacked avals with exact dtypes,
slot-map/free-list consistency, session references) before installing anything, then replays journal
records in sequence order with their ORIGINAL sequence numbers. Replayed submissions re-enter the normal
ingest queues, so the next tick groups them into the same waves a never-crashed engine would have
dispatched: recovered states are bit-exact versus the no-crash run.
"""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import struct
import zlib
from typing import Any, Callable, Dict, Hashable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.observe import tracing as _trace
from metrics_tpu_torch.resilience.checkpoint import (
    CheckpointError,
    CorruptCheckpointError,
    IncompatibleCheckpointError,
    _as_tensor,
    _dtype_matches,
    _host,
    _parse,
    _write_container,
)
from metrics_tpu_torch.utils.compute import acc_dtype
from metrics_tpu_torch.utils.io import atomic_write_chunks, fsync_directory

__all__ = ["IngestWAL", "replay_wal", "restore_fleet_checkpoint", "save_fleet_checkpoint"]

WAL_MAGIC = b"MTWAL001"
_FRAME = struct.Struct(">II")  # record_len, record_crc32
_PICKLE = pickle.HIGHEST_PROTOCOL

DeviceLike = Optional[Union[str, torch.device]]


# ------------------------------------------------------------------ metrics as host payloads
# the device a packed metric is rebuilt on while unpack_metric runs (None: its own)
_LOAD_DEVICE: List[Optional[torch.device]] = [None]


def _device_from_name(name: str) -> torch.device:
    target = _LOAD_DEVICE[0]
    return target if target is not None else torch.device(name)


def _tensor_from_host(arr: np.ndarray, device: str) -> torch.Tensor:
    """A packed tensor rebuilt: a host tensor stays on the host (a metric moves its states itself), one
    from a device goes back to that device, or to the device unpack_metric names."""
    tensor = _as_tensor(arr)
    return tensor if device == "cpu" else tensor.to(_device_from_name(device))


class _HostPickler(pickle.Pickler):
    """Pickles every tensor as a numpy array (with its device's name) and every ``torch.device`` as its
    name."""

    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor):
            return _tensor_from_host, (_host(obj), str(obj.device))
        if isinstance(obj, torch.device):
            return _device_from_name, (str(obj),)
        return NotImplemented


def pack_metric(metric: Metric) -> bytes:
    """A metric as pickle bytes holding numpy arrays, never tensors (its states read to the host once)."""
    buf = io.BytesIO()
    _HostPickler(buf, protocol=_PICKLE).dump(metric)
    return buf.getvalue()


@contextlib.contextmanager
def _load_device(device: DeviceLike) -> Iterator[None]:
    prev = _LOAD_DEVICE[0]
    _LOAD_DEVICE[0] = None if device is None else torch.device(device)
    try:
        yield
    finally:
        _LOAD_DEVICE[0] = prev


def _settle(obj: Any, device: DeviceLike) -> Any:
    """A metric rebuilt for ``device``: the configuration's tensors too (a host tensor stays on the host while
    unpickling, so a curve's thresholds packed on the CPU would), as a metric built there holds them."""
    if device is not None and isinstance(obj, Metric):
        obj.to_device(device)
    return obj


def unpack_metric(blob: bytes, device: DeviceLike = None) -> Any:
    """Rebuild a :func:`pack_metric` payload: on the device it was packed on, or on ``device``."""
    with _load_device(device):
        return _settle(pickle.loads(blob), device)


def _on_device(v: Any, device: DeviceLike) -> Any:
    """A journaled submission value as the engine takes it: a numpy array becomes a tensor on ``device``
    (the CPU when None)."""
    if isinstance(v, np.ndarray):
        return _as_tensor(v).to("cpu" if device is None else device)
    return v


# ------------------------------------------------------------------ ingest WAL
class IngestWAL:
    """Append-only, CRC-framed redo journal for StreamEngine ingest records.

    ``append`` is buffered (one tick's records cost one syscall burst at the next ``sync``); ``sync`` is
    the durability point and is called by the engine before any buffered record's effect lands. ``truncate``
    atomically rewrites the journal keeping only frames whose seq satisfies a predicate. ``read_records`` is
    the recovery-side reader: every intact record up to the first torn or corrupt frame, plus a flag saying
    whether it stopped early.
    """

    def __init__(self, path: Union[str, os.PathLike]) -> None:
        self.path = os.fspath(path)
        fresh = not os.path.exists(self.path) or os.path.getsize(self.path) == 0
        # byte ledger kept explicitly: tell() on a buffered append handle lies about unsynced writes
        self._nbytes = 0 if fresh else os.path.getsize(self.path)
        self._fh = open(self.path, "ab")
        if fresh:
            self._fh.write(WAL_MAGIC)
            self._nbytes = len(WAL_MAGIC)
            self.sync()
            fsync_directory(os.path.dirname(os.path.abspath(self.path)))

    def append(self, kind: str, seq: int, sid: Any, payload: Any = None) -> int:
        """Buffer one record; durable only after the next :meth:`sync`. Returns the framed size in bytes."""
        if isinstance(payload, Metric):
            # host arrays, so that the journal replays on any device; tagged so replay knows to unpack
            payload = ("__metric__", pack_metric(payload))
        rec = pickle.dumps((kind, seq, sid, payload), protocol=_PICKLE)
        self._fh.write(_FRAME.pack(len(rec), zlib.crc32(rec) & 0xFFFFFFFF))
        self._fh.write(rec)
        nframe = _FRAME.size + len(rec)
        self._nbytes += nframe
        return nframe

    def size_bytes(self) -> int:
        """Journal record bytes (magic header excluded), counting buffered not-yet-synced appends."""
        return max(0, self._nbytes - len(WAL_MAGIC))

    def sync(self) -> None:
        """Flush buffered frames and fsync: everything appended so far is durable."""
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def truncate(self, keep: Callable[[int], bool]) -> int:
        """Atomically rewrite the journal with only the frames whose seq passes ``keep``; returns how many
        records were kept. Torn trailing frames (if any) are dropped: they were never durable records."""
        with _trace.span("wal", "truncate"):
            self.sync()
            records, _torn = self.read_records(self.path)
            kept = [r for r in records if keep(r[1])]
            chunks: List[bytes] = [WAL_MAGIC]
            for rec_tuple in kept:
                rec = pickle.dumps(rec_tuple, protocol=_PICKLE)
                chunks.append(_FRAME.pack(len(rec), zlib.crc32(rec) & 0xFFFFFFFF))
                chunks.append(rec)
            self._fh.close()
            try:
                atomic_write_chunks(self.path, chunks)
            finally:
                self._fh = open(self.path, "ab")
            self._nbytes = sum(len(c) for c in chunks)
            return len(kept)

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self.sync()
            self._fh.close()

    @staticmethod
    def read_records(path: Union[str, os.PathLike]) -> Tuple[List[Tuple[Any, ...]], bool]:
        """Read every intact record; ``(records, torn)`` where ``torn`` means the scan stopped at a damaged
        frame. A missing, empty or magic-torn file is an empty journal."""
        records, torn = IngestWAL.read_records_detailed(path)
        return records, torn is not None

    @staticmethod
    def read_records_detailed(
        path: Union[str, os.PathLike],
    ) -> Tuple[List[Tuple[Any, ...]], Optional[Dict[str, int]]]:
        """:meth:`read_records` with the torn flag expanded into *where*: ``None`` for a clean scan or
        ``{"frame_index": i, "byte_offset": off}`` locating the first damaged frame."""
        path = os.fspath(path)
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            return [], None
        with open(path, "rb") as fh:
            blob = fh.read()
        if len(blob) < len(WAL_MAGIC) or blob[: len(WAL_MAGIC)] != WAL_MAGIC:
            return [], {"frame_index": 0, "byte_offset": 0}
        records: List[Tuple[Any, ...]] = []
        off = len(WAL_MAGIC)
        while off < len(blob):
            torn_here = {"frame_index": len(records), "byte_offset": off}
            if off + _FRAME.size > len(blob):
                return records, torn_here
            length, crc = _FRAME.unpack_from(blob, off)
            body = blob[off + _FRAME.size : off + _FRAME.size + length]
            if len(body) < length or zlib.crc32(body) & 0xFFFFFFFF != crc:
                return records, torn_here
            try:
                rec = pickle.loads(body)
            except Exception:  # noqa: BLE001 — CRC passed but the record is garbage
                return records, torn_here
            if not (isinstance(rec, tuple) and len(rec) == 4):
                return records, torn_here
            records.append(rec)
            off += _FRAME.size + length
        return records, None


# ------------------------------------------------------------------ save
def _bucket_node(bucket: Any) -> Dict[str, Any]:
    return {
        "label": bucket.label,
        "class": type(bucket.template).__name__,
        "fingerprint": bucket.template.config_fingerprint(),
        "template": pack_metric(bucket.template),
        "capacity": int(bucket.capacity),
        "high_water": int(bucket.high_water),
        "version": int(bucket.version),
        "faults": int(bucket.faults),
        "compute_eager": bool(bucket.compute_eager),
        "slot_sids": list(bucket.slot_sids),
        "free": [int(s) for s in bucket.free],
        "stacked": {k: _host(v) for k, v in bucket.stacked.items()},
    }


def save_fleet_checkpoint(engine: Any, path: Union[str, os.PathLike], truncate_wal: bool = True) -> str:
    """Write an incremental fleet snapshot; optionally truncate the ingest WAL.

    Only *dirty* buckets (state version moved since their last snapshot) pay a device read and a pickle;
    clean buckets re-emit their cached bytes. Pending (unapplied) ingest queue entries are deliberately NOT
    part of the snapshot: they live in the WAL, which after truncation holds exactly the records the
    snapshot does not cover. ``truncate_wal=False`` preserves the full journal.
    """
    with _trace.span("ckpt", "save"):
        return _save_fleet_checkpoint(engine, path, truncate_wal)


def _save_fleet_checkpoint(engine: Any, path: Union[str, os.PathLike], truncate_wal: bool) -> str:
    path = os.fspath(path)
    if engine._wal is not None:
        engine._wal.sync()  # the snapshot must never be ahead of the journal
    bucket_blobs: List[bytes] = []
    bucket_pos: Dict[Any, int] = {}
    mt = _observe._METER if _observe.ENABLED else None
    for key, bucket in engine._buckets.items():
        cached = engine._ckpt_cache.get(key)
        if cached is not None and cached[0] == bucket.version:
            blob = cached[1]
        else:
            blob = pickle.dumps(_bucket_node(bucket), protocol=_PICKLE)
            engine._ckpt_cache[key] = (bucket.version, blob)
        bucket_pos[key] = len(bucket_blobs)
        bucket_blobs.append(blob)
        if mt is not None:
            mt.note_ckpt_bytes([str(s) for s in bucket.slot_sids if s is not None], len(blob))
    for key in [k for k in engine._ckpt_cache if k not in engine._buckets]:
        del engine._ckpt_cache[key]  # dropped buckets must not pin their bytes
    sessions: Dict[Hashable, Dict[str, Any]] = {}
    for sid, sess in engine._sessions.items():
        node: Dict[str, Any] = {
            "class": type(sess.metric).__name__,
            "fingerprint": sess.metric.config_fingerprint(),
            "slot": int(sess.slot),
            "base_count": int(sess.base_count),
            "engine_count": int(sess.engine_count),
            "health": sess.health,
        }
        if sess.bucket is not None:
            node["mode"] = "bucketed"
            node["bucket"] = bucket_pos[sess.bucket.key]
        else:
            node["mode"] = "loose"
            node["metric"] = pack_metric(sess.metric)
            if mt is not None:
                mt.note_ckpt_bytes([str(sid)], len(node["metric"]))
        sessions[sid] = node
    outer = {
        "kind": "fleet",
        "class": "StreamEngine",
        "acc_dtype": str(acc_dtype()),
        "ticks": int(engine._ticks),
        "seq": int(engine._seq),
        "applied_seq": int(engine._applied_seq),
        "applied_above": sorted(engine._applied_above),
        "initial_capacity": int(engine._initial_capacity),
        "next_auto": int(engine._next_auto),
        "nan_guard": bool(engine._nan_guard),
        "serve_marks": {str(p): int(v) for p, v in engine._serve_marks.items()},
        "buckets": bucket_blobs,
        "sessions": sessions,
    }
    payload = pickle.dumps(outer, protocol=_PICKLE)
    nbytes = _write_container(path, "fleet", "StreamEngine", [payload])
    _observe.note_checkpoint_save("StreamEngine", path, nbytes)
    if truncate_wal and engine._wal is not None:
        kept = engine._wal.truncate(lambda seq: not engine._is_applied(seq))
        _observe.note_wal_truncate(getattr(engine, "_name", "engine"), kept)
    # durability-lag watermark: the snapshot covers exactly the applied records
    engine._ckpt_applied_seq = engine._applied_seq + len(engine._applied_above)
    engine._last_ckpt_time = _observe.clock()
    return path


# ------------------------------------------------------------------ restore
def _unpickle(blob: bytes, what: str, path: str) -> Any:
    try:
        return pickle.loads(blob)
    except Exception as exc:  # noqa: BLE001 — damage shows up as a pickle zoo
        raise CorruptCheckpointError(f"{path}: {what} does not unpickle ({type(exc).__name__}: {exc})") from exc


def _unpack(blob: bytes, what: str, path: str, device: DeviceLike) -> Any:
    with _load_device(device):
        return _settle(_unpickle(blob, what, path), device)


def _validate_bucket(bnode: Any, i: int, path: str, device: DeviceLike) -> Metric:
    where = f"{path}: fleet bucket[{i}]"
    if not isinstance(bnode, dict) or "template" not in bnode or "stacked" not in bnode:
        raise CorruptCheckpointError(f"{where} is not a bucket node")
    template = _unpack(bnode["template"], f"fleet bucket[{i}] template", path, device)
    if not isinstance(template, Metric) or type(template).__name__ != bnode.get("class"):
        raise IncompatibleCheckpointError(
            f"{where}: template is {type(template).__name__}, node declares {bnode.get('class')!r}"
        )
    fp = template.config_fingerprint()
    if bnode.get("fingerprint") is not None and fp is not None and fp != bnode["fingerprint"]:
        raise IncompatibleCheckpointError(
            f"{where}: template config fingerprint drifted: the checkpointed bucket was "
            "built from a different configuration of " + bnode["class"]
        )
    capacity = bnode["capacity"]
    avals = template.state_avals()
    stacked = bnode["stacked"]
    if set(stacked) != {name for name, _s, _d in avals}:
        raise IncompatibleCheckpointError(
            f"{where}: stacked states {sorted(stacked)} do not match the template's "
            f"registered states {sorted(name for name, _s, _d in avals)}"
        )
    for name, shape, dtype in avals:
        arr = stacked[name]
        if shape == "list":
            raise IncompatibleCheckpointError(f"{where}: list state {name!r} cannot be bucketed")
        if tuple(arr.shape) != (capacity,) + tuple(shape):
            raise IncompatibleCheckpointError(
                f"{where}: state {name!r} has stacked shape {tuple(arr.shape)}, "
                f"expected {(capacity,) + tuple(shape)}"
            )
        if not _dtype_matches(str(arr.dtype), dtype):
            raise IncompatibleCheckpointError(
                f"{where}: state {name!r} was checkpointed as dtype {arr.dtype} but this "
                f"process expects {dtype}: precision regime mismatch (was the default float type switched "
                "between the writing and the restoring process?). Refusing to silently cast restored "
                "accumulator state."
            )
    slot_sids = bnode["slot_sids"]
    free = bnode["free"]
    occupied = [s for s, sid in enumerate(slot_sids) if sid is not None]
    if (
        len(slot_sids) != capacity
        or len(set(free)) != len(free)
        or set(free) & set(occupied)
        or set(free) | set(occupied) != set(range(capacity))
    ):
        raise CorruptCheckpointError(f"{where}: slot map and free-list are inconsistent")
    return template


def restore_fleet_checkpoint(
    engine: Any,
    path: Union[str, os.PathLike],
    wal_path: Optional[Union[str, os.PathLike]] = None,
    device: DeviceLike = None,
) -> Any:
    """Rebuild ``engine`` in place from a fleet checkpoint, then replay the WAL.

    The whole tree is validated before anything is installed (a corrupt or incompatible file leaves the
    engine untouched). Journal records at or below the snapshot's applied watermark are skipped; the rest
    are re-applied in sequence order with their original seqs. ``device`` rebuilds every metric and stacked
    state there (by default each keeps the device it was saved on). Returns ``engine``.
    """
    with _trace.span("ckpt", "restore"):
        return _restore_fleet_checkpoint(engine, path, wal_path, device)


def _restore_fleet_checkpoint(
    engine: Any, path: Union[str, os.PathLike], wal_path: Optional[Union[str, os.PathLike]], device: DeviceLike
) -> Any:
    from metrics_tpu_torch.engine.stream import _Bucket, _Session

    path = os.fspath(path)
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except OSError as exc:
        raise CheckpointError(f"{path}: cannot read checkpoint ({exc})") from exc
    node = _parse(blob, path)
    if node.get("kind") != "fleet" or node.get("class") != "StreamEngine":
        raise IncompatibleCheckpointError(
            f"{path}: restore target is a StreamEngine but the checkpoint holds "
            f"kind={node.get('kind')!r} class={node.get('class')!r}"
        )
    stored = node.get("acc_dtype")
    if stored is not None and stored != str(acc_dtype()):
        raise IncompatibleCheckpointError(
            f"{path}: checkpoint was written with accumulators in {stored} but this process accumulates in "
            f"{acc_dtype()}: precision regime mismatch. Refusing to silently cast restored accumulator state."
        )
    # ---- validate the whole tree before touching the engine ----
    bucket_blobs: List[bytes] = list(node.get("buckets", []))
    validated: List[Tuple[Dict[str, Any], Metric]] = []
    for i, bblob in enumerate(bucket_blobs):
        bnode = _unpickle(bblob, f"fleet bucket[{i}]", path)
        validated.append((bnode, _validate_bucket(bnode, i, path, device)))
    sessions_node: Dict[Hashable, Dict[str, Any]] = node.get("sessions", {})
    loose_metrics: Dict[Hashable, Metric] = {}
    for sid, snode in sessions_node.items():
        where = f"{path}: fleet session {sid!r}"
        if snode.get("mode") == "bucketed":
            bi = snode.get("bucket")
            if not isinstance(bi, int) or not 0 <= bi < len(validated):
                raise CorruptCheckpointError(f"{where} references unknown bucket {bi!r}")
            bnode = validated[bi][0]
            slot = snode.get("slot")
            if not isinstance(slot, int) or not 0 <= slot < bnode["capacity"] or bnode["slot_sids"][slot] != sid:
                raise CorruptCheckpointError(f"{where} does not own its claimed slot {slot!r}")
        elif snode.get("mode") == "loose":
            m = _unpack(snode["metric"], f"fleet session {sid!r} metric", path, device)
            if not isinstance(m, Metric) or type(m).__name__ != snode.get("class"):
                raise IncompatibleCheckpointError(
                    f"{where}: metric is {type(m).__name__}, node declares {snode.get('class')!r}"
                )
            loose_metrics[sid] = m
        else:
            raise CorruptCheckpointError(f"{where} has unknown mode {snode.get('mode')!r}")
    for i, (bnode, _t) in enumerate(validated):
        for slot, sid in enumerate(bnode["slot_sids"]):
            if sid is None:
                continue
            snode = sessions_node.get(sid)
            if snode is None or snode.get("mode") != "bucketed" or snode.get("bucket") != i or snode.get("slot") != slot:
                raise CorruptCheckpointError(
                    f"{path}: fleet bucket[{i}] slot {slot} claims session {sid!r} "
                    "but the session registry disagrees"
                )
    # ---- install ----
    engine._buckets.clear()
    engine._sessions.clear()
    engine._ckpt_cache.clear()
    engine._ticks = int(node.get("ticks", 0))
    engine._seq = int(node.get("seq", 0))
    engine._applied_seq = int(node.get("applied_seq", 0))
    engine._applied_above = set(node.get("applied_above", ()))
    engine._initial_capacity = int(node.get("initial_capacity", engine._initial_capacity))
    engine._next_auto = int(node.get("next_auto", 0))
    engine._nan_guard = engine._nan_guard or bool(node.get("nan_guard", False))
    engine._serve_marks = {str(p): int(v) for p, v in node.get("serve_marks", {}).items()}
    buckets: List[Any] = []
    for (bnode, template), bblob in zip(validated, bucket_blobs):
        key = engine._bucket_key(template)
        if key is None:
            raise IncompatibleCheckpointError(
                f"{path}: bucket template {bnode['class']} is no longer bucket-eligible in this process"
            )
        bucket = _Bucket(template, bnode["label"], key, bnode["capacity"])
        bucket.stacked = {k: _as_tensor(v).to(template.device) for k, v in bnode["stacked"].items()}
        bucket.slot_sids = list(bnode["slot_sids"])
        bucket.slot_skeys = [None if s is None else str(s) for s in bucket.slot_sids]
        bucket.free = list(bnode["free"])
        bucket.high_water = int(bnode["high_water"])
        bucket.version = int(bnode["version"])
        bucket.faults = int(bnode["faults"])
        bucket.compute_eager = bool(bnode["compute_eager"])
        engine._buckets[key] = bucket
        engine._ckpt_cache[key] = (bucket.version, bblob)  # clean until state moves again
        buckets.append(bucket)
    for sid, snode in sessions_node.items():
        if snode["mode"] == "bucketed":
            bucket = buckets[snode["bucket"]]
            # the adopted original died with the crashed process; expire() materializes the recovered row
            # into this fresh clone
            sess = _Session(sid, bucket.template.clone(), bucket, snode["slot"])
        else:
            sess = _Session(sid, loose_metrics[sid], None, -1)
        sess.base_count = int(snode["base_count"])
        sess.engine_count = int(snode["engine_count"])
        sess.health = snode["health"]
        engine._sessions[sid] = sess
        engine._skey_index[str(sid)] = sid
    # ---- replay the journal, original seqs ----
    n_replayed = replay_wal(engine, wal_path, device=device) if wal_path is not None else 0
    if wal_path is not None:
        engine._wal = IngestWAL(wal_path)
        engine._wal_path = os.fspath(wal_path)
        # repair: drop applied records and any torn tail the crash left behind
        engine._wal.truncate(lambda seq: not engine._is_applied(seq))
    engine._ckpt_applied_seq = engine._applied_seq + len(engine._applied_above)
    engine._last_ckpt_time = _observe.clock()
    _observe.note_checkpoint_restore("StreamEngine", path)
    _observe.note_fleet_restore(getattr(engine, "_name", "engine"), len(engine._sessions), n_replayed)
    return engine


def _session_device(sess: Any) -> torch.device:
    return sess.bucket.template.device if sess.bucket is not None else sess.metric.device


def replay_wal(engine: Any, wal_path: Union[str, os.PathLike], device: DeviceLike = None) -> int:
    """Replay every surviving, not-yet-applied journal record into ``engine``.

    Records keep their ORIGINAL sequence numbers; replayed submissions land in the normal ingest queues for
    the next tick, their arrays as tensors on the session's device. A torn tail stops the scan at the last
    intact frame; its location is recorded on ``engine._wal_torn`` and emitted as a ``wal_torn_tail``
    observe event. ``device`` rebuilds the journaled metrics there. Returns the number of records replayed.
    """
    name = getattr(engine, "_name", "engine")
    wal_path = os.fspath(wal_path)
    n_replayed = 0
    if not os.path.exists(wal_path):
        return 0
    with _trace.span("wal", "replay"):
        records, torn = IngestWAL.read_records_detailed(wal_path)
        if torn is not None:
            engine._wal_torn = (torn["frame_index"], torn["byte_offset"])
            _observe.note_wal_torn_tail(name, torn["frame_index"], torn["byte_offset"])
        engine._replaying = True
        try:
            for kind, seq, sid, payload in records:
                engine._seq = max(engine._seq, seq)
                if engine._is_applied(seq):
                    continue
                if kind == "submit":
                    sess = engine._sessions.get(sid)
                    if sess is None:
                        raise CorruptCheckpointError(
                            f"{wal_path}: journal submit seq={seq} targets unknown "
                            f"session {sid!r} (journal/checkpoint mismatch)"
                        )
                    args, kwargs = payload
                    dev = _session_device(sess)
                    engine._route(sess, seq, tuple(_on_device(a, dev) for a in args),
                                  {k: _on_device(v, dev) for k, v in kwargs.items()})
                elif kind == "add":
                    if isinstance(payload, tuple) and len(payload) == 2 and payload[0] == "__metric__":
                        payload = _unpack(payload[1], f"journal add seq={seq} metric", wal_path, device)
                    engine._apply_add(sid, payload)
                    if isinstance(sid, int) and sid >= engine._next_auto:
                        engine._next_auto = sid + 1  # auto-assigned ids must not recycle
                    engine._mark_applied(seq)
                elif kind == "expire":
                    engine._apply_expire(sid)
                    engine._mark_applied(seq)
                elif kind == "reset":
                    engine._apply_reset(sid)
                    engine._mark_applied(seq)
                elif kind == "serve_mark":
                    # remote producer watermark: sid is the producer name, payload its highest applied pseq
                    marks = engine._serve_marks
                    marks[sid] = max(marks.get(sid, 0), int(payload))
                    engine._mark_applied(seq)
                else:
                    raise CorruptCheckpointError(f"{wal_path}: journal record seq={seq} has unknown kind {kind!r}")
                n_replayed += 1
        finally:
            engine._replaying = False
    _observe.note_wal_replay(name, n_replayed)
    return n_replayed
