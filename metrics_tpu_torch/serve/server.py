"""Host-side ingest server: sockets in, per-bucket waves out (counterpart of ``metrics_tpu/serve/server.py``).

``MetricsServer`` is a single-threaded ``selectors`` reactor (stdlib only)
in front of a ``StreamEngine`` or ``ShardedStreamEngine``:

* **authenticates** each connection's ``hello`` session key (constant-time
  compare) before any data record is honored;
* **routes** every record to its target shard by the same stable crc32 hash
  the sharded engine uses, and applies it through the normal public API —
  so remote submissions coalesce into exactly the per-bucket waves a local
  caller's would;
* **journals before acking**: each applied record write-ahead journals into
  the target shard's WAL via the engine, the producer's ``pseq`` rides along
  as a ``serve_mark`` record, and every touched journal is fsynced once per
  poll batch before the batch's acks go out — an acked record is durable;
* **dedups** resends against the target shard's per-producer watermark
  (``status="dup"``), turning the protocol's at-least-once delivery into
  exactly-once application — and keeps that watermark sound by resolving a
  producer's records strictly in ``pseq`` order: while a record sits
  deferred, every later ``pseq`` is answered ``defer`` (rule ``ordering``)
  instead of applied, so the watermark never advances over an unresolved
  gap and a deferred record's retry can never be mistaken for a duplicate;
* **admits** through the explicit verdict table (``serve/admission.py``),
  refreshing one signal snapshot per poll pass;
* optionally drives an :class:`AutonomicController` every poll, so the
  observe→act reflexes run even when the ingest loop is the only pump.

An arriving metric is loaded only after authentication, and only if every
class its blob names is this package's: a blob that names a class of the JAX
package (``metrics_tpu.*``) or of ``jax`` is refused before anything of it is
imported, and its record gets an ``err`` ack. The metric is rebuilt on the
target shard's device (a plain engine's: the server's ``device``, the card
unless the caller names another), not on the producer's. Submissions arrive
as numpy arrays and stay host rows until the engine's wave assembly copies
each column to the device once.

Drive it explicitly (``poll()`` + your own ``engine.tick()`` cadence, as the
tests and the chip smoke do) or hand it a background thread with
``serve_in_thread()``.
"""

from __future__ import annotations

import hmac
import io
import pickle
import selectors
import socket
import threading
from typing import Any, Dict, Hashable, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.engine.durability import _load_device, _settle
from metrics_tpu_torch.metric import Metric, resolve_device
from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.observe.metering import installed_meter
from metrics_tpu_torch.serve.admission import AdmissionController
from metrics_tpu_torch.serve.autonomic import AutonomicController
from metrics_tpu_torch.serve.protocol import (
    DATA_KINDS,
    DEFAULT_MAX_FRAME_BYTES,
    DEFAULT_WINDOW,
    PROTO_VERSION,
    FrameDecoder,
    ProtocolError,
    WAL_MAGIC,
    encode_frame,
)

__all__ = ["MetricsServer"]

_FOREIGN_ROOTS = ("metrics_tpu", "jax", "jaxlib", "flax")


class _PortMetricUnpickler(pickle.Unpickler):
    """Full pickle for an authenticated peer's metric blob, but only over this package's classes: a global
    from the JAX package or from ``jax`` is refused before it is imported."""

    def find_class(self, module: str, name: str) -> Any:
        if module.split(".")[0] in _FOREIGN_ROOTS:
            raise ProtocolError(
                f"add payload names {module}.{name}: a metric of another package, not of metrics_tpu_torch"
            )
        return super().find_class(module, name)


class _Conn:
    __slots__ = ("sock", "peer", "decoder", "out", "producer", "pending", "closing", "bytes_unmetered")

    def __init__(self, sock: socket.socket, peer: Any, max_frame_bytes: int) -> None:
        self.sock = sock
        self.peer = peer
        self.decoder = FrameDecoder(max_frame_bytes=max_frame_bytes)
        self.out = bytearray(WAL_MAGIC)  # the server's stream is journal-framed too
        self.producer: Optional[str] = None  # set by an authenticated hello
        self.pending: List[Tuple[Any, ...]] = []  # decoded, not yet processed
        self.closing = False
        self.bytes_unmetered = 0  # received but not yet charged to the meter


class MetricsServer:
    """WAL-native network ingest in front of a (sharded) stream engine."""

    def __init__(
        self,
        engine: Any,
        session_key: str,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        admission: Optional[AdmissionController] = None,
        autonomic: Optional[AutonomicController] = None,
        window: int = DEFAULT_WINDOW,
        max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
        read_budget_bytes: int = 1 << 20,
        backlog: int = 16,
        name: str = "serve",
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.engine = engine
        # where a plain engine's arrivals are rebuilt (a sharded engine's go to their shard's device)
        self.device = None if getattr(engine, "_shards", None) is not None else resolve_device(device)
        # the key is compared as bytes: hmac.compare_digest rejects non-ASCII
        # str input with a TypeError, which a hostile hello could trigger
        self._key_bytes = str(session_key).encode("utf-8", "replace")
        self.window = int(window)
        self.max_frame_bytes = int(max_frame_bytes)
        # fairness + memory guards per connection (one fast or non-conforming
        # producer must not monopolize a poll pass or grow pending unboundedly)
        self.read_budget_bytes = int(read_budget_bytes)
        self.pending_cap = max(2 * self.window, 8)
        self._name = str(name)
        self.admission = admission if admission is not None else AdmissionController()
        self.autonomic = autonomic
        self._sel = selectors.DefaultSelector()
        self._lsock: Optional[socket.socket] = None
        self.address: Optional[Tuple[str, int]] = None
        if host is not None:
            lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lsock.bind((host, int(port)))
            lsock.listen(int(backlog))
            lsock.setblocking(False)
            self._sel.register(lsock, selectors.EVENT_READ, None)
            self._lsock = lsock
            self.address = lsock.getsockname()[:2]
        self._conns: Dict[socket.socket, _Conn] = {}
        self._signals: Dict[str, float] = {}
        # per-producer contiguous resolved prefix: every pseq <= this was
        # applied, rejected, errored or deduped. Seeded from the journal's
        # recovered watermarks at hello; the in-order gate in _apply keeps it
        # (and therefore the durable serve_marks) free of gaps.
        self._resolved: Dict[str, int] = {}
        self.frames_total = 0
        self.bytes_in_total = 0
        self.dedup_skipped = 0
        self.protocol_errors = 0
        self.ordering_defers = 0
        self.disconnects = 0
        self.queue_high_water = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---------------------------------------------------------------- engine adapters
    def _engines(self) -> List[Any]:
        shards = getattr(self.engine, "_shards", None)
        return list(shards) if shards is not None else [self.engine]

    def _target_engine(self, sid: Hashable) -> Any:
        shards = getattr(self.engine, "_shards", None)
        if shards is None:
            return self.engine
        return shards[self.engine.shard_of(sid)]

    def _fleet_watermark(self, producer: str) -> int:
        return max((eng.serve_watermark(producer) for eng in self._engines()), default=0)

    # ---------------------------------------------------------------- connections
    def adopt(self, sock: socket.socket) -> None:
        """Register an already-connected socket (socketpair tests, chaos)."""
        sock.setblocking(False)
        conn = _Conn(sock, "adopted", self.max_frame_bytes)
        self._conns[sock] = conn
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _accept(self) -> None:
        assert self._lsock is not None
        while True:
            try:
                sock, peer = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            sock.setblocking(False)
            conn = _Conn(sock, peer, self.max_frame_bytes)
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _drop(self, conn: _Conn, reason: str) -> None:
        if conn.sock not in self._conns:
            return
        del self._conns[conn.sock]
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self.disconnects += 1
        if conn.producer is not None:
            _observe.note_serve_disconnect(conn.producer, reason)

    def _read(self, conn: _Conn) -> None:
        budget = self.read_budget_bytes
        while budget > 0:
            if len(conn.pending) >= self.pending_cap:
                # a peer far past its advertised credit window: stop reading
                # and let TCP backpressure hold the rest in its send buffer
                return
            try:
                chunk = conn.sock.recv(min(65536, budget))
            except (BlockingIOError, InterruptedError):
                return
            except (ConnectionResetError, OSError):
                self._drop(conn, "reset")
                return
            if not chunk:
                # peer went away; whatever partial frame it left behind never
                # decoded, so the engine saw only whole records
                self._drop(conn, "eof")
                return
            budget -= len(chunk)
            self.bytes_in_total += len(chunk)
            conn.bytes_unmetered += len(chunk)
            _observe.note_serve_bytes(len(chunk))
            try:
                conn.pending.extend(conn.decoder.feed(chunk))
            except ProtocolError as exc:
                # intact records decoded before the damage still count; the
                # framing itself can no longer be trusted past it. They face
                # the same admission signals and durability point as a normal
                # poll batch (acks queued here die with the drop, so fsyncing
                # before it keeps the ack-implies-durable contract vacuously
                # true and the journal consistent with what was applied).
                conn.pending.extend(getattr(exc, "records", []))
                self.protocol_errors += 1
                _observe.note_serve_protocol_error(str(exc))
                self._signals = self.admission.signals(self.engine)
                self._process(conn)
                self._sync_wals()
                self._drop(conn, "protocol_error")
                return

    # ---------------------------------------------------------------- record processing
    def _respond(self, conn: _Conn, kind: str, pseq: int, sid: Any, payload: Dict[str, Any]) -> None:
        conn.out += encode_frame(kind, pseq, sid, payload)

    def _arrival_device(self, sid: Hashable) -> torch.device:
        shards = getattr(self.engine, "_shards", None)
        if shards is None:
            return self.device
        return self.engine._shard_device(self.engine.shard_of(sid))

    def _materialize_metric(self, payload: Any, sid: Hashable) -> Metric:
        # the nested blob is full pickle by design (it reconstructs arbitrary Metric subclasses) and is only
        # ever loaded here, after the session key authenticated the producer and admission accepted the
        # arrival, over this package's classes only; pre-auth bytes never reach pickle machinery beyond the
        # restricted frame decoder (protocol.SAFE_PICKLE_GLOBALS)
        if isinstance(payload, tuple) and len(payload) == 2 and payload[0] == "__metric__":
            device = self._arrival_device(sid)
            with _load_device(device):
                payload = _settle(_PortMetricUnpickler(io.BytesIO(payload[1])).load(), device)
        if not isinstance(payload, Metric):
            raise ProtocolError(f"add payload is not a Metric ({type(payload).__name__})")
        return payload

    def _process(self, conn: _Conn) -> None:
        """Apply this connection's decoded records in order; queue responses."""
        pending, conn.pending = conn.pending, []
        n_data = 0
        dedup_before = self.dedup_skipped
        try:
            for rec in pending:
                kind, pseq, sid, payload = rec
                self.frames_total += 1
                _observe.note_serve_frame(kind)
                if conn.producer is None:
                    if kind != "hello":
                        self.protocol_errors += 1
                        _observe.note_serve_protocol_error("data before hello")
                        conn.closing = True
                        return
                    hello = payload if isinstance(payload, dict) else {}
                    key = str(hello.get("key", "")).encode("utf-8", "replace")
                    producer = str(hello.get("producer", sid))
                    if not hmac.compare_digest(key, self._key_bytes):
                        _observe.note_serve_admission("reject", "auth")
                        self._respond(conn, "ack", 0, None, {"status": "reject", "reason": "auth"})
                        conn.closing = True
                        return
                    conn.producer = producer
                    wm = self._fleet_watermark(producer)
                    if wm > self._resolved.get(producer, 0):
                        self._resolved[producer] = wm
                    _observe.note_serve_connect(producer)
                    self._respond(conn, "welcome", 0, producer, {
                        "watermark": wm,
                        "credits": self.window,
                        "proto": PROTO_VERSION,
                    })
                    continue
                if kind == "ping":
                    self._respond(conn, "pong", pseq, None, {})
                    continue
                if kind == "bye":
                    conn.closing = True
                    continue
                if kind not in DATA_KINDS:
                    self.protocol_errors += 1
                    _observe.note_serve_protocol_error(f"unknown kind {kind!r}")
                    conn.closing = True
                    return
                if not isinstance(pseq, int) or isinstance(pseq, bool) or pseq < 1:
                    self.protocol_errors += 1
                    _observe.note_serve_protocol_error(f"bad pseq for {kind!r} record")
                    conn.closing = True
                    return
                n_data += 1
                self._apply(conn, kind, pseq, sid, payload)
        except Exception as exc:  # noqa: BLE001 — a malformed CRC-valid record
            # must cost only its own connection, never the reactor: anything
            # escaping per-record handling would otherwise propagate out of
            # poll() and kill service for every connected producer
            self.protocol_errors += 1
            _observe.note_serve_protocol_error(f"malformed record: {type(exc).__name__}")
            conn.closing = True
        finally:
            # per-producer ingest attribution (observe/metering.py): one meter
            # call per processed batch, covering early exits too
            mt = installed_meter()
            if mt is not None and conn.producer is not None and (n_data or conn.bytes_unmetered):
                mt.note_ingest(
                    conn.producer, n_data, conn.bytes_unmetered,
                    self.dedup_skipped - dedup_before,
                )
                conn.bytes_unmetered = 0

    def _apply(self, conn: _Conn, kind: str, pseq: int, sid: Any, payload: Any) -> None:
        producer = conn.producer
        target = self._target_engine(sid) if sid is not None else self._engines()[0]
        resolved = self._resolved.get(producer, 0)
        if pseq <= target.serve_watermark(producer):
            # a resend of something this shard already durably resolved
            self.dedup_skipped += 1
            _observe.note_serve_dedup(producer)
            self._respond(conn, "ack", pseq, sid, {"status": "dup"})
            if pseq > resolved:
                self._resolved[producer] = pseq
            return
        if pseq > resolved + 1:
            # in-order resolution: an earlier record from this producer is
            # still unresolved (deferred). Applying or watermarking this one
            # would advance the shard watermark over the gap and the deferred
            # record's retry would be falsely acked "dup" — applied never.
            self.ordering_defers += 1
            _observe.note_serve_admission("defer", "ordering")
            self._respond(conn, "ack", pseq, sid, {
                "status": "defer", "rule": "ordering", "retry_after_s": 0.05,
            })
            return
        decision = self.admission.decide(kind, self._signals)
        _observe.note_serve_admission(decision.verdict, decision.rule)
        if decision.verdict == "defer":
            self._respond(conn, "ack", pseq, sid, {
                "status": "defer", "rule": decision.rule,
                "retry_after_s": decision.retry_after_s if decision.retry_after_s is not None else 0.25,
            })
            return  # unresolved: the ordering gate holds later pseqs back until the retry
        if decision.verdict == "reject":
            target.serve_mark(producer, pseq)  # refusals are final: dedup resends
            self._resolved[producer] = max(resolved, pseq)
            self._respond(conn, "ack", pseq, sid, {"status": "reject", "reason": decision.rule})
            return
        if decision.verdict == "shed" and self.autonomic is not None:
            self.autonomic.shed(1, reason=f"admission:{decision.rule}")
        status: Dict[str, Any] = {"status": "ok"}
        try:
            if kind == "add":
                self.engine.add_session(self._materialize_metric(payload, sid), session_id=sid)
            elif kind == "submit":
                args, kwargs = payload
                self.engine.submit(sid, *args, **kwargs)
            elif kind == "expire":
                self.engine.expire(sid)
            else:  # reset
                self.engine.reset(sid)
        except Exception as exc:  # noqa: BLE001 — per-record failure, connection survives
            status = {"status": "err", "reason": f"{type(exc).__name__}: {str(exc)[:200]}"}
        target.serve_mark(producer, pseq)
        self._resolved[producer] = max(resolved, pseq)
        self._respond(conn, "ack", pseq, sid, status)

    # ---------------------------------------------------------------- IO pump
    def _sync_wals(self) -> None:
        """Durability point for this poll batch: every ack queued above is
        backed by a journal record; fsync them before any ack leaves."""
        for eng in self._engines():
            if eng._wal is not None:
                eng._wal.sync()

    def _flush_writes(self) -> None:
        for conn in list(self._conns.values()):
            if conn.out:
                try:
                    sent = conn.sock.send(conn.out)
                    del conn.out[:sent]
                except (BlockingIOError, InterruptedError):
                    pass
                except OSError:
                    self._drop(conn, "reset")
                    continue
            if conn.closing and not conn.out:
                self._drop(conn, "bye")

    def poll(self, timeout: float = 0.0) -> int:
        """One reactor pass: read sockets, admit/apply whole records, fsync
        touched journals, then release the batch's acks. Returns the number
        of records processed."""
        for key, _mask in self._sel.select(timeout):
            if key.data is None:
                self._accept()
            else:
                self._read(key.data)
        backlog = sum(len(c.pending) for c in self._conns.values())
        self.queue_high_water = max(self.queue_high_water, backlog)
        processed = 0
        if backlog:
            self._signals = self.admission.signals(self.engine)
            for conn in list(self._conns.values()):
                processed += len(conn.pending)
                self._process(conn)
            self._sync_wals()
        if self.autonomic is not None:
            self.autonomic.step()
        self._flush_writes()
        if _observe.ENABLED:
            producers = sum(1 for c in self._conns.values() if c.producer is not None)
            _observe.set_serve_gauges(producers, sum(len(c.pending) for c in self._conns.values()))
        return processed

    def tick(self) -> int:
        """Convenience cadence: one poll, one engine tick."""
        self.poll(0.0)
        return self.engine.tick()

    # ---------------------------------------------------------------- lifecycle
    def serve_in_thread(self, poll_interval_s: float = 0.01, tick_every: int = 5) -> threading.Thread:
        """Run the reactor on a daemon thread, ticking the engine every
        ``tick_every`` polls; ``stop()`` joins it."""

        def _loop() -> None:
            polls = 0
            while not self._stop.is_set():
                self.poll(poll_interval_s)
                polls += 1
                if polls % max(1, int(tick_every)) == 0:
                    self.engine.tick()

        self._stop.clear()
        self._thread = threading.Thread(target=_loop, name=f"{self._name}-reactor", daemon=True)
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def close(self) -> None:
        self.stop()
        for conn in list(self._conns.values()):
            self._drop(conn, "server_close")
        if self._lsock is not None:
            try:
                self._sel.unregister(self._lsock)
            except (KeyError, ValueError):
                pass
            self._lsock.close()
            self._lsock = None
        self._sel.close()

    # ---------------------------------------------------------------- telemetry
    def stats(self) -> Dict[str, Any]:
        return {
            "name": self._name,
            "address": self.address,
            "connections": len(self._conns),
            "producers": sorted(
                c.producer for c in self._conns.values() if c.producer is not None
            ),
            "frames_total": self.frames_total,
            "bytes_in_total": self.bytes_in_total,
            "dedup_skipped": self.dedup_skipped,
            "protocol_errors": self.protocol_errors,
            "ordering_defers": self.ordering_defers,
            "disconnects": self.disconnects,
            "queue_high_water": self.queue_high_water,
            "admission": dict(self.admission.counts),
            "autonomic": dict(self.autonomic.counts) if self.autonomic is not None else None,
            "window": self.window,
        }
