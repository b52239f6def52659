"""The MTWAL001 wire protocol: a producer's socket stream IS the journal format (counterpart of
``metrics_tpu/serve/protocol.py``).

``engine/durability.py`` frames every ingest-WAL record as::

    u32 record_len | u32 crc32(record) | pickle((kind, seq, sid, payload))

preceded, once per file, by the 8-byte magic ``b"MTWAL001"``. This module lifts exactly that grammar onto a
socket: each direction of a connection starts with the same magic and then carries nothing but CRC-framed
records, so a captured client stream written to disk byte for byte *is* a readable WAL file, and the decoder
here accepts and rejects frames under the same rules as :meth:`IngestWAL.read_records_detailed`. Two
deliberate divergences, both because a socket peer is untrusted where a local journal file is not: the
streaming decoder rejects any declared length above ``max_frame_bytes`` before buffering the body, and it
unpickles record bodies under the :data:`SAFE_PICKLE_GLOBALS` allowlist. A CRC proves integrity, not trust,
and frames arrive *before* any authentication, so a frame whose pickle names any global outside the
allowlist reads as damage (``ProtocolError``), never as code execution.

**What travels on the wire.** Payloads are host data: containers, scalars, strings, bytes and numpy arrays.
:func:`encode_frame` turns every tensor of a payload into a numpy array (the host form the engine journals),
and a metric into the journal's ``("__metric__", bytes)`` blob, whose tensors are numpy arrays too
(:func:`~metrics_tpu_torch.engine.durability.pack_metric`). The allowlist is the JAX package's less its
``jax`` entry, and it names no torch global: a frame that pickles a tensor or any torch object reaches
``torch`` rebuild machinery, so it reads as damage. A record of numpy payloads encodes to the same bytes in
both packages.

**Record kinds.** Client-to-server data records reuse the WAL kinds verbatim (``add`` / ``submit`` /
``expire`` / ``reset``), with ``seq`` drawn from the producer's own increasing sequence (``pseq``). Control
records ride the same framing: the client opens with ``hello`` (payload: the session key, producer name,
protocol version) and may send ``ping`` / ``bye``; the server answers ``welcome`` (payload: the producer's
recovered seq watermark and granted credit window), one ``ack`` per data record (payload ``status``: ``ok`` /
``dup`` / ``err`` / ``defer`` / ``reject``), and ``pong``.

**At-least-once with dedup.** A producer retains every data record until its ack arrives; the server journals
each applied record (and the producer's ``pseq``, as a ``serve_mark`` journal record) into the target shard's
WAL and fsyncs *before* acking, so an acked record is durable, a crash loses at most unacked records, and
after reconnecting the producer resends its unacked buffer. Routing is a stable hash of the session id, so a
resent record lands on the same shard, whose recovered per-producer watermark makes the duplicate detectable
(``status="dup"``) and application exactly-once. The server resolves a producer's records strictly in
``pseq`` order: while a record sits deferred, every later ``pseq`` is answered ``defer`` (rule ``ordering``),
so the watermark always describes a contiguous resolved prefix.

**Backpressure.** The ``welcome`` grants a credit window: the producer keeps at most ``window`` data records
in flight (sent, unacked); each ack returns one credit. Deferred records drop back into the resend buffer and
are retried after ``retry_after_s``.
"""

from __future__ import annotations

import io
import pickle
import select
import socket
import time
import zlib
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from metrics_tpu_torch.engine.durability import _FRAME, _PICKLE, WAL_MAGIC, pack_metric
from metrics_tpu_torch.engine.stream import _host_value, _tree_map
from metrics_tpu_torch.metric import Metric

__all__ = [
    "CONTROL_KINDS",
    "DATA_KINDS",
    "DEFAULT_MAX_FRAME_BYTES",
    "DEFAULT_WINDOW",
    "FrameDecoder",
    "PROTO_VERSION",
    "Producer",
    "ProtocolError",
    "SAFE_PICKLE_GLOBALS",
    "WAL_MAGIC",
    "decode_blob",
    "encode_frame",
    "restricted_loads",
]

PROTO_VERSION = 1
DEFAULT_WINDOW = 64  # data records in flight per producer before pausing sends
DEFAULT_MAX_FRAME_BYTES = 64 << 20  # streaming-only guard; files have no cap
DATA_KINDS = ("add", "submit", "expire", "reset")
CONTROL_KINDS = ("hello", "welcome", "ack", "ping", "pong", "bye")


class ProtocolError(RuntimeError):
    """Framing or handshake violation; the connection cannot be trusted past it."""


# The outer (kind, seq, sid, payload) record is pure data (containers, scalars, strings, bytes) plus the
# reconstruction callables numpy arrays pickle through. Anything else (a tensor's torch rebuild, a JAX
# array, the classic ``os.system`` reduce gadget) raises, and the frame reads as damage. Metric objects travel
# as tagged ``("__metric__", bytes)`` blobs that the server loads only after the session key authenticated
# the producer.
SAFE_PICKLE_GLOBALS = frozenset({
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.multiarray", "_reconstruct"),  # frames from pre-numpy-2 writers
    ("numpy.core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
})


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in SAFE_PICKLE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"disallowed global {module}.{name}")


def restricted_loads(blob: bytes) -> Any:
    """``pickle.loads`` confined to :data:`SAFE_PICKLE_GLOBALS`.

    Safe for bytes from an unauthenticated socket peer: a pickle that names
    any other global — i.e. anything that could execute code — raises
    ``UnpicklingError`` instead of importing it. Used by :class:`FrameDecoder`
    for every frame, on both the server and the client side.
    """
    return _RestrictedUnpickler(io.BytesIO(blob)).load()


def _has_tensor(tree: Any) -> bool:
    if isinstance(tree, torch.Tensor):
        return True
    if isinstance(tree, dict):
        return any(_has_tensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_tensor(v) for v in tree)
    return False


def encode_frame(kind: str, seq: int, sid: Any, payload: Any = None) -> bytes:
    """Frame one record exactly as ``IngestWAL.append`` writes it.

    A metric payload gets the WAL's ``("__metric__", bytes)`` tagging (:func:`pack_metric`: numpy arrays and
    device names, so frames are process- and host-portable); every tensor elsewhere in the payload becomes a
    numpy array, read to the host once, as the engine journals a submission.
    """
    if isinstance(payload, Metric):
        payload = ("__metric__", pack_metric(payload))
    elif _has_tensor(payload):
        payload = _tree_map(_host_value, payload)
    rec = pickle.dumps((kind, seq, sid, payload), protocol=_PICKLE)
    return _FRAME.pack(len(rec), zlib.crc32(rec) & 0xFFFFFFFF) + rec


class FrameDecoder:
    """Incremental MTWAL001 reader over a byte stream.

    ``feed`` returns every complete record the buffered bytes hold, in order;
    partial frames simply wait for more bytes. Damage — bad magic, CRC
    mismatch, an unpicklable or non-4-tuple record, or a declared length
    above ``max_frame_bytes`` — raises :class:`ProtocolError`; the records
    decoded before the damage ride on the exception's ``records`` attribute
    so a caller draining a dying connection loses nothing intact.
    """

    def __init__(
        self, expect_magic: bool = True, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES
    ) -> None:
        self._buf = bytearray()
        self._magic_ok = not expect_magic
        self.max_frame_bytes = int(max_frame_bytes)
        self.frames_decoded = 0  # intact records handed out so far
        self.bytes_consumed = 0  # magic + full frames consumed so far

    def pending_bytes(self) -> int:
        """Buffered bytes not yet part of a complete record (a partial frame)."""
        return len(self._buf)

    def _damage(self, msg: str, records: List[Tuple[Any, ...]]) -> ProtocolError:
        err = ProtocolError(msg)
        err.records = records  # type: ignore[attr-defined]
        err.byte_offset = self.bytes_consumed  # type: ignore[attr-defined]
        return err

    def feed(self, data: bytes) -> List[Tuple[Any, ...]]:
        self._buf += data
        out: List[Tuple[Any, ...]] = []
        if not self._magic_ok:
            if len(self._buf) < len(WAL_MAGIC):
                if WAL_MAGIC.startswith(bytes(self._buf)):
                    return out  # a magic prefix: wait for the rest
                raise self._damage("bad stream magic", out)
            if bytes(self._buf[: len(WAL_MAGIC)]) != WAL_MAGIC:
                raise self._damage("bad stream magic", out)
            del self._buf[: len(WAL_MAGIC)]
            self.bytes_consumed += len(WAL_MAGIC)
            self._magic_ok = True
        while len(self._buf) >= _FRAME.size:
            length, crc = _FRAME.unpack_from(self._buf, 0)
            if length > self.max_frame_bytes:
                raise self._damage(f"oversized frame: {length} bytes declared", out)
            if len(self._buf) < _FRAME.size + length:
                break  # partial body: wait for more
            body = bytes(self._buf[_FRAME.size : _FRAME.size + length])
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                raise self._damage("frame crc mismatch", out)
            try:
                rec = restricted_loads(body)
            except Exception as exc:  # noqa: BLE001 — CRC passed but the record is garbage or hostile
                detail = str(exc) if isinstance(exc, pickle.UnpicklingError) else type(exc).__name__
                raise self._damage(f"frame does not unpickle: {detail}", out) from exc
            if not (isinstance(rec, tuple) and len(rec) == 4):
                raise self._damage("frame is not a (kind, seq, sid, payload) record", out)
            del self._buf[: _FRAME.size + length]
            self.bytes_consumed += _FRAME.size + length
            self.frames_decoded += 1
            out.append(rec)
        return out


def decode_blob(blob: bytes) -> Tuple[List[Tuple[Any, ...]], Optional[Dict[str, int]]]:
    """Decode one finite byte blob under the streaming acceptance rules.

    Returns ``(records, torn)`` shaped exactly like
    ``IngestWAL.read_records_detailed``: ``torn`` is ``None`` for a clean
    decode or ``{"frame_index", "byte_offset"}`` locating the first damaged
    or incomplete frame. The protocol fuzz test pins this byte-for-byte
    against the file reader over truncations, bit-flips, oversized lengths
    and alien magic.
    """
    dec = FrameDecoder()
    try:
        records = dec.feed(blob)
    except ProtocolError as exc:
        return (
            list(getattr(exc, "records", [])),
            {"frame_index": dec.frames_decoded, "byte_offset": dec.bytes_consumed},
        )
    if dec.pending_bytes():
        return records, {"frame_index": dec.frames_decoded, "byte_offset": dec.bytes_consumed}
    return records, None


# ------------------------------------------------------------------ producer
class Producer:
    """Reference client: journal-framed metric ops over a socket, at-least-once.

    Every data op is buffered until its ack arrives; ``flush`` drives the
    window until the buffer drains. ``drive`` (optional) is called while
    waiting — an in-process test passes ``lambda: server.poll(0)`` so one
    thread can play both ends of the loopback. After a server crash,
    ``reconnect()`` re-handshakes and resends the whole unacked buffer; the
    server's per-shard watermarks turn duplicates into ``dup`` acks.
    """

    def __init__(
        self,
        address: Optional[Tuple[str, int]],
        session_key: str,
        name: str,
        *,
        window: int = DEFAULT_WINDOW,
        timeout: float = 10.0,
        drive: Optional[Callable[[], Any]] = None,
        sock: Optional[socket.socket] = None,
    ) -> None:
        self.name = str(name)
        self._key = str(session_key)
        self.window = int(window)
        self._timeout = float(timeout)
        self._drive = drive
        self._address = address
        self._seq = 0  # last data pseq assigned
        # pseq -> (frame bytes, kind, sid); insertion order == send order
        self._unacked: "OrderedDict[int, Tuple[bytes, str, Any]]" = OrderedDict()
        self._inflight: set = set()  # pseqs sent and awaiting a response
        self._deferred_until: Dict[int, float] = {}  # pseq -> earliest resend time
        self.errors: List[Tuple[int, str, Any, str]] = []  # (pseq, kind, sid, reason)
        self.acked = 0  # highest pseq ever acked ok/dup (informational)
        self.deferred = 0
        self.rejected = 0
        self.server_watermark = 0  # from the last welcome
        self._sock: Optional[socket.socket] = None
        self._connect(sock)

    # ---------------------------------------------------------------- wiring
    def _connect(self, sock: Optional[socket.socket] = None) -> None:
        self._dec = FrameDecoder()
        if sock is not None:
            self._sock = sock
        else:
            if self._address is None:
                raise ProtocolError("producer has no address to connect to")
            self._sock = socket.create_connection(self._address, timeout=self._timeout)
        self._sock.setblocking(False)
        hello = encode_frame(
            "hello", 0, self.name,
            {"key": self._key, "producer": self.name, "proto": PROTO_VERSION},
        )
        self._send_raw(WAL_MAGIC + hello)
        rec = self._await_control(("welcome",))
        self.server_watermark = int(rec[3].get("watermark", 0))
        self.window = int(rec[3].get("credits", self.window))

    def _send_raw(self, data: bytes) -> None:
        assert self._sock is not None
        deadline = time.monotonic() + self._timeout
        view = memoryview(data)
        while view:
            try:
                n = self._sock.send(view)
            except (BlockingIOError, InterruptedError):
                n = 0
            if n:
                view = view[n:]
                continue
            if time.monotonic() > deadline:
                raise ProtocolError("send timed out (window stalled?)")
            if self._drive is not None:
                self._drive()
            select.select([], [self._sock], [], 0.05)

    def _recv_available(self) -> List[Tuple[Any, ...]]:
        assert self._sock is not None
        out: List[Tuple[Any, ...]] = []
        while True:
            try:
                chunk = self._sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            if not chunk:
                raise ProtocolError("server closed the connection")
            out.extend(self._dec.feed(chunk))
        return out

    def _await_control(self, kinds: Tuple[str, ...]) -> Tuple[Any, ...]:
        deadline = time.monotonic() + self._timeout
        while True:
            for rec in self._recv_available():
                if rec[0] in kinds:
                    return rec
                self._handle(rec)
            if time.monotonic() > deadline:
                raise ProtocolError(f"timed out waiting for {'/'.join(kinds)}")
            if self._drive is not None:
                self._drive()
            else:
                select.select([self._sock], [], [], 0.05)

    # ---------------------------------------------------------------- acks
    def _handle(self, rec: Tuple[Any, ...]) -> None:
        kind, pseq, sid, payload = rec
        if kind != "ack":
            return  # welcome/pong outside a wait: informational
        pseq = int(pseq)
        status = (payload or {}).get("status", "ok")
        self._inflight.discard(pseq)
        if status in ("ok", "dup"):
            self._unacked.pop(pseq, None)
            self._deferred_until.pop(pseq, None)
            self.acked = max(self.acked, pseq)
        elif status == "defer":
            self.deferred += 1
            retry = float((payload or {}).get("retry_after_s", 0.05))
            self._deferred_until[pseq] = time.monotonic() + retry
        elif status == "reject":
            self.rejected += 1
            entry = self._unacked.pop(pseq, None)
            self._deferred_until.pop(pseq, None)
            if entry is not None:
                self.errors.append((pseq, entry[1], entry[2], (payload or {}).get("reason", "rejected")))
        else:  # "err": applied-side failure; the record will not be retried
            entry = self._unacked.pop(pseq, None)
            self._deferred_until.pop(pseq, None)
            if entry is not None:
                self.errors.append((pseq, entry[1], entry[2], (payload or {}).get("reason", "error")))

    def pump(self) -> None:
        """One non-blocking round: drain acks, then fill the credit window."""
        for rec in self._recv_available():
            self._handle(rec)
        now = time.monotonic()
        for pseq, (frame, _kind, _sid) in list(self._unacked.items()):
            if len(self._inflight) >= self.window:
                break
            if pseq in self._inflight:
                continue
            if self._deferred_until.get(pseq, 0.0) > now:
                continue
            self._send_raw(frame)
            self._inflight.add(pseq)

    # ---------------------------------------------------------------- data ops
    def _data(self, kind: str, sid: Any, payload: Any = None) -> int:
        self._seq += 1
        frame = encode_frame(kind, self._seq, sid, payload)
        self._unacked[self._seq] = (frame, kind, sid)
        self.pump()
        return self._seq

    def add_session(self, metric: Metric, session_id: Hashable) -> int:
        """Arrive one session (explicit id: the producer owns its namespace)."""
        return self._data("add", session_id, metric)

    def submit(self, session_id: Hashable, *args: Any, **kwargs: Any) -> int:
        return self._data("submit", session_id, (tuple(args), dict(kwargs)))

    def expire(self, session_id: Hashable) -> int:
        return self._data("expire", session_id)

    def reset(self, session_id: Optional[Hashable] = None) -> int:
        return self._data("reset", session_id)

    @property
    def outstanding(self) -> int:
        """Unacked data records (buffered + in flight)."""
        return len(self._unacked)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Pump until every data record is acked (ok/dup/err/reject)."""
        deadline = time.monotonic() + (self._timeout if timeout is None else float(timeout))
        while self._unacked:
            self.pump()
            if not self._unacked:
                break
            if time.monotonic() > deadline:
                raise ProtocolError(f"flush timed out with {len(self._unacked)} records unacked")
            if self._drive is not None:
                self._drive()
            else:
                select.select([self._sock], [], [], 0.05)

    def resume_from_watermark(self) -> int:
        """Skip pseq numbering past the server's recovered watermark.

        For a *fresh* producer process that reuses a durable name but has NEW
        data to send (no replay): without this, its numbering restarts at 1
        and every new record is silently squelched as a ``dup`` of the
        recovered prefix. Never call it when replaying old records for
        idempotence — replay relies on reusing the original numbering.
        Returns the pseq the next record will follow.
        """
        if self._unacked:
            raise ProtocolError("resume_from_watermark with records unacked: replay them instead")
        self._seq = max(self._seq, self.server_watermark)
        return self._seq

    def reconnect(self, sock: Optional[socket.socket] = None) -> None:
        """Re-handshake after a drop and resend the whole unacked buffer.

        The welcome watermark is informational only: after a crash, shards
        may have durably applied *different* prefixes of the producer's
        stream, so the only safe recovery is resending everything unacked
        and letting per-shard watermarks squelch the duplicates. (A fresh
        process with new data under a recovered name is the opposite case:
        see :meth:`resume_from_watermark`.)
        """
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._inflight.clear()
        self._deferred_until.clear()
        self._connect(sock)
        self.pump()

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            self._send_raw(encode_frame("bye", 0, self.name))
        except (ProtocolError, OSError):
            pass
        try:
            self._sock.close()
        finally:
            self._sock = None
