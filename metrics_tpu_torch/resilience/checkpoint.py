"""Durable checkpoint/restore for metric state (counterpart of ``metrics_tpu/resilience/checkpoint.py``).

File format, the JAX package's (all integers big-endian)::

    MAGIC "MTCKPT01"  (8 bytes)
    u32 header_len | u32 header_crc32
    header JSON      {"format_version", "payload_len", "payload_crc32",
                      "root_kind", "root_class"}
    payload          pickled host tree of the node structure below

A node is ``{"kind": "metric", "class", "fingerprint", "update_count",
"state", "avals"}``, ``{"kind": "collection", "class", "members"}``, or a
``"replicated"`` metric node with a ``"replicas"`` list of metric nodes (a
``ReplicatedWrapper``: ``BootStrapper``, ``MultioutputWrapper``); a
``StreamEngine`` target is routed to ``engine/durability.py``, whose fleet
payload has ``root_kind == "fleet"``. States
are numpy arrays (one device-to-host copy per tensor state; a list state keeps
one array per element), never pickled torch tensors, so either package's
``_parse`` reads the other's files into equal node trees. The identities are
not shared: the port's ``config_fingerprint`` spells its own module path, so a
checkpoint the JAX package wrote is refused here with
:class:`IncompatibleCheckpointError` (state crosses packages through
``interop.load_reference_state``), and the port's int64 counters would be
refused by the exact-dtype check anyway.

The write is crash-consistent (``utils.io.atomic_write_chunks``: sibling temp
file + fsync + ``os.replace`` + directory fsync), so a reader only ever sees a
complete old or complete new checkpoint. ``restore_checkpoint`` verifies the
magic, version, both CRCs and exact length, then validates class names, config
fingerprints and state avals against the live target — all BEFORE installing
anything, so a truncated, bit-flipped or mismatched checkpoint is rejected with
a clean error and never leaves the target partially loaded. The aval rule is
the JAX package's ``Metric._validate_loaded_state``: a value's dtype kind must
match the state's, and a list state's elements are held to the metric's float
dtype, so that a list of integer arrays (the labels of ``MeanAveragePrecision``,
the targets of an exact-mode curve) is refused as the JAX package refuses it.
Installation goes through ``Metric.load_state_dict``, onto the target's
device: a checkpoint taken on the card restores into a CPU instance.

"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import struct
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.observe import tracing as _trace
from metrics_tpu_torch.utils.compute import acc_dtype
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.io import atomic_write_chunks

__all__ = [
    "CheckpointError",
    "CorruptCheckpointError",
    "IncompatibleCheckpointError",
    "PeriodicCheckpointer",
    "SnapshotPolicy",
    "load_manifest",
    "restore_checkpoint",
    "save_checkpoint",
    "save_manifest",
]

MAGIC = b"MTCKPT01"
MANIFEST_MAGIC = b"MTMAN001"
FORMAT_VERSION = 1
_HEAD = struct.Struct(">II")  # header_len, header_crc32

# CRC32 is computed over fixed-size windows so a large payload never needs a
# second contiguous copy just to be checksummed
_CRC_CHUNK = 1 << 20


def _crc32_chunked(*parts: bytes, chunk_size: int = _CRC_CHUNK) -> int:
    """``zlib.crc32`` over the concatenation of ``parts`` without concatenating.

    Bit-identical to ``zlib.crc32(b"".join(parts))``: the CRC state is threaded
    through ``chunk_size`` memoryview windows, so peak extra memory is O(chunk)
    instead of O(payload).
    """
    crc = 0
    for part in parts:
        view = memoryview(part)
        for off in range(0, len(view), chunk_size):
            crc = zlib.crc32(view[off : off + chunk_size], crc)
    return crc & 0xFFFFFFFF


def _write_container(path: str, root_kind: str, root_class: str, payload_parts: List[bytes]) -> int:
    """Frame ``payload_parts`` into one MTCKPT file, streamed (never joined); returns the bytes written."""
    header = json.dumps(
        {
            "format_version": FORMAT_VERSION,
            "payload_len": sum(len(p) for p in payload_parts),
            "payload_crc32": _crc32_chunked(*payload_parts),
            "root_kind": root_kind,
            "root_class": root_class,
        },
        sort_keys=True,
    ).encode("utf-8")
    head = _HEAD.pack(len(header), zlib.crc32(header) & 0xFFFFFFFF)
    return atomic_write_chunks(path, [MAGIC, head, header, *payload_parts])


# ------------------------------------------------------------------ manifests
# A manifest is the durability root of a multi-file checkpoint: a small
# CRC-framed JSON document written ATOMICALLY and LAST, so its existence
# certifies that every file it names was already fsynced. Format:
# MANIFEST_MAGIC | u32 len | u32 crc32 | JSON body.
def save_manifest(path: Union[str, os.PathLike], node: Dict[str, Any]) -> str:
    """Atomically write ``node`` (a JSON-able dict) as a CRC-validated manifest."""
    path = os.fspath(path)
    body = json.dumps(node, sort_keys=True).encode("utf-8")
    head = _HEAD.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF)
    atomic_write_chunks(path, [MANIFEST_MAGIC, head, body])
    return path


def load_manifest(path: Union[str, os.PathLike]) -> Dict[str, Any]:
    """Read and verify a manifest written by :func:`save_manifest`.

    Verifies magic, declared length and CRC before parsing; a damaged file
    raises :class:`CorruptCheckpointError` (never a partial dict)."""
    path = os.fspath(path)
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except OSError as exc:
        raise CheckpointError(f"{path}: cannot read manifest ({exc})") from exc
    base = len(MANIFEST_MAGIC) + _HEAD.size
    if len(blob) < base or blob[: len(MANIFEST_MAGIC)] != MANIFEST_MAGIC:
        raise CorruptCheckpointError(f"{path}: not a metrics_tpu manifest (bad magic or truncated preamble)")
    body_len, body_crc = _HEAD.unpack_from(blob, len(MANIFEST_MAGIC))
    body = blob[base:]
    if len(body) != body_len:
        raise CorruptCheckpointError(
            f"{path}: manifest body length {len(body)} != declared {body_len} (truncated or trailing garbage)"
        )
    if zlib.crc32(body) & 0xFFFFFFFF != body_crc:
        raise CorruptCheckpointError(f"{path}: manifest CRC mismatch (bit-flipped or damaged)")
    try:
        node = json.loads(body.decode("utf-8"))
    except ValueError as exc:
        raise CorruptCheckpointError(f"{path}: manifest body is not valid JSON ({exc})") from exc
    if not isinstance(node, dict):
        raise CorruptCheckpointError(f"{path}: manifest body is not a JSON object")
    return node


def file_crc32(path: Union[str, os.PathLike], chunk_size: int = _CRC_CHUNK) -> int:
    """Streaming CRC32 of a file's bytes (manifest-side integrity for the files it names)."""
    crc = 0
    with open(os.fspath(path), "rb") as fh:
        while True:
            chunk = fh.read(chunk_size)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures; the target is guaranteed untouched."""


class CorruptCheckpointError(CheckpointError):
    """The file is not a complete, intact checkpoint (truncated, bit-flipped,
    wrong magic/version, or trailing garbage)."""


class IncompatibleCheckpointError(CheckpointError):
    """The file is intact but describes a different object (class, config
    fingerprint, structure, or state avals do not match the target)."""


# ------------------------------------------------------------------ extraction
def _fingerprint(metric: Any) -> Optional[str]:
    """Config fingerprint; None when the config is not fingerprintable (child metrics, unhashable attrs) —
    aval checks still apply."""
    fp = getattr(metric, "config_fingerprint", None)
    return fp() if callable(fp) else None


def _host(v: Any) -> np.ndarray:
    """One state value as a host numpy array: one device-to-host copy of a tensor (bfloat16 through
    ``ml_dtypes``, the type the JAX package's arrays have); anything else through ``np.asarray``, as the
    JAX package stores it."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            import ml_dtypes

            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.numpy()
    return np.asarray(v)


def _aval_of(v: Any) -> Any:
    if isinstance(v, list):
        return {"list": [{"shape": list(x.shape), "dtype": str(x.dtype)} for x in v]}
    return {"shape": list(v.shape), "dtype": str(v.dtype)}


def _metric_payload(m: Any) -> Dict[str, Any]:
    state: Dict[str, Any] = {}
    for key in m._defaults:
        v = m.__dict__["_state"][key]
        state[key] = [_host(x) for x in v] if isinstance(v, list) else _host(v)
    return {
        "kind": "metric",
        "class": type(m).__name__,
        "fingerprint": _fingerprint(m),
        "update_count": int(m._update_count),
        "state": state,
        "avals": {k: _aval_of(v) for k, v in state.items()},
    }


def _extract(obj: Any) -> Dict[str, Any]:
    from metrics_tpu_torch.collections import MetricCollection
    from metrics_tpu_torch.wrappers.replicated import ReplicatedWrapper

    if isinstance(obj, MetricCollection):
        return {
            "kind": "collection",
            "class": type(obj).__name__,
            "members": {name: _extract(m) for name, m in obj._modules.items()},
        }
    if isinstance(obj, ReplicatedWrapper):
        obj._materialize()
        node = _metric_payload(obj)
        node["kind"] = "replicated"
        node["replicas"] = [_metric_payload(r) for r in obj._replicas]
        return node
    return _metric_payload(obj)


# ------------------------------------------------------------------ save
def _label(obj: Any) -> str:
    return type(obj).__name__


def save_checkpoint(obj: Any, path: Union[str, os.PathLike]) -> str:
    """Atomically snapshot ``obj`` (Metric / MetricCollection / ReplicatedWrapper / StreamEngine; fleet
    targets route to ``engine/durability.py``).

    Captures ALL registered states (persistence flags gate ``state_dict``, not
    durability checkpoints) plus update counts, recursively for collections and
    replica engines. Returns the path written.
    """
    fleet = _as_fleet(obj)
    if fleet is not None:
        from metrics_tpu_torch.engine.durability import save_fleet_checkpoint

        return save_fleet_checkpoint(fleet, path)
    path = os.fspath(path)
    with _trace.span("ckpt", "save"):
        node = _extract(obj)
        payload = pickle.dumps(node, protocol=pickle.HIGHEST_PROTOCOL)
        nbytes = _write_container(path, node["kind"], node["class"], [payload])
    _observe.note_checkpoint_save(_label(obj), path, nbytes)
    return path


def _as_fleet(obj: Any) -> Optional[Any]:
    """``obj`` when it is a StreamEngine, else None, without importing the engine package for the common
    metric-only case (a ``sys.modules`` probe)."""
    import sys

    stream_mod = sys.modules.get("metrics_tpu_torch.engine.stream")
    if stream_mod is not None and isinstance(obj, stream_mod.StreamEngine):
        return obj
    return None


# ------------------------------------------------------------------ parse + verify
def _parse(blob: bytes, path: str) -> Dict[str, Any]:
    base = len(MAGIC) + _HEAD.size
    if len(blob) < base or blob[: len(MAGIC)] != MAGIC:
        raise CorruptCheckpointError(f"{path}: not a metrics_tpu checkpoint (bad magic or truncated preamble)")
    header_len, header_crc = _HEAD.unpack_from(blob, len(MAGIC))
    if len(blob) < base + header_len:
        raise CorruptCheckpointError(f"{path}: truncated header")
    header_bytes = blob[base : base + header_len]
    if zlib.crc32(header_bytes) & 0xFFFFFFFF != header_crc:
        raise CorruptCheckpointError(f"{path}: header CRC mismatch (bit-flipped or damaged)")
    try:
        header = json.loads(header_bytes.decode("utf-8"))
    except ValueError as exc:
        raise CorruptCheckpointError(f"{path}: header is not valid JSON ({exc})") from exc
    if header.get("format_version") != FORMAT_VERSION:
        raise CorruptCheckpointError(
            f"{path}: unsupported checkpoint format version {header.get('format_version')!r} "
            f"(this build reads version {FORMAT_VERSION})"
        )
    payload = blob[base + header_len :]
    if len(payload) != header.get("payload_len"):
        raise CorruptCheckpointError(
            f"{path}: payload length {len(payload)} != declared {header.get('payload_len')} "
            "(truncated or trailing garbage)"
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != header.get("payload_crc32"):
        raise CorruptCheckpointError(f"{path}: payload CRC mismatch (bit-flipped or damaged)")
    try:
        node = pickle.loads(payload)
    except Exception as exc:  # pickle raises a zoo of exception types on damage
        raise CorruptCheckpointError(f"{path}: payload does not unpickle ({type(exc).__name__}: {exc})") from exc
    if not isinstance(node, dict) or "kind" not in node:
        raise CorruptCheckpointError(f"{path}: payload is not a checkpoint node tree")
    return node


def _expected_aval(m: Any, key: str) -> Tuple[Tuple[int, ...], np.dtype, bool]:
    """(shape, numpy dtype, growable) the registered default prescribes, by the JAX package's rule: an
    empty-list default is held to the metric's float dtype; a cat-reduced state may grow."""
    default = m._defaults[key]
    if isinstance(default, list):
        return (), _host(torch.zeros((), dtype=m._dtype)).dtype, True
    return tuple(default.shape), _host(torch.zeros((), dtype=default.dtype)).dtype, m._reductions[key] is dim_zero_cat


def _validate_loaded_state(m: Any, key: str, value: Any) -> None:
    """The JAX package's ``Metric._validate_loaded_state`` over host arrays: every value's dtype kind is the
    state's, and a fixed-shape state's shape is its default's."""
    shape, dtype, growable = _expected_aval(m, key)
    for v in value if isinstance(value, list) else [value]:
        arr = np.asarray(v)
        if arr.dtype.kind != dtype.kind:
            raise RuntimeError(
                f"{type(m).__name__}.load_state_dict: state {key!r} expects dtype "
                f"{dtype.name} (shape {shape}) but got {arr.dtype.name} "
                f"(shape {arr.shape}) — wrong checkpoint or mismatched metric config."
            )
        if not growable and arr.shape != shape:
            raise RuntimeError(
                f"{type(m).__name__}.load_state_dict: state {key!r} expects shape "
                f"{shape} (dtype {dtype.name}) but got {arr.shape} "
                f"(dtype {arr.dtype.name}) — wrong checkpoint or mismatched metric config."
            )


def _validate_metric(m: Any, node: Dict[str, Any], where: str) -> None:
    if node.get("kind") not in ("metric", "replicated"):
        raise IncompatibleCheckpointError(f"{where}: expected a metric node, checkpoint holds {node.get('kind')!r}")
    if node["class"] != type(m).__name__:
        raise IncompatibleCheckpointError(
            f"{where}: checkpoint was saved from {node['class']} but the restore target is {type(m).__name__}"
        )
    fp_ckpt, fp_live = node.get("fingerprint"), _fingerprint(m)
    if fp_ckpt is not None and fp_live is not None and fp_ckpt != fp_live:
        raise IncompatibleCheckpointError(
            f"{where}: config fingerprint mismatch for {type(m).__name__} — the checkpointed instance "
            "was constructed with different arguments (or by the other package) than the restore target"
        )
    for key, value in node["state"].items():
        if key not in m._defaults:
            raise IncompatibleCheckpointError(
                f"{where}: checkpoint carries state {key!r} that {type(m).__name__} does not register"
            )
        try:
            _validate_loaded_state(m, key, value)
        except RuntimeError as exc:
            raise IncompatibleCheckpointError(f"{where}: {exc}") from exc
        _validate_exact_dtype(m, key, node.get("avals", {}).get(key), where)


# Where the accumulators are float64 (``acc_dtype()``, the port's switch for the
# JAX package's x64 regime), a registered 32-bit state may legitimately be
# checkpointed as its 64-bit twin. Any other divergence is a writer/reader
# regime mismatch.
_X64_WIDENS = {
    "int32": "int64",
    "uint32": "uint64",
    "float32": "float64",
    "complex64": "complex128",
}


def _dtype_matches(got: str, expected: str) -> bool:
    if got == expected:
        return True
    return acc_dtype() == torch.float64 and _X64_WIDENS.get(expected) == got


def _validate_exact_dtype(m: Any, key: str, aval: Optional[Dict[str, Any]], where: str) -> None:
    """Exact-dtype aval check, stricter than :func:`_validate_loaded_state`.

    The in-memory loader accepts any same-kind dtype by design, but a durability
    checkpoint crossing that boundary is almost always a precision-regime
    mismatch between writer and reader — silently narrowing (or widening)
    restored accumulators corrupts long-run aggregates, so reject it with a
    diagnosis instead.
    """
    if not aval or "list" in aval:
        return  # list payloads carry their own per-element dtypes (validated by kind)
    _, expected, growable = _expected_aval(m, key)
    if growable:
        return  # cat-reduced defaults don't pin the accumulated element dtype
    got = aval.get("dtype")
    if got and not _dtype_matches(got, expected.name):
        raise IncompatibleCheckpointError(
            f"{where}: state {key!r} was checkpointed as dtype {got} but this process "
            f"expects {expected.name} — precision regime mismatch (was the default float "
            "type switched between the writing and the restoring process?). Refusing to "
            "silently cast restored accumulator state."
        )


def _validate(obj: Any, node: Dict[str, Any], where: str) -> None:
    from metrics_tpu_torch.collections import MetricCollection

    if isinstance(obj, MetricCollection):
        if node.get("kind") != "collection":
            raise IncompatibleCheckpointError(
                f"{where}: restore target is a MetricCollection but the checkpoint holds {node.get('kind')!r}"
            )
        members = node.get("members", {})
        missing = sorted(set(obj._modules) - set(members))
        unexpected = sorted(set(members) - set(obj._modules))
        if missing or unexpected:
            raise IncompatibleCheckpointError(
                f"{where}: collection members do not match the checkpoint "
                f"(missing: {missing or 'none'}, unexpected: {unexpected or 'none'})"
            )
        for name, sub in members.items():
            _validate(obj._modules[name], sub, f"{where}.{name}")
        return
    from metrics_tpu_torch.wrappers.replicated import ReplicatedWrapper

    if isinstance(obj, ReplicatedWrapper):
        if node.get("kind") != "replicated":
            raise IncompatibleCheckpointError(
                f"{where}: restore target is a ReplicatedWrapper but the checkpoint holds {node.get('kind')!r}"
            )
        obj._materialize()  # layout only: the logical state is unchanged
        replicas = node.get("replicas", [])
        if len(replicas) != len(obj._replicas):
            raise IncompatibleCheckpointError(
                f"{where}: checkpoint holds {len(replicas)} replicas, target has {len(obj._replicas)}"
            )
        _validate_metric(obj, node, where)
        for i, (r, sub) in enumerate(zip(obj._replicas, replicas)):
            _validate_metric(r, sub, f"{where}.replica[{i}]")
        return
    _validate_metric(obj, node, where)


def _as_tensor(v: np.ndarray) -> torch.Tensor:
    """A payload array as a CPU tensor over its memory (the unpickled node is not kept)."""
    if not (v.flags.c_contiguous and v.flags.writeable):
        v = np.array(v, order="C")  # keeps a 0-d array 0-d, as np.ascontiguousarray would not
    if v.dtype.name == "bfloat16":
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(v)


def _install_metric(m: Any, node: Dict[str, Any]) -> None:
    flat: Dict[str, Any] = {
        k: [_as_tensor(x) for x in v] if isinstance(v, list) else _as_tensor(v) for k, v in node["state"].items()
    }
    flat["_update_count"] = node["update_count"]
    # load_state_dict installs onto the metric's device and drops the compute cache
    m.load_state_dict(flat, strict=False)
    # no sync leftovers survive a restore
    m._is_synced = False
    m._cache = None


def _install(obj: Any, node: Dict[str, Any]) -> None:
    from metrics_tpu_torch.collections import MetricCollection

    if isinstance(obj, MetricCollection):
        for name, sub in node["members"].items():
            _install(obj._modules[name], sub)
        return
    from metrics_tpu_torch.wrappers.replicated import ReplicatedWrapper

    if isinstance(obj, ReplicatedWrapper):
        _install_metric(obj, node)
        for r, sub in zip(obj._replicas, node["replicas"]):
            _install_metric(r, sub)
        # a stale stacked layout (if any) was materialized during validation; the next engine dispatch
        # re-stacks from the restored replica states
        obj.__dict__["_stacked"] = None
        obj._engine_updates = 0
        return
    _install_metric(obj, node)


def restore_checkpoint(obj: Any, path: Union[str, os.PathLike]) -> Any:
    """Restore ``obj`` from a checkpoint written by :func:`save_checkpoint`.

    Fully reads and verifies the file (magic, version, CRCs, exact length) and
    validates every class name, config fingerprint and state aval against the
    live target BEFORE installing anything — a failure raises
    :class:`CorruptCheckpointError` / :class:`IncompatibleCheckpointError` and
    leaves ``obj`` as it was. Returns ``obj``. A StreamEngine target is restored in place by
    ``engine/durability.py``.
    """
    fleet = _as_fleet(obj)
    if fleet is not None:
        from metrics_tpu_torch.engine.durability import restore_fleet_checkpoint

        return restore_fleet_checkpoint(fleet, path)
    path = os.fspath(path)
    with _trace.span("ckpt", "restore"):
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError as exc:
            raise CheckpointError(f"{path}: cannot read checkpoint ({exc})") from exc
        node = _parse(blob, path)
        _validate(obj, node, _label(obj))
        _install(obj, node)
    _observe.note_checkpoint_restore(_label(obj), path)
    return obj


# ------------------------------------------------------------------ periodic snapshots
@dataclasses.dataclass(frozen=True)
class SnapshotPolicy:
    """When :class:`PeriodicCheckpointer.step` actually writes: after every
    ``every_n_updates`` accumulated steps, and/or every ``every_s`` seconds of
    wall clock — whichever fires first. Both ``None`` means manual-only."""

    every_n_updates: Optional[int] = 1000
    every_s: Optional[float] = None


class PeriodicCheckpointer:
    """Policy-driven snapshot loop for long-lived streams.

    Call :meth:`step` from the ingest loop after each update (or batch of
    updates); it saves according to the policy and is cheap when not due.
    Every save is atomic, so a preemption mid-save costs at most the interval
    since the previous snapshot.
    """

    def __init__(self, target: Any, path: Union[str, os.PathLike], policy: SnapshotPolicy = SnapshotPolicy()) -> None:
        self.target = target
        self.path = os.fspath(path)
        self.policy = policy
        self.saves = 0
        self._updates_since = 0
        self._last_save_t = time.monotonic()

    def step(self, n_updates: int = 1) -> bool:
        """Account ``n_updates`` more updates; snapshot if the policy says so."""
        self._updates_since += n_updates
        due_n = self.policy.every_n_updates is not None and self._updates_since >= self.policy.every_n_updates
        due_t = self.policy.every_s is not None and (time.monotonic() - self._last_save_t) >= self.policy.every_s
        if due_n or due_t:
            self.save()
            return True
        return False

    def save(self) -> str:
        out = save_checkpoint(self.target, self.path)
        self.saves += 1
        self._updates_since = 0
        self._last_save_t = time.monotonic()
        return out
