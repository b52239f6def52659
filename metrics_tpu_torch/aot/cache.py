"""The kernel-library build cache, with validated manifests (counterpart of ``metrics_tpu/aot/cache.py``).

The JAX package persists one compiled XLA executable per metric program. The port compiles no program per
class: its only persisted artifacts are the kernel libraries that :mod:`metrics_tpu_torch.ops._native`
builds from ``csrc/`` (``lib<name>-<hash of sources and flags>.so``). This module is the JAX package's cache
API over that build directory:

* :func:`cache_dir`/:func:`set_cache_dir` read and move ``_native.BUILD_DIR`` (the default is the package's
  ``_build/``, or the directory ``METRICS_TPU_TORCH_KERNEL_CACHE`` names when the process starts);
* :func:`store` writes, beside a built library, a CRC-framed *manifest* (``<digest>.aotx``) holding the
  library's name, size and sha256 and the :func:`environment_fingerprint` it was built under;
  :func:`read_entry` validates one before anything is loaded: damage (bad magic, CRC mismatch, wrong key,
  a library whose bytes no longer match) raises :class:`CorruptEntryError`, an intact manifest from another
  torch, CUDA, ``nvcc``, host compiler or card architecture raises :class:`StaleEntryError`;
* :func:`lookup` consults the manifest (``None`` on a miss, a stale or a corrupt entry, which is latched
  until the next :func:`store`); ``_native.build`` rebuilds every library whose lookup misses and stores its
  manifest, so this is the one check of whether a library is loaded; :func:`purge_cache` deletes libraries
  and manifests, :func:`cache_stats` counts them.

Entry file layout::

    MAGIC "MTKLB001"                        8 bytes
    header_len u32 | header_crc32 u32       big-endian frame
    header JSON                             format_version, key_digest, label, payload_len,
                                            payload_crc32, env {torch, cuda, nvcc, cxx, capability}
    payload                                 JSON {library, bytes, sha256}
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import subprocess
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.ops import _native
from metrics_tpu_torch.utils.io import atomic_write_chunks, fsync_directory

__all__ = [
    "AOTCacheError",
    "CorruptEntryError",
    "ENV_VAR",
    "FORMAT_VERSION",
    "MAGIC",
    "StaleEntryError",
    "cache_dir",
    "cache_stats",
    "entry_digest",
    "entry_path",
    "environment_fingerprint",
    "lookup",
    "purge_cache",
    "read_entry",
    "set_cache_dir",
    "store",
    "write_entry",
]

ENV_VAR = _native.CACHE_ENV_VAR
MAGIC = b"MTKLB001"
FORMAT_VERSION = 1
_FRAME = struct.Struct(">II")  # header_len, header_crc32
_SUFFIX = ".aotx"
# header fields that must match the running process for a library to be reused
_ENV_FIELDS = ("torch", "cuda", "nvcc", "cxx", "capability")


class AOTCacheError(Exception):
    """Base for cache entry problems."""


class CorruptEntryError(AOTCacheError):
    """The manifest or its library is damaged: bad magic, CRC or digest mismatch, undecodable parts."""


class StaleEntryError(AOTCacheError):
    """The manifest is intact but was written under another torch/CUDA/compiler/card."""


# digests known unusable in this process (stale or corrupt): lookups miss at once until the next store
_STALE_DIGESTS: set = set()
_ENV_FP: Optional[Dict[str, Any]] = None


def cache_dir() -> str:
    """The build directory the kernel libraries are built into and loaded from."""
    return str(_native.BUILD_DIR)


def set_cache_dir(path: Optional[os.PathLike]) -> None:
    """Build and load the kernel libraries in ``path`` from now on (``None``: the package's ``_build/``).
    Libraries already loaded stay loaded; the stale latch resets, since it described the old directory."""
    _native.BUILD_DIR = Path(os.fspath(path)) if path else _native.DEFAULT_BUILD_DIR
    _STALE_DIGESTS.clear()


def _tool_version(tool: str, line: int) -> Optional[str]:
    """One line of ``tool --version`` (g++ names its version first, nvcc its build last); None if it fails."""
    try:
        out = subprocess.run([tool, "--version"], capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[line] if lines else None


def environment_fingerprint() -> Dict[str, Any]:
    """What a built library depends on: torch's and CUDA's versions, ``nvcc``'s (None without one), the host
    compiler's (for the RLE codec) and the card's compute capability (None without a card). Read once per
    process."""
    global _ENV_FP
    if _ENV_FP is None:
        import torch

        try:
            nvcc: Optional[str] = _native._nvcc()
        except RuntimeError:
            nvcc = None
        cxx = shutil.which(os.environ.get("CXX") or "g++") or shutil.which("c++")
        capability = None
        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability(0)
            capability = f"{major}.{minor}"
        _ENV_FP = {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": _tool_version(nvcc, -1) if nvcc else None,
            "cxx": _tool_version(cxx, 0) if cxx else None,
            "capability": capability,
        }
    return dict(_ENV_FP)


def entry_digest(key: Any) -> str:
    """Content address of a cache key: sha256 over its repr (keys are built from primitives only, so the
    digest is stable across processes and equal to the JAX package's for the same key)."""
    return hashlib.sha256(repr(key).encode()).hexdigest()


def entry_path(digest: str, directory: Optional[str] = None) -> str:
    return os.path.join(directory if directory is not None else cache_dir(), digest + _SUFFIX)


def _library_key(name: str) -> Tuple[str, str, str]:
    return ("kernel-library", name, _native.library_path(name).name)


# ---------------------------------------------------------------- entry framing
def write_entry(path: str, key_digest: str, label: str, payload: bytes) -> int:
    """Atomically write one framed manifest; returns the bytes written."""
    header = {
        "format_version": FORMAT_VERSION,
        "key_digest": key_digest,
        "label": label,
        "payload_len": len(payload),
        "payload_crc32": zlib.crc32(payload) & 0xFFFFFFFF,
        "env": environment_fingerprint(),
    }
    header_bytes = json.dumps(header, sort_keys=True).encode()
    frame = _FRAME.pack(len(header_bytes), zlib.crc32(header_bytes) & 0xFFFFFFFF)
    return atomic_write_chunks(path, (MAGIC, frame, header_bytes, payload))


def read_entry(path: str, key_digest: str) -> Tuple[Dict[str, Any], bytes]:
    """Parse and fully validate one manifest: :class:`CorruptEntryError` for damage,
    :class:`StaleEntryError` for another environment; ``(header, payload)`` only when every check passed."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as exc:
        raise CorruptEntryError(f"unreadable entry: {exc}") from exc
    base = len(MAGIC) + _FRAME.size
    if len(data) < base or data[: len(MAGIC)] != MAGIC:
        raise CorruptEntryError("bad magic")
    header_len, header_crc = _FRAME.unpack_from(data, len(MAGIC))
    header_bytes = data[base: base + header_len]
    if len(header_bytes) != header_len or zlib.crc32(header_bytes) & 0xFFFFFFFF != header_crc:
        raise CorruptEntryError("header CRC mismatch")
    try:
        header = json.loads(header_bytes.decode())
    except (ValueError, UnicodeDecodeError) as exc:
        raise CorruptEntryError(f"undecodable header: {exc}") from exc
    version = header.get("format_version")
    if version != FORMAT_VERSION:
        raise StaleEntryError(f"format_version {version!r} != {FORMAT_VERSION}")
    if header.get("key_digest") != key_digest:
        raise CorruptEntryError("key digest mismatch (file renamed or hash collision)")
    payload = data[base + header_len:]
    if len(payload) != header.get("payload_len") or zlib.crc32(payload) & 0xFFFFFFFF != header.get("payload_crc32"):
        raise CorruptEntryError("payload CRC mismatch")
    env = header.get("env") or {}
    mine = environment_fingerprint()
    for field in _ENV_FIELDS:
        if env.get(field) != mine[field]:
            raise StaleEntryError(f"{field}: entry {env.get(field)!r} != process {mine[field]!r}")
    return header, payload


def _file_sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


# ----------------------------------------------------------------- cache traffic
def lookup(name: str) -> Optional[Path]:
    """The built library for ``csrc/<name>`` when its manifest validates and its bytes match, else None.

    Counts one of ``aot_hit``/``aot_miss``/``aot_stale`` per call; a stale or corrupt entry is latched so
    that later lookups miss without reading the file again."""
    digest = entry_digest(_library_key(name))
    if digest in _STALE_DIGESTS:
        _observe.note_aot_miss(name)
        return None
    path = entry_path(digest)
    lib = _native.library_path(name)
    if not os.path.exists(path) or not lib.exists():
        _observe.note_aot_miss(name)
        return None
    try:
        _header, payload = read_entry(path, digest)
        info = json.loads(payload.decode())
        if info.get("library") != lib.name or info.get("sha256") != _file_sha256(lib):
            raise CorruptEntryError("the library's bytes differ from its manifest")
    except AOTCacheError as exc:
        _STALE_DIGESTS.add(digest)
        _observe.note_aot_stale(name, str(exc) if isinstance(exc, StaleEntryError) else f"corrupt: {exc}")
        return None
    _observe.note_aot_hit(name)
    return lib


def has_manifest(name: str) -> bool:
    """Whether a manifest for the library of ``csrc/<name>`` exists in the build directory, valid or not."""
    return os.path.exists(entry_path(entry_digest(_library_key(name))))


def store(name: str) -> bool:
    """Write the manifest of the built library for ``csrc/<name>``; True on success (False when the library
    is not built). Overwrites a stale manifest and lifts its latch."""
    lib = _native.library_path(name)
    if not lib.exists():
        return False
    digest = entry_digest(_library_key(name))
    payload = json.dumps({"library": lib.name, "bytes": lib.stat().st_size, "sha256": _file_sha256(lib)},
                         sort_keys=True).encode()
    nbytes = write_entry(entry_path(digest), digest, name, payload)
    _STALE_DIGESTS.discard(digest)
    _observe.note_aot_store(name, nbytes)
    return True


def _owned(name: str) -> bool:
    return name.endswith(_SUFFIX) or (name.startswith("lib") and name.endswith(".so"))


def purge_cache(directory: Optional[str] = None) -> int:
    """Delete every built library and manifest in ``directory`` (default: the build directory); the number
    of files removed. Libraries already loaded stay mapped in this process."""
    d = directory if directory is not None else cache_dir()
    _STALE_DIGESTS.clear()
    if not os.path.isdir(d):
        return 0
    removed = 0
    for name in os.listdir(d):
        if _owned(name):
            try:
                os.unlink(os.path.join(d, name))
                removed += 1
            except OSError:
                pass
    fsync_directory(d)
    _observe.record_event("aot_purge", directory=d, removed=removed)
    return removed


def cache_stats(directory: Optional[str] = None) -> Dict[str, Any]:
    """Manifest and library counts and their total bytes on disk."""
    d = directory if directory is not None else cache_dir()
    out: Dict[str, Any] = {"directory": d, "entries": 0, "libraries": 0, "bytes": 0}
    if os.path.isdir(d):
        for name in os.listdir(d):
            if not _owned(name):
                continue
            out["entries" if name.endswith(_SUFFIX) else "libraries"] += 1
            try:
                out["bytes"] += os.path.getsize(os.path.join(d, name))
            except OSError:
                pass
    return out
