"""Crash-consistent file writes (counterpart of ``metrics_tpu/utils/io.py``), used by checkpointing.

The contract: a reader at any instant sees either the complete old
file or the complete new file, never a truncated mix. Achieved the classic way —
write a sibling temp file, flush+fsync it, then atomically ``os.replace`` over
the destination, and fsync the directory so the rename itself is durable.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable, Union

__all__ = ["atomic_write_bytes", "atomic_write_chunks", "atomic_write_text", "fsync_directory"]


def fsync_directory(directory: str) -> None:
    """fsync a directory so a just-completed rename inside it is durable."""
    try:
        dir_fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds: the data fsync already ran
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def atomic_write_chunks(path: Union[str, os.PathLike], chunks: Iterable[bytes], fsync: bool = True) -> int:
    """Atomically replace ``path`` with the concatenation of ``chunks``.

    The streaming sibling of :func:`atomic_write_bytes`: chunks are written one
    by one, so a multi-part payload (checkpoint framing + per-bucket pickles)
    never has to be concatenated into one giant host buffer first. The temp
    file lives in the destination directory (``os.replace`` must not cross
    filesystems) and is unlinked on any failure, so a crashed writer never
    leaves a partial file under the real name. Returns the bytes written.
    """
    path = os.fspath(path)
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", suffix=".tmp", dir=directory)
    written = 0
    try:
        with os.fdopen(fd, "wb") as fh:
            for chunk in chunks:
                fh.write(chunk)
                written += len(chunk)
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        fsync_directory(directory)
    return written


def atomic_write_bytes(path: Union[str, os.PathLike], payload: bytes, fsync: bool = True) -> None:
    """Atomically replace ``path`` with ``payload`` (one-chunk convenience)."""
    atomic_write_chunks(path, (payload,), fsync=fsync)


def atomic_write_text(path: Union[str, os.PathLike], text: str, fsync: bool = True) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), fsync=fsync)
