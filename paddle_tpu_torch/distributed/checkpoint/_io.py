"""Checkpoint byte-level IO (port of
``paddle_tpu/distributed/checkpoint/_io.py``): the one chokepoint every
checkpoint file write goes through.

* Durability: :meth:`CheckpointIO.write_file` stages to ``<path>.part``,
  writes in bounded chunks, fsyncs the file, then ``os.replace``-s it
  into place and fsyncs the parent directory: a crash at any syscall
  leaves either no visible file or the whole one.
  :meth:`CheckpointIO.staged` is the same for a file written in pieces
  (a pickle streamed into it): its :class:`ChunkWriter` cuts the stream
  into the same chunks and hashes it on the way.
* Fault injection: ``paddle_tpu_torch.testing.faults.FaultyIO``
  subclasses this and overrides the per-chunk ``_write`` to crash at the
  Nth syscall, truncate, fail transiently or stall; :func:`set_io`
  swaps the active instance.

Bytes durably written are counted in the plain counter
``STATS["bytes_written"]`` (JAX's registry counter
``checkpoint_bytes_written_total`` waits for the observability port).
"""
from __future__ import annotations

import contextlib
import hashlib
import os
from typing import Optional

__all__ = ["CheckpointIO", "ChunkWriter", "get_io", "set_io", "STATS"]

# chunked writes make "crash at the Nth write syscall" a meaningful
# injection point; 1 MiB keeps the syscall overhead negligible
WRITE_CHUNK = 1 << 20

#: bytes published by write_file (counted after the atomic rename only)
STATS = {"bytes_written": 0}


class ChunkWriter:
    """The file-like of one staged file: what is written reaches
    ``io._write`` in WRITE_CHUNK pieces cut at the offsets a whole-blob
    write would cut (every piece full but the last), without copying a
    large buffer; the bytes are counted and hashed (SHA-256) as they
    pass.  An empty file is one empty write."""

    def __init__(self, io: "CheckpointIO", f):
        self._io, self._f = io, f
        self._carry = bytearray()
        self.sha256 = hashlib.sha256()
        self.nbytes = 0

    def write(self, data) -> int:
        view = memoryview(data).cast("B")
        n = len(view)
        self.nbytes += n
        i = 0
        if self._carry:
            i = min(n, WRITE_CHUNK - len(self._carry))
            self._carry += view[:i]
            if len(self._carry) == WRITE_CHUNK:
                self._flush()
        while n - i >= WRITE_CHUNK:
            # each chunk hashed just before its write, while it is cached
            self._emit(view[i:i + WRITE_CHUNK])
            i += WRITE_CHUNK
        if i < n:
            self._carry += view[i:]
        return n

    def _emit(self, chunk) -> None:
        self.sha256.update(chunk)
        self._io._write(self._f, chunk)

    def _flush(self) -> None:
        self._emit(bytes(self._carry))
        self._carry.clear()

    def close(self) -> None:
        if self._carry or not self.nbytes:
            self._flush()

    def digest(self) -> dict:
        """The manifest's record of the bytes written."""
        return {"bytes": self.nbytes, "sha256": self.sha256.hexdigest()}


class CheckpointIO:
    """Crash-consistent file IO: stage, fsync, rename, fsync the
    directory."""

    def _write(self, f, chunk) -> None:
        """One write syscall: the fault-injection override point."""
        f.write(chunk)

    @contextlib.contextmanager
    def staged(self, path: str):
        """A :class:`ChunkWriter` onto ``<path>.part``; when the block
        ends cleanly the file is fsynced and published at ``path``."""
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            w = ChunkWriter(self, f)
            yield w
            w.close()
            f.flush()
            os.fsync(f.fileno())
        self.replace(tmp, path)
        # counted only after the publish: a torn write never inflates it
        STATS["bytes_written"] += w.nbytes

    def write_file(self, path: str, data: bytes) -> None:
        with self.staged(path) as w:
            w.write(data)

    def read_file(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def replace(self, src: str, dst: str) -> None:
        """Atomic publish: rename, then fsync the parent directory (the
        rename is durable only once the directory entry is)."""
        os.replace(src, dst)
        self.fsync_dir(os.path.dirname(os.path.abspath(dst)))

    def fsync_dir(self, path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
        except OSError:  # pragma: no cover - a file system without dir fds
            return
        try:
            os.fsync(fd)
        except OSError:  # pragma: no cover
            pass
        finally:
            os.close(fd)


_io: CheckpointIO = CheckpointIO()


def get_io() -> CheckpointIO:
    return _io


def set_io(io: Optional[CheckpointIO]) -> CheckpointIO:
    """Install ``io`` as the active layer (None restores the default);
    returns the previous instance."""
    global _io
    prev = _io
    _io = io if io is not None else CheckpointIO()
    return prev
