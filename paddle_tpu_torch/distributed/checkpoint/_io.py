"""Checkpoint byte-level IO (port of
``paddle_tpu/distributed/checkpoint/_io.py``): the one chokepoint every
checkpoint file write goes through.

* Durability: :meth:`CheckpointIO.write_file` stages to ``<path>.part``,
  writes in bounded chunks, fsyncs the file, then ``os.replace``-s it
  into place and fsyncs the parent directory: a crash at any syscall
  leaves either no visible file or the whole one.
* Fault injection: ``paddle_tpu_torch.testing.faults.FaultyIO``
  subclasses this and overrides the per-chunk ``_write`` to crash at the
  Nth syscall, truncate, fail transiently or stall; :func:`set_io`
  swaps the active instance.

Bytes durably written are counted in the plain counter
``STATS["bytes_written"]`` (JAX's registry counter
``checkpoint_bytes_written_total`` waits for the observability port).
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["CheckpointIO", "get_io", "set_io", "STATS"]

# chunked writes make "crash at the Nth write syscall" a meaningful
# injection point; 1 MiB keeps the syscall overhead negligible
WRITE_CHUNK = 1 << 20

#: bytes published by write_file (counted after the atomic rename only)
STATS = {"bytes_written": 0}


class CheckpointIO:
    """Crash-consistent file IO: stage, fsync, rename, fsync the
    directory."""

    def _write(self, f, chunk: bytes) -> None:
        """One write syscall: the fault-injection override point."""
        f.write(chunk)

    def write_file(self, path: str, data: bytes) -> None:
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            if data:
                for i in range(0, len(data), WRITE_CHUNK):
                    self._write(f, data[i:i + WRITE_CHUNK])
            else:
                self._write(f, b"")
            f.flush()
            os.fsync(f.fileno())
        self.replace(tmp, path)
        # counted only after the publish: a torn write never inflates it
        STATS["bytes_written"] += len(data)

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
