"""Background checkpointing with a bounded queue (port of
``paddle_tpu/distributed/checkpoint/async_save.py``:
``AsyncCheckpointer``).

:meth:`AsyncCheckpointer.save` snapshots the state in the caller's
thread and enqueues it; one worker thread commits it
(:func:`~.atomic.save_checkpoint`) under a ``distributed/watchdog.py``
deadline while training goes on.  The queue holds one save, so a slow
file system applies backpressure to the loop instead of stacking
snapshots in host memory.

The snapshot.  JAX arrays are immutable, so JAX's snapshot holds
references; the port's train step updates params and moments IN PLACE,
so the snapshot is a copy: each CUDA tensor is copied into pinned host
memory on a side stream that first waits for the current stream (the
step that made the values), an event is recorded after the copies, and
the current stream waits on that event — the next step's kernels are
queued at once but cannot overwrite a tensor before its copy is read.
The caller's thread does not block; the worker waits on the event before
it serializes.  CPU tensors are cloned.

The pinned copies go into one of two buffer sets that live as long as
the checkpointer: one is being committed while the other takes the next
snapshot, which is all the one-slot queue lets exist at once.  A set
keeps a buffer per leaf, made again only when the leaf's shape or dtype
changes, and a save takes the set freed last, so saves further apart
than a commit use one set and allocate pinned memory once.
:meth:`save` waits for a free set (the same backpressure as the queue).

Each commit's parts are kept in :attr:`spans` as (step, name, start,
end) on ``time.perf_counter``: "wait" (the snapshot's copies), the
parts of ``save_state_dict.SPANS``, and "commit" (the whole, the
publish and retention included).

A worker failure (a commit past its deadline included) is raised on the
next :meth:`save` or :meth:`drain`.  :meth:`save_lag` is the age of the
oldest save not yet committed (JAX's ``async_ckpt_save_lag_seconds``).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from .atomic import save_checkpoint
from .save_state_dict import SPANS

__all__ = ["AsyncCheckpointer"]

#: saves queued behind the one in flight
QUEUE_SIZE = 1
#: pinned snapshot buffer sets: the one committing and the one queued
BUFFER_SETS = QUEUE_SIZE + 1
#: commit parts kept in ``AsyncCheckpointer.spans`` (the newest)
SPANS_KEPT = 64

_logger = logging.getLogger("paddle_tpu_torch.checkpoint")


class AsyncCheckpointer:
    """Double-buffered background saves into an atomic step-dir root."""

    def __init__(self, root: str, keep_last_n: Optional[int] = None,
                 commit_timeout: float = 600.0):
        self.root = root
        self.keep_last_n = keep_last_n
        self.commit_timeout = float(commit_timeout)
        self._q: "queue.Queue" = queue.Queue(maxsize=QUEUE_SIZE)
        # pinned buffer sets ({leaf path: tensor}) free for a snapshot,
        # the one freed last on top
        self._free: "queue.LifoQueue" = queue.LifoQueue()
        for _ in range(BUFFER_SETS):
            self._free.put({})
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._pending_ts: "deque[float]" = deque()
        self._streams: Dict[torch.device, Any] = {}
        #: commits done, failures, and the last commit's seconds
        self.stats = {"commits": 0, "failures": 0, "commit_seconds": 0.0}
        self.spans: "deque[tuple]" = deque(maxlen=SPANS_KEPT)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def save_lag(self) -> float:
        """Seconds the oldest uncommitted save has been pending (0.0 when
        nothing is in flight)."""
        with self._lock:
            if not self._pending_ts:
                return 0.0
            return max(0.0, time.monotonic() - self._pending_ts[0])

    # -- producer side -----------------------------------------------------
    def save(self, state_dict: Dict[str, Any], step: int) -> None:
        """Snapshot ``state_dict`` and enqueue it for a background commit.
        Blocks while both buffer sets are taken, one committing and one
        queued (backpressure); raises an earlier background failure
        first."""
        self.check()
        bufs = self._free.get()
        try:
            snap, events = self._snapshot(state_dict, bufs)
        except BaseException:
            self._free.put(bufs)
            raise
        with self._lock:
            self._pending_ts.append(time.monotonic())
        self._q.put((snap, events, bufs, int(step)))

    def _side_stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def _snapshot(self, state_dict, bufs):
        """The enqueue-time copy: CUDA tensors into the pinned buffers of
        ``bufs`` on a side stream (returns the copies' events, one a
        device), others cloned."""
        events = {}
        side = {}

        def copy(v, path=()):
            if isinstance(v, dict):
                return {k: copy(x, path + (k,)) for k, x in v.items()}
            if isinstance(v, np.ndarray):
                return v.copy()
            if not torch.is_tensor(v):
                return v
            v = v.detach()
            if not v.is_cuda:
                return v.clone()
            dev = v.device
            if dev not in side:
                s = self._side_stream(dev)
                s.wait_stream(torch.cuda.current_stream(dev))
                side[dev] = s
            out = bufs.get(path)
            if out is None or out.shape != v.shape or out.dtype != v.dtype:
                out = bufs[path] = torch.empty(v.shape, dtype=v.dtype,
                                               pin_memory=True)
            with torch.cuda.stream(side[dev]):
                out.copy_(v, non_blocking=True)
            return out

        snap = copy(state_dict)
        for dev, s in side.items():
            ev = torch.cuda.Event()
            ev.record(s)
            # the next step's writes wait for the copies' reads
            torch.cuda.current_stream(dev).wait_event(ev)
            events[dev] = ev
        return snap, list(events.values())

    # -- worker side -------------------------------------------------------
    def _worker(self):
        from ..watchdog import watch
        while not self._stop.is_set():
            try:
                snap, events, bufs, step = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                t0 = time.perf_counter()
                with watch(f"ckpt_commit:step_{step}",
                           timeout=self.commit_timeout):
                    for ev in events:
                        ev.synchronize()
                    t1 = time.perf_counter()
                    save_checkpoint(snap, self.root, step,
                                    keep_last_n=self.keep_last_n)
                t2 = time.perf_counter()
                self.spans.extend([(step, "wait", t0, t1)]
                                  + [(step, *s) for s in SPANS]
                                  + [(step, "commit", t0, t2)])
                self.stats["commits"] += 1
                self.stats["commit_seconds"] = t2 - t0
            except BaseException as e:
                self.stats["failures"] += 1
                _logger.error("background checkpoint commit of step %d "
                              "failed: %r", step, e)
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                del snap
                self._free.put(bufs)
                with self._lock:
                    if self._pending_ts:
                        self._pending_ts.popleft()
                self._q.task_done()

    # -- flush / lifecycle -------------------------------------------------
    def check(self) -> None:
        """Raise the first background failure, if any."""
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def drain(self) -> None:
        """Block until every queued and in-flight save committed, then
        surface any failure (the preemption guard's flush)."""
        self._q.join()
        self.check()

    def close(self) -> None:
        """Drain, then stop the worker thread."""
        try:
            self.drain()
        finally:
            self._stop.set()
            self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
