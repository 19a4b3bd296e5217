"""Request-lifecycle primitives for the serving engines (the parts of
``paddle_tpu/inference/lifecycle.py`` the port's engines use: the
status constants, the engine state, the two error types, and the
bounded admission queue with the ``reject`` overload policy and the
front re-queue the paged engine's evictions use).  Pure Python;
imports no backend."""
from __future__ import annotations

import time
from collections import deque
from typing import Iterable, Optional

__all__ = ["RequestStatus", "EngineState", "AdmissionQueue",
           "QueueFullError", "EngineClosedError", "now"]


def now() -> float:
    """Monotonic clock used for all request timestamps."""
    return time.monotonic()


class RequestStatus:
    """Per-request states (plain strings, so they serialize and compare
    without an import on the client side).  DONE ends a request that
    produced its tokens; FAILED one the livelock guard retired.  The
    JAX module's TIMEOUT / CANCELLED / REJECTED come with deadlines,
    cancellation and the other overload policies."""
    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"


class EngineState:
    SERVING = "SERVING"
    DRAINING = "DRAINING"
    STOPPED = "STOPPED"


class QueueFullError(RuntimeError):
    """Admission queue at capacity under the `reject` overload policy —
    the caller should back off or shed."""


class EngineClosedError(RuntimeError):
    """submit() after drain() — the engine no longer admits."""


class AdmissionQueue:
    """Bounded FIFO admission queue with the ``reject`` policy:
    :meth:`offer` raises :class:`QueueFullError` at the bound
    (``maxsize=None`` is unbounded).  :meth:`appendleft` and
    :meth:`extendleft` re-queue requests the engine already accepted
    (paged evictions, admissions the pool cannot back yet) and bypass
    the bound, so accepted work is never bounced."""

    def __init__(self, maxsize: Optional[int] = None):
        if maxsize is not None and maxsize < 1:
            raise ValueError(f"max_queue must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.high_water = 0   # deepest the queue has ever been
        self._q: deque = deque()

    @property
    def full(self) -> bool:
        return self.maxsize is not None and len(self._q) >= self.maxsize

    def offer(self, req) -> None:
        if self.full:
            raise QueueFullError(
                f"admission queue full ({len(self._q)}/{self.maxsize} "
                f"queued, policy='reject')")
        self._q.append(req)
        self.high_water = max(self.high_water, len(self._q))

    def appendleft(self, req) -> None:
        self._q.appendleft(req)
        self.high_water = max(self.high_water, len(self._q))

    def extendleft(self, reqs: Iterable) -> None:
        """Like ``deque.extendleft``: the LAST item ends up in front."""
        self._q.extendleft(reqs)
        self.high_water = max(self.high_water, len(self._q))

    def popleft(self):
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
