"""Request-lifecycle primitives for the serving engines (port of
``paddle_tpu/inference/lifecycle.py``).  Pure Python; imports no
backend, so statuses and errors stay importable anywhere.

* :class:`RequestStatus` — the request state machine: ``QUEUED`` →
  [``INSTALLING`` →] ``RUNNING`` → one **terminal** status (``DONE`` /
  ``FAILED`` / ``TIMEOUT`` / ``CANCELLED`` / ``REJECTED``); a terminal
  status never changes again.  ``INSTALLING`` is the host-tier
  reinstall state: the slot is reserved and a host-to-device copy of
  the request's cached prefix is in flight; the decode rounds go on,
  and admission completes when the copy has landed (a failed reinstall
  sends the request back to QUEUED, never to a terminal status).
* :class:`EngineState` — ``SERVING`` → ``DRAINING`` → ``STOPPED``.
  :data:`DRAIN_MODES` names the two drains: ``"retire"`` finishes or
  fails everything before stopping; ``"handoff"`` stops at a step
  boundary and parks every non-terminal request back in the queue,
  still QUEUED, for ``inference.handoff`` to carry to a successor.
* :class:`AdmissionQueue` — a bounded admission queue with an overload
  policy (``reject`` / ``shed-oldest`` / ``block``).
* :class:`CircuitBreaker` — opens after N consecutive device failures so
  a sick device fails requests fast; with a cooldown it lets ONE probe
  request through (half-open) and closes on its success.
* Error types: :class:`QueueFullError`, :class:`CircuitOpenError`,
  :class:`EngineClosedError`.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Iterable, Optional

__all__ = ["RequestStatus", "EngineState", "AdmissionQueue",
           "CircuitBreaker", "QueueFullError", "CircuitOpenError",
           "EngineClosedError", "OVERLOAD_POLICIES", "DRAIN_MODES", "now"]


def now() -> float:
    """Monotonic clock used for all timestamps and deadlines (never wall
    time)."""
    return time.monotonic()


class RequestStatus:
    """Per-request states (plain strings, so they serialize and compare
    without an import on the client side)."""
    QUEUED = "QUEUED"
    # slot reserved, the host-tier prefix reinstall in flight: RUNNING
    # when the copy lands, QUEUED again (re-prefill) if it fails
    INSTALLING = "INSTALLING"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    TIMEOUT = "TIMEOUT"
    CANCELLED = "CANCELLED"
    REJECTED = "REJECTED"

    TERMINAL = frozenset({DONE, FAILED, TIMEOUT, CANCELLED, REJECTED})


class EngineState:
    SERVING = "SERVING"
    DRAINING = "DRAINING"
    STOPPED = "STOPPED"


class QueueFullError(RuntimeError):
    """Admission queue at capacity under the ``reject`` (or timed-out
    ``block``) overload policy — the caller should back off or shed."""


class CircuitOpenError(RuntimeError):
    """The engine's circuit breaker is open: the device failed N
    consecutive times and new work is refused fast."""


class EngineClosedError(RuntimeError):
    """submit() after drain() — the engine no longer admits."""


OVERLOAD_POLICIES = ("reject", "shed-oldest", "block")

#: engine.drain(mode=...): "retire" finishes or fails everything before
#: stopping; "handoff" parks non-terminal requests back in the queue
#: for a successor engine
DRAIN_MODES = ("retire", "handoff")


class AdmissionQueue:
    """Bounded FIFO admission queue.

    :meth:`offer` enforces the bound; the deque surface the scheduler
    uses (``popleft``, ``[0]``, ``extendleft`` for re-queues of accepted
    work, ``remove`` for cancellation) bypasses it, so accepted work is
    never bounced.

    Overload policies:

    * ``reject`` — :meth:`offer` raises :class:`QueueFullError`;
    * ``shed-oldest`` — :meth:`offer` drops the oldest queued request and
      returns it (the engine marks it ``REJECTED``), admitting the new
      one;
    * ``block`` — handled by the engine: it runs scheduler iterations
      until space opens or its timeout expires, then raises
      :class:`QueueFullError`.
    """

    def __init__(self, maxsize: Optional[int] = None,
                 policy: str = "reject", label: Optional[str] = None):
        if policy not in OVERLOAD_POLICIES:
            raise ValueError(f"unknown overload policy {policy!r}; "
                             f"choose one of {OVERLOAD_POLICIES}")
        if maxsize is not None and maxsize < 1:
            raise ValueError(f"max_queue must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.policy = policy
        # owning engine's label, stamped into every rejection message
        self.label = label
        self.high_water = 0   # deepest the queue has ever been
        self._q: deque = deque()

    def context(self) -> str:
        """Queue state for error messages: depth/bound, policy and the
        owning engine's label."""
        bound = "unbounded" if self.maxsize is None else str(self.maxsize)
        eng = f", engine={self.label}" if self.label else ""
        return (f"{len(self._q)}/{bound} queued, "
                f"policy={self.policy!r}{eng}")

    def _mark(self):
        if len(self._q) > self.high_water:
            self.high_water = len(self._q)

    @property
    def full(self) -> bool:
        return self.maxsize is not None and len(self._q) >= self.maxsize

    def offer(self, req):
        """Admit ``req`` under the bound.  Returns the shed request under
        ``shed-oldest`` (the caller marks it terminal), else None.  Raises
        :class:`QueueFullError` under ``reject`` and ``block`` (whose
        waiting loop lives in the engine)."""
        if not self.full:
            self._q.append(req)
            self._mark()
            return None
        if self.policy == "shed-oldest":
            shed = self._q.popleft()
            self._q.append(req)
            self._mark()
            return shed
        raise QueueFullError(f"admission queue full ({self.context()})")

    # -- deque surface used by the scheduler ---------------------------------
    def appendleft(self, req):
        self._q.appendleft(req)
        self._mark()

    def extendleft(self, reqs: Iterable):
        """Like ``deque.extendleft``: the LAST item ends up in front."""
        self._q.extendleft(reqs)
        self._mark()

    def popleft(self):
        return self._q.popleft()

    def remove(self, req):
        self._q.remove(req)

    def __getitem__(self, i):
        return self._q[i]

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        return iter(self._q)


class CircuitBreaker:
    """Open after ``threshold`` CONSECUTIVE failures; any success resets
    the count.

    While open, the engine fails queued and new requests fast with the
    breaker's :attr:`reason` instead of running every request through
    the retry ladder against a device that is down.  :meth:`reset`
    (operator action) closes it again.

    ``cooldown_seconds`` (None: manual reset only) arms automatic
    recovery: once the breaker has been open that long,
    :meth:`should_probe` admits exactly ONE request (half-open).  Its
    device success closes the breaker (:meth:`record_success`); its
    failure re-opens it and re-arms the cooldown.

    ``on_transition`` (a callable taking True on open, False on close)
    is the telemetry seam.  ``label`` names the owning engine in
    :attr:`reason`.

    Flap accounting: a flap is a completed open → close → open cycle.
    Each is stamped into a sliding ``flap_window``-second ring:
    :meth:`flap_count` counts those inside the window, :meth:`flap_rate`
    divides by the window; ``flaps_total`` and ``open_count`` are the
    lifetime totals."""

    def __init__(self, threshold: int = 5,
                 cooldown_seconds: Optional[float] = None,
                 label: Optional[str] = None,
                 flap_window: float = 300.0):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, "
                             f"got {threshold}")
        if cooldown_seconds is not None and cooldown_seconds < 0:
            raise ValueError(f"cooldown_seconds must be >= 0 or None, "
                             f"got {cooldown_seconds}")
        if flap_window <= 0:
            raise ValueError(f"flap_window must be > 0, "
                             f"got {flap_window}")
        self.threshold = int(threshold)
        self.cooldown_seconds = (None if cooldown_seconds is None
                                 else float(cooldown_seconds))
        self.label = label
        self.flap_window = float(flap_window)
        self.failures = 0          # consecutive
        self.total_failures = 0
        self.open = False
        self.half_open = False     # ONE probe in flight
        self.opened_at: Optional[float] = None
        self.probes = 0            # half-open probes admitted (lifetime)
        self.last_error: Optional[str] = None
        self.on_transition = None  # callable(bool) | None
        self.open_count = 0        # closed → open edges (lifetime)
        self.flaps_total = 0       # open → close → open cycles (lifetime)
        self._closed_after_open = False   # an open episode has ended
        self._flaps: deque = deque()      # flap stamps in flap_window

    def _open(self) -> bool:
        """Go open (re-arming the cooldown clock); True only on the
        closed → open edge."""
        was = self.open
        self.open = True
        self.half_open = False
        self.opened_at = now()
        if was:
            return False
        self.open_count += 1
        if self._closed_after_open:
            # re-opening after a recovery completes a flap
            self.flaps_total += 1
            self._flaps.append(self.opened_at)
            self._prune_flaps(self.opened_at)
        if self.on_transition is not None:
            self.on_transition(True)
        return True

    def _prune_flaps(self, t: float) -> None:
        while self._flaps and t - self._flaps[0] > self.flap_window:
            self._flaps.popleft()

    def flap_count(self) -> int:
        """Completed open → close → open cycles inside the sliding
        ``flap_window``."""
        self._prune_flaps(now())
        return len(self._flaps)

    def flap_rate(self) -> float:
        """:meth:`flap_count` over ``flap_window``: flaps a second."""
        return self.flap_count() / self.flap_window

    def record_failure(self, err: BaseException) -> bool:
        """Count a device failure; True when this failure OPENS the
        breaker (the transition, not the steady state).  A failure while
        half-open (the probe died) re-arms the cooldown without a
        transition."""
        self.failures += 1
        self.total_failures += 1
        self.last_error = repr(err)
        if self.open:
            if self.half_open:
                self._open()   # the probe failed: re-arm, stay open
            return False
        if self.failures >= self.threshold:
            return self._open()
        return False

    def trip(self, err: BaseException) -> bool:
        """Force the breaker open whatever the consecutive count; True
        on the open transition."""
        self.last_error = repr(err)
        return self._open()

    def should_probe(self) -> bool:
        """One-shot half-open gate: True exactly once a cooldown window,
        flipping the breaker to half-open — the caller admits that one
        request as the recovery probe."""
        if not self.probe_due():
            return False
        self.half_open = True
        self.probes += 1
        return True

    def probe_due(self) -> bool:
        """Read-only: would :meth:`should_probe` admit a probe now?"""
        return (self.open and not self.half_open
                and self.cooldown_seconds is not None
                and self.opened_at is not None
                and now() - self.opened_at >= self.cooldown_seconds)

    def record_success(self):
        self.failures = 0
        if self.open and self.half_open:
            self.reset()   # the probe came back: close
        elif not self.open:
            self.last_error = None

    def reset(self):
        was_open = self.open
        self.failures = 0
        self.open = False
        self.half_open = False
        self.opened_at = None
        self.last_error = None
        if was_open:
            # an open episode ended: the NEXT open completes a flap
            self._closed_after_open = True
            if self.on_transition is not None:
                self.on_transition(False)

    @property
    def reason(self) -> str:
        eng = f" on {self.label}" if self.label else ""
        if self.cooldown_seconds is None:
            heal = "manual reset_circuit() required"
        else:
            heal = ("half-open probe in flight" if self.half_open
                    else f"probe after {self.cooldown_seconds}s cooldown")
        return (f"circuit breaker open{eng} after {self.failures} "
                f"consecutive device failures (last: {self.last_error}; "
                f"{heal})")
