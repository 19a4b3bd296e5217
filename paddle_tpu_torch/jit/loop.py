"""Async training dispatch: bounded in-flight steps, deferred losses
(port of ``paddle_tpu/jit/loop.py``: ``DeferredScalar``,
``TrainStepError``, ``TrainLoop`` and the host-sync counter).

PyTorch launches CUDA work asynchronously, as JAX dispatches.  A loss
stays a device tensor until something reads it: :class:`DeferredScalar`
is its lazy host view, and each read is one counted host sync
(:func:`host_sync_count`).  :class:`TrainLoop` keeps at most
``max_inflight`` steps outstanding: admitting a step records a CUDA
event after its loss, and when too many are pending the loop waits on
the oldest step's event — a completion wait in place of JAX's
``block_until_ready``, never a readback.  Losses are bit-identical to a
synchronous loop; only when the host learns them changes.

Not ported yet: elastic interrupts, host-sync hooks, the metrics and
flight-recorder instrumentation, postmortems, and the persistent
compilation cache (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import numbers
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import torch

__all__ = ["DeferredScalar", "TrainLoop", "TrainStepError",
           "host_sync_count", "record_host_sync", "reset_host_syncs"]

_sync_lock = threading.Lock()
_HOST_SYNCS = 0


def record_host_sync() -> None:
    """Count one loss readback (device scalar -> host float)."""
    global _HOST_SYNCS
    with _sync_lock:
        _HOST_SYNCS += 1


def host_sync_count() -> int:
    with _sync_lock:
        return _HOST_SYNCS


def reset_host_syncs() -> int:
    """Zero the counter; returns the previous value (test isolation)."""
    global _HOST_SYNCS
    with _sync_lock:
        prev, _HOST_SYNCS = _HOST_SYNCS, 0
    return prev


class DeferredScalar:
    """Lazy host view of a device scalar (a training loss).

    Holds the tensor and converts it to a host float only when something
    reads it — ``float()``, ``item()``, a comparison or formatting.  The
    first read is one counted readback; later reads are free.
    Registered as a virtual :class:`numbers.Real`."""

    __slots__ = ("_raw", "_value", "step_index")

    def __init__(self, value: Any, step_index: Optional[int] = None):
        self._raw = value
        self._value: Optional[float] = None
        self.step_index = step_index

    @property
    def materialized(self) -> bool:
        return self._value is not None

    def value(self) -> float:
        if self._value is None:
            raw, self._raw = self._raw, None
            self._value = float(raw.item() if torch.is_tensor(raw)
                                else raw)
            record_host_sync()
        return self._value

    def __float__(self) -> float:
        return self.value()

    def __int__(self) -> int:
        return int(self.value())

    def item(self) -> float:
        return self.value()

    def __format__(self, spec: str) -> str:
        return format(self.value(), spec)

    def __eq__(self, other):
        try:
            return self.value() == float(other)
        except (TypeError, ValueError):
            return NotImplemented

    def __lt__(self, other):
        return self.value() < float(other)

    def __le__(self, other):
        return self.value() <= float(other)

    def __gt__(self, other):
        return self.value() > float(other)

    def __ge__(self, other):
        return self.value() >= float(other)

    def __hash__(self):
        return hash(self.value())

    def __repr__(self):
        if self._value is None:
            return "DeferredScalar(<pending>)"
        return f"DeferredScalar({self._value!r})"


numbers.Real.register(DeferredScalar)


class TrainStepError(RuntimeError):
    """A train step failed; ``step_index`` is the 0-based step whose
    work raised (at dispatch, or when the loop waited on it)."""

    def __init__(self, step_index: int, cause: BaseException):
        super().__init__(f"train step {step_index} failed: "
                         f"{type(cause).__name__}: {cause}")
        self.step_index = step_index


class TrainLoop:
    """Bounded async dispatch driver for a training loop.

    * governor only — the caller dispatches each step and hands its
      device loss to :meth:`admit`, which returns the
      :class:`DeferredScalar` and enforces the in-flight bound;
    * driver — built with ``step_fn``, :meth:`step` dispatches and
      admits (the loss is a bare return or the first element of a
      tuple, which gets the deferred handle in its place).

    A CUDA loss gets an event recorded on the current stream when it is
    admitted; the bound waits on the oldest event (``Event.synchronize``),
    which is not a readback and does not count as a host sync.  A CPU
    loss counts as in flight too, but is complete when admitted, so
    waiting on it returns at once.  Blocked time adds up in
    :attr:`stall_seconds`."""

    def __init__(self, step_fn: Optional[Callable] = None,
                 max_inflight: int = 2):
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}")
        self._step_fn = step_fn
        self.max_inflight = int(max_inflight)
        self._pending: deque = deque()   # (step_index, event)
        self.steps = 0
        self.stall_seconds = 0.0

    def admit(self, loss: Any) -> DeferredScalar:
        """Register one dispatched step's loss; blocks (completion wait)
        while more than ``max_inflight`` steps are outstanding."""
        idx = self.steps
        self.steps += 1
        if isinstance(loss, DeferredScalar):
            d = loss
            d.step_index = idx
        else:
            d = DeferredScalar(loss, step_index=idx)
        if not d.materialized:
            raw, event = d._raw, None
            if torch.is_tensor(raw) and raw.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(raw.device))
            self._pending.append((idx, event))
        while len(self._pending) > self.max_inflight:
            self._wait_oldest()
        return d

    def step(self, *args, **kwargs):
        """Dispatch one step through ``step_fn`` and admit its loss."""
        if self._step_fn is None:
            raise TypeError("TrainLoop built without step_fn; use admit()")
        try:
            out = self._step_fn(*args, **kwargs)
        except Exception as e:
            idx = self.steps
            self.drain(raise_errors=False)
            raise TrainStepError(idx, e) from e
        if isinstance(out, tuple):
            return (self.admit(out[0]),) + out[1:]
        return self.admit(out)

    def _wait_oldest(self) -> None:
        idx, event = self._pending.popleft()
        if event is None:           # a CPU loss is complete when admitted
            return
        t0 = time.monotonic()
        try:
            event.synchronize()
        except Exception as e:
            self.drain(raise_errors=False)
            raise TrainStepError(idx, e) from e
        finally:
            self.stall_seconds += time.monotonic() - t0

    def drain(self, raise_errors: bool = True) -> None:
        """Block until every in-flight step completed.  With
        ``raise_errors=False`` completion failures are swallowed — used
        while unwinding from an earlier error, so the loop always ends
        empty."""
        while self._pending:
            if raise_errors:
                self._wait_oldest()
            else:
                _, event = self._pending.popleft()
                try:
                    if event is not None:
                        event.synchronize()
                except Exception:   # unwinding: the first error is raised
                    pass

    @property
    def inflight(self) -> int:
        return len(self._pending)

    def stats(self) -> dict:
        return {"steps": self.steps, "inflight": len(self._pending),
                "max_inflight": self.max_inflight,
                "stall_seconds": self.stall_seconds}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.drain(raise_errors=exc_type is None)
        return False
