"""Async training dispatch: bounded in-flight steps, deferred losses
(port of ``paddle_tpu/jit/loop.py``: ``DeferredScalar``,
``TrainStepError``, ``ElasticInterrupt``, ``TrainLoop``, the host-sync
counter and hooks, ``synchronous`` and ``maybe_enable_compile_cache``).

PyTorch launches CUDA work asynchronously, as JAX dispatches.  A loss
stays a device tensor until something reads it: :class:`DeferredScalar`
is its lazy host view, and each read is one counted host sync
(:func:`host_sync_count`, and every hook of :func:`add_host_sync_hook`).
:class:`TrainLoop` keeps at most ``max_inflight`` steps outstanding:
admitting a step records a CUDA event after its loss, and when too many
are pending the loop waits on the oldest step's event — a completion
wait in place of JAX's ``block_until_ready``, never a readback.  Losses
are bit-identical to a synchronous loop; only when the host learns them
changes.  :func:`synchronous` makes every loss materialize when it is
made (the parity baseline and a debugging aid).

An ``interrupt_check`` (a preemption guard's ``should_save``) is polled
once per admitted step; when it fires the loop drains and raises
:class:`ElasticInterrupt` at a clean step boundary.

Instrumentation: JAX's registry histogram ``train_dispatch_stall_
seconds`` and gauge ``train_inflight_steps`` are plain fields of the
loop, reported by :meth:`TrainLoop.stats`; its flight events and
postmortem bundles are ``logging`` records (logger
``paddle_tpu_torch.train``) until the observability port.

The persistent compilation cache: the port compiles no XLA programs; what
a process builds is its CUDA kernel libraries, so
:func:`maybe_enable_compile_cache` (env ``PT_COMPILE_CACHE_DIR``) points
the kernel build cache at a directory that outlives the process.  CUDA
graphs (``inference/programs.py``) have no persistent form: each process
captures its own.
"""
from __future__ import annotations

import contextlib
import logging
import numbers
import os
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional

import torch

__all__ = ["DeferredScalar", "TrainLoop", "TrainStepError",
           "ElasticInterrupt",
           "host_sync_count", "record_host_sync", "reset_host_syncs",
           "add_host_sync_hook", "remove_host_sync_hook", "synchronous",
           "maybe_enable_compile_cache", "Histogram"]

_logger = logging.getLogger("paddle_tpu_torch.train")

#: the environment variable of the kernel build cache's directory
COMPILE_CACHE_ENV = "PT_COMPILE_CACHE_DIR"

_sync_lock = threading.Lock()
_HOST_SYNCS = 0
_SYNC_HOOKS: List[Callable[[], None]] = []
_SYNC_MODE = 0  # > 0: DeferredScalar materializes at construction


def record_host_sync() -> None:
    """Count one loss readback (device scalar -> host float) and run the
    host-sync hooks."""
    global _HOST_SYNCS
    with _sync_lock:
        _HOST_SYNCS += 1
        hooks = list(_SYNC_HOOKS)
    for h in hooks:
        h()


def host_sync_count() -> int:
    with _sync_lock:
        return _HOST_SYNCS


def reset_host_syncs() -> int:
    """Zero the counter; returns the previous value (test isolation)."""
    global _HOST_SYNCS
    with _sync_lock:
        prev, _HOST_SYNCS = _HOST_SYNCS, 0
    return prev


def add_host_sync_hook(fn: Callable[[], None]) -> None:
    """Call ``fn()`` at every counted host sync."""
    with _sync_lock:
        _SYNC_HOOKS.append(fn)


def remove_host_sync_hook(fn: Callable[[], None]) -> None:
    with _sync_lock:
        if fn in _SYNC_HOOKS:
            _SYNC_HOOKS.remove(fn)


@contextlib.contextmanager
def synchronous():
    """Every loss made while the context is active materializes at once
    (one counted readback a step): the old per-step behaviour, the
    parity baseline for async-vs-sync tests, and a debugging aid (an
    error surfaces at the step that made it)."""
    global _SYNC_MODE
    with _sync_lock:
        _SYNC_MODE += 1
    try:
        yield
    finally:
        with _sync_lock:
            _SYNC_MODE -= 1


def _sync_mode_on() -> bool:
    return _SYNC_MODE > 0


class Histogram:
    """A plain histogram of seconds (JAX's registry histogram until the
    observability port): ``observe(x)``; ``summary()`` -> count, sum,
    max and the cumulative count at or below each bucket bound."""

    BOUNDS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
              5.0, 10.0)

    def __init__(self):
        self.count, self.sum, self.max = 0, 0.0, 0.0
        self._le = [0] * len(self.BOUNDS)

    def observe(self, x: float) -> None:
        self.count += 1
        self.sum += x
        self.max = max(self.max, x)
        for i, b in enumerate(self.BOUNDS):
            if x <= b:
                self._le[i] += 1

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum, "max": self.max,
                "buckets": dict(zip(self.BOUNDS, self._le))}


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
        if _sync_mode_on():
            self.value()

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


class ElasticInterrupt(RuntimeError):
    """The loop's ``interrupt_check`` fired (a preemption save-and-exit,
    a membership change): the loop has stopped at a CLEAN step boundary
    — every admitted step is complete (the loop drained before raising),
    so ``completed_steps`` is the exact checkpoint step and no in-flight
    work is orphaned."""

    def __init__(self, completed_steps: int, reason: str = ""):
        self.completed_steps = int(completed_steps)
        self.reason = str(reason)
        super().__init__(
            f"elastic interrupt after {completed_steps} completed "
            f"step(s)" + (f": {reason}" if reason else ""))


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
    :attr:`stall_seconds` and :attr:`stall_histogram`; the depth is
    :attr:`inflight` (JAX's in-flight gauge).

    ``interrupt_check`` is polled once per admitted step, after the
    bound; a truthy return drains the loop and raises
    :class:`ElasticInterrupt` with the number of completed steps."""

    def __init__(self, step_fn: Optional[Callable] = None,
                 max_inflight: int = 2,
                 interrupt_check: Optional[Callable[[], Any]] = None):
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}")
        self._step_fn = step_fn
        self._interrupt_check = interrupt_check
        self.max_inflight = int(max_inflight)
        self._pending: deque = deque()   # (step_index, event)
        self.steps = 0
        self.stall_seconds = 0.0
        self.stall_histogram = Histogram()

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
        if self._interrupt_check is not None:
            reason = self._interrupt_check()
            if reason:
                self.drain()
                _logger.warning("train loop interrupted after %d "
                                "completed step(s): %s", self.steps,
                                str(reason)[:200])
                raise ElasticInterrupt(self.steps, str(reason))
        return d

    def step(self, *args, **kwargs):
        """Dispatch one step through ``step_fn`` and admit its loss."""
        if self._step_fn is None:
            raise TypeError("TrainLoop built without step_fn; use admit()")
        try:
            out = self._step_fn(*args, **kwargs)
        except BaseException as e:
            idx = self.steps
            self.drain(raise_errors=False)
            raise self._step_failure(idx, e) from e
        if isinstance(out, tuple):
            return (self.admit(out[0]),) + out[1:]
        return self.admit(out)

    def _step_failure(self, idx: int, cause: BaseException
                      ) -> TrainStepError:
        """The TrainStepError of step ``idx``, with an error record (the
        JAX loop's flight event and postmortem); the loop has drained."""
        err = TrainStepError(idx, cause)
        _logger.error("train step %d failed: %r", idx, cause)
        return err

    def _wait_oldest(self) -> None:
        idx, event = self._pending.popleft()
        if event is None:           # a CPU loss is complete when admitted
            return
        t0 = time.monotonic()
        try:
            event.synchronize()
        except BaseException as e:
            self.drain(raise_errors=False)
            raise self._step_failure(idx, e) from e
        finally:
            dt = time.monotonic() - t0
            self.stall_seconds += dt
            self.stall_histogram.observe(dt)

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
                except BaseException:   # unwinding: the first error raised
                    pass

    sync = drain

    @property
    def inflight(self) -> int:
        return len(self._pending)

    def stats(self) -> dict:
        return {"steps": self.steps, "inflight": len(self._pending),
                "max_inflight": self.max_inflight,
                "stall_seconds": self.stall_seconds,
                "stall_histogram": self.stall_histogram.summary()}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.drain(raise_errors=exc_type is None)
        return False


# ---------------------------------------------------------------------------
# The kernel build cache across processes (PT_COMPILE_CACHE_DIR)
# ---------------------------------------------------------------------------

_compile_cache_dir: Optional[str] = None


def maybe_enable_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel build cache (``incubate/nn/kernels/_build.py``'s
    library directory) at ``path``, default the ``PT_COMPILE_CACHE_DIR``
    environment variable.  Libraries there stay keyed by the hash of
    their source and headers, so a process given a directory that an
    earlier process built into loads every library and runs no ``nvcc``
    (JAX's persistent XLA compilation cache; the port's only compiled
    artifacts are these libraries: CUDA graphs have no persistent form
    and are captured anew in each process).  Idempotent; returns the
    active directory, or None when none is set.  ``build_train_step``
    calls it before every build."""
    global _compile_cache_dir
    path = path or os.environ.get(COMPILE_CACHE_ENV, "")
    if not path:
        return _compile_cache_dir
    path = str(path)
    if path == _compile_cache_dir:
        return path
    from ..incubate.nn.kernels import _build
    _build.set_build_dir(path)
    _compile_cache_dir = path
    _logger.info("kernel build cache at %s", path)
    return path
