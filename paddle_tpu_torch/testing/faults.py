"""Fault injection for the serving engines and the checkpoint IO
layer (port of ``paddle_tpu/testing/faults.py``: ``FaultInjected``,
``FaultyIO``, ``inject_io``, ``EngineFaultInjector`` and
``inject_engine_faults``).

Every device call of an engine lands in ``engine._device_invoke`` — one
override point — and :func:`inject_engine_faults` patches it, so a test
can make device calls fail N times then succeed (the retry policy), fail
always (quarantine and the circuit breaker) or stall (the watchdog's
step deadline), deterministically and by call kind; ``defer_ready``
patches the engine's ``_install_ready`` poll, the slow host-to-device
copy of the tiered cache's reinstall.  :class:`TrainStepFaultInjector`
(:func:`wrap_train_step`) does the same for a train step callable, the
one ``TrainLoop`` drives.

The handoff's bundle bytes go through
``distributed.checkpoint._io.CheckpointIO._write``: :func:`inject_io`
installs a :class:`FaultyIO` that crashes at the Nth write syscall
(:class:`FaultInjected`, a BaseException, so ``except Exception`` in the
save path cannot absorb it: the disk is left as a kill at that syscall
leaves it), truncates, fails transiently or stalls; the training
checkpoints go through the same layer.  (``FlakyFS`` and the store fakes
of the JAX module come with the modules they test.)
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional, Type

from ..distributed.checkpoint._io import CheckpointIO, set_io

__all__ = ["FaultInjected", "FaultyIO", "inject_io", "EngineFaultInjector",
           "inject_engine_faults", "TrainStepFaultInjector",
           "wrap_train_step"]


class FaultInjected(BaseException):
    """A simulated hard crash (kill at a syscall).  Not an Exception
    subclass: the save path cannot catch it, so the disk state when it
    escapes is the disk state after a SIGKILL."""


class FaultyIO(CheckpointIO):
    """A CheckpointIO whose per-chunk ``_write`` misbehaves on schedule.
    Write syscalls are counted from 1 across all files (only paths
    containing ``match``, when it is given):

    * ``crash_at_write=N`` — the Nth write (and every later one) raises
      :class:`FaultInjected`;
    * ``truncate_at_write=N`` — the Nth write keeps half its chunk and
      later writes to that file are lost: a torn write that looks
      successful, caught only by the manifest;
    * ``fail_times=K`` — the first K writes raise ``fail_exc``;
    * ``slow_write=seconds`` — every write sleeps first."""

    def __init__(self, crash_at_write: Optional[int] = None,
                 truncate_at_write: Optional[int] = None,
                 fail_times: int = 0,
                 fail_exc: Type[BaseException] = OSError,
                 slow_write: float = 0.0, match: Optional[str] = None):
        self.crash_at_write = crash_at_write
        self.truncate_at_write = truncate_at_write
        self.fail_times = int(fail_times)
        self.fail_exc = fail_exc
        self.slow_write = float(slow_write)
        self.match = match
        self.writes = 0            # matching write syscalls seen
        self.injected = 0          # faults fired
        self._truncating = set()   # files past their torn write
        self._lock = threading.Lock()

    def _write(self, f, chunk: bytes) -> None:
        if self.match is not None and self.match not in getattr(
                f, "name", ""):
            f.write(chunk)
            return
        with self._lock:
            self.writes += 1
            n = self.writes
        if self.slow_write:
            time.sleep(self.slow_write)
        if n <= self.fail_times:
            self.injected += 1
            raise self.fail_exc(f"injected transient failure (write #{n})")
        if self.crash_at_write is not None and n >= self.crash_at_write:
            self.injected += 1
            raise FaultInjected(f"injected crash at write #{n}")
        if id(f) in self._truncating:
            return  # the rest of this file's bytes are lost
        if self.truncate_at_write is not None and \
                n >= self.truncate_at_write:
            self.injected += 1
            f.write(chunk[:max(0, len(chunk) // 2)])
            self._truncating.add(id(f))
            return
        f.write(chunk)


@contextlib.contextmanager
def inject_io(**kwargs):
    """Install a :class:`FaultyIO` as the checkpoint IO layer for the
    scope; yields it and restores the previous layer whatever
    escaped."""
    io = FaultyIO(**kwargs)
    prev = set_io(io)
    try:
        yield io
    finally:
        set_io(prev)


class EngineFaultInjector:
    """Schedules device-call failures for a serving engine.

    Per-kind knobs (``kind`` is ``"prefill"``, ``"decode"``,
    ``"prefix"`` — the prefix cache's install and suffix calls —,
    ``"draft"`` — a model draft's prefill and proposal —, ``"verify"``,
    ``"demote"`` and ``"reinstall"`` — the host tier's copies out and
    back —, ``"snapshot"`` and ``"restore"`` — the handoff's span export
    and install; restrict with ``kinds``):

    * ``fail_times=K`` — the first K matching calls raise ``fail_exc``
      BEFORE the device call runs, then calls pass through;
    * ``fail_after_times=K`` — the first K matching calls raise AFTER
      the device call ran, its result discarded (JAX: the donated-buffer
      loss case; the port writes its caches in place, so the retry runs
      the call again on unchanged host state);
    * ``fail_always=True`` — every matching call raises;
    * ``stall=seconds`` — every matching call sleeps first, then
      proceeds (with an engine ``step_timeout`` below the stall, the
      watchdog deadline fires);
    * ``defer_ready=N`` — the slow host-to-device copy: the first N
      ``_install_ready`` polls report the reinstall still in flight, so
      the request stays INSTALLING for N scheduler rounds while the
      decode rounds go on (past the engine's ``install_timeout`` it
      falls back to re-prefill).

    Counters: ``calls`` / ``injected`` are per-kind dicts; ``deferred``
    counts the polls answered not ready.
    """

    def __init__(self, fail_times: int = 0, fail_always: bool = False,
                 fail_after_times: int = 0, stall: float = 0.0,
                 defer_ready: int = 0,
                 fail_exc: Type[BaseException] = OSError,
                 kinds=("prefill", "decode", "prefix", "draft", "verify",
                        "demote", "reinstall", "snapshot", "restore")):
        self.fail_times = int(fail_times)
        self.fail_always = bool(fail_always)
        self.fail_after_times = int(fail_after_times)
        self.stall = float(stall)
        self.defer_ready = int(defer_ready)
        self.fail_exc = fail_exc
        self.kinds = tuple(kinds)
        self.calls: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        self.deferred = 0

    def defer(self) -> bool:
        """The readiness-poll gate: True while the injected slow copy
        still has the reinstall in flight."""
        if self.deferred < self.defer_ready:
            self.deferred += 1
            return True
        return False

    def before(self, kind: str):
        """Called before the real device call; raises or stalls per the
        schedule."""
        if kind not in self.kinds:
            return
        n = self.calls.get(kind, 0) + 1
        self.calls[kind] = n
        if self.stall:
            time.sleep(self.stall)
        if self.fail_always or n <= self.fail_times:
            self.injected[kind] = self.injected.get(kind, 0) + 1
            raise self.fail_exc(
                f"injected device fault ({kind} call #{n})")

    def after(self, kind: str):
        """Called after the real device call completed; raises per the
        ``fail_after_times`` schedule (the result is then discarded)."""
        if kind not in self.kinds:
            return
        n = self.calls.get(kind, 0)
        if n <= self.fail_after_times:
            self.injected[kind] = self.injected.get(kind, 0) + 1
            raise self.fail_exc(
                f"injected post-execution device fault "
                f"({kind} call #{n})")


class TrainStepFaultInjector:
    """Schedules failures of a train step callable: :meth:`wrap` returns
    a step whose scheduled calls raise ``OSError`` before the real step
    runs (the loop's contract under test: the error names the right
    step index and the loop drains).

    * ``fail_at=N`` — the Nth call (1-based) raises, later calls pass;
    * ``fail_times=K`` — the first K calls raise, then calls pass.

    Counters ``calls`` and ``injected``."""

    def __init__(self, fail_at: Optional[int] = None, fail_times: int = 0):
        self.fail_at = fail_at
        self.fail_times = int(fail_times)
        self.calls = 0
        self.injected = 0

    def wrap(self, step_fn):
        def faulty(*args, **kwargs):
            self.calls += 1
            n = self.calls
            if n <= self.fail_times or n == self.fail_at:
                self.injected += 1
                raise OSError(
                    f"injected train-step device fault (call #{n})")
            return step_fn(*args, **kwargs)

        return faulty


def wrap_train_step(step_fn, **kwargs):
    """Returns (faulty step_fn, its :class:`TrainStepFaultInjector`)."""
    inj = TrainStepFaultInjector(**kwargs)
    return inj.wrap(step_fn), inj


@contextlib.contextmanager
def inject_engine_faults(engine, **kwargs):
    """Patch ``engine._device_invoke`` (and with ``defer_ready``,
    ``engine._install_ready``) with an :class:`EngineFaultInjector` for
    the scope; yields the injector and restores the engine on exit
    whatever escaped."""
    inj = EngineFaultInjector(**kwargs)
    orig = engine._device_invoke

    def faulty(kind, fn, *args, **kw):
        inj.before(kind)
        out = orig(kind, fn, *args, **kw)
        inj.after(kind)
        return out

    engine._device_invoke = faulty
    if inj.defer_ready:
        orig_ready = engine._install_ready

        def slow_ready(job):
            if inj.defer():
                return False
            return orig_ready(job)

        engine._install_ready = slow_ready
    try:
        yield inj
    finally:
        engine.__dict__.pop("_device_invoke", None)
        engine.__dict__.pop("_install_ready", None)
