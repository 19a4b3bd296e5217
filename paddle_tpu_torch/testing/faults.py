"""Device-fault injection for the serving engines (port of the engine
part of ``paddle_tpu/testing/faults.py``: ``EngineFaultInjector`` and
``inject_engine_faults``).

Every device call of an engine lands in ``engine._device_invoke`` — one
override point — and :func:`inject_engine_faults` patches it, so a test
can make device calls fail N times then succeed (the retry policy), fail
always (quarantine and the circuit breaker) or stall (the watchdog's
step deadline), deterministically and by call kind.  (The checkpoint IO
and store fakes of the JAX module come with the serving fleet; the
tiered cache's ``defer_ready`` with its reinstall path.)
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Type

__all__ = ["EngineFaultInjector", "inject_engine_faults"]


class EngineFaultInjector:
    """Schedules device-call failures for a serving engine.

    Per-kind knobs (``kind`` is ``"prefill"``, ``"decode"``,
    ``"prefix"`` — the prefix cache's install and suffix calls —,
    ``"draft"`` — a model draft's prefill and proposal — or
    ``"verify"``; restrict with ``kinds``):

    * ``fail_times=K`` — the first K matching calls raise ``fail_exc``
      BEFORE the device call runs, then calls pass through;
    * ``fail_after_times=K`` — the first K matching calls raise AFTER
      the device call ran, its result discarded (JAX: the donated-buffer
      loss case; the port writes its caches in place, so the retry runs
      the call again on unchanged host state);
    * ``fail_always=True`` — every matching call raises;
    * ``stall=seconds`` — every matching call sleeps first, then
      proceeds (with an engine ``step_timeout`` below the stall, the
      watchdog deadline fires).

    Counters: ``calls`` / ``injected`` are per-kind dicts.
    """

    def __init__(self, fail_times: int = 0, fail_always: bool = False,
                 fail_after_times: int = 0, stall: float = 0.0,
                 fail_exc: Type[BaseException] = OSError,
                 kinds=("prefill", "decode", "prefix", "draft", "verify")):
        self.fail_times = int(fail_times)
        self.fail_always = bool(fail_always)
        self.fail_after_times = int(fail_after_times)
        self.stall = float(stall)
        self.fail_exc = fail_exc
        self.kinds = tuple(kinds)
        self.calls: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

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


@contextlib.contextmanager
def inject_engine_faults(engine, **kwargs):
    """Patch ``engine._device_invoke`` with an
    :class:`EngineFaultInjector` for the scope; yields the injector and
    restores the engine on exit whatever escaped."""
    inj = EngineFaultInjector(**kwargs)
    orig = engine._device_invoke

    def faulty(kind, fn, *args, **kw):
        inj.before(kind)
        out = orig(kind, fn, *args, **kw)
        inj.after(kind)
        return out

    engine._device_invoke = faulty
    try:
        yield inj
    finally:
        engine.__dict__.pop("_device_invoke", None)
