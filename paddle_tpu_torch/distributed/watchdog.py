"""Watchdog deadlines for blocking host waits (port of
``paddle_tpu/distributed/watchdog.py``: ``CommTask``,
``CommTaskManager`` and ``watch``).

``watch(name, timeout=...)`` scopes a blocking call with a deadline: a
poller thread logs every task that outlives its deadline, and the scope
raises :class:`TimeoutError` when the watched call returns after its
deadline, so the caller cannot silently go on.  It sees host time only:
a device stall shows up in the scope that waits for the device (a
readback, a synchronize), not in one that merely queues work.

Escalation ladder on expiry:

1. always: an error through ``logging`` (logger
   ``paddle_tpu_torch.watchdog``), from the poller thread;
2. the optional ``on_timeout`` hook;
3. ``abort_process=True``: SIGABRT the process — the only way out of a
   wait the host cannot interrupt;
4. a watched call that returns after expiry raises ``TimeoutError``.

The poller thread only reads clocks and logs; it makes no CUDA call, so
it cannot disturb a CUDA-graph capture running on another thread.  (The
flight recorder and postmortem hooks of the JAX module come with the
observability port; ``barrier_with_timeout`` with multi-device
rendezvous.)
"""
from __future__ import annotations

import collections
import logging
import os
import signal
import threading
import time
from typing import Callable, List, Optional

__all__ = ["CommTask", "CommTaskManager", "comm_task_manager", "watch"]

_logger = logging.getLogger("paddle_tpu_torch.watchdog")


class CommTask:
    """One watched wait: its name, group, start and deadline."""

    __slots__ = ("name", "group", "start", "timeout", "done", "error")

    def __init__(self, name: str, group: str, timeout: float):
        self.name = name
        self.group = group
        self.start = time.monotonic()
        self.timeout = timeout
        self.done = False
        self.error: Optional[str] = None

    def is_timeout(self) -> bool:
        return (not self.done
                and time.monotonic() - self.start > self.timeout)

    def elapsed(self) -> float:
        return time.monotonic() - self.start


class CommTaskManager:
    """Registry of watched tasks and the daemon thread that polls them
    every ``poll_interval`` seconds."""

    def __init__(self, poll_interval: float = 0.5,
                 on_timeout: Optional[Callable[[CommTask], None]] = None,
                 abort_process: bool = False, keep_last: int = 100):
        self._tasks: List[CommTask] = []
        self._lock = threading.Lock()
        self._interval = poll_interval
        self._on_timeout = on_timeout
        self._abort_process = abort_process
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.timed_out = collections.deque(maxlen=keep_last)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    # -- task API ------------------------------------------------------------
    def commit(self, name: str, group: str = "default",
               timeout: float = 300.0) -> CommTask:
        t = CommTask(name, group, timeout)
        with self._lock:
            self._tasks.append(t)
        self.start()
        return t

    def complete(self, task: CommTask):
        task.done = True
        with self._lock:
            if task in self._tasks:
                self._tasks.remove(task)

    def pending(self) -> List[CommTask]:
        with self._lock:
            return list(self._tasks)

    # -- poller --------------------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            with self._lock:
                expired = [t for t in self._tasks if t.is_timeout()]
                for t in expired:
                    self._tasks.remove(t)
            for t in expired:
                t.error = (f"'{t.name}' (group {t.group}) exceeded "
                           f"{t.timeout}s (waited {t.elapsed():.1f}s)")
                self.timed_out.append(t)
                _logger.error("[watchdog] TIMEOUT: %s", t.error)
                if self._on_timeout is not None:
                    try:
                        self._on_timeout(t)
                    except Exception as e:  # the hook must not kill the poller
                        _logger.warning(
                            "[watchdog] on_timeout hook failed: %r", e)
                if self._abort_process:
                    _logger.critical("[watchdog] aborting the process")
                    os.kill(os.getpid(), signal.SIGABRT)
            self._stop.wait(self._interval)


comm_task_manager = CommTaskManager()


class watch:
    """Scope a blocking call with a watchdog deadline:

        with watch("serving:decode", timeout=30):
            tokens = out.cpu()

    On expiry the manager logs and escalates; on scope exit the task is
    retired, and the scope raises :class:`TimeoutError` if the deadline
    passed before the watched block returned."""

    def __init__(self, name: str, group: str = "default",
                 timeout: float = 300.0, raise_on_timeout: bool = True):
        self._args = (name, group, timeout)
        self._raise = raise_on_timeout

    def __enter__(self):
        self._task = comm_task_manager.commit(*self._args)
        return self._task

    def __exit__(self, exc_type, exc, tb):
        timed_out = self._task.is_timeout() or self._task.error
        comm_task_manager.complete(self._task)
        if timed_out and self._raise and exc_type is None:
            raise TimeoutError(self._task.error or
                               f"'{self._task.name}' exceeded deadline")
        return False
