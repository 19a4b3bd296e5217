"""Bounded retry with exponential backoff and jitter (port of
``paddle_tpu/utils/retry.py``).  One policy answers three questions:

* **what** is transient — ``retry_excs`` (retried) against
  ``no_retry_excs`` (re-raised at once, even when they subclass a
  retryable type);
* **how long** to wait — ``backoff * 2**attempt`` capped at
  ``max_backoff``, times a random jitter in ``[1-jitter, 1+jitter]``;
* **when to give up** — after ``retries`` re-attempts the last error
  reaches the caller, which makes the isolation decision (quarantine the
  request, open the circuit).
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["RetryPolicy", "retry_call", "TRANSIENT_EXCS"]

# The default notion of "transient": I/O hiccups and deadline expiries.
# Contract errors (ValueError, TypeError, ...) are not retried.
TRANSIENT_EXCS: Tuple[Type[BaseException], ...] = (OSError, TimeoutError)


class RetryPolicy:
    """Bounded retries + exponential backoff + jitter around a call.

        policy = RetryPolicy(retries=3, backoff=0.1)
        out = policy.call(flaky_fn, arg1, key=val)

    ``sleep`` and ``rng`` are injectable for deterministic tests.
    """

    def __init__(self, retries: int = 3, backoff: float = 0.1,
                 max_backoff: float = 5.0, jitter: float = 0.25,
                 retry_excs: Tuple[Type[BaseException], ...] = TRANSIENT_EXCS,
                 no_retry_excs: Tuple[Type[BaseException], ...] = (),
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None,
                 on_retry: Optional[Callable[[int, BaseException],
                                             None]] = None):
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self.retry_excs = tuple(retry_excs)
        self.no_retry_excs = tuple(no_retry_excs)
        self._sleep = sleep
        self._rng = rng or random.Random()
        # telemetry seam: called with (attempt, exc) for each failure
        # that WILL be retried (never for the final give-up)
        self.on_retry = on_retry

    def delay(self, attempt: int) -> float:
        d = min(self.max_backoff, self.backoff * (2 ** attempt))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def call(self, fn: Callable, *args, **kwargs):
        """Invoke ``fn``, retrying transient failures per the policy."""
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except self.no_retry_excs:
                raise
            except self.retry_excs as e:
                if attempt >= self.retries:
                    raise
                if self.on_retry is not None:
                    self.on_retry(attempt, e)
                if self.backoff:
                    self._sleep(self.delay(attempt))
                attempt += 1

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form: every call of the returned callable goes
        through :meth:`call`."""
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped


def retry_call(fn: Callable, *args, retries: int = 3, backoff: float = 0.1,
               max_backoff: float = 5.0, jitter: float = 0.25,
               retry_excs: Tuple[Type[BaseException], ...] = TRANSIENT_EXCS,
               **kwargs):
    """One-shot convenience: ``retry_call(fn, a, b, retries=2)``."""
    return RetryPolicy(retries=retries, backoff=backoff,
                       max_backoff=max_backoff, jitter=jitter,
                       retry_excs=retry_excs).call(fn, *args, **kwargs)
