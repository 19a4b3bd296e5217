"""Preemption-aware checkpointing (port of
``paddle_tpu/distributed/fleet/preemption.py``: ``PreemptionGuard``,
``resume_step``, ``MARKER``), on one process.

* :class:`PreemptionGuard` installs SIGTERM handlers (configurable) that
  only set a flag; no work happens in signal context.
* The training loop polls :meth:`PreemptionGuard.should_save` at step
  boundaries — as ``TrainLoop(interrupt_check=guard.should_save)``,
  which drains and raises ``ElasticInterrupt`` with the exact number of
  completed steps.
* :meth:`PreemptionGuard.checkpoint_and_exit` drains the
  ``AsyncCheckpointer`` it was given, saves the state synchronously,
  writes a ``PREEMPTED.json`` marker with the resume step and exits
  with 128 + SIGTERM (143).  A final save that fails still exits 143,
  without a marker, so the relaunch falls back to ``load_latest``.
* :func:`resume_step` reads the marker back on relaunch, after
  verifying the checkpoint's manifest.

One process: JAX's all-gather of the flags (``should_save``) and its
barrier before the marker (:138-140) are not ported (ROADMAP Queue 1
item 10).  Its flight event and postmortem are ``logging`` records.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import sys
from typing import Optional

__all__ = ["PreemptionGuard", "resume_step", "MARKER"]

_logger = logging.getLogger("paddle_tpu_torch.preemption")

MARKER = "PREEMPTED.json"


class PreemptionGuard:
    """SIGTERM-aware checkpoint-then-exit for a training loop::

        guard = PreemptionGuard(checkpointer=ac)
        loop = TrainLoop(step, interrupt_check=guard.should_save)
        try:
            for batch in batches:
                loop.step(params, opt, *batch)
        except ElasticInterrupt as e:
            guard.checkpoint_and_exit(state, path, e.completed_steps)
    """

    def __init__(self, signals=(signal.SIGTERM,), exit_code: int = 143,
                 checkpointer=None):
        self._flag = False
        self._exit_code = exit_code
        self._prev = {}
        # an AsyncCheckpointer whose in-flight saves are drained before
        # the final save, so exiting never abandons a half-committed step
        self._checkpointer = checkpointer
        for s in signals:
            self._prev[s] = signal.signal(s, self._on_signal)

    def _on_signal(self, signum, frame):  # signal context: the flag only
        self._flag = True

    @property
    def triggered(self) -> bool:
        """This process received the signal."""
        return self._flag

    def should_save(self) -> bool:
        """The preemption decision at a step boundary (one process: the
        local flag)."""
        return self._flag

    def checkpoint_and_exit(self, state, path: str, step: int,
                            extra: Optional[dict] = None):
        """Drain the background checkpointer, save ``state`` to ``path``,
        write the resume marker and exit 143.  The final save is
        best-effort: if it raises (a crash mid-shard included) the
        failure is logged, no marker is written, and the process still
        exits 143."""
        from ..checkpoint import save_state_dict
        _logger.warning("preemption save at step %d to %s", int(step), path)
        if self._checkpointer is not None:
            try:
                self._checkpointer.drain()
            except Exception as e:
                # a failed background save must not block the final one
                _logger.warning("async checkpoint flush failed: %r", e)
        save_ok = True
        try:
            save_state_dict(state, path)
        except (SystemExit, KeyboardInterrupt):
            raise
        except BaseException as e:
            # BaseException on purpose: the injected crash
            # (testing.faults.FaultInjected) models a kill mid-shard, and
            # the guard's job is to turn it into a clean 143
            save_ok = False
            _logger.error("final preemption save to %r failed (%r); "
                          "exiting %d WITHOUT a resume marker", path, e,
                          self._exit_code)
        if save_ok:
            with open(os.path.join(path, MARKER), "w") as f:
                json.dump({"step": int(step), **(extra or {})}, f)
        self.restore()
        sys.exit(self._exit_code)

    def restore(self):
        """Reinstall the previous signal handlers."""
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, TypeError):
                pass
        self._prev = {}


def resume_step(path: str) -> Optional[int]:
    """The step a preempted run's marker records, or None: no marker, or
    a checkpoint whose manifest fails verification (the relaunch then
    falls back to ``checkpoint.load_latest`` or a fresh start)."""
    p = os.path.join(path, MARKER)
    if not os.path.exists(p):
        return None
    from ..checkpoint.manifest import read_manifest, verify_checkpoint
    if read_manifest(path) is not None:
        ok, problems = verify_checkpoint(path)
        if not ok:
            _logger.warning("marker present but checkpoint %r failed "
                            "verification (%s); ignoring marker", path,
                            "; ".join(problems))
            return None
    with open(p) as f:
        return int(json.load(f)["step"])
