"""Atomic step-numbered checkpoints (port of
``paddle_tpu/distributed/checkpoint/atomic.py``).

Layout under a checkpoint root::

    root/
      step_00000010/            committed checkpoint (has a manifest)
      step_00000020/
      .tmp-30/                  staging: a save in flight (or a crash)
      .corrupt-step_00000020-0/ quarantined: failed verification
      latest                    pointer file {"step": N, "dir": ...}

Commit protocol: the shards, metadata and manifest (last) are written
into the staging dir ``.tmp-<step>``; one ``os.replace`` publishes the
whole step; the ``latest`` pointer is rewritten afterwards and is a HINT
only — :func:`load_latest` trusts the verified walk, newest first, and
quarantines every step that fails verification on the way.

One process: JAX's cross-process barrier before the publish is not
ported (ROADMAP Queue 1 item 10).  JAX's registry series
(``checkpoint_commit_seconds`` and ``_bytes``, ``checkpoint_verify_
failures_total``, ``checkpoint_quarantined_total``) are the plain
counters of :data:`STATS`, and its flight events and postmortems
``logging`` records (logger ``paddle_tpu_torch.checkpoint``).
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from ._io import STATS as _IO_STATS
from ._io import get_io
from .load_state_dict import load_state_dict
from .manifest import verify_checkpoint
from .save_state_dict import save_state_dict

__all__ = ["save_checkpoint", "load_latest", "find_latest_verified",
           "list_steps", "latest_pointer", "step_dir", "quarantine",
           "apply_retention", "LATEST_FILE", "STEP_PREFIX", "STATS"]

_logger = logging.getLogger("paddle_tpu_torch.checkpoint")

STEP_PREFIX = "step_"
STAGING_PREFIX = ".tmp-"
QUARANTINE_PREFIX = ".corrupt-"
LATEST_FILE = "latest"

_STEP_RE = re.compile(rf"^{STEP_PREFIX}(\d+)$")

#: commits, the last commit's seconds and bytes, steps that failed
#: verification in a walk, steps quarantined
STATS = {"commits": 0, "commit_seconds": 0.0, "commit_bytes": 0,
         "verify_failures": 0, "quarantined": 0}


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{STEP_PREFIX}{int(step):08d}")


def list_steps(root: str) -> List[int]:
    """Committed (published, not quarantined) step numbers, ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_pointer(root: str) -> Optional[int]:
    """The step the ``latest`` pointer names: a hint; prefer
    :func:`find_latest_verified`."""
    p = os.path.join(root, LATEST_FILE)
    if not os.path.exists(p):
        return None
    try:
        return int(json.loads(get_io().read_file(p).decode())["step"])
    except (OSError, ValueError, KeyError):
        return None


def _update_latest(root: str, step: int) -> None:
    get_io().write_file(
        os.path.join(root, LATEST_FILE),
        json.dumps({"step": int(step),
                    "dir": f"{STEP_PREFIX}{int(step):08d}"}).encode())


def quarantine(root: str, step: int) -> Optional[str]:
    """Move a bad step dir out of the step namespace (kept for a
    post-mortem, never deleted); returns where it went."""
    src = step_dir(root, step)
    if not os.path.isdir(src):
        return None
    base = f"{QUARANTINE_PREFIX}{os.path.basename(src)}"
    for i in range(1000):
        dst = os.path.join(root, f"{base}-{i}")
        if not os.path.exists(dst):
            try:
                os.replace(src, dst)
            except OSError:
                return None
            STATS["quarantined"] += 1
            _logger.warning("checkpoint step %d quarantined to %s",
                            int(step), dst)
            return dst
    return None


def save_checkpoint(state_dict: Dict[str, Any], root: str, step: int,
                    keep_last_n: Optional[int] = None) -> str:
    """Atomically commit ``state_dict`` as step ``step`` under ``root``;
    returns the published directory.  With ``keep_last_n``, verified
    checkpoints beyond the newest N are deleted after the commit."""
    t0 = time.monotonic()
    bytes0 = _IO_STATS["bytes_written"]
    os.makedirs(root, exist_ok=True)
    staging = os.path.join(root, f"{STAGING_PREFIX}{int(step)}")
    final = step_dir(root, step)
    if os.path.isdir(staging):
        shutil.rmtree(staging)      # stale staging of a crashed save
    os.makedirs(staging, exist_ok=True)
    save_state_dict(state_dict, staging)
    if os.path.isdir(final):
        # a re-save of a published step: quarantine the old dir first
        # (a rename keeps a fallback until the publish lands)
        quarantine(root, step)
    get_io().replace(staging, final)
    _update_latest(root, step)
    if keep_last_n is not None:
        apply_retention(root, keep_last_n)
    dur = time.monotonic() - t0
    STATS["commits"] += 1
    STATS["commit_seconds"] = dur
    STATS["commit_bytes"] = _IO_STATS["bytes_written"] - bytes0
    _logger.debug("committed checkpoint step %d to %s in %.3fs",
                  int(step), final, dur)
    return final


def find_latest_verified(root: str, quarantine_bad: bool = True
                         ) -> Optional[Tuple[int, str]]:
    """Newest step under ``root`` whose manifest verifies, as (step,
    dir); corrupt or uncommitted steps found on the way are quarantined
    (when ``quarantine_bad``)."""
    for step in reversed(list_steps(root)):
        d = step_dir(root, step)
        ok, problems = verify_checkpoint(d)
        if ok:
            return step, d
        STATS["verify_failures"] += 1
        _logger.warning("step %d failed verification (%s)%s", step,
                        "; ".join(problems),
                        " — quarantined" if quarantine_bad else "")
        if quarantine_bad:
            quarantine(root, step)
    return None


def load_latest(state_dict: Optional[Dict[str, Any]], root: str
                ) -> Optional[int]:
    """Resume from the newest VERIFIED checkpoint under ``root``: load it
    in place into ``state_dict`` and return its step, or None when there
    is none (a fresh start).  ``state_dict=None`` only locates (and
    cleans)."""
    found = find_latest_verified(root)
    if found is None:
        return None
    step, d = found
    if state_dict is not None:
        # verification just ran on this dir
        load_state_dict(state_dict, d, verify=False)
    return step


def apply_retention(root: str, keep_last_n: int) -> List[int]:
    """Keep the newest ``keep_last_n`` VERIFIED checkpoints and delete
    older step dirs (corrupt ones do not count toward the quota, so the
    last good checkpoint is never deleted for newer garbage).  Returns
    the deleted steps."""
    if keep_last_n < 1:
        raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
    verified = 0
    deleted: List[int] = []
    for step in reversed(list_steps(root)):
        d = step_dir(root, step)
        if verified >= keep_last_n:
            try:
                shutil.rmtree(d)
                deleted.append(step)
            except OSError:
                pass
            continue
        ok, _ = verify_checkpoint(d)
        if ok:
            verified += 1
    return deleted
