"""Live engine-state handoff: snapshot and warm restore (port of
``paddle_tpu/inference/handoff.py``).

A serving engine drains, hands its warm prefix cache and its live
requests to a successor, and the successor carries on: the requests
finish with the streams they would have had, and their prompts are not
prefilled again.  Three parts carry it:

* the crash-consistent checkpoint write path
  (``distributed.checkpoint``): a bundle is staged, written through the
  checkpoint IO layer, committed by its manifest (sizes and SHA-256 of
  every file) and published by one atomic rename, so a crash at any
  syscall leaves no bundle or a verifiable one.  Verification runs
  BEFORE anything is unpickled; a corrupt or truncated bundle is
  quarantined (renamed out of the namespace, kept) and the restore falls
  back to a cold start, never a crash;
* the request state machine: ``drain(mode="handoff")`` stops admissions
  at a step boundary and parks every live request back in the queue;
  prompt, tokens so far, seed and deadline (as remaining TTL) go into
  plain host records, with each request's stream offset;
* the prefix cache's host tier: the trie is exported span by span (device
  spans copied to host memory) in the canonical ``[L, tokens, nH, hD]``
  layout, so any successor — contiguous, paged or fused, either
  ``attn_kernel``, other budgets or block sizes — imports them as HOST
  payloads, and its INSTALLING path turns them back into device state at
  their first hit.

The fallback ladder: warm restore → a span that fails its SHA-256 (or
does not fit) is dropped, and its prompts re-prefill → a bundle that
fails verification is quarantined and the successor starts cold.

Bundle layout under a handoff root::

    root/
      handoff-000001/             committed bundle (has its manifest)
        requests.pkl              carried request records
        cache.pkl                 canonical prefix-cache spans
        checkpoint.manifest.json  commit record (sizes + SHA-256)
      .tmp-handoff-000002/        staging: a snapshot in flight (or crashed)
      .corrupt-handoff-000001-0/  quarantined: failed verification

Known differences from the JAX module: bf16 K/V travel in a record as
their raw 16-bit words (numpy uint16) beside the dtype's name (the
record's ``"dtype"``; numpy has no bfloat16 without ``ml_dtypes``), fp8
as its bytes, so a span's SHA-256 is over the same bytes as JAX's;
JAX's flight-recorder events and postmortem bundles are ``logging``
records here (the flight recorder comes with the observability port);
request records carry ``"trace": None`` until tracing is ported.  The
engines' ``metrics()["handoff"]`` block has JAX's counters.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import pickle
import re
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..distributed.checkpoint._io import get_io
from ..distributed.checkpoint.manifest import (digest_bytes, read_manifest,
                                               verify_checkpoint,
                                               write_manifest)
from ..incubate.nn.kv_quant import kv_components, kv_has_scales, kv_map
from .lifecycle import EngineState, now as _now

__all__ = ["snapshot", "restore", "latest_bundle", "quarantine_bundle",
           "RestoreReport", "HandoffError", "BUNDLE_PREFIX"]

_logger = logging.getLogger("paddle_tpu_torch.handoff")

BUNDLE_PREFIX = "handoff-"
STAGING_PREFIX = ".tmp-"
QUARANTINE_PREFIX = ".corrupt-"
REQUESTS_FILE = "requests.pkl"
CACHE_FILE = "cache.pkl"
_VERSION = 1

_BUNDLE_RE = re.compile(rf"^{BUNDLE_PREFIX}(\d+)$")


class HandoffError(RuntimeError):
    """Handoff misuse (an engine in the wrong state), not corruption:
    corruption never raises, it quarantines and falls back."""


@dataclasses.dataclass
class RestoreReport:
    """One restore's outcome.  ``ok=False`` with ``fallback="cold"``:
    the bundle failed verification and was quarantined — start cold and
    re-submit from the client's own ledger.  ``spans_bad`` counts spans
    dropped at the SHA or install seam (their prompts re-prefill)."""
    ok: bool
    bundle: str
    fallback: Optional[str] = None
    carried: List[int] = dataclasses.field(default_factory=list)
    rejected: List[int] = dataclasses.field(default_factory=list)
    rid_map: Dict[int, int] = dataclasses.field(default_factory=dict)
    stream_offsets: Dict[int, int] = dataclasses.field(default_factory=dict)
    spans_installed: int = 0
    spans_bad: int = 0
    bytes_in: int = 0
    problems: List[str] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# the bundle namespace
# ---------------------------------------------------------------------------

def _bundle_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _BUNDLE_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def _next_bundle_id(root: str) -> int:
    taken = set(_bundle_steps(root))
    for name in os.listdir(root) if os.path.isdir(root) else []:
        m = re.match(rf"^(?:{re.escape(STAGING_PREFIX)}|"
                     rf"{re.escape(QUARANTINE_PREFIX)})"
                     rf"{BUNDLE_PREFIX}(\d+)", name)
        if m:
            taken.add(int(m.group(1)))
    return (max(taken) + 1) if taken else 1


def quarantine_bundle(path: str) -> Optional[str]:
    """Move a bad bundle out of the namespace (kept, not deleted, for a
    post-mortem); returns its new path, or None."""
    path = os.path.normpath(path)
    if not os.path.isdir(path):
        return None
    root, base = os.path.split(path)
    for i in range(1000):
        dst = os.path.join(root, f"{QUARANTINE_PREFIX}{base}-{i}")
        if not os.path.exists(dst):
            try:
                os.replace(path, dst)
            except OSError:
                return None
            return dst
    return None


def latest_bundle(root: str, quarantine_bad: bool = True) -> Optional[str]:
    """The newest bundle under ``root`` whose manifest verifies; corrupt
    or uncommitted bundles met on the way are quarantined (with
    ``quarantine_bad``).  Staging directories are never considered."""
    for n in reversed(_bundle_steps(root)):
        d = os.path.join(root, f"{BUNDLE_PREFIX}{n:06d}")
        if not os.path.isdir(d):
            d = os.path.join(root, f"{BUNDLE_PREFIX}{n}")
        ok, problems = verify_checkpoint(d)
        if ok:
            return d
        _logger.warning("handoff bundle %s failed verification (%s)%s", d,
                        "; ".join(problems),
                        " — quarantined" if quarantine_bad else "")
        if quarantine_bad:
            quarantine_bundle(d)
    return None


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------

def _request_record(req) -> Dict[str, Any]:
    """One carried request as a plain host record, built in one pass
    (tokens copied), so a cancel during serialization changes the queue,
    never a half-built record."""
    t = _now()
    return {
        "rid": int(req.rid),
        "prompt": np.asarray(req.prompt, np.int32),
        "tokens": [int(x) for x in req.tokens],
        # tokens the client already has: its stream resumes here
        "stream_offset": len(req.tokens),
        "max_new": int(req.max_new),
        "seed": int(req.seed),
        # the deadline as remaining TTL: clocks never cross processes
        "remaining_ttl": (None if req.deadline is None
                          else max(req.deadline - t, 0.0)),
        "submitted_ago": max(t - req.submitted_at, 0.0),
        "trace": None,
    }


def _kv_bytes(x) -> bytes:
    """The bytes of a canonical K or V, both components of an int8
    ``(data, scale)`` pair: a scale plane torn from its rows is exactly
    what the hash must catch."""
    return b"".join(np.asarray(c).tobytes() for c in kv_components(x))


def span_digest(k, v) -> str:
    """A span record's SHA-256: over the K bytes then the V bytes (the
    JAX record's digest for the same stored K/V)."""
    return hashlib.sha256(_kv_bytes(k) + _kv_bytes(v)).hexdigest()


def _span_record(key: np.ndarray, a: int, b: int, k, v,
                 dtype: str) -> Dict[str, Any]:
    return {"key": np.asarray(key, np.int32), "a": int(a), "b": int(b),
            "k": k, "v": v, "dtype": dtype, "sha256": span_digest(k, v)}


def snapshot(engine, root: str, bundle_id: Optional[int] = None) -> str:
    """Write a drained engine's live state to an atomic, verified bundle
    under ``root``; returns the bundle's path.

    Drains the engine first (``drain(mode="handoff")``) if it is still
    SERVING.  Every record is built BEFORE the first byte is written;
    the bytes go through the checkpoint IO layer (staged files, fsync,
    manifest last, one atomic rename), so a crash at any instant leaves
    no bundle or a verifiable one.  The span export runs through the
    engine's funnel (kind "snapshot"), the writes through
    ``checkpoint._io`` (``testing.faults.inject_io``)."""
    t0 = time.monotonic()
    if engine.state == EngineState.SERVING:
        engine.drain(mode="handoff")
    if engine.state != EngineState.STOPPED:
        raise HandoffError(f"snapshot needs a handoff-drained engine, "
                           f"state is {engine.state}")
    os.makedirs(root, exist_ok=True)
    if bundle_id is None:
        bundle_id = _next_bundle_id(root)
    name = f"{BUNDLE_PREFIX}{int(bundle_id):06d}"
    final = os.path.join(root, name)
    staging = os.path.join(root, f"{STAGING_PREFIX}{name}")

    # 1. every record before any byte hits the disk
    reqs = [_request_record(r) for r in engine._queue if not r.terminal]
    dtype = engine.kv_storage_name()
    spans = [_span_record(*rec, dtype) for rec in engine.export_cache_spans()]
    cfg = engine.cfg
    meta = {
        "version": _VERSION, "bundle": name,
        "engine": type(engine).__name__,
        "attn_kernel": engine.attn_kernel,
        # a successor at another kv_dtype must not install these bytes
        "kv_dtype": engine.kv_dtype, "kv_storage": dtype,
        "scale_shape": ([int(cfg.num_heads), 1]
                        if kv_has_scales(engine.kv_dtype) else None),
        "max_len": int(engine.max_len),
        "dims": {"num_layers": int(cfg.num_layers),
                 "num_heads": int(cfg.num_heads),
                 "head_dim": int(cfg.head_dim)},
        "requests": len(reqs), "spans": len(spans),
    }

    # 2. the atomic commit
    io = get_io()
    if os.path.isdir(staging):
        shutil.rmtree(staging)   # a crashed snapshot's staging
    os.makedirs(staging)
    req_blob = pickle.dumps(reqs, protocol=4)
    cache_blob = pickle.dumps({"version": _VERSION, "spans": spans},
                              protocol=4)
    try:
        io.write_file(os.path.join(staging, REQUESTS_FILE), req_blob)
        io.write_file(os.path.join(staging, CACHE_FILE), cache_blob)
        write_manifest(staging, {REQUESTS_FILE: digest_bytes(req_blob),
                                 CACHE_FILE: digest_bytes(cache_blob)},
                       extra={"bundle": meta})
        io.replace(staging, final)
    except Exception:
        # a write failed: clean the staging and raise (the caller falls
        # back to a cold start).  A BaseException crash (FaultInjected, a
        # kill) skips this and leaves the staging as a real crash would;
        # latest_bundle never considers it.
        shutil.rmtree(staging, ignore_errors=True)
        raise

    nbytes = len(req_blob) + len(cache_blob)
    st = engine._handoff_stats
    st["snapshots"] += 1
    st["carried_out"] += len(reqs)
    st["spans_out"] += len(spans)
    st["bytes_out"] += nbytes
    _logger.info("handoff snapshot %s: %d requests, %d spans, %d bytes in "
                 "%.3fs", final, len(reqs), len(spans), nbytes,
                 time.monotonic() - t0)
    return final


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def _install_span(engine, rec: Dict[str, Any]) -> None:
    """Check one span record's SHA-256 and insert it into the
    successor's trie as a HOST payload.  Raises on a mismatch (the
    caller drops the span; its prompts re-prefill)."""
    k, v = rec["k"], rec["v"]
    got = span_digest(k, v)
    if got != rec["sha256"]:
        raise ValueError(f"span sha mismatch (key len {rec['b']}): bundle "
                         f"says {rec['sha256'][:12]}…, bytes hash "
                         f"{got[:12]}…")
    a, b = int(rec["a"]), int(rec["b"])
    key = np.asarray(rec["key"], np.int32)

    def make(ia: int, ib: int):
        return engine._canonical_to_payload(
            kv_map(lambda x: x[:, ia - a:ib - a], k),
            kv_map(lambda x: x[:, ia - a:ib - a], v), ia, ib)

    engine._prefix.insert(key, make)


def restore(engine, path: str) -> RestoreReport:
    """Restore a bundle into a fresh SERVING engine.

    The manifest is verified BEFORE anything is unpickled; a failing
    bundle is quarantined and the report says ``ok=False,
    fallback="cold"`` (never a raise for corruption).  Spans go in as
    HOST payloads (any layout; each SHA-256 checked, bad spans dropped),
    then the carried requests re-enter the queue AHEAD of new traffic.
    Each span's install runs through the engine's funnel (kind
    "restore")."""
    t0 = time.monotonic()
    if engine.state != EngineState.SERVING:
        raise HandoffError(f"restore needs a SERVING successor, state is "
                           f"{engine.state}")
    st = engine._handoff_stats
    rep = RestoreReport(ok=False, bundle=path)
    ok, problems = verify_checkpoint(path)
    if not ok:
        q = quarantine_bundle(path)
        st["fallbacks"] += 1
        rep.fallback = "cold"
        rep.problems = problems
        _logger.warning("handoff bundle %s failed verification (%s) — "
                        "quarantined to %s, cold start", path,
                        "; ".join(problems[:4]), q)
        return rep

    io = get_io()
    meta = (read_manifest(path) or {}).get("bundle", {})
    req_blob = io.read_file(os.path.join(path, REQUESTS_FILE))
    cache_blob = io.read_file(os.path.join(path, CACHE_FILE))
    records = pickle.loads(req_blob)
    cache = pickle.loads(cache_blob)

    # spans first, so the carried requests admit into a warm cache
    installed = bad = 0
    cfg = engine.cfg
    dims = meta.get("dims") or {}
    compatible = (
        engine._prefix is not None
        # another storage format's bytes must not be reinterpreted: a
        # cross-dtype restore carries the requests, which re-prefill
        and meta.get("kv_dtype", "bf16") == engine.kv_dtype
        and meta.get("kv_storage", engine.kv_storage_name())
        == engine.kv_storage_name()
        and (not dims or (int(dims.get("num_layers", -1)) == cfg.num_layers
                          and int(dims.get("num_heads", -1)) == cfg.num_heads
                          and int(dims.get("head_dim", -1)) == cfg.head_dim)))
    if compatible:
        covered: set = set()
        for rec in sorted(cache.get("spans", ()), key=lambda r: int(r["b"])):
            a = int(rec["a"])
            key = np.asarray(rec["key"], np.int32)
            if a and key[:a].tobytes() not in covered:
                bad += 1   # orphaned: its parent span was dropped
                continue
            try:
                engine._device_call("restore", _install_span, engine, rec)
            except Exception as e:  # noqa: BLE001 — the re-prefill rung
                bad += 1
                _logger.info("handoff span dropped from %s: %r", path, e)
                continue
            covered.add(key.tobytes())
            installed += 1
    else:
        bad = len(cache.get("spans", ()))

    restored, rejected, rid_map = engine.restore_requests(records)
    rep.ok = True
    rep.carried = [r.rid for r in restored]
    rep.rejected = [r.rid for r in rejected]
    rep.rid_map = rid_map
    rep.stream_offsets = {rid_map[int(r["rid"])]: int(r["stream_offset"])
                          for r in records if int(r["rid"]) in rid_map}
    rep.spans_installed = installed
    rep.spans_bad = bad
    rep.bytes_in = len(req_blob) + len(cache_blob)
    st["restores"] += 1
    st["spans_in"] += installed
    st["spans_bad"] += bad
    st["bytes_in"] += rep.bytes_in
    _logger.info("handoff restore %s: %d carried, %d spans (%d dropped) in "
                 "%.3fs", path, len(restored), installed, bad,
                 time.monotonic() - t0)
    return rep
