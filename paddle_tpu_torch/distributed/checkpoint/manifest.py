"""Checkpoint integrity manifest (port of
``paddle_tpu/distributed/checkpoint/manifest.py``).

The manifest is a checkpoint's commit record: written last, atomically,
after every other file is durable, with each file's intended byte size
and SHA-256.  Its presence means the checkpoint was fully written; its
digests mean the bytes on disk are the bytes that were written.  A save
killed at an earlier syscall leaves no manifest; a torn or bit-flipped
file fails the digest check.  Digests come from the in-memory payload
at save time, not from re-reading the file, so a write that silently
truncated is caught at verification.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

from ._io import get_io

__all__ = ["MANIFEST_FILE", "CheckpointCorruptError", "digest_bytes",
           "write_manifest", "read_manifest", "verify_checkpoint"]

MANIFEST_FILE = "checkpoint.manifest.json"
_VERSION = 1


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification; ``.problems`` lists every
    mismatch found."""

    def __init__(self, path: str, problems: List[str]):
        self.path = path
        self.problems = list(problems)
        super().__init__(f"checkpoint {path!r} failed verification: "
                         + "; ".join(self.problems))


def digest_bytes(data: bytes) -> Dict[str, object]:
    return {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest()}


def write_manifest(path: str, file_digests: Dict[str, Dict[str, object]],
                   extra: Optional[dict] = None) -> None:
    """Atomically write the manifest of checkpoint directory ``path``;
    ``file_digests`` maps a file name (relative to ``path``) to the
    :func:`digest_bytes` record of the bytes handed to the writer."""
    doc = {"version": _VERSION, "files": dict(file_digests)}
    if extra:
        doc.update(extra)
    get_io().write_file(os.path.join(path, MANIFEST_FILE),
                        json.dumps(doc, indent=1, sort_keys=True).encode())


def read_manifest(path: str) -> Optional[dict]:
    """The parsed manifest, or None if it is absent or unreadable (an
    uncommitted or corrupt checkpoint)."""
    p = os.path.join(path, MANIFEST_FILE)
    if not os.path.exists(p):
        return None
    try:
        return json.loads(get_io().read_file(p).decode())
    except (OSError, ValueError):
        return None


def verify_checkpoint(path: str, require_manifest: bool = True
                      ) -> Tuple[bool, List[str]]:
    """Check every file the manifest names: it exists, its size and its
    SHA-256 match.  Returns (ok, problems)."""
    if not os.path.isdir(path):
        return False, [f"not a directory: {path!r}"]
    man = read_manifest(path)
    if man is None:
        if require_manifest:
            return False, ["no manifest (save never committed, or "
                           "pre-manifest checkpoint)"]
        return True, []
    problems: List[str] = []
    for name, rec in man.get("files", {}).items():
        fp = os.path.join(path, name)
        if not os.path.isfile(fp):
            problems.append(f"missing file {name!r}")
            continue
        size = os.path.getsize(fp)
        if size != int(rec["bytes"]):
            problems.append(f"{name!r}: size {size} != recorded "
                            f"{rec['bytes']} (truncated/torn write)")
            continue
        h = hashlib.sha256()
        with open(fp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != rec["sha256"]:
            problems.append(f"{name!r}: sha256 mismatch (bit corruption)")
    return not problems, problems
