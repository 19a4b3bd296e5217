"""Checkpoints (port of ``paddle_tpu/distributed/checkpoint``): save and
load in JAX's on-disk format with reshard-on-load, and the crash-safe
layer — atomic step-dir commits, integrity manifests, the verified
``load_latest`` fallback and background saves.  One process; JAX's
``elastic_resume`` waits for the multi-device port (ROADMAP Queue 1
item 10)."""
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata  # noqa
from .save_state_dict import (flatten_state_dict, save_state_dict,  # noqa
                              wait_async_save)
from .load_state_dict import load_state_dict  # noqa
from .manifest import (CheckpointCorruptError, read_manifest,  # noqa
                       verify_checkpoint, MANIFEST_FILE)
from .atomic import (apply_retention, find_latest_verified,  # noqa
                     latest_pointer, list_steps, load_latest,
                     save_checkpoint, step_dir, quarantine)
from .async_save import AsyncCheckpointer  # noqa
from ._io import CheckpointIO, get_io, set_io  # noqa

__all__ = ["save_state_dict", "load_state_dict", "wait_async_save",
           "flatten_state_dict", "Metadata", "LocalTensorMetadata",
           "LocalTensorIndex",
           # crash-safe layer
           "save_checkpoint", "load_latest", "find_latest_verified",
           "list_steps", "step_dir", "latest_pointer", "quarantine",
           "apply_retention", "AsyncCheckpointer",
           "CheckpointCorruptError", "verify_checkpoint", "read_manifest",
           "MANIFEST_FILE", "CheckpointIO", "get_io", "set_io"]
