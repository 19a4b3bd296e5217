"""Checkpoint load with reshard-on-load (port of
``paddle_tpu/distributed/checkpoint/load_state_dict.py``).

Each target tensor is assembled from every saved box that covers it
(:func:`_box_intersection`, :func:`_assemble`: the reference's overlap
arithmetic), so a checkpoint that JAX wrote on a mesh of many devices —
a tensor in many shards — loads onto one device.  The result is copied
IN PLACE into the target tensor on its device; a saved dtype other than
the target's is cast.  A missing key raises ``KeyError`` and a shape
mismatch ``ValueError``, as in JAX.

The manifest is verified before anything is unpickled, and the pickles
are read with :class:`_Unpickler`, which resolves only the metadata
classes — under JAX's module path or the port's (the rule is in
``save_state_dict``'s docstring) — so neither package's import is
needed and no other global loads.
"""
from __future__ import annotations

import os
import pickle
import warnings
from typing import Any, Dict

import numpy as np
import torch

from . import metadata as _metadata
from .manifest import CheckpointCorruptError, read_manifest, verify_checkpoint
from .metadata import LocalTensorIndex, Metadata
from .save_state_dict import (_METADATA_FILE, JAX_METADATA_MODULE,
                              flatten_state_dict)

__all__ = ["load_state_dict", "read_metadata"]

#: a saved dtype name -> (numpy dtype of its raw elements, torch dtype)
_NAMES = {"bfloat16": (np.int16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
          "float8_e5m2": (np.uint8, torch.float8_e5m2)}


class _Unpickler(pickle.Unpickler):
    """Loads checkpoint pickles: the metadata classes map to this
    package's (from JAX's module path or the port's); any other global
    is refused."""

    _MODULES = (JAX_METADATA_MODULE, _metadata.__name__)

    def find_class(self, module, name):
        if module in self._MODULES and name in _metadata.__all__:
            return getattr(_metadata, name)
        raise pickle.UnpicklingError(
            f"checkpoint pickle names {module}.{name}: only the metadata "
            f"classes load")


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def read_metadata(path: str) -> Metadata:
    """The ``0.metadata`` of checkpoint directory ``path``."""
    return _load_pickle(os.path.join(path, _METADATA_FILE))


def _raw_dtype(name: str):
    return _NAMES[name][0] if name in _NAMES else np.dtype(name)


def _torch_dtype(name: str) -> torch.dtype:
    return _NAMES[name][1] if name in _NAMES else getattr(torch, name)


class _ShardReader:
    """Loads data files lazily; caches the unpacked raw arrays."""

    def __init__(self, path: str):
        self.path = path
        self._files: Dict[str, dict] = {}
        self._arrays: Dict[tuple, np.ndarray] = {}

    def file(self, name: str) -> dict:
        if name not in self._files:
            self._files[name] = _load_pickle(os.path.join(self.path, name))
        return self._files[name]

    def array(self, file_name: str, key: str, offset: tuple) -> np.ndarray:
        ck = (file_name, key, offset)
        if ck not in self._arrays:
            rec = self.file(file_name)[(key, offset)]
            arr = np.frombuffer(rec["bytes"], dtype=_raw_dtype(rec["dtype"]))
            self._arrays[ck] = arr.reshape(rec["shape"])
        return self._arrays[ck]


def _box_intersection(off_a, shape_a, off_b, shape_b):
    """Intersection of two boxes as (offset, shape) in global
    coordinates; None if empty."""
    lo, hi = [], []
    for oa, sa, ob, sb in zip(off_a, shape_a, off_b, shape_b):
        l, h = max(oa, ob), min(oa + sa, ob + sb)
        if h <= l:
            return None
        lo.append(l)
        hi.append(h)
    return tuple(lo), tuple(h - l for l, h in zip(lo, hi))


def _assemble(key, req_off, req_shape, meta, reader):
    """The box (req_off, req_shape) of tensor ``key`` from every saved
    shard that intersects it, in the saved dtype's raw elements."""
    raw = _raw_dtype(meta.global_dtypes[key])
    shards = meta.state_dict_metadata[key]
    for lm in shards:
        if (tuple(lm.global_offset) == tuple(req_off)
                and tuple(lm.local_shape) == tuple(req_shape)):
            # one shard is the box (every one-device save): its bytes
            return reader.array(meta.storage_metadata[LocalTensorIndex(
                key, tuple(lm.global_offset))], key, lm.global_offset)
    out = np.empty(req_shape, dtype=raw)
    filled = 0
    for lm in shards:
        inter = _box_intersection(req_off, req_shape, lm.global_offset,
                                  lm.local_shape)
        if inter is None:
            continue
        ioff, ishape = inter
        src = reader.array(
            meta.storage_metadata[LocalTensorIndex(key,
                                                   tuple(lm.global_offset))],
            key, lm.global_offset)
        src_sl = tuple(slice(o - go, o - go + s)
                       for o, go, s in zip(ioff, lm.global_offset, ishape))
        dst_sl = tuple(slice(o - ro, o - ro + s)
                       for o, ro, s in zip(ioff, req_off, ishape))
        out[dst_sl] = src[src_sl]
        filled += int(np.prod(ishape))
    if filled < int(np.prod(req_shape)):
        raise RuntimeError(f"checkpoint shards do not cover tensor {key!r} "
                           f"box offset={req_off} shape={req_shape}")
    return out


def load_state_dict(state_dict: Dict[str, Any], path: str,
                    verify: bool = True) -> None:
    """Load the checkpoint at ``path`` IN PLACE into the tensors of
    ``state_dict`` (possibly nested), each on its own device.

    With ``verify`` (the default) the integrity manifest is checked
    before anything is unpickled: a truncated, torn or bit-flipped file
    raises :class:`CheckpointCorruptError`.  A directory without a
    manifest loads with a warning."""
    if verify:
        if read_manifest(path) is None:
            warnings.warn(
                f"checkpoint {path!r} has no integrity manifest; loading "
                f"unverified", RuntimeWarning)
        else:
            ok, problems = verify_checkpoint(path)
            if not ok:
                raise CheckpointCorruptError(path, problems)
    meta = read_metadata(path)
    reader = _ShardReader(path)
    flat, _ = flatten_state_dict(state_dict)
    for key, target in flat.items():
        if target is None:
            continue
        if key not in meta.state_dict_metadata:
            raise KeyError(f"{key!r} not found in checkpoint {path!r}")
        gshape = tuple(meta.global_shapes[key])
        if tuple(target.shape) != gshape:
            raise ValueError(f"shape mismatch for {key!r}: target "
                             f"{tuple(target.shape)} vs saved {gshape}")
        arr = _assemble(key, (0,) * len(gshape), gshape, meta, reader)
        with warnings.catch_warnings():
            # a shard's array is a read-only view of the file's bytes;
            # it is only read, into the target
            warnings.simplefilter("ignore", UserWarning)
            src = torch.from_numpy(arr)
        src = src.view(_torch_dtype(meta.global_dtypes[key]))
        with torch.no_grad():
            target.copy_(src.to(target.dtype))
