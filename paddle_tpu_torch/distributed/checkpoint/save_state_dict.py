"""Checkpoint save (port of
``paddle_tpu/distributed/checkpoint/save_state_dict.py``:
``flatten_state_dict``, ``save_state_dict``, ``wait_async_save``), in
JAX's on-disk format exactly:

* ``{rank}_0.distcp`` — a pickle (protocol 4) of ``{(key, offset):
  {"bytes", "dtype", "shape"}}``, one record a saved shard;
* ``0.metadata`` — a pickle of :class:`~.metadata.Metadata`;
* the integrity manifest, written last through ``CheckpointIO`` (its
  presence is the commit record).

On one device each tensor is one shard at offset 0, rank 0.  A leaf's
bytes are its raw element bytes: bfloat16 travels as its 16-bit words
beside the dtype name ``"bfloat16"`` (numpy has no bfloat16 without
``ml_dtypes``; JAX reads those words as ``ml_dtypes.bfloat16``), fp8 as
bytes.

The pickle rule, both directions.  JAX's ``0.metadata`` pickles
``paddle_tpu.distributed.checkpoint.metadata.Metadata`` (and its
``LocalTensorMetadata`` / ``LocalTensorIndex``).  A pickle names a class
by a module path and a name — a string, not an import — so the port
writes its own dataclasses under JAX's path (:func:`dumps_metadata`: a
pickler that emits those names for the port's classes without importing
anything), and reads either package's pickle with an unpickler whose
``find_class`` maps that path to the port's module
(``load_state_dict._Unpickler``).  The fields are the same, so each
package's loader rebuilds its own classes from the other's file.
"""
from __future__ import annotations

import contextlib
import io as _pyio
import os
import pickle
import struct
import threading
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ._io import get_io
from .manifest import digest_bytes, write_manifest
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata

__all__ = ["flatten_state_dict", "save_state_dict", "wait_async_save",
           "dumps_metadata", "JAX_METADATA_MODULE", "SPANS"]

_METADATA_FILE = "0.metadata"
#: the module path JAX's metadata classes pickle under
JAX_METADATA_MODULE = "paddle_tpu.distributed.checkpoint.metadata"
_JAX_NAMES = {cls: (JAX_METADATA_MODULE, cls.__name__)
              for cls in (Metadata, LocalTensorMetadata, LocalTensorIndex)}

#: torch dtypes stored through another element type of the same width
_RAW_VIEW = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
             torch.float8_e5m2: torch.uint8}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy / JAX name of a torch dtype ("float32", "bfloat16")."""
    return str(dtype).replace("torch.", "")


def _host(value) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor (numpy arrays and Python
    scalars are wrapped; a CUDA tensor is copied to the host)."""
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value))
    if not torch.is_tensor(value):
        return torch.as_tensor(value)
    return value.detach().to("cpu").contiguous()


#: the last save's parts as (name, start, end) on ``time.perf_counter``:
#: "pack" (each leaf to the host, as a view of its bytes), "write" (the
#: shard file's pickle streamed through its SHA-256 into the file, and
#: the fsync), "metadata" (the metadata file and the manifest)
SPANS: List[Tuple[str, float, float]] = []


@contextlib.contextmanager
def _span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SPANS.append((name, t0, time.perf_counter()))


class _RawBytes:
    """A shard's bytes as a view of its contiguous host tensor (which
    must not change until the file is written)."""
    __slots__ = ("view",)

    def __init__(self, view: memoryview):
        self.view = view


class _ShardPickler(pickle._Pickler):
    """The pure-Python pickler, writing a :class:`_RawBytes` as the
    ``bytes`` object it views (the same opcodes and memo entry, so the
    stream is the one ``pickle.dumps`` gives for the bytes): a large
    one goes to the file straight from the tensor's memory, so no copy
    of the state is made and the GIL is not held while its bytes are
    hashed and written."""
    dispatch = dict(pickle._Pickler.dispatch)

    def save_raw_bytes(self, obj):
        # the stdlib's save_bytes at protocol 4, on the view
        view, n = obj.view, len(obj.view)
        if n <= 0xff:
            self.write(pickle.SHORT_BINBYTES + struct.pack("<B", n)
                       + bytes(view))
        elif n > 0xffffffff:
            self.framer.write_large_bytes(
                pickle.BINBYTES8 + struct.pack("<Q", n), view)
        elif n >= self.framer._FRAME_SIZE_TARGET:
            self.framer.write_large_bytes(
                pickle.BINBYTES + struct.pack("<I", n), view)
        else:
            self.write(pickle.BINBYTES + struct.pack("<I", n) + bytes(view))
        self.memoize(obj)

    dispatch[_RawBytes] = save_raw_bytes


def _pack(t: torch.Tensor) -> dict:
    """bytes + dtype name + shape: JAX's record of one shard (the bytes
    as a view of ``t``)."""
    raw = t.view(_RAW_VIEW[t.dtype]) if t.dtype in _RAW_VIEW else t
    view = memoryview(raw.numpy().reshape(-1)).cast("B")
    return {"bytes": _RawBytes(view), "dtype": dtype_name(t.dtype),
            "shape": tuple(t.shape)}


def flatten_state_dict(state_dict: Dict[str, Any], prefix: str = ""):
    """Flatten nested dicts to dotted keys; returns (flat, mapping)."""
    flat, mapping = {}, {}
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            sub_flat, sub_map = flatten_state_dict(v, key)
            flat.update(sub_flat)
            mapping.update(sub_map)
        else:
            flat[key] = v
            mapping[key] = key
    return flat, mapping


class _JaxPathPickler(pickle._Pickler):
    """The pure-Python pickler, naming the port's metadata classes by
    JAX's module path (written as the GLOBAL opcodes' strings; nothing
    is imported)."""

    def save_global(self, obj, name=None):
        names = _JAX_NAMES.get(obj)
        if names is None:
            return super().save_global(obj, name)
        module, qualname = names
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def dumps_metadata(meta: Metadata) -> bytes:
    """``meta`` pickled (protocol 4) as JAX's ``Metadata``: JAX's
    ``load_state_dict`` unpickles it into its own classes."""
    buf = _pyio.BytesIO()
    _JaxPathPickler(buf, protocol=4).dump(meta)
    return buf.getvalue()


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    async_save: bool = False) -> None:
    """Write ``state_dict`` (possibly nested; values torch tensors on any
    device, numpy arrays or scalars) as a checkpoint directory of one
    rank, each tensor one shard at offset 0.  The shard file is pickled
    straight from the host tensors into the file (CUDA tensors are first
    copied to the host; CPU tensors are read in place, so they must not
    change until this returns).  With ``async_save`` the values are
    copied before this returns and the files are written on a thread
    (:func:`wait_async_save` joins it)."""
    os.makedirs(path, exist_ok=True)
    SPANS.clear()
    flat, _ = flatten_state_dict(state_dict)
    meta = Metadata()
    data_file = "0_0.distcp"
    payload: Dict[tuple, dict] = {}
    with _span("pack"):
        for key, value in flat.items():
            if value is None:
                continue
            t = _host(value)
            if async_save and (not torch.is_tensor(value)
                               or t.data_ptr() == value.data_ptr()):
                t = t.clone()
            shape, off = tuple(t.shape), (0,) * t.dim()
            meta.global_shapes[key] = shape
            meta.global_dtypes[key] = dtype_name(t.dtype)
            meta.state_dict_metadata[key] = [
                LocalTensorMetadata(off, shape, dtype_name(t.dtype))]
            meta.storage_metadata[LocalTensorIndex(key, off)] = data_file
            payload[(key, off)] = _pack(t)

    def _write():
        # every file is staged, fsynced and renamed by the IO layer; the
        # manifest goes last, so its presence is the commit record
        io = get_io()
        with _span("write"):
            with io.staged(os.path.join(path, data_file)) as w:
                _ShardPickler(w, protocol=4).dump(payload)
        with _span("metadata"):
            meta_blob = dumps_metadata(meta)
            io.write_file(os.path.join(path, _METADATA_FILE), meta_blob)
            write_manifest(path, {data_file: w.digest(),
                                  _METADATA_FILE: digest_bytes(meta_blob)})

    if async_save:
        t = threading.Thread(target=_run_async, args=(_write,), daemon=True)
        t.start()
        _ASYNC_THREADS.append(t)
    else:
        _write()


_ASYNC_THREADS: list = []
_ASYNC_ERRORS: list = []


def _run_async(fn):
    try:
        fn()
    except BaseException as e:  # surfaced by wait_async_save
        _ASYNC_ERRORS.append(e)


def wait_async_save():
    """Join every pending async write; re-raises the first failure."""
    while _ASYNC_THREADS:
        _ASYNC_THREADS.pop().join()
    if _ASYNC_ERRORS:
        raise _ASYNC_ERRORS.pop(0)
