"""Host-to-device transfer (port of ``paddle_tpu/io``:
``device_put_async``, ``_device_put_tree`` and ``prefetch_to_device``).

:func:`device_put_async` is the single-tensor primitive: one
asynchronous copy of a pinned host tensor onto the device, on a side
stream the caller owns, so that the copy overlaps the work on the
current stream (the serving engines' reinstall path).
:func:`prefetch_to_device` is the training prefetcher over it: a
``depth``-deep buffer of batches already on the device, each copied on
the prefetcher's own side stream while the consumer computes.
"""
from __future__ import annotations

import collections
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ByteCounter", "device_put_async", "prefetch_to_device",
           "TRAIN_H2D_BYTES"]


class ByteCounter:
    """A plain byte counter: ``inc(n)`` adds, ``value`` reads."""

    def __init__(self):
        self.value = 0

    def inc(self, n: int) -> None:
        self.value += int(n)


def device_put_async(x: torch.Tensor, device, stream=None,
                     counter: Optional[ByteCounter] = None
                     ) -> Tuple[torch.Tensor, Optional[object]]:
    """Copy host tensor ``x`` onto ``device``; returns ``(tensor,
    event)``.

    On CUDA ``x`` must be contiguous and pinned (the caching host allocator's memory:
    a pageable source would make the copy synchronous, and a raw
    ``cudaHostAlloc`` buffer would not be kept alive while the copy is
    in flight).  The destination is allocated on ``stream`` (the
    engine's side stream) and filled there by ONE ``non_blocking``
    copy; ``event`` is a ``torch.cuda.Event`` recorded on ``stream``
    after it.  The consumer must make its own stream wait on ``event``
    and ``record_stream`` the tensor before it reads it.  fp8 is copied
    as its bytes.

    On the CPU (a CPU engine) the copy is a plain clone and ``event`` is
    None: the bytes are there when this returns.  ``counter`` receives
    the bytes moved.  Any other device raises."""
    dev = torch.device(device)
    src = x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x
    if dev.type == "cuda":
        if x.device.type != "cpu" or not x.is_pinned() \
                or not x.is_contiguous():
            raise ValueError(
                "device_put_async needs a contiguous pinned host tensor "
                f"(got {x.device}, pinned={x.is_pinned()}, "
                f"contiguous={x.is_contiguous()})")
        if stream is None:
            raise ValueError("device_put_async on CUDA needs the side "
                             "stream to copy on")
        with torch.cuda.stream(stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=dev)
            out.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
    elif dev.type == "cpu":
        out = src.clone(memory_format=torch.contiguous_format)
        event = None
    else:
        raise ValueError(f"unsupported device {dev}")
    if counter is not None:
        counter.inc(src.numel() * src.element_size())
    return out.view(x.dtype), event



#: bytes moved host-to-device by the training prefetcher (JAX's
#: ``train_h2d_bytes_total``)
TRAIN_H2D_BYTES = ByteCounter()


def _host_tensor(x) -> torch.Tensor:
    """A batch leaf (a tensor or numpy array) as a host tensor."""
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else torch.as_tensor(x)
    if t.device.type != "cpu":
        raise ValueError(f"prefetch_to_device moves host batches, got a "
                         f"tensor on {t.device}")
    return t


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """``t`` in pinned memory (a pinned contiguous tensor as it is)."""
    if t.is_pinned() and t.is_contiguous():
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _device_put_tree(batch, device, stream=None) -> Tuple[Any, int, Any]:
    """Copy every leaf of ``batch`` (a tensor, numpy array, or a tuple,
    list or dict of them) onto ``device``; returns ``(placed, bytes
    moved, event)``.  On CUDA each leaf is staged in pinned memory and
    copied with :func:`device_put_async` on ``stream``; ``event`` follows
    the last copy.  On the CPU the leaves are cloned and ``event`` is
    None."""
    dev = torch.device(device)
    moved, last = [0], [None]

    def leaf(x):
        t = _host_tensor(x)
        if dev.type == "cuda":
            out, last[0] = device_put_async(_pinned(t), dev, stream)
        else:
            out, _ = device_put_async(t, dev)
        moved[0] += out.numel() * out.element_size()
        return out

    def walk(node):
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(batch), moved[0], last[0]


def _consume(batch, event, device):
    """Make the consumer's stream wait on the copy's event, and mark each
    leaf as used there so the caching allocator (the leaf was allocated
    on the side stream) does not hand its memory out early."""
    if event is None:
        return batch
    cur = torch.cuda.current_stream(device)
    cur.wait_event(event)

    def walk(node):
        if isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            node.record_stream(cur)
    walk(batch)
    return batch


def prefetch_to_device(loader, device=None, depth: int = 2):
    """Yield the batches of ``loader`` (any iterable of tensors, numpy
    arrays, or tuples, lists or dicts of them) already on ``device``
    (CUDA unless the caller asks for the CPU; a train step's
    ``step.data_device``), copied ``depth`` batches ahead of the
    consumer.

    On CUDA each batch is staged in pinned host memory and copied with
    ``non_blocking=True`` on a side stream the prefetcher owns, so batch
    i + 1's copy overlaps step i's kernels; before a batch is yielded the
    consumer's current stream waits on its copy's event and every leaf
    is ``record_stream``-ed onto it.  On the CPU the copies are plain.

    Bytes moved are counted in :data:`TRAIN_H2D_BYTES`.  If the source
    raises, the batches already moved are
    yielded first, then the error propagates.  Breaking out early closes
    the source iterator.  ``depth < 1`` raises ``ValueError``."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    dev = resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    it = iter(loader)
    buf = collections.deque()
    exc = [None]

    def refill():
        while exc[0] is None and len(buf) < depth:
            try:
                item = next(it)
            except StopIteration:
                exc[0] = StopIteration()
                break
            except BaseException as e:  # surfaces after the good batches
                exc[0] = e
                break
            placed, nb, event = _device_put_tree(item, dev, stream)
            TRAIN_H2D_BYTES.inc(nb)
            buf.append((placed, event))

    try:
        refill()
        while buf:
            placed, event = buf.popleft()
            refill()  # the next copies go out before the consumer computes
            yield _consume(placed, event, dev)
        if exc[0] is not None and not isinstance(exc[0], StopIteration):
            raise exc[0]
    finally:
        if hasattr(it, "close"):
            try:
                it.close()
            except Exception:
                pass
