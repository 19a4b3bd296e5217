"""Host-to-device transfer (port of ``paddle_tpu/io``:
``device_put_async``).

:func:`device_put_async` is the serving engines' reinstall primitive:
one asynchronous copy of a host tensor onto the device, on a side
stream the caller owns, so that the copy overlaps the decode work on
the current stream.  ``prefetch_to_device`` (the training prefetcher's
double buffering) is not ported yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ByteCounter", "device_put_async"]


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
