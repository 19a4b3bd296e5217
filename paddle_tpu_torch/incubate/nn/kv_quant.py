"""Quantized KV-cache storage: dtype registry + quantize/dequantize
(port of ``paddle_tpu/incubate/nn/kv_quant.py``).

The serving engines store the KV cache in one of three formats, chosen
by the ``kv_dtype`` engine knob:

* ``"bf16"`` — the model's own cache dtype; storage is unchanged.
* ``"fp8"``  — ``float8_e4m3fn`` storage, scale-free.  The cast follows
  the JAX package's rounding exactly: round to nearest even, and a value
  whose magnitude rounds past 448 (``|x| > 464``, infinities included)
  becomes NaN.  ``Tensor.to(torch.float8_e4m3fn)`` saturates to ±448
  instead, so :func:`quantize_kv` sets those values to NaN itself.
* ``"int8"`` — symmetric per-head, per-token scales: each written row
  quantizes over its head_dim with ``s = max(amax, 1e-8)/127`` and
  stores ``q = clip(round(x/s), -127, 127)`` (round half to even)
  beside a float32 scale tensor whose trailing axis is 1, so every
  token-axis index expression that addresses the data addresses the
  scale unchanged.  Density ``2*hD/(hD+4)`` over bf16.

A quantized K (or V) travels through the model as a ``(data, scale)``
tuple; bf16/fp8 stay bare tensors.  The helpers here are the single
place that knows the tuple convention.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

__all__ = ["KV_DTYPES", "resolve_kv_dtype", "kv_storage_dtype",
           "kv_has_scales", "quantize_kv", "dequantize_kv",
           "kv_components", "kv_map", "kv_nbytes", "kv_cache_dtype",
           "cast_kv", "byte_view", "kv_zeros", "FP8_MAX"]

KV_DTYPES = ("bf16", "int8", "fp8")

#: the largest finite float8_e4m3fn value
FP8_MAX = 448.0
# |x| above this rounds (to nearest even) past FP8_MAX: NaN in e4m3fn,
# which has no infinity; |x| == 464 is the tie and rounds down to 448
_FP8_NAN_ABOVE = 464.0


def resolve_kv_dtype(name) -> str:
    """Validate and canonicalize a ``kv_dtype`` knob value."""
    name = str(name or "bf16").lower()
    if name not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES}, got {name!r}")
    return name


def kv_has_scales(kv_dtype: str) -> bool:
    """True iff the format stores a scale tensor beside the data."""
    return kv_dtype == "int8"


def kv_storage_dtype(kv_dtype: str, model_dtype: torch.dtype
                     ) -> torch.dtype:
    """The dtype of the stored K/V bytes for this format."""
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    return model_dtype


def kv_cache_dtype(cache) -> str:
    """Recover the ``kv_dtype`` knob from a live cache dict."""
    if "ks" in cache:
        return "int8"
    if cache["k"].dtype == torch.float8_e4m3fn:
        return "fp8"
    return "bf16"


def _to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to float8_e4m3fn as JAX casts it: in-range values
    round to nearest even (the cast's own rounding; clamping first to
    ±448 sends the values in (448, 464] where the rounding would), and
    ``|x| > 464`` or non-finite becomes NaN."""
    xf = x.float()
    xf = torch.where(xf.abs() > _FP8_NAN_ABOVE,
                     torch.full_like(xf, float("nan")),
                     xf.clamp(-FP8_MAX, FP8_MAX))
    return xf.to(torch.float8_e4m3fn)


def cast_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast freshly computed rows to a bare cache's storage dtype (the
    JAX programs' ``val.astype(arr.dtype)``, with the fp8 rule above)."""
    if dtype == torch.float8_e4m3fn:
        return _to_fp8(x)
    return x.to(dtype)


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor viewed as its uint8 bytes (other dtypes as they
    are): the cache's gathers, scatters and selects index fp8 storage
    through this view, so they need no float8 kernel on the device."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def kv_zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Zeroed storage: zero bytes are +0.0 in every storage dtype, and
    fp8 is allocated as bytes (no float8 fill kernel needed)."""
    if dtype == torch.float8_e4m3fn:
        return torch.zeros(shape, dtype=torch.uint8,
                           device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def quantize_kv(x: torch.Tensor, kv_dtype: str):
    """Quantize freshly computed K or V rows for storage.

    ``x`` is ``[..., hD]`` in compute precision.  Returns
    ``(stored, scale)`` where ``scale`` is ``[..., 1]`` float32 for
    int8 and ``None`` otherwise.  The op order is the JAX function's:
    float32 amax, ``max(amax, 1e-8)/127``, divide, round half to even,
    clip — so data and scales are bit-identical to it."""
    if kv_dtype == "int8":
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True)
        scale = amax.clamp_min(1e-8) / 127.0
        q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
        return q, scale
    if kv_dtype == "fp8":
        return _to_fp8(x), None
    return x, None


def dequantize_kv(data, scale=None) -> torch.Tensor:
    """Back to float32 compute precision.  ``data`` may be a bare
    tensor, a ``(data, scale)`` tuple, or tensor+scale passed apart."""
    if isinstance(data, tuple):
        data, scale = data
    out = data.float()
    if scale is not None:
        out = out * scale.float()
    return out


def kv_components(x) -> Tuple[Any, ...]:
    """The stored tensors behind one K or V: ``(data,)`` or
    ``(data, scale)``."""
    return tuple(x) if isinstance(x, tuple) else (x,)


def kv_map(f, x):
    """Apply ``f`` to every component, preserving bare/tuple shape."""
    if isinstance(x, tuple):
        return tuple(f(a) for a in x)
    return f(x)


def kv_nbytes(x) -> int:
    """Actual stored bytes (data + scales)."""
    return sum(a.numel() * a.element_size() for a in kv_components(x))
