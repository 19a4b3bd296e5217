"""Plain attention compositions of the serving path (port of
``_dequant_kv``, ``_decode_attention`` and ``_window_decode_attention``
in ``paddle_tpu/incubate/nn/functional/__init__.py``).

These are what the ``attn_kernel="xla"`` knob runs: the JAX package
leaves them to XLA, so they are plain PyTorch here too.  The rounding
points follow the JAX versions: scores accumulate in float32, the
softmax runs in float32, and the probabilities are cast to the value
dtype before the P.V product.  A quantized cache (int8 ``(data,
scale)`` tuples or bare ``float8_e4m3fn`` tensors) dequantizes to
float32 up front, and only then is the output cast back to q's dtype.
"""
from __future__ import annotations

import math

import torch

from ..kv_quant import dequantize_kv

__all__ = ["_dequant_kv", "_decode_attention", "_window_decode_attention"]

_QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)


def _is_quant(keys) -> bool:
    return isinstance(keys, tuple) or keys.dtype in _QUANT_DTYPES


def _dequant_kv(keys, values):
    """Quantized-cache prologue shared by the plain decode/window
    compositions: int8 ``(data, scale)`` tuples or fp8 tensors become
    float32; anything else passes through."""
    if _is_quant(keys):
        return dequantize_kv(keys), dequantize_kv(values)
    return keys, values


def _repeat_kv(keys, values, nH):
    nKV = keys.shape[2]
    if nKV != nH:
        keys = keys.repeat_interleave(nH // nKV, dim=2)
        values = values.repeat_interleave(nH // nKV, dim=2)
    return keys, values


def _decode_attention(q, keys, values, seq_lens):
    """One-token attention over a padded KV history: q [B, nH, hD];
    keys/values [B, maxS, nKV, hD] (optionally quantized); seq_lens [B]
    (INCLUDING the token written this step).  Positions >= seq_len are
    masked."""
    quant = _is_quant(keys)
    keys, values = _dequant_kv(keys, values)
    maxS, hD = keys.shape[1], keys.shape[3]
    keys, values = _repeat_kv(keys, values, q.shape[1])
    logits = torch.einsum("bhd,bshd->bhs", q.float(), keys.float()) \
        * (1.0 / math.sqrt(hD))
    mask = (torch.arange(maxS, device=q.device)[None, None, :]
            < seq_lens[:, None, None])
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(values.dtype)
    out = torch.einsum("bhs,bshd->bhd", probs, values)
    return out.to(q.dtype) if quant else out


def _window_decode_attention(q, keys, values, pos):
    """Teacher-forced window attention: q [B, W, nH, hD] fed at
    positions pos..pos+W-1; keys/values [B, maxS, nKV, hD] including
    the window's own K/V (optionally quantized); pos [B].  Query j
    attends positions < pos + j + 1, with the same per-query math as
    :func:`_decode_attention`."""
    quant = _is_quant(keys)
    keys, values = _dequant_kv(keys, values)
    W = q.shape[1]
    maxS, hD = keys.shape[1], keys.shape[3]
    keys, values = _repeat_kv(keys, values, q.shape[2])
    logits = torch.einsum("bwhd,bshd->bhws", q.float(), keys.float()) \
        * (1.0 / math.sqrt(hD))
    s_idx = torch.arange(maxS, device=q.device)[None, None, None, :]
    w_idx = torch.arange(W, device=q.device)[None, None, :, None]
    allowed = s_idx <= w_idx + pos[:, None, None, None]   # [B, 1, W, S]
    logits = logits.masked_fill(~allowed, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(values.dtype)
    out = torch.einsum("bhws,bshd->bwhd", probs, values)
    return out.to(q.dtype) if quant else out
