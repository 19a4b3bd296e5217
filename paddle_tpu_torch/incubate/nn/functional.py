"""Plain attention compositions of the serving path (port of
``_decode_attention`` and ``_window_decode_attention`` in
``paddle_tpu/incubate/nn/functional/__init__.py``, dense caches only).

These are what the ``attn_kernel="xla"`` knob runs: the JAX package
leaves them to XLA, so they are plain PyTorch here too.  The rounding
points follow the JAX versions: scores accumulate in float32, the
softmax runs in float32, and the probabilities are cast to the value
dtype before the P.V product.
"""
from __future__ import annotations

import math

import torch

__all__ = ["_decode_attention", "_window_decode_attention"]


def _repeat_kv(keys, values, nH):
    nKV = keys.shape[2]
    if nKV != nH:
        keys = keys.repeat_interleave(nH // nKV, dim=2)
        values = values.repeat_interleave(nH // nKV, dim=2)
    return keys, values


def _decode_attention(q, keys, values, seq_lens):
    """One-token attention over a padded KV history: q [B, nH, hD];
    keys/values [B, maxS, nKV, hD]; seq_lens [B] (INCLUDING the token
    written this step).  Positions >= seq_len are masked."""
    maxS, hD = keys.shape[1], keys.shape[3]
    keys, values = _repeat_kv(keys, values, q.shape[1])
    logits = torch.einsum("bhd,bshd->bhs", q.float(), keys.float()) \
        * (1.0 / math.sqrt(hD))
    mask = (torch.arange(maxS, device=q.device)[None, None, :]
            < seq_lens[:, None, None])
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(values.dtype)
    return torch.einsum("bhs,bshd->bhd", probs, values)


def _window_decode_attention(q, keys, values, pos):
    """Teacher-forced window attention: q [B, W, nH, hD] fed at
    positions pos..pos+W-1; keys/values [B, maxS, nKV, hD] including
    the window's own K/V; pos [B].  Query j attends positions
    < pos + j + 1, with the same per-query math as
    :func:`_decode_attention`."""
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
    return torch.einsum("bhws,bshd->bwhd", probs, values)
