"""Ring attention: causal attention over a sequence split across the
ranks of a process group (port of
``paddle_tpu/incubate/nn/kernels/ring_attention.py``: ``_merge`` and
``ring_attention``).

Rank r holds chunk r of the sequence, q/k/v [B, S_local, nH, hD].  For P
steps it attends its q to the K/V chunk it holds through
:func:`~.flash_attention.flash_attention_with_lse`, at the offset of q's
chunk against that K/V chunk (``(r - src) * S_local``), merges the
normalised partial into its running output in log-sum-exp space
(:func:`_merge`), and hands the K/V chunk on to rank r + 1 while it
takes the next one from rank r - 1.  Every block is computed, the fully
masked ones (src > r) too, as in the JAX schedule: their lse is -1e30, so
they merge with weight 0 and their gradients are 0.

The JAX function takes a mesh axis name and runs inside ``shard_map``;
here :func:`ring_attention` takes a ``torch.distributed`` group and reads
P and r from it.  The K/V hand-over is
:func:`~paddle_tpu_torch.distributed.collective.ring_pass`, one
differentiable exchange of K and V together (send to r + 1, receive from
r - 1; the backward the reverse, as the transpose of ``lax.ppermute``).
The last step hands nothing on (JAX rotates once more and drops the
result).

:func:`ring_attention_loop` is the schedule itself, with the rank, the
ring size and the hand-over function as arguments: a test drives all P
ranks of a ring in one process with a hand-over that returns the next
chunk.  ``ulysses_attention`` (the all-to-all variant) is not ported.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ....distributed.collective import ring_pass
from .flash_attention import NEG_INF, flash_attention_with_lse

__all__ = ["ring_attention", "ring_attention_loop"]


def _merge(o_acc, lse_acc, o_new, lse_new):
    """Merge two normalised attention partials in log-sum-exp space:
    o [B, S, nH, hD] float32, lse [B, nH, S] float32.  A zero total
    weight (two fully masked partials) divides by 1."""
    m = torch.maximum(lse_acc, lse_new)
    w_acc = torch.exp(lse_acc - m)
    w_new = torch.exp(lse_new - m)
    denom = w_acc + w_new
    denom_safe = torch.where(denom == 0.0, 1.0, denom)

    def per_row(w):                                   # [B, nH, S] -> o's
        return w.transpose(1, 2)[..., None]

    o = (o_acc * per_row(w_acc) + o_new * per_row(w_new)) \
        / per_row(denom_safe)
    return o, m + torch.log(denom_safe)


def ring_attention_loop(q, k, v, rank: int, size: int,
                        pass_kv: Callable, causal: bool = True,
                        scale: Optional[float] = None):
    """The ring schedule for rank ``rank`` of ``size``: q/k/v this rank's
    chunk [B, S_local, nH, hD]; ``pass_kv(k, v)`` returns the K/V chunk
    of rank - 1 (of the chunk held one step before).  Returns the local
    [B, S_local, nH, hD] output of full-sequence attention in q's
    dtype; partials merge in float32."""
    B, Sl, nH, hD = q.shape
    o = torch.zeros((B, Sl, nH, hD), dtype=torch.float32, device=q.device)
    lse = torch.full((B, nH, Sl), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for t in range(size):
        src = (rank - t) % size               # owner of the K/V chunk held
        o_t, lse_t = flash_attention_with_lse(q, k, v, (rank - src) * Sl,
                                              scale=scale, causal=causal)
        o, lse = _merge(o, lse, o_t.float(), lse_t)
        if t + 1 < size:
            k, v = pass_kv(k, v)
    return o.to(q.dtype)


def ring_attention(q, k, v, group=None, causal: bool = True,
                   scale: Optional[float] = None):
    """Causal ring attention on this rank's chunk of a sequence split in
    rank order over ``group`` (the default group when None): q/k/v
    [B, S_local, nH, hD] -> [B, S_local, nH, hD]."""
    return ring_attention_loop(
        q, k, v, dist.get_rank(group), dist.get_world_size(group),
        lambda kk, vv: ring_pass(kk, vv, group), causal, scale)
