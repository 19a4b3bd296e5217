"""Functional losses of the ``paddle.nn.functional`` surface (port of
``paddle_tpu/nn/functional/__init__.py``): so far ``ctc_loss`` and its
recursion ``_ctc_impl``, on torch tensors.

The JAX package computes CTC in XLA (a ``lax.scan`` over time, no Pallas
kernel), so the port's CTC is plain PyTorch on every device: a Python
loop over the T - 1 frames after the first, each step a handful of
elementwise kernels on [B, 2L + 1] alphas.  The gradient with respect to
``log_probs`` is autograd through that loop, as JAX's is ``jax.vjp``
through the scan: the exact derivative with respect to the given
log-probabilities (warpctc and ``torch.nn.functional.ctc_loss`` return
the gradient that assumes a log-softmax input; through the logits the
two agree).
"""
from __future__ import annotations

import torch

__all__ = ["ctc_loss"]

#: the recursion's "log 0" (JAX's ``jnp.asarray(-1e30, lp.dtype)``)
_NEG_INF = -1e30
#: added inside each log-sum-exp, so a sum of exp(-huge) terms stays finite
_TINY = 1e-37


def _logsumexp3(a0, a1, a2):
    m = torch.maximum(torch.maximum(a0, a1), a2)
    return m + torch.log(torch.exp(a0 - m) + torch.exp(a1 - m)
                         + torch.exp(a2 - m) + _TINY)


def _ctc_impl(lp, lab, in_len, lab_len, blank: int, reduction: str):
    """CTC alpha recursion.  lp: [T, B, C] log-probs; lab: [B, L].
    O(T 2L) a sequence: the extended label sequence (blanks between and
    around the labels) [B, S = 2L + 1]; a skip from s - 2 allowed where
    ext[s] is a label other than ext[s - 2]; each sequence's final alpha
    selected as the loop streams past its (clipped) input length; the
    loss from the states 2 lab_len - 1 and 2 lab_len (clipped to S)."""
    T, B, _ = lp.shape
    S = 2 * lab.shape[1] + 1
    dev, dt = lp.device, lp.dtype
    # int64: the gather index, whatever integer type the labels come in
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    skip_ok = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                         ext[:, 2:] != ext[:, :-2]], dim=1) & (ext != blank)
    neg = torch.full((B, S), _NEG_INF, dtype=dt, device=dev)
    first = lp[0].gather(1, ext)                       # frame 0's emissions
    init = torch.cat([first[:, :1],
                      torch.where(lab_len[:, None] > 0, first[:, 1:2],
                                  neg[:, 1:2]),
                      neg[:, 2:]], dim=1)
    # a length of 0 reads frame 0, one past T the last frame
    in_len = torch.clamp(in_len.to(torch.int64), 1, T)
    last = torch.where((in_len == 1)[:, None], init, neg)
    alpha = init
    for t in range(1, T):
        a1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        a2 = torch.where(skip_ok, torch.cat([neg[:, :2], alpha[:, :-2]],
                                            dim=1), neg)
        alpha = _logsumexp3(alpha, a1, a2) + lp[t].gather(1, ext)
        last = torch.where((in_len == t + 1)[:, None], alpha, last)
    s1 = torch.clamp(2 * lab_len.to(torch.int64) - 1, 0, S - 1)
    s2 = torch.clamp(2 * lab_len.to(torch.int64), 0, S - 1)
    v1 = last.gather(1, s1[:, None])[:, 0]
    v2 = last.gather(1, s2[:, None])[:, 0]
    m = torch.maximum(v1, v2)
    loss = -(m + torch.log(torch.exp(v1 - m) + torch.exp(v2 - m) + _TINY))
    if reduction == "mean":
        return (loss / torch.clamp(lab_len.to(dt), min=1.0)).mean()
    return loss.sum() if reduction == "sum" else loss


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank: int = 0,
             reduction: str = "mean", norm_by_times: bool = False):
    """CTC loss (reference warpctc binding,
    python/paddle/nn/functional/loss.py ``ctc_loss``) on torch tensors:
    ``log_probs`` [T, B, C] float, ``labels`` [B, L] integer,
    ``input_lengths`` and ``label_lengths`` [B] integer, all on one
    device.  ``reduction`` "mean" averages each sequence's loss divided
    by max(label length, 1); "sum" sums the losses; "none" returns the
    [B] losses.  Differentiable in ``log_probs``.  ``norm_by_times`` is
    accepted and has no effect, as in the JAX function (warpctc scales
    only the gradient by it)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    devs = {t.device for t in (log_probs, labels, input_lengths,
                               label_lengths)}
    if len(devs) != 1:
        raise ValueError(f"ctc_loss operands lie on different devices: "
                         f"{sorted(map(str, devs))}")
    return _ctc_impl(log_probs, labels, input_lengths, label_lengths,
                     int(blank), reduction)
