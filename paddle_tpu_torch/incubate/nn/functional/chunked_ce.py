"""Chunked (streaming) softmax cross-entropy over a large vocabulary
(port of ``paddle_tpu/incubate/nn/functional/chunked_ce.py``, one
device: the ``mp_axis`` combine across vocabulary shards is not ported;
``vocab_offset`` is kept).

The per-token loss -log softmax(h @ W.T)[label] streams over vocabulary
chunks with an online logsumexp, and the backward recomputes each
chunk's probabilities instead of saving the [N, V] logits.  Every
product is bf16 x bf16 -> float32 (:func:`matmul_f32out`), as the JAX
einsums with ``preferred_element_type=float32``.

Dispatch, as the JAX function's: under autograd the forward is the
chunked scan and the backward the chunked recompute; without autograd,
a CUDA call of a supported shape runs the ``fused_ce_fwd`` kernel
(logits never in device memory), anything else the scan.  The JAX
environment switches (``PT_FUSED_CE``, ``PT_CE_CHUNKS``) are not carried
over.
"""
from __future__ import annotations

import torch

from ....models.common import matmul_f32out
from ..kernels.fused_ce import fused_ce_fwd, fused_ce_supported

__all__ = ["chunked_vocab_nll", "pick_num_chunks"]

# upper bound for one chunk's [N, Vc] float32 logits (the JAX budget)
_CHUNK_BYTES_BUDGET = 4 << 30


def pick_num_chunks(n_tokens: int, vocab: int) -> int:
    """Smallest power-of-two chunk count keeping N x V/nc float32 logits
    under the budget (at most 64)."""
    nc = 1
    while vocab * n_tokens * 4 // nc > _CHUNK_BYTES_BUDGET and nc < 64:
        nc *= 2
    return nc


def _chunks(V: int, num_chunks: int):
    """(start, stop) of each vocabulary chunk: ceil(V/nc) rows each, the
    last one short (the JAX version pads W to a multiple instead; the
    padded rows never count, so the result is the same)."""
    vc = -(-V // num_chunks)
    return [(s, min(s + vc, V)) for s in range(0, V, vc)]


def _fwd_scan(h, W, labels, num_chunks, vocab_offset):
    N = h.shape[0]
    local = labels.long() - vocab_offset
    m = torch.full((N,), float("-inf"), dtype=torch.float32, device=h.device)
    sse = torch.zeros((N,), dtype=torch.float32, device=h.device)
    picked = torch.zeros((N,), dtype=torch.float32, device=h.device)
    for start, stop in _chunks(W.shape[0], num_chunks):
        logits = matmul_f32out(h, W[start:stop].t())            # [N, Vc]
        m_new = torch.maximum(m, logits.amax(-1))
        sse = sse * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(-1)
        m = m_new
        in_chunk = (local >= start) & (local < stop)
        idx = (local - start).clamp(0, stop - start - 1)
        got = logits.gather(1, idx[:, None])[:, 0]
        picked = picked + torch.where(in_chunk, got, 0.0)
    return m + torch.log(sse), picked


class _ChunkedVocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, W, labels, vocab_offset, num_chunks):
        z, picked = _fwd_scan(h, W, labels, num_chunks, vocab_offset)
        ctx.save_for_backward(h, W, labels, z)
        ctx.vocab_offset = vocab_offset
        ctx.num_chunks = num_chunks
        return z - picked

    @staticmethod
    def backward(ctx, g):
        h, W, labels, z = ctx.saved_tensors
        V = W.shape[0]
        gz = g.float()
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dW = torch.empty(W.shape, dtype=torch.float32, device=W.device)
        for start, stop in _chunks(V, ctx.num_chunks):
            Wc = W[start:stop]
            logits = matmul_f32out(h, Wc.t())
            # globally normalised probabilities, in the operand dtype for
            # the two products (the JAX body's MXU-dtype cast)
            dl = (torch.exp(logits - z[:, None]) * gz[:, None]).to(h.dtype)
            dh += matmul_f32out(dl, Wc)
            dW[start:stop] = matmul_f32out(dl.t(), h)
        # the -picked term: dh -= g * W[label]; dW[label] -= g * h
        local = labels.long() - ctx.vocab_offset
        in_shard = (local >= 0) & (local < V)
        safe = local.clamp(0, V - 1)
        gmask = torch.where(in_shard, gz, 0.0)
        dh -= gmask[:, None] * W[safe].float()
        # index_add_ on CUDA sums rows that share a label in no fixed
        # order (float32 atomics): equal up to rounding between runs
        dW.index_add_(0, safe, gmask[:, None] * h.float(), alpha=-1.0)
        return dh.to(h.dtype), dW.to(W.dtype), None, None, None


def _fwd_dispatch(h, W, labels, num_chunks, vocab_offset):
    """The fused kernel for a CUDA call of a supported shape, the
    streaming scan otherwise."""
    N, H = h.shape
    if h.device.type == "cuda" and fused_ce_supported(N, W.shape[0], H):
        return fused_ce_fwd(h, W, (labels - vocab_offset).to(torch.int32))
    return _fwd_scan(h, W, labels, num_chunks, vocab_offset)


def chunked_vocab_nll(h, W, labels, vocab_offset: int = 0,
                      num_chunks: int = 1):
    """Per-token -log softmax(h @ W.T)[label] without materialising the
    full logits under autograd.

    h: [N, Hdim] hidden states (float32 or bfloat16; logits accumulate
    in float32); W: [V, Hdim] (the tied head); labels: [N] integer
    vocabulary ids; vocab_offset: the id of W's first row (0 unsharded).
    Returns nll [N] float32.  A label outside [vocab_offset,
    vocab_offset + V) picks nothing (its loss is z alone)."""
    if torch.is_grad_enabled() and (h.requires_grad or W.requires_grad):
        return _ChunkedVocabNLL.apply(h, W, labels, vocab_offset,
                                      num_chunks)
    z, picked = _fwd_dispatch(h, W, labels, num_chunks, vocab_offset)
    return z - picked
