"""Fused vocabulary cross-entropy forward (port of
``paddle_tpu/incubate/nn/kernels/fused_ce.py``).

Per token, z = logsumexp_v(h . W[v]) and the logit at the token's
(shard-local) label, 0 when the label lies outside [0, V): the contract
of the chunked scan in ``functional/chunked_ce.py``, whose no-grad
primal runs this kernel on the card.  The TPU kernel ``_ce_fwd_kernel``
becomes the hand-written CUDA kernel in ``csrc/fused_ce.cu``; its source
note says what bounds it on the H100.

Dispatch: a CPU tensor runs :func:`fused_ce_fwd_plain`; a CUDA tensor
launches the kernel or raises.  There is no fallback.

bfloat16 runs on the tensor cores, split over the vocabulary: each
split writes per-row partials (max, sum-exp, picked) and a second kernel
merges them in a fixed order (:func:`ce_plan` fixes the splits,
:func:`fused_ce_fwd_split_plain` is that rule in plain PyTorch, for the
tests).  ``LAUNCHES`` counts one per call, however many CUDA launches
the call makes.
"""
from __future__ import annotations

import ctypes

import torch

from ....models.common import matmul_f32out
from . import _build

__all__ = ["fused_ce_fwd", "fused_ce_fwd_plain", "fused_ce_fwd_split_plain",
           "fused_ce_supported", "ce_plan", "LAUNCHES"]

#: kernel calls so far, one per wrapper call (CUDA tensors only; the
#: plain version and rejected calls do not count)
LAUNCHES = 0

#: the bfloat16 kernel's tiles: rows of h a block, vocabulary rows a
#: tile, and blocks resident on one SM
ROW_TILE, VOCAB_TILE, BLOCKS_PER_SM = 128, 256, 1

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
_fn = None


def fused_ce_supported(N: int, V: int, H: int) -> bool:
    """The JAX shape gate, kept as it is: the chunked loss takes the
    kernel only for these shapes."""
    return H <= 2048 and H % 128 == 0 and N % 128 == 0 and V >= 128


def _check(h, W, local_labels):
    if h.dim() != 2 or W.dim() != 2 or h.shape[1] != W.shape[1]:
        raise ValueError(f"fused_ce_fwd: h [N, H] and W [V, H] expected, "
                         f"got {tuple(h.shape)} and {tuple(W.shape)}")
    N = h.shape[0]
    if N % 128:
        # the JAX kernel's row blocks never write a ragged tail
        raise ValueError(f"fused_ce_fwd: N={N} must be a multiple of 128; "
                         f"see fused_ce_supported")
    if local_labels.shape != (N,) or local_labels.dtype != torch.int32:
        raise ValueError(f"fused_ce_fwd: labels must be int32 [{N}], got "
                         f"{local_labels.dtype} {tuple(local_labels.shape)}")
    devs = {t.device for t in (h, W, local_labels)}
    if len(devs) != 1:
        raise ValueError(f"fused_ce_fwd: operands lie on different devices: "
                         f"{sorted(map(str, devs))}")


def fused_ce_fwd_plain(h, W, local_labels):
    """The kernel's function in plain PyTorch: float32 logits (built in
    full), logsumexp, and the label's logit masked outside [0, V)."""
    V = W.shape[0]
    logits = matmul_f32out(h, W.t())
    z = torch.logsumexp(logits, dim=-1)
    lbl = local_labels.long()
    ok = (lbl >= 0) & (lbl < V)
    got = logits.gather(1, lbl.clamp(0, V - 1)[:, None])[:, 0]
    return z, torch.where(ok, got, 0.0)


def ce_plan(N: int, V: int, n_sm: int):
    """(splits, tiles_per_split) of the bfloat16 kernel: the vocabulary
    in runs of whole 128-row tiles, as few runs as reach the least
    (waves of ``BLOCKS_PER_SM * n_sm`` blocks) x (tiles a block).  At
    N 8192, V 50304 on 132 SMs: 33 splits of 6 tiles."""
    row_tiles = -(-N // ROW_TILE)
    v_tiles = -(-V // VOCAB_TILE)
    slots = BLOCKS_PER_SM * n_sm
    best = None
    for per in range(v_tiles, 0, -1):
        splits = -(-v_tiles // per)
        cost = -(-(row_tiles * splits) // slots) * per
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def fused_ce_fwd_split_plain(h, W, local_labels, tiles_per_split: int,
                             splits=None):
    """The bfloat16 kernel's split-and-merge rule in plain PyTorch (float32
    logits): split s covers vocabulary rows [s * tiles_per_split * 128,
    (s + 1) * tiles_per_split * 128) and yields per row its max m_s
    (-1e30 when it holds no row of W), sum-exp sse_s and picked logit;
    the merge, in split order, is z = M + log(sum_s sse_s exp(m_s - M))
    (a zero sum reads as 1) and picked = sum_s pick_s.  ``splits`` may
    exceed the splits V needs: the extra ones are empty."""
    V = W.shape[0]
    per_rows = tiles_per_split * VOCAB_TILE
    if splits is None:
        splits = -(-V // per_rows)
    logits = matmul_f32out(h, W.t())
    lbl = local_labels.long()
    m, sse, pick = [], [], []
    for s in range(splits):
        lo, hi = min(V, s * per_rows), min(V, (s + 1) * per_rows)
        x = logits[:, lo:hi]
        if hi > lo:
            ms = x.amax(-1)
            sse.append(torch.exp(x - ms[:, None]).sum(-1))
        else:
            ms = torch.full_like(logits[:, 0], _NEG_INF)
            sse.append(torch.zeros_like(ms))
        m.append(ms)
        inside = (lbl >= lo) & (lbl < hi)
        got = x.gather(1, (lbl - lo).clamp(0, max(hi - lo - 1, 0))[:, None]
                       )[:, 0] if hi > lo else torch.zeros_like(ms)
        pick.append(torch.where(inside, got, 0.0))
    M = torch.stack(m).amax(0)
    total = torch.zeros_like(M)
    picked = torch.zeros_like(M)
    for s in range(splits):
        total = total + sse[s] * torch.exp(m[s] - M)
        picked = picked + pick[s]
    return M + torch.log(torch.where(total == 0, 1.0, total)), picked


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("fused_ce").pt_fused_ce_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(h, W, local_labels):
    global LAUNCHES
    N, H = h.shape
    V = W.shape[0]
    if h.dtype not in _DTYPE_CODE or W.dtype != h.dtype:
        raise TypeError(f"fused_ce_fwd: h and W must share float32 or "
                        f"bfloat16, got {h.dtype}/{W.dtype}")
    if H % 32:
        raise ValueError(f"fused_ce_fwd: H={H} must be a multiple of 32")
    for name, t in (("h", h), ("W", W), ("labels", local_labels)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_ce_fwd: {name} must be contiguous and "
                             f"16-byte aligned")
    z = torch.empty((N,), dtype=torch.float32, device=h.device)
    picked = torch.empty((N,), dtype=torch.float32, device=h.device)
    splits, per, part = 0, 0, None
    if h.dtype == torch.bfloat16:
        splits, per = ce_plan(N, V, torch.cuda.get_device_properties(
            h.device).multi_processor_count)
        part = torch.empty((3, splits, N), dtype=torch.float32,
                           device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    rc = _kernel()(h.data_ptr(), W.data_ptr(), local_labels.data_ptr(),
                   z.data_ptr(), picked.data_ptr(),
                   None if part is None else part.data_ptr(),
                   _DTYPE_CODE[h.dtype], N, V, H, splits, per, stream)
    if rc != 0:
        raise RuntimeError(f"fused_ce_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return z, picked


def fused_ce_fwd(h, W, local_labels):
    """(z, picked) per token, each [N] float32, with no [N, V] logits in
    device memory.

    h: [N, H]; W: [V, H]; local_labels: [N] int32 shard-local ids (an
    id outside [0, V) never matches, so picked stays 0).  N must be a
    multiple of 128.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (float32 or bfloat16, contiguous, H a multiple of
    32: one count in ``LAUNCHES``, for the split kernel and its merge
    alike) or raise."""
    _check(h, W, local_labels)
    if h.device.type == "cpu":
        return fused_ce_fwd_plain(h, W, local_labels)
    if h.device.type != "cuda":
        raise ValueError(f"fused_ce_fwd runs on cuda or cpu tensors, got "
                         f"{h.device}")
    return _launch(h, W, local_labels)
