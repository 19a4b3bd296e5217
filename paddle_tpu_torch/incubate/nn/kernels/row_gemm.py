"""Batch-invariant small-M matrix products for the serving path (a
module of the port only).

The JAX package takes the decode, verify and suffix-fill products of
GPT (``paddle_tpu/models/gpt.py`` ``_wmm`` and the tied head) as XLA
einsums outside any Pallas kernel, and on the TPU a row's result does
not move with the batch.  On the card cuBLAS picks its algorithm and
split from M, so a verify pass (M = B (k + 1)) and a decode step (M =
B) round the same row differently and a speculative stream leaves the
plain one.  :func:`row_gemm` is the hand-written kernel of
``csrc/row_gemm.cu`` for these products: every output row is a
function of that row of x and of w alone, bit for bit, whatever M is.
:func:`row_gemm_plan` fixes the K order and the split-K count from
(K, N, dtype) only; the source note says what bounds the kernel.

Dispatch: a CPU tensor runs :func:`row_gemm_plain`, which is exactly
what the CPU serving path computed before the kernel existed (``x @ w``
for the layer weights, ``matmul_f32out`` for the head), so the CPU
streams and the parity with JAX do not move.  A CUDA tensor launches
the kernel or raises.  There is no fallback.  ``LAUNCHES`` counts one
per wrapper call, however many CUDA launches the call makes (one per 64
rows).
"""
from __future__ import annotations

import ctypes

import torch

from ....models.common import matmul_f32out
from . import _build

__all__ = ["row_gemm", "row_gemm_plain", "row_gemm_split_plain",
           "row_gemm_plan", "weight_layout", "reset_launches", "LAUNCHES"]

#: kernel calls so far, one per wrapper call (CUDA tensors only; the
#: plain version and rejected calls do not count)
LAUNCHES = 0

#: output columns a block, K rows a stage, rows a launch
BLOCK_N, BLOCK_K, MAX_ROWS = 64, 64, 64
#: blocks the plan aims for (two on each of the H100's 132 SMs), and the
#: fewest K stages a split keeps
TARGET_BLOCKS, MIN_SPLIT_STAGES = 264, 4

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_COUNTERS = {}


def reset_launches():
    """Set the launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0


def row_gemm_plan(M: int, K: int, N: int, dtype) -> dict:
    """How the kernel cuts y [M, N] = x [M, K] @ w: ``splits`` runs of
    ``split_stages`` stages of ``BLOCK_K`` rows of K (ascending; the
    last run may be shorter) over ``n_tiles`` tiles of ``BLOCK_N``
    columns, the partials summed in split order.  Everything that
    decides a row's arithmetic comes from (K, N, dtype); M sets only how
    many launches of at most ``MAX_ROWS`` rows (``row_chunks``) and
    16-row tiles (``m_tiles``) carry the rows."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"row_gemm takes float32 or bfloat16, got {dtype}")
    n_tiles = -(-N // BLOCK_N)
    k_stages = -(-K // BLOCK_K)
    want = min(-(-TARGET_BLOCKS // n_tiles),
               max(1, k_stages // MIN_SPLIT_STAGES))
    per = -(-k_stages // max(1, want))
    return {"n_tiles": n_tiles, "k_stages": k_stages,
            "splits": -(-k_stages // per), "split_stages": per,
            "row_chunks": -(-M // MAX_ROWS),
            "m_tiles": -(-min(M, MAX_ROWS) // 16)}


def weight_layout(w) -> str:
    """"kn" for a [K, N] weight with N contiguous (the layer weights),
    "nk" for a [K, N] view of a [N, K] table with K contiguous
    (``wte.t()``, the tied head)."""
    if w.dim() != 2:
        raise ValueError(f"row_gemm: w must be 2-D, got {tuple(w.shape)}")
    if w.stride(1) == 1 and w.stride(0) >= w.shape[1]:
        return "kn"
    if w.stride(0) == 1 and w.stride(1) >= w.shape[0]:
        return "nk"
    raise ValueError(f"row_gemm: w {tuple(w.shape)} with strides "
                     f"{w.stride()} is neither [K, N] nor the transpose of "
                     f"a row-major [N, K]")


def _check(x, w, out_dtype):
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"row_gemm: x [..., K] and w [K, N] expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"row_gemm: x and w must share float32 or bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if out_dtype not in (None, x.dtype, torch.float32):
        raise TypeError(f"row_gemm: output in {x.dtype} or float32, got "
                        f"{out_dtype}")
    if x.device != w.device:
        raise ValueError(f"row_gemm: x lies on {x.device}, w on {w.device}")


def row_gemm_plain(x, w, out_dtype=None):
    """The kernel's function in plain PyTorch, as the CPU path computes
    it: ``x @ w`` in x's dtype, or with ``out_dtype=torch.float32`` the
    float32 product of :func:`~paddle_tpu_torch.models.common.
    matmul_f32out` over x's rows."""
    if out_dtype is None or out_dtype == x.dtype:
        return x @ w
    y = matmul_f32out(x.reshape(-1, x.shape[-1]), w)
    return y.view(*x.shape[:-1], y.shape[-1])


def row_gemm_split_plain(x, w, out_dtype=None):
    """The kernel's summation rule in plain PyTorch (float32 math, for
    the tests): each split of :func:`row_gemm_plan` sums its run of K,
    then the splits add in order, then one rounding to the output
    dtype."""
    K, N = w.shape
    plan = row_gemm_plan(x.shape[0], K, N, x.dtype)
    step = plan["split_stages"] * BLOCK_K
    xf, wf = x.float(), w.float()
    acc = None
    for s in range(plan["splits"]):
        part = xf[:, s * step:(s + 1) * step] @ wf[s * step:(s + 1) * step]
        acc = part if acc is None else acc + part
    return acc.to(out_dtype or x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("row_gemm").pt_row_gemm
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _counters(device, n_tiles):
    """The per-column-tile arrival counters of ``device``: zeroed once,
    and left zeroed by every launch (the last block of a tile resets
    its count)."""
    have = _COUNTERS.get(device)
    if have is None or have.numel() < n_tiles:
        have = torch.zeros(max(n_tiles, 1024), dtype=torch.int32,
                           device=device)
        _COUNTERS[device] = have
    return have


def _launch(x2, w, out_dtype):
    global LAUNCHES
    M, K = x2.shape
    N = w.shape[1]
    layout = weight_layout(w)
    if K % 8 or N % 8:
        raise ValueError(f"row_gemm: K={K} and N={N} must be multiples of 8 "
                         f"(16-byte copies)")
    for t in (x2, w):
        if t.data_ptr() % 16:
            raise ValueError("row_gemm: operands must be 16-byte aligned")
    ldw = w.stride(0) if layout == "kn" else w.stride(1)
    if ldw % 8:
        raise ValueError(f"row_gemm: weight rows {ldw} elements apart are "
                         f"not 16-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=x2.device)
    if M == 0:
        return out
    plan = row_gemm_plan(M, K, N, x2.dtype)
    splits = plan["splits"]
    counters = _counters(x2.device, plan["n_tiles"]) if splits > 1 else None
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    for r0 in range(0, M, MAX_ROWS):
        rows = min(MAX_ROWS, M - r0)
        part = (torch.empty((splits, rows, N), dtype=torch.float32,
                            device=x2.device) if splits > 1 else None)
        rc = _kernel()(
            x2[r0:].data_ptr(), w.data_ptr(), out[r0:].data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            _DTYPE_CODE[x2.dtype], int(layout == "nk"),
            int(out_dtype == torch.float32 and x2.dtype != torch.float32),
            rows, K, N, ldw, splits, plan["split_stages"], stream)
        if rc != 0:
            raise RuntimeError(f"row_gemm kernel launch failed: CUDA error "
                               f"{rc}")
    LAUNCHES += 1
    return out


def row_gemm(x, w, out_dtype=None):
    """y = x @ w over x [..., K] and w [K, N], each row of y computed
    from that row of x and w alone, bit for bit whatever the number of
    rows (see the module note).  ``w`` is a row-major [K, N] weight or
    the transpose of a row-major [N, K] table (``wte.t()``); ``out_dtype``
    None keeps x's dtype, ``torch.float32`` gives float32 output from
    bfloat16 operands.  CPU tensors run :func:`row_gemm_plain`; CUDA
    tensors launch the kernel (x and w float32 or bfloat16 alike, K and
    N multiples of 8) or raise."""
    _check(x, w, out_dtype)
    dev = x.device.type
    if dev == "cpu":
        return row_gemm_plain(x, w, out_dtype)
    if dev != "cuda":
        raise ValueError(f"row_gemm runs on cuda or cpu tensors, got "
                         f"{x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = _launch(x2, w, out_dtype or x.dtype)
    return y.view(*lead, w.shape[1])
