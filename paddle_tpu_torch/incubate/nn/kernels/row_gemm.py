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
(K, N) and the card's SM and cluster counts only, never from M; the
source note says what bounds the kernel and how it is built.

Dispatch: a CPU tensor runs :func:`row_gemm_plain`, which is exactly
what the CPU serving path computed before the kernel existed (``x @ w``
for the layer weights, ``matmul_f32out`` for the head), so the CPU
streams and the parity with JAX do not move.  A CUDA tensor launches
the kernel or raises.  There is no fallback.  ``LAUNCHES`` counts one
per wrapper call, however many CUDA launches the call makes (one per
256 rows).
"""
from __future__ import annotations

import ctypes

import torch

from ....models.common import matmul_f32out
from . import _build

__all__ = ["row_gemm", "row_gemm_plain", "row_gemm_split_plain",
           "row_gemm_plan", "split_bounds", "device_card", "weight_layout",
           "reset_launches", "LAUNCHES"]

#: kernel calls so far, one per wrapper call (CUDA tensors only; the
#: plain version and rejected calls do not count)
LAUNCHES = 0

#: weight columns a tile, K rows a stage, rows a group (one wgmma chain),
#: rows a launch
BLOCK_N, BLOCK_K, GROUP_ROWS, MAX_ROWS = 128, 64, 64, 256
#: the cluster sizes a plan may take (K splits of a tile)
CLUSTER_SIZES = (1, 2, 4, 8)
#: (SMs, {cluster size: clusters that fit at once}) of an H100 SXM as
#: ``pt_row_gemm_max_clusters`` reads it (a cluster stays inside one GPC),
#: the card a plan is made for when no card is named (the CPU tests)
H100 = (132, {1: 132, 2: 66, 4: 30, 8: 15})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_CARDS = {}
_PLANS = {}


def reset_launches():
    """Set the launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0


def row_gemm_plan(M: int, K: int, N: int, dtype, card=None) -> dict:
    """How the kernel cuts y [M, N] = x [M, K] @ w on ``card`` ((SMs,
    {cluster size: clusters that fit}); default :data:`H100`).

    A unit is (one tile of ``BLOCK_N`` columns, one K split).  The
    ``splits`` K splits of a tile are the ranks of one thread-block
    cluster, rank r owning stages [r ks / splits, (r + 1) ks / splits) of
    the ``k_stages`` stages of ``BLOCK_K`` (lengths differ by at most
    one); ``clusters`` clusters walk the tiles ``clusters`` apart, so
    every SM of the grid streams the same weight bytes to within one
    unit.  The plan takes the cluster size whose busiest SM streams the
    fewest stages (``sm_stages``), then the smaller cluster (fewer
    partials to sum).  Everything that decides a row's arithmetic
    comes from (K, N) and the card; dtype picks the instance, M only the
    launches of at most ``MAX_ROWS`` rows (``row_chunks``) and the row
    groups of a launch (``groups``)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"row_gemm takes float32 or bfloat16, got {dtype}")
    sms, fits = card or H100
    n_tiles = -(-N // BLOCK_N)
    k_stages = -(-K // BLOCK_K)
    cands = []
    for c in CLUSTER_SIZES:
        fit = fits.get(c, 0)
        if c > k_stages or fit < 1:
            continue
        tiles_per_cluster = -(-n_tiles // min(fit, n_tiles))
        clusters = -(-n_tiles // tiles_per_cluster)
        cands.append({"splits": c, "clusters": clusters,
                      "tiles_per_cluster": tiles_per_cluster,
                      "sm_stages": tiles_per_cluster * -(-k_stages // c)})
    best = min(cands, key=lambda p: (p["sm_stages"], p["splits"]))
    plan = {"n_tiles": n_tiles, "k_stages": k_stages, **best,
            "split_stages": -(-k_stages // best["splits"]),
            "sms": sms, "sms_used": best["clusters"] * best["splits"],
            "row_chunks": -(-M // MAX_ROWS),
            "groups": -(-min(M, MAX_ROWS) // GROUP_ROWS)}
    return plan


def split_bounds(K, splits):
    """The K ranges [k0, k1) of the splits, in order (stages of
    ``BLOCK_K``; the last may end past K)."""
    ks = -(-K // BLOCK_K)
    return [(r * ks // splits * BLOCK_K, (r + 1) * ks // splits * BLOCK_K)
            for r in range(splits)]


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


def row_gemm_split_plain(x, w, out_dtype=None, card=None):
    """The kernel's summation rule in plain PyTorch (float32 math, for
    the tests): each split of :func:`row_gemm_plan` on ``card`` sums its
    run of K, then the splits add in rank order, then one rounding to the
    output dtype."""
    K, N = w.shape
    plan = row_gemm_plan(x.shape[0], K, N, x.dtype, card)
    xf, wf = x.float(), w.float()
    acc = None
    for k0, k1 in split_bounds(K, plan["splits"]):
        part = xf[:, k0:k1] @ wf[k0:k1]
        acc = part if acc is None else acc + part
    return acc.to(out_dtype or x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("row_gemm").pt_row_gemm
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def device_card(device) -> tuple:
    """(SMs, {cluster size: clusters of the kernel that fit at once}) of
    a CUDA device, queried once."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    card = _CARDS.get(idx)
    if card is None:
        query = _build.load("row_gemm").pt_row_gemm_max_clusters
        query.argtypes = [ctypes.c_int]
        query.restype = ctypes.c_int
        with torch.cuda.device(idx):
            fits = {c: query(c) for c in CLUSTER_SIZES}
        bad = {c: n for c, n in fits.items() if n < 0}
        if bad or fits[1] < 1:
            raise RuntimeError(f"row_gemm: cluster occupancy query failed: "
                               f"{fits} (minus a CUDA error)")
        card = (torch.cuda.get_device_properties(idx).multi_processor_count,
                fits)
        _CARDS[idx] = card
    return card


def _plan(device, K, N):
    """(splits, clusters) of (K, N) on ``device``, cached."""
    key = (device.index, K, N)
    got = _PLANS.get(key)
    if got is None:
        plan = row_gemm_plan(1, K, N, torch.bfloat16, device_card(device))
        got = _PLANS[key] = (plan["splits"], plan["clusters"])
    return got


def _launch(x2, w, out_dtype):
    global LAUNCHES
    M, K = x2.shape
    N = w.shape[1]
    nk = weight_layout(w) == "nk"
    if K % 8 or N % 8:
        raise ValueError(f"row_gemm: K={K} and N={N} must be multiples of 8 "
                         f"(16-byte rows)")
    ldw = w.stride(1) if nk else w.stride(0)
    if ldw % 8 or x2.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"row_gemm: operands must be 16-byte aligned, "
                         f"with weight rows a multiple of 8 elements apart "
                         f"(got {ldw})")
    out = torch.empty((M, N), dtype=out_dtype, device=x2.device)
    if M == 0:
        return out
    splits, clusters = _plan(x2.device, K, N)
    stream = torch._C._cuda_getCurrentRawStream(x2.device.index)
    dtype = _DTYPE_CODE[x2.dtype]
    f32out = int(out_dtype == torch.float32 and dtype == 1)
    xp, op = x2.data_ptr(), out.data_ptr()
    xrow, orow = K * x2.element_size(), N * out.element_size()
    for r0 in range(0, M, MAX_ROWS):
        rc = _kernel()(xp + r0 * xrow, w.data_ptr(), op + r0 * orow, dtype,
                       int(nk), f32out, min(MAX_ROWS, M - r0), K, N, ldw,
                       splits, clusters, stream)
        if rc != 0:
            raise RuntimeError(
                f"row_gemm kernel launch failed: "
                + (f"tensor map not made (code {rc})" if rc >= 100000
                   else f"CUDA error {rc}"))
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
