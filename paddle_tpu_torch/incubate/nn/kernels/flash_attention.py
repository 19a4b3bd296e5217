"""Flash attention, forward and backward (port of
``paddle_tpu/incubate/nn/kernels/flash_attention.py``: ``flash_attention``
and its custom VJP ``_flash_bh``, at a zero q offset).

softmax(Q K^T * scale, causal or not) V on [B, S, nH, hD] with O(S)
memory.  :func:`flash_attention` is a ``torch.autograd.Function``: the
forward saves (q, k, v, out, lse); the backward computes
delta = rowsum(dO * O) in plain torch (the JAX wrapper computes it in
XLA outside the kernels) and launches the dK/dV kernel, then the dQ
kernel, both recomputing P from the saved lse.  The TPU kernels
(``_single_fwd_kernel`` / ``_fwd_kernel`` forward, ``_single_bwd_kernel``
/ ``_bwd_fused_kernel`` / ``_bwd_dkv_kernel`` + ``_bwd_dq_kernel``
backward) become the three hand-written CUDA kernels in
``csrc/flash_attention.cu``; its source note says what bounds them.

Dispatch: CPU tensors run the plain forward and backward
(:func:`flash_attention_fwd_plain`, :func:`flash_attention_bwd_dkv_plain`,
:func:`flash_attention_bwd_dq_plain`); CUDA tensors launch the kernels
or raise.  There is no fallback.  The kernels take the batch, token and
head strides of q, k, v and dO, so the training path's q/k/v (strided
slices of the packed qkv activation) reach them without a copy; the
gradients come back contiguous.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .flash_decode import _strides

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_fwd_plain", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_dq_plain", "default_use_flash",
           "NEG_INF", "LAUNCHES"]

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)

#: kernel launches so far, per kernel (CUDA tensors only; the plain
#: versions and rejected calls do not count)
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def default_use_flash(device: torch.device) -> bool:
    """The models' policy: the kernel on the card, the plain softmax
    composition on the CPU."""
    return device.type == "cuda"


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _check(*ts):
    q, k, v = ts[:3]
    if any(t.dim() != 4 for t in ts):
        raise ValueError("flash_attention operands must be 4-D "
                         "[B, S, nH, hD]")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must share batch, heads and "
                         f"head dim (k and v their length)")
    for t in ts[3:]:
        if t.shape != q.shape:
            raise ValueError(f"dO {tuple(t.shape)} must match q "
                             f"{tuple(q.shape)}")
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"flash_attention operands lie on different "
                         f"devices: {sorted(map(str, devs))}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {dev}")
    return dev.type == "cuda"


def _mask(Sq, Sk, device):
    """[Sq, Sk] True where key j is visible to query i (j <= i)."""
    return (torch.arange(Sk, device=device)[None, :]
            <= torch.arange(Sq, device=device)[:, None])


# ---------------------------------------------------------------------------
# Plain versions (float32 math)
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, causal: bool = True,
                              scale: Optional[float] = None):
    """(out [B, Sq, nH, hD] in q's dtype, lse [B, nH, Sq] float32):
    masked scores at -1e30, exp against the row max, P.V over
    max-normalised sums (a zero sum divides by 1)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * _scale(q, scale)
    if causal:
        s = s.masked_fill(~_mask(q.shape[1], k.shape[1], q.device), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _bwd_terms(q, k, v, dout, lse, delta, causal, scale):
    """P = exp(S - lse) and dS = P * (dP - delta), [B, nH, Sq, Sk]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * _mask(q.shape[1], k.shape[1], q.device)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                  causal: bool = True,
                                  scale: Optional[float] = None):
    """(dk, dv) in k's and v's dtype from the saved lse and delta."""
    scale = _scale(q, scale)
    p, ds = _bwd_terms(q, k, v, dout, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                 causal: bool = True,
                                 scale: Optional[float] = None):
    """dq in q's dtype from the saved lse and delta."""
    scale = _scale(q, scale)
    _, ds = _bwd_terms(q, k, v, dout, lse, delta, causal, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
            * scale).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _kernel(name: str, n_ptrs: int, n_strides: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("flash_attention"), f"pt_{name}")
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _kernel_args(q, k, v, *more):
    """Checks what the kernels take, then (dtype, B, Sq, Sk, nH, hD,
    strides...) for q, k, v and any further [B, S, nH, hD] operand."""
    B, Sq, nH, hD = q.shape
    if hD not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hD} not in {SUPPORTED_HEAD_DIMS}")
    ops = (q, k, v) + more
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in ops):
        raise TypeError(f"flash_attention operands must share float32 or "
                        f"bfloat16, got {[t.dtype for t in ops]}")
    vec = 16 // q.element_size()
    strides = [s for t in ops for s in _strides(t, vec)]
    return [_DTYPE_CODE[q.dtype], B, Sq, k.shape[1], nH, hD] + strides


def _stats(t, B, nH, Sq):
    if t.dtype != torch.float32 or tuple(t.shape) != (B, nH, Sq) \
            or not t.is_contiguous():
        raise ValueError(f"lse/delta must be contiguous float32 "
                         f"[{B}, {nH}, {Sq}], got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t


def _run(name, ptrs, args, scale, causal, device):
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = _kernel(name, len(ptrs), len(args) - 6)
    rc = fn(*ptrs, *args, scale, int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _empty(shape, like):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """(out, lse) of :func:`flash_attention_fwd_plain`'s function.  CPU
    tensors run the plain version; CUDA tensors launch the forward
    kernel (float32 or bfloat16, hD in 32/64/128, last axis contiguous,
    other strides and the base 16-byte aligned) or raise."""
    if not _check(q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    args = _kernel_args(q, k, v)
    B, Sq, nH, hD = q.shape
    out = _empty((B, Sq, nH, hD), q)
    lse = torch.empty((B, nH, Sq), dtype=torch.float32, device=q.device)
    _run("flash_attention_fwd",
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr()], args, _scale(q, scale), causal, q.device)
    return out, lse


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                            scale: Optional[float] = None):
    """(dk, dv), contiguous [B, Sk, nH, hD].  CPU tensors run the plain
    version; CUDA tensors launch the dK/dV kernel or raise."""
    if not _check(q, k, v, dout):
        return flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                             causal, scale)
    args = _kernel_args(q, k, v, dout)
    B, Sq, nH, _ = q.shape
    dk, dv = _empty(k.shape, k), _empty(v.shape, v)
    _run("flash_attention_bwd_dkv",
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          _stats(lse, B, nH, Sq).data_ptr(),
          _stats(delta, B, nH, Sq).data_ptr(), dk.data_ptr(),
          dv.data_ptr()], args, _scale(q, scale), causal, q.device)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                           scale: Optional[float] = None):
    """dq, contiguous [B, Sq, nH, hD].  CPU tensors run the plain
    version; CUDA tensors launch the dQ kernel or raise."""
    if not _check(q, k, v, dout):
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                            causal, scale)
    args = _kernel_args(q, k, v, dout)
    B, Sq, nH, _ = q.shape
    dq = _empty(q.shape, q)
    _run("flash_attention_bwd_dq",
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          _stats(lse, B, nH, Sq).data_ptr(),
          _stats(delta, B, nH, Sq).data_ptr(), dq.data_ptr()],
         args, _scale(q, scale), causal, q.device)
    return dq


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()                                   # [B, nH, Sq]
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                         ctx.causal, ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Flash attention on [B, S, nH, hD] tensors (k/v may be longer or
    shorter than q; causal masks key j from query i unless j <= i).
    Differentiable: both passes are kernels on the card and plain
    PyTorch on the CPU.  ``scale`` defaults to 1/sqrt(hD)."""
    return _FlashAttention.apply(q, k, v, causal, scale)
