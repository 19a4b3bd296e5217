"""Multi-slot flash-decoding attention (port of
``paddle_tpu/incubate/nn/kernels/flash_decode.py``).

One kernel serves every attention of the serving path: decode (W = 1),
and admission prefill (W = S, pos = 0: causal self-attention is the
window mask with a zero base offset).  The TPU kernel
``_flash_decode_kernel`` becomes the hand-written CUDA kernel in
``csrc/flash_decode.cu``; its source note says what bounds it on the
H100 and what the simple design leaves for later.

Dispatch: a CPU tensor runs :func:`flash_decode_attention_plain`; a
CUDA tensor launches the kernel or raises.  There is no fallback from
one to the other.

The kernel takes the batch, token and head strides of q, k and v, so
the prefill path's q/k/v (strided slices of the packed qkv activation)
reach it without a copy; only the last axis must be contiguous.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_decode_attention", "flash_decode_attention_plain",
           "LAUNCHES"]

#: kernel launches so far (CUDA tensors only; the plain version and
#: rejected calls do not count)
LAUNCHES = 0

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
_fn = None


def _check(q, keys, values, pos):
    if q.dim() != 4 or keys.dim() != 4 or values.dim() != 4:
        raise ValueError("q, keys and values must be 4-D "
                         "([B, W, nH, hD] and [B, T, nKV, hD])")
    B, W, nH, hD = q.shape
    if keys.shape != values.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and values "
                         f"{tuple(values.shape)} differ in shape")
    if keys.shape[0] != B or keys.shape[3] != hD:
        raise ValueError(f"q {tuple(q.shape)} does not match keys "
                         f"{tuple(keys.shape)} in batch or head dim")
    nKV = keys.shape[2]
    if nKV < 1 or nH % nKV:
        raise ValueError(f"{nH} query heads are not a multiple of "
                         f"{nKV} kv heads")
    if hD not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hD} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or keys.dtype != q.dtype \
            or values.dtype != q.dtype:
        raise TypeError(f"q/keys/values must share float32 or bfloat16, "
                        f"got {q.dtype}/{keys.dtype}/{values.dtype}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be int32 [{B}], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    devs = {t.device for t in (q, keys, values, pos)}
    if len(devs) != 1:
        raise ValueError(f"q, keys, values and pos lie on different "
                         f"devices: {sorted(map(str, devs))}")


def flash_decode_attention_plain(q, keys, values, pos):
    """The kernel's function in plain PyTorch, float32 math: masked
    scores, exp against the row max, P.V divided by max(l, 1e-30)."""
    B, W, nH, hD = q.shape
    T, nKV = keys.shape[1], keys.shape[2]
    k = keys.float()
    v = values.float()
    if nKV != nH:
        k = k.repeat_interleave(nH // nKV, dim=2)
        v = v.repeat_interleave(nH // nKV, dim=2)
    s = torch.einsum("bwhd,bthd->bhwt",
                     q.float() * (1.0 / math.sqrt(hD)), k)
    rows = torch.arange(T, device=q.device)
    qidx = torch.arange(W, device=q.device)
    allowed = (rows[None, None, :]
               <= pos[:, None, None].long() + qidx[None, :, None])
    allowed = allowed[:, None]                          # [B, 1, W, T]
    s = s.masked_fill(~allowed, _NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * allowed
    l = p.sum(-1).clamp_min(1e-30)                      # [B, nH, W]
    out = torch.einsum("bhwt,bthd->bwhd", p, v)
    return (out / l.transpose(1, 2)[..., None]).to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_decode").pt_flash_decode
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _strides(t, vec):
    """Element strides of axes 0..2 of a 4-D operand, checked for the
    kernel's 16-byte vector loads (an axis of size 1 is never stepped,
    so its stride is passed as 0)."""
    if t.stride(3) != 1:
        raise ValueError(f"last axis must be contiguous, strides "
                         f"{t.stride()}")
    out = []
    for ax in range(3):
        s = 0 if t.shape[ax] == 1 else t.stride(ax)
        if s % vec:
            raise ValueError(f"stride {s} of axis {ax} is not a multiple "
                             f"of {vec} elements (16-byte loads)")
        out.append(s)
    if t.data_ptr() % 16:
        raise ValueError("operand is not 16-byte aligned")
    return out


def _launch(q, keys, values, pos):
    global LAUNCHES
    B, W, nH, hD = q.shape
    T, nKV = keys.shape[1], keys.shape[2]
    out = torch.empty((B, W, nH, hD), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    vec = 16 // q.element_size()
    qs, ks, vs = (_strides(t, vec) for t in (q, keys, values))
    pos = pos.contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(q.data_ptr(), keys.data_ptr(), values.data_ptr(),
                   pos.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
                   B, W, T, nH, nKV, hD, *qs, *ks, *vs,
                   1.0 / math.sqrt(hD), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out


def flash_decode_attention(q, keys, values, pos):
    """Contiguous-layout flash decoding attention.

    q [B, W, nH, hD] (W query positions per slot, fed at positions
    pos..pos+W-1); keys/values [B, T, nKV, hD] INCLUDING the window's
    own just-written K/V; pos [B] int32 (>= 0).  Query j of slot b
    attends cache rows < pos[b] + j + 1, so W = 1 is the decode step
    and pos = 0, W = S is causal prefill.  GQA via head grouping.
    Returns [B, W, nH, hD] in q's dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (float32 or bfloat16, hD in 16/32/64/128, last axis contiguous,
    other strides and the base 16-byte aligned) or raise."""
    _check(q, keys, values, pos)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, keys, values, pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    return _launch(q, keys, values, pos)
