"""RMSNorm kernel and the rotary-embedding helpers (port of
``paddle_tpu/incubate/nn/kernels/fused_norm_rope.py``).

:func:`rms_norm` normalises each row of x [N, H] by its root mean square
and scales it by w [H], in one of two rounding policies:

* ``"fused"`` — the TPU kernel ``_rms_fwd_kernel`` (reached through
  ``rms_norm_pallas``): ``(x * rstd * w)`` in float32, rounded once to
  x's dtype; rstd [N] float32 is returned too.
* ``"llama"`` — ``paddle_tpu/models/llama.py::_rms_norm``, the XLA
  function every RMSNorm of the LLaMA path runs: rstd rounded to x's
  dtype, then ``x * rstd`` rounded, then ``* w`` rounded.  No path of the
  JAX package calls ``rms_norm_pallas``; this policy is what the port's
  LLaMA runs on the card.

In float32 the two are one function; in bfloat16 they differ in about a
third of the elements.  Both run in the hand-written CUDA kernel of
``csrc/rms_norm.cu``, whose header lists the rounding points that
:func:`rms_norm_plain` shares with it.

Dispatch: a CPU tensor runs :func:`rms_norm_plain`; a CUDA tensor
launches the kernel or raises.  There is no fallback.

Under autograd :func:`rms_norm` is differentiable in x and w in both
policies: the forward is the kernel (or the plain version on the CPU),
the backward plain PyTorch, as both JAX counterparts are XLA — "fused"
is the custom VJP ``_rms2d_bwd`` over the saved rstd, "llama" the
gradient JAX's autodiff takes through ``_rms_norm``, in its order and
with its roundings in x's dtype (rstd recomputed from x).

The rotary helpers (:func:`rope_tables`, :func:`apply_rope`,
:func:`fused_rotary_position_embedding`) are plain PyTorch, as the JAX
module keeps them out of Pallas.  Their rotation is the rotate-half
(NeoX) convention, which is NOT the interleaved-pair rotation of
``models/llama.py``.
"""
from __future__ import annotations

import ctypes

import torch

from ....device import resolve_device
from . import _build

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_pallas", "rope_tables",
           "apply_rope", "fused_rotary_position_embedding",
           "reset_launches", "LAUNCHES", "POLICIES"]

POLICIES = ("fused", "llama")

#: kernel launches so far, per policy (CUDA tensors only; the plain
#: version and rejected calls do not count)
LAUNCHES = {"fused": 0, "llama": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_POLICY_CODE = {"fused": 0, "llama": 1}
_fn = None


def reset_launches():
    """Set every policy's launch count to 0."""
    for policy in LAUNCHES:
        LAUNCHES[policy] = 0


def _check(x2d, w, policy):
    if policy not in POLICIES:
        raise ValueError(f"rms_norm policy must be one of {POLICIES}, got "
                         f"{policy!r}")
    if x2d.dim() != 2 or w.dim() != 1 or w.shape[0] != x2d.shape[1]:
        raise ValueError(f"rms_norm: x [N, H] and w [H] expected, got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    if x2d.device != w.device:
        raise ValueError(f"rms_norm: x lies on {x2d.device}, w on "
                         f"{w.device}")


def rms_norm_plain(x2d, w, eps: float, policy: str):
    """The kernel's function in plain PyTorch, with its rounding points:
    (out [N, H] in x's dtype, rstd [N] float32 for "fused" or None)."""
    _check(x2d, w, policy)
    xf = x2d.float()
    ms = (xf * xf).sum(-1, keepdim=True) / x2d.shape[1]
    rstd = torch.rsqrt(ms + eps)
    if policy == "fused":
        return ((xf * rstd) * w.float()).to(x2d.dtype), rstd[:, 0]
    return (x2d * rstd.to(x2d.dtype)) * w, None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rms_norm").pt_rms_norm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] \
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x2d, w, eps, policy):
    N, H = x2d.shape
    if x2d.dtype not in _DTYPE_CODE or w.dtype != x2d.dtype:
        raise TypeError(f"rms_norm: x and w must share float32 or bfloat16, "
                        f"got {x2d.dtype}/{w.dtype}")
    if H > 1 and x2d.stride(1) != 1:
        raise ValueError(f"rms_norm: the last axis of x must be contiguous, "
                         f"strides {x2d.stride()}")
    if H > 1 and w.stride(0) != 1:
        raise ValueError(f"rms_norm: w must be contiguous, stride "
                         f"{w.stride()}")
    out = torch.empty((N, H), dtype=x2d.dtype, device=x2d.device)
    rstd = (torch.empty((N,), dtype=torch.float32, device=x2d.device)
            if policy == "fused" else None)
    if N == 0 or H == 0:
        return out, rstd
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    rc = _kernel()(x2d.data_ptr(), x2d.stride(0), w.data_ptr(),
                   out.data_ptr(), 0 if rstd is None else rstd.data_ptr(),
                   _DTYPE_CODE[x2d.dtype], _POLICY_CODE[policy], N, H,
                   float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {rc}")
    LAUNCHES[policy] += 1
    return out, rstd


def _forward(x2d, w, eps, policy):
    if x2d.device.type == "cpu":
        return rms_norm_plain(x2d, w, eps, policy)
    if x2d.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu tensors, got "
                         f"{x2d.device}")
    return _launch(x2d, w, eps, policy)


def _fused_bwd(x, w, rstd, g):
    """JAX's ``_rms2d_bwd``: float32 math over the saved rstd."""
    xf, gf, wf = x.float(), g.float(), w.float()
    r = rstd[:, None]
    xhat = xf * r
    dxhat = gf * wf
    dx = r * (dxhat - xhat * ((dxhat * xhat).sum(-1, keepdim=True)
                              / x.shape[-1]))
    dw = (gf * xhat).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _llama_bwd(x, w, eps, g):
    """The gradient of ``(x * rstd.to(x.dtype)) * w`` with rstd =
    rsqrt(var), var = mean(x^2 in float32) + eps, step by step as JAX's
    autodiff takes it through ``_rms_norm`` (its jaxpr's order): the
    products in x's dtype, rsqrt's derivative as ``-0.5 * rstd / var``,
    the rstd branch back through float32, rounded once before the last
    add.  XLA:CPU fuses some of these bfloat16 steps at a higher
    precision, so JAX's bfloat16 gradient on the CPU is not a per-element
    reference; float32 is the bar."""
    H = x.shape[1]
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / H + eps
    rf = torch.rsqrt(var)
    r = rf.to(x.dtype)
    gy = g * w                                       # d(x * r)
    dw = (g * (x * r)).sum(0)
    dr = (gy * x).sum(-1, keepdim=True).float()
    dvar = dr * (-0.5 * (rf / var))                  # rsqrt's derivative
    dx = gy * r + ((dvar / H) * (2.0 * xf)).to(x.dtype)
    return dx, dw.to(w.dtype)


class _RmsNorm(torch.autograd.Function):
    """:func:`rms_norm` under autograd: the kernel (or plain) forward,
    the policy's plain backward."""

    @staticmethod
    def forward(ctx, x2d, w, eps, policy):
        out, rstd = _forward(x2d, w, eps, policy)
        ctx.save_for_backward(x2d, w, rstd)
        ctx.eps, ctx.policy = eps, policy
        if rstd is not None:
            ctx.mark_non_differentiable(rstd)
        return out, rstd

    @staticmethod
    def backward(ctx, g, _g_rstd):
        x, w, rstd = ctx.saved_tensors
        if ctx.policy == "fused":
            dx, dw = _fused_bwd(x, w, rstd, g)
        else:
            dx, dw = _llama_bwd(x, w, ctx.eps, g)
        return dx, dw, None, None


def rms_norm(x2d, w, eps: float, policy: str):
    """RMSNorm of each row of x2d [N, H] scaled by w [H]: (out [N, H] in
    x's dtype, rstd [N] float32 for ``policy="fused"``, None for
    ``"llama"``).

    CPU tensors run :func:`rms_norm_plain`; CUDA tensors launch the
    kernel (x and w float32 or both bfloat16, the last axis of x and w
    contiguous, any row stride) or raise.  Differentiable in x and w
    (the policy's plain backward)."""
    _check(x2d, w, policy)
    if torch.is_grad_enabled() and (x2d.requires_grad or w.requires_grad):
        return _RmsNorm.apply(x2d, w, eps, policy)
    return _forward(x2d, w, eps, policy)


def rms_norm_pallas(x, weight, epsilon: float = 1e-6):
    """RMSNorm over the last axis of ``x`` (any leading shape), the
    "fused" policy, differentiable in x and weight."""
    shape = x.shape
    out, _ = rms_norm(x.reshape(-1, shape[-1]), weight, epsilon, "fused")
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Rotary position embedding (NeoX rotate-half convention)
# ---------------------------------------------------------------------------

def rope_tables(seq_len: int, head_dim: int, base: float = 10000.0,
                dtype=torch.float32, position_ids=None, device=None):
    """(cos, sin), each [S, head_dim / 2] in ``dtype``: angles pos / base
    ** (i / half) in float32.  The tables land on ``position_ids``'
    device, else on ``device`` (CUDA by default)."""
    dev = (position_ids.device if position_ids is not None
           else resolve_device(device))
    half = head_dim // 2
    inv = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                       device=dev) / half))
    pos = (torch.arange(seq_len, dtype=torch.float32, device=dev)
           if position_ids is None else position_ids.float())
    freqs = torch.outer(pos, inv)                   # [S, half]
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [S, D/2].  Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style: bool = True):
    """The reference ``fused_rotary_position_embedding`` surface on
    tensors [B, S, H, D]: tables built from S (or ``position_ids``) when
    not given, else cut to [S, D/2]; returns the rotated q (and k), v
    unchanged."""
    S, D = q.shape[1], q.shape[-1]
    if cos is None or sin is None:
        cos, sin = rope_tables(S, D, dtype=q.dtype, position_ids=position_ids,
                               device=q.device)
    else:
        cos = cos.reshape(cos.shape[-2], -1)[:, :D // 2]
        sin = sin.reshape(sin.shape[-2], -1)[:, :D // 2]
    outs = [apply_rope(q, cos, sin)]
    if k is not None:
        outs.append(apply_rope(k, cos, sin))
    if v is not None:
        outs.append(v)
    return tuple(outs) if len(outs) > 1 else outs[0]
