"""RMSNorm kernels and the rotary-embedding helpers (port of
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
third of the elements.

:func:`add_rms_norm` is the residual add that feeds a norm, fused into
it: ``s = h + delta`` (rounded once to the dtype, as torch's add rounds
it) and the norm of s, both written by one launch; its plain version
:func:`add_rms_norm_plain` is exactly ``(h + delta, rms_norm_plain(h +
delta))``.  :func:`rms_norm_bwd` is the backward of either, one pass over
the rows (dx, plus the residual's cotangent when given, and dw).

All three run the hand-written CUDA kernels of ``csrc/rms_norm.cu``,
whose header lists the rounding points that the plain versions share
with them.  Dispatch: a CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.  There is no fallback.

Under autograd :func:`rms_norm` and :func:`add_rms_norm` are
differentiable in every tensor input, in both policies: the forward is
the kernel (or the plain version on the CPU), and so is the backward.
The backward is what JAX's gradient computes — "fused" the custom VJP
``_rms2d_bwd`` over the saved rstd, "llama" the gradient JAX's autodiff
takes through ``_rms_norm``, in its order and with its roundings in x's
dtype (rstd recomputed from x) — and the fused instance passes the
residual's cotangent through (ds = g_s + the norm's dx).

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

__all__ = ["rms_norm", "rms_norm_plain", "add_rms_norm",
           "add_rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
           "rms_norm_pallas", "rms_plan", "rope_tables", "apply_rope",
           "fused_rotary_position_embedding", "reset_launches", "LAUNCHES",
           "POLICIES"]

POLICIES = ("fused", "llama")

#: kernel launches so far (CUDA tensors only; the plain versions and
#: rejected calls do not count): the norm per policy, the fused residual
#: add instance ("add_<policy>") and the backward ("bwd_<policy>", both
#: instances; its two kernels count once)
LAUNCHES = {"fused": 0, "llama": 0, "add_fused": 0, "add_llama": 0,
            "bwd_fused": 0, "bwd_llama": 0}

#: the widest row a plan takes: threads of a row slot, vectors a thread
#: (the backward, whose dw partials stay in registers, up to 8)
MAX_GROUP, VPTS = 512, (1, 2, 4, 8, 16)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_POLICY_CODE = {"fused": 0, "llama": 1}
_fns = {}
_plans = {}


def reset_launches():
    """Set every launch count to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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


def _check_pair(a, b, what):
    if a.shape != b.shape or a.device != b.device or a.dtype != b.dtype:
        raise ValueError(f"rms_norm: {what} must match in shape, dtype and "
                         f"device, got {tuple(a.shape)} {a.dtype} {a.device}"
                         f" and {tuple(b.shape)} {b.dtype} {b.device}")


def _route(t):
    """True for a CUDA tensor (the kernel), False for a CPU one (the
    plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu tensors, got "
                         f"{t.device}")
    return True


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


def add_rms_norm_plain(h, delta, w, eps: float, policy: str):
    """The fused instance's function in plain PyTorch: (s, out) with
    s = h + delta and out = rms_norm_plain(s)."""
    _check_pair(h, delta, "h and delta")
    s = h + delta
    return s, rms_norm_plain(s, w, eps, policy)[0]


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


def rms_norm_bwd_plain(x2d, w, g, eps: float, policy: str, rstd=None,
                       g_s=None):
    """The backward kernel's function in plain PyTorch: (dx, dw) of the
    policy's norm at x2d for the cotangent g ("fused" reads the forward's
    rstd), with the residual's cotangent g_s added to dx when given."""
    if policy == "fused":
        dx, dw = _fused_bwd(x2d, w, rstd, g)
    else:
        dx, dw = _llama_bwd(x2d, w, eps, g)
    return (dx if g_s is None else dx + g_s), dw


def rms_plan(N: int, H: int, nv: int, kind: int = 0, sms: int = 132):
    """The kernels' thread layout for N rows of H elements read nv at a
    time: (vpt, group, threads) — a row slot of ``group`` threads (a
    multiple of 32) holds the row, ``vpt`` vectors a thread, and a block
    of ``threads`` holds one slot or several.  It takes the fewest
    vectors a thread that keep the slot within 256 threads — up to 16
    for the forward (``kind`` 0), 8 for the backward (1), whose dw
    partials stay in registers — else 8 over up to 512 threads.  A
    block takes as many slots as fit in 256 threads, but no more than
    the rows an SM gets when the rows are spread over ``sms`` SMs.  N
    enters only the slots a block: every row count takes the same sum
    order.  Raises for rows wider than MAX_GROUP x 8 vectors."""
    nvec = H // nv

    def slot(vpt):
        threads = -(-nvec // vpt)
        return vpt, 32 * max(1, -(-threads // 32))

    plans = [slot(v) for v in (VPTS if kind == 0 else VPTS[:-1])]
    plan = next((p for p in plans if p[1] <= 256), None) or slot(8)
    if plan[1] > MAX_GROUP:
        raise ValueError(f"rms_norm: a row of {H} elements read {nv} at a "
                         f"time exceeds the kernel's {MAX_GROUP} x 8 "
                         f"vectors")
    vpt, group = plan
    rows = max(1, min(256 // group, -(-N // sms)))
    return vpt, group, group * rows


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("rms_norm"), name)
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = {
            "pt_rms_norm_fwd": [ptr, ll, ptr, ll] + [ptr] * 4 + [i] * 9
                               + [ctypes.c_float, ptr],
            "pt_rms_norm_bwd": [ptr, ll, ptr, ptr, ll, ptr, ll] + [ptr] * 4
                               + [i] * 9 + [ctypes.c_float, ptr],
            "pt_rms_norm_blocks_per_sm": [i] * 7 + [ptr]}[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _plan(kind, x2d, policy, wide):
    """(vpt, group, threads, grid) of a launch, cached by kind (bit 0 the
    backward, bit 1 the residual instance: the fused add, g_s), device,
    shape, dtype, policy and width: the persistent grid is the blocks
    that fit on the card at once (registers, and w staged in shared
    memory), or fewer when the rows need fewer."""
    N, H = x2d.shape
    key = (kind, x2d.device, N, H, x2d.dtype, policy, wide)
    plan = _plans.get(key)
    if plan is None:
        nv = 16 // x2d.element_size() if wide else 1
        sms = torch.cuda.get_device_properties(
            x2d.device).multi_processor_count
        vpt, group, threads = rms_plan(N, H, nv, kind & 1, sms)
        fits = ctypes.c_int(0)
        rc = _kernel("pt_rms_norm_blocks_per_sm")(
            kind, _DTYPE_CODE[x2d.dtype], _POLICY_CODE[policy], int(wide),
            vpt, threads, H, ctypes.addressof(fits))
        if rc != 0 or fits.value < 1:
            raise RuntimeError(f"rms_norm occupancy query failed: CUDA error "
                               f"{rc}, {fits.value} blocks an SM")
        grid = min(-(-N // (threads // group)), sms * fits.value)
        plan = _plans[key] = (vpt, group, threads, grid)
    return plan


def _launchable(x2d, w, *rows):
    """Check a CUDA launch's tensors; returns whether 16-byte vectors
    can read every row (``wide``)."""
    if x2d.dtype not in _DTYPE_CODE or w.dtype != x2d.dtype:
        raise TypeError(f"rms_norm: x and w must share float32 or bfloat16, "
                        f"got {x2d.dtype}/{w.dtype}")
    H = x2d.shape[1]
    for t in (x2d, *rows):
        if H > 1 and t.stride(1) != 1:
            raise ValueError(f"rms_norm: the last axis of every [N, H] input "
                             f"must be contiguous, strides {t.stride()}")
    if H > 1 and w.stride(0) != 1:
        raise ValueError(f"rms_norm: w must be contiguous, stride "
                         f"{w.stride()}")
    nv = 16 // x2d.element_size()
    return H % nv == 0 and w.data_ptr() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) % nv == 0
        for t in (x2d, *rows))


def _launch_fwd(x2d, w, eps, policy, delta=None):
    """The forward kernel on CUDA tensors: (s or None, out, rstd or
    None); the fused instance when ``delta`` is given."""
    N, H = x2d.shape
    wide = _launchable(x2d, w, *(() if delta is None else (delta,)))
    dev, dt = x2d.device, x2d.dtype
    s = None if delta is None else torch.empty((N, H), dtype=dt, device=dev)
    out = torch.empty((N, H), dtype=dt, device=dev)
    rstd = (torch.empty((N,), dtype=torch.float32, device=dev)
            if policy == "fused" else None)
    if N == 0 or H == 0:
        return s, out, rstd
    vpt, group, threads, grid = _plan(0 if delta is None else 2, x2d,
                                      policy, wide)
    rc = _kernel("pt_rms_norm_fwd")(
        x2d.data_ptr(), x2d.stride(0),
        None if delta is None else delta.data_ptr(),
        0 if delta is None else delta.stride(0), w.data_ptr(),
        None if s is None else s.data_ptr(), out.data_ptr(),
        None if rstd is None else rstd.data_ptr(), _DTYPE_CODE[dt],
        _POLICY_CODE[policy], int(wide), vpt, group, threads, grid, N, H,
        float(eps), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {rc}")
    LAUNCHES[policy if delta is None else f"add_{policy}"] += 1
    return s, out, rstd


def _launch_bwd(x2d, w, g, eps, policy, rstd, g_s):
    N, H = x2d.shape
    g = g.contiguous() if H > 1 and g.stride(1) != 1 else g
    if g_s is not None and H > 1 and g_s.stride(1) != 1:
        g_s = g_s.contiguous()
    rows = (g,) if g_s is None else (g, g_s)
    wide = _launchable(x2d, w, *rows)
    dev, dt = x2d.device, x2d.dtype
    dx = torch.empty((N, H), dtype=dt, device=dev)
    if N == 0 or H == 0:
        return dx, torch.zeros((H,), dtype=dt, device=dev)
    dw = torch.empty((H,), dtype=dt, device=dev)
    vpt, group, threads, grid = _plan(1 if g_s is None else 3, x2d,
                                      policy, wide)
    part = torch.empty((grid * (threads // group), H), dtype=torch.float32,
                       device=dev)
    rc = _kernel("pt_rms_norm_bwd")(
        x2d.data_ptr(), x2d.stride(0), w.data_ptr(), g.data_ptr(),
        g.stride(0), None if g_s is None else g_s.data_ptr(),
        0 if g_s is None else g_s.stride(0),
        None if rstd is None else rstd.data_ptr(), dx.data_ptr(),
        part.data_ptr(), dw.data_ptr(), _DTYPE_CODE[dt],
        _POLICY_CODE[policy], int(wide), vpt, group, threads, grid, N, H,
        float(eps), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm backward kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES[f"bwd_{policy}"] += 1
    return dx, dw


def rms_norm_bwd(x2d, w, g, eps: float, policy: str, rstd=None, g_s=None):
    """The backward of the policy's norm at x2d [N, H] for the cotangent
    g [N, H]: (dx + g_s when g_s is given, dw).  "fused" takes the
    forward's rstd [N].  CPU tensors run :func:`rms_norm_bwd_plain`; CUDA
    tensors launch the backward kernel (one pass over the rows, then a
    fixed-order sum of dw's partials) or raise."""
    _check(x2d, w, policy)
    _check_pair(x2d, g, "x and its cotangent")
    if g_s is not None:
        _check_pair(x2d, g_s, "x and the residual's cotangent")
    if policy == "fused" and (rstd is None or rstd.shape != (x2d.shape[0],)):
        raise ValueError("rms_norm_bwd: the fused policy needs the "
                         "forward's rstd [N]")
    if not _route(x2d):
        return rms_norm_bwd_plain(x2d, w, g, eps, policy, rstd, g_s)
    return _launch_bwd(x2d, w, g, eps, policy, rstd, g_s)


def _forward(x2d, w, eps, policy):
    if not _route(x2d):
        return rms_norm_plain(x2d, w, eps, policy)
    _, out, rstd = _launch_fwd(x2d, w, eps, policy)
    return out, rstd


def _add_forward(h, delta, w, eps, policy):
    """(s, out, rstd or None) of the fused instance."""
    if not _route(h):
        s = h + delta
        return (s, *rms_norm_plain(s, w, eps, policy))
    return _launch_fwd(h, w, eps, policy, delta)


class _RmsNorm(torch.autograd.Function):
    """:func:`rms_norm` under autograd: the kernel (or plain) forward and
    backward."""

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
        dx, dw = rms_norm_bwd(x, w, g, ctx.eps, ctx.policy, rstd)
        return dx, dw, None, None


class _AddRmsNorm(torch.autograd.Function):
    """:func:`add_rms_norm` under autograd: s = h + delta feeds both the
    norm and the residual stream, so h and delta both receive
    ds = g_s + the norm's dx (one backward launch)."""

    @staticmethod
    def forward(ctx, h, delta, w, eps, policy):
        s, out, rstd = _add_forward(h, delta, w, eps, policy)
        ctx.save_for_backward(s, w, rstd)
        ctx.eps, ctx.policy = eps, policy
        ctx.set_materialize_grads(False)
        return s, out

    @staticmethod
    def backward(ctx, g_s, g):
        s, w, rstd = ctx.saved_tensors
        if g is None:
            return g_s, g_s, None, None, None
        ds, dw = rms_norm_bwd(s, w, g, ctx.eps, ctx.policy, rstd, g_s)
        return ds, ds, dw, None, None


def rms_norm(x2d, w, eps: float, policy: str):
    """RMSNorm of each row of x2d [N, H] scaled by w [H]: (out [N, H] in
    x's dtype, rstd [N] float32 for ``policy="fused"``, None for
    ``"llama"``).

    CPU tensors run :func:`rms_norm_plain`; CUDA tensors launch the
    kernel (x and w float32 or both bfloat16, the last axis of x and w
    contiguous, any row stride) or raise.  Differentiable in x and w
    (the backward kernel, :func:`rms_norm_bwd`)."""
    _check(x2d, w, policy)
    if torch.is_grad_enabled() and (x2d.requires_grad or w.requires_grad):
        return _RmsNorm.apply(x2d, w, eps, policy)
    return _forward(x2d, w, eps, policy)


def add_rms_norm(h, delta, w, eps: float, policy: str):
    """The residual add fused into the norm that reads it: (s, out) for
    h, delta [N, H] (any row strides, contiguous last axes) and w [H],
    with s = h + delta rounded once to their dtype and out the policy's
    RMSNorm of s, both [N, H] contiguous, in one launch.  For the same
    inputs s is bit for bit ``h + delta`` and out bit for bit
    :func:`rms_norm` of s (when h, delta and s take the same vector
    width: 16-byte aligned rows).  CPU tensors run
    :func:`add_rms_norm_plain`; CUDA tensors launch the kernel or raise.
    Differentiable in h, delta and w."""
    _check(h, w, policy)
    _check_pair(h, delta, "h and delta")
    if torch.is_grad_enabled() and (h.requires_grad or delta.requires_grad
                                    or w.requires_grad):
        return _AddRmsNorm.apply(h, delta, w, eps, policy)
    s, out, _ = _add_forward(h, delta, w, eps, policy)
    return s, out


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
