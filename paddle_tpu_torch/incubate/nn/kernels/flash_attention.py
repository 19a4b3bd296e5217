"""Flash attention, forward and backward (port of
``paddle_tpu/incubate/nn/kernels/flash_attention.py``: ``flash_attention``
and its custom VJP ``_flash_bh``; ``flash_attention_with_lse``, the ring
variant with a run-time q offset, and its custom VJP ``_flash_bh_lse``).

softmax(Q K^T * scale, causal or not) V on [B, S, nH, hD] with O(S)
memory.  :func:`flash_attention` and :func:`flash_attention_with_lse`
call one ``torch.library`` custom op, :func:`flash_attention_op`
(``torch.ops.paddle_tpu_torch.flash_attention_fwd``), with its autograd
registered: the forward saves (q, k, v, out, lse); the backward computes
delta = rowsum(dO * O) in plain torch (the JAX wrapper computes it in
XLA outside the kernels) and launches the dK/dV kernel, then the dQ
kernel, both recomputing P from the saved lse.  The TPU kernels
(``_single_fwd_kernel`` / ``_fwd_kernel`` forward, ``_single_bwd_kernel``
/ ``_bwd_fused_kernel`` / ``_bwd_dkv_kernel`` + ``_bwd_dq_kernel``
backward) become the three hand-written CUDA kernels in
``csrc/flash_attention.cu``, in two designs chosen there by dtype:
bfloat16 runs on the tensor cores (``mma.sync``, bf16 tiles staged by
``cp.async``); float32 runs all three on the tensor cores too (``wgmma``),
each product as three TF32 products of split operands (``tf32x3.py``;
:func:`flash_attention_fwd_tf32x3_plain`,
:func:`flash_attention_bwd_dkv_tf32x3_plain` and
:func:`flash_attention_bwd_dq_tf32x3_plain` are that arithmetic in plain
PyTorch, no call takes a single TF32 pass); its source note says what
bounds them.

Rounding: every version keeps P and dS to float32 precision (the
bfloat16 kernels feed each to the tensor cores as two bf16 halves), so
the plain versions below are the kernels' function in float32.  The TPU
kernels round P and dS to bf16 before their products; in bfloat16 the
port stays within one bf16 step of the element plus half a step of the
largest value of JAX's results (tests/test_torch_flash_attention.py),
and the source note says why it does not round there itself.

:func:`flash_attention_with_lse` runs the same three kernels with a
run-time ``offset`` (key j visible to query i iff j <= i + offset) and
returns ``(out, lse)``; its backward takes the lse cotangent too and
folds it into delta (``delta - g_lse``), as ``_flash_bwd`` does.  Masked
scores are -1e30 and are exponentiated like any others, as in the TPU
kernels: a query row with no visible key attends every key with p = 1
(out the mean of v, lse -1e30), forward and backward.  Known difference:
for such rows of a k length that is not a multiple of the TPU kernel's
``block_k``, the JAX kernel also counts its padding keys (out = the sum
of v over the padded count); the port counts the Sk real keys.

Dispatch: CPU tensors run the plain forward and backward
(:func:`flash_attention_with_lse_plain` at offset 0 for
:func:`flash_attention`, :func:`flash_attention_bwd_dkv_plain`,
:func:`flash_attention_bwd_dq_plain`); CUDA tensors launch the kernels
or raise.  There is no fallback.  The kernels take the batch, token and
head strides of q, k, v and dO, so the training path's q/k/v (strided
slices of the packed qkv activation) reach them without a copy; the
gradients come back contiguous.

Launches are counted per kernel and per autograd entry that launched
it (:data:`LAUNCHES`): ``flash_attention_{fwd,bwd_dkv,bwd_dq}`` for
:func:`flash_attention` and for direct calls of the three wrappers,
``flash_attention_with_lse_{fwd,bwd_dkv,bwd_dq}`` for the ring variant.
The wrappers' ``entry`` argument names the key; the offset does not.
"""
from __future__ import annotations

import ctypes
import math
import numbers
from typing import Optional, Tuple

import torch

from . import _build
from .flash_decode import _strides
from .tf32x3 import einsum_tf32x3

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_fwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_with_lse_plain",
           "flash_attention_fwd_tf32x3_plain",
           "flash_attention_bwd_dkv_plain", "flash_attention_bwd_dq_plain",
           "flash_attention_bwd_dkv_tf32x3_plain",
           "flash_attention_bwd_dq_tf32x3_plain",
           "flash_attention_op", "default_use_flash", "launches",
           "reset_launches", "NEG_INF", "ENTRIES", "LAUNCHES"]

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)

#: the autograd entries that launch the kernels
ENTRIES = ("flash_attention", "flash_attention_with_lse")
_KERNELS = ("fwd", "bwd_dkv", "bwd_dq")
#: kernel launches so far, ``"<entry>_<kernel>"`` (CUDA tensors only;
#: the plain versions and rejected calls do not count)
LAUNCHES = {f"{e}_{k}": 0 for e in ENTRIES for k in _KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def reset_launches():
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches(entry: str = "flash_attention"):
    """The three kernels' counts under one entry of :data:`ENTRIES`."""
    return {f"{entry}_{k}": LAUNCHES[f"{entry}_{k}"] for k in _KERNELS}


def default_use_flash(device: torch.device) -> bool:
    """The models' policy: the kernel on the card, the plain softmax
    composition on the CPU."""
    return device.type == "cuda"


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _check(*ts, fake: bool = False):
    """Shapes and devices of q, k, v (and dO); True for CUDA operands.
    ``fake`` (the op's fake implementation) skips the device type."""
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
    if fake:
        return False
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {dev}")
    return dev.type == "cuda"


def _scores(q, k, causal, scale, offset):
    """Scaled float32 scores [B, nH, Sq, Sk], masked keys (j > i +
    offset under the causal mask) at -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        visible = (torch.arange(Sk, device=q.device)[None, :]
                   <= torch.arange(Sq, device=q.device)[:, None]
                   + offset)
        s = s.masked_fill(~visible, NEG_INF)
    return s


# ---------------------------------------------------------------------------
# Plain versions (float32 math)
# ---------------------------------------------------------------------------

def flash_attention_with_lse_plain(q, k, v, offset: int = 0,
                                   scale: Optional[float] = None,
                                   causal: bool = True):
    """The forward kernel's function, (out [B, Sq, nH, hD] in q's dtype,
    lse [B, nH, Sq] float32): the softmax of the scores with masked keys
    at -1e30 (a row with no visible key: every key at weight 1/Sk, lse
    -1e30), and ``torch.logsumexp`` for lse."""
    s = _scores(q, k, causal, _scale(q, scale), offset)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.float())
    return out.to(q.dtype), torch.logsumexp(s, -1)


def flash_attention_fwd_tf32x3_plain(q, k, v, offset: int = 0,
                                     scale: Optional[float] = None,
                                     causal: bool = True):
    """The float32 forward kernel's arithmetic in plain PyTorch, (out,
    lse): S = (q * scale) K^T and O = P V as three TF32 products of split
    operands (:func:`tf32x3.einsum_tf32x3`), P = exp(S - max) split as it
    is, l the sum of the unsplit P, out = O / l, lse = max + log l; masked
    scores -1e30 as in :func:`flash_attention_with_lse_plain`.  The
    kernel's online softmax rescales P tile by tile: another rounding of
    the same terms."""
    if q.dtype != torch.float32:
        raise TypeError(f"the tf32x3 forward is float32's, got {q.dtype}")
    s = _scores_tf32x3(q * _scale(q, scale), k, causal, offset)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    out = einsum_tf32x3("bhqk,bkhd->bqhd", p, v) / l.transpose(1, 2)[..., None]
    return out, m[..., 0] + torch.log(l)


def _scores_tf32x3(qs, k, causal, offset):
    """(q * scale) K^T [B, nH, Sq, Sk] as three TF32 products of split
    operands, masked keys at -1e30."""
    s = einsum_tf32x3("bqhd,bkhd->bhqk", qs, k)
    if causal:
        Sq, Sk = qs.shape[1], k.shape[1]
        visible = (torch.arange(Sk, device=qs.device)[None, :]
                   <= torch.arange(Sq, device=qs.device)[:, None] + offset)
        s = s.masked_fill(~visible, NEG_INF)
    return s


def _bwd_terms(q, k, v, dout, lse, delta, causal, scale, offset):
    """P = exp(S - lse), masked scores included (exp(-1e30 - lse): 0 in a
    row with a visible key, 1 in a row without), and dS = P * (dP -
    delta), [B, nH, Sq, Sk]."""
    p = torch.exp(_scores(q, k, causal, scale, offset) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                  causal: bool = True,
                                  scale: Optional[float] = None,
                                  offset: int = 0):
    """(dk, dv) in k's and v's dtype from the saved lse and delta."""
    scale = _scale(q, scale)
    p, ds = _bwd_terms(q, k, v, dout, lse, delta, causal, scale, offset)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                 causal: bool = True,
                                 scale: Optional[float] = None,
                                 offset: int = 0):
    """dq in q's dtype from the saved lse and delta."""
    scale = _scale(q, scale)
    _, ds = _bwd_terms(q, k, v, dout, lse, delta, causal, scale, offset)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
            * scale).to(q.dtype)


def _bwd_terms_tf32x3(q, k, v, dout, lse, delta, causal, scale, offset):
    """The float32 backward kernels' P and dS: S = (q * scale) K^T and
    dP = dO V^T as three TF32 products, P = exp(S - lse) and dS = P (dP -
    delta) unsplit, as the kernels hold them; and q * scale."""
    if q.dtype != torch.float32:
        raise TypeError(f"the tf32x3 backward is float32's, got {q.dtype}")
    qs = q * _scale(q, scale)
    p = torch.exp(_scores_tf32x3(qs, k, causal, offset) - lse[..., None])
    dp = einsum_tf32x3("bqhd,bkhd->bhqk", dout, v)
    return p, p * (dp - delta[..., None]), qs


def flash_attention_bwd_dkv_tf32x3_plain(q, k, v, dout, lse, delta,
                                         causal: bool = True,
                                         scale: Optional[float] = None,
                                         offset: int = 0):
    """The float32 dK/dV kernel's arithmetic in plain PyTorch, (dk, dv):
    S^T, dP^T (:func:`_bwd_terms_tf32x3`), dV = P^T dO and dK = dS^T
    (q * scale), every product three TF32 products of split operands
    (:func:`tf32x3.einsum_tf32x3`) with P and dS split as they are.  The
    kernel sums each query tile's products from zero and the tiles with
    rounding adds: another rounding of the same terms."""
    p, ds, qs = _bwd_terms_tf32x3(q, k, v, dout, lse, delta, causal, scale,
                                  offset)
    return (einsum_tf32x3("bhqk,bqhd->bkhd", ds, qs),
            einsum_tf32x3("bhqk,bqhd->bkhd", p, dout))


def flash_attention_bwd_dq_tf32x3_plain(q, k, v, dout, lse, delta,
                                        causal: bool = True,
                                        scale: Optional[float] = None,
                                        offset: int = 0):
    """The float32 dQ kernel's arithmetic in plain PyTorch: dQ = (dS K)
    scale, dS K three TF32 products of split operands, the scale a
    float32 multiply at the end (S and dS as in
    :func:`flash_attention_bwd_dkv_tf32x3_plain`)."""
    _, ds, _ = _bwd_terms_tf32x3(q, k, v, dout, lse, delta, causal, scale,
                                 offset)
    return einsum_tf32x3("bhqk,bkhd->bqhd", ds, k) * _scale(q, scale)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _kernel(name: str, n_ptrs: int, n_strides: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("flash_attention"), f"pt_{name}")
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
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


def _offset(offset):
    """The host int in int32 range that the kernels take."""
    if not isinstance(offset, numbers.Integral) \
            or not -2 ** 31 < int(offset) < 2 ** 31:
        raise TypeError(f"offset must be a host int in int32 range, got "
                        f"{offset!r}")
    return int(offset)


def _entry(entry):
    if entry not in ENTRIES:
        raise ValueError(f"entry must be one of {ENTRIES}, got {entry!r}")
    return entry


def _run(kernel, ptrs, args, scale, causal, offset, device, entry):
    name = f"flash_attention_{kernel}"
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = _kernel(name, len(ptrs), len(args) - 6)
    rc = fn(*ptrs, *args, scale, int(causal), offset, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[f"{entry}_{kernel}"] += 1


def _empty(shape, like):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None, offset: int = 0,
                        entry: str = "flash_attention"):
    """(out, lse) of :func:`flash_attention_with_lse_plain`'s function at
    the run-time ``offset`` (a host int).  CPU tensors run the plain
    version; CUDA tensors launch the forward kernel (float32 or
    bfloat16, hD in 32/64/128, last axis contiguous, other strides and
    the base 16-byte aligned; float32 as three TF32 products a product,
    :func:`flash_attention_fwd_tf32x3_plain`, whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says) or raise.  The
    launch counts under ``LAUNCHES[entry + "_fwd"]``."""
    offset, entry = _offset(offset), _entry(entry)
    if not _check(q, k, v):
        return flash_attention_with_lse_plain(q, k, v, offset, scale, causal)
    args = _kernel_args(q, k, v)
    B, Sq, nH, hD = q.shape
    out = _empty((B, Sq, nH, hD), q)
    lse = torch.empty((B, nH, Sq), dtype=torch.float32, device=q.device)
    _run("fwd",
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr()], args, _scale(q, scale), causal, offset, q.device,
         entry)
    return out, lse


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                            scale: Optional[float] = None, offset: int = 0,
                            entry: str = "flash_attention"):
    """(dk, dv), contiguous [B, Sk, nH, hD].  CPU tensors run the plain
    version; CUDA tensors launch the dK/dV kernel (counted under
    ``LAUNCHES[entry + "_bwd_dkv"]``; float32 as three TF32 products a
    product, :func:`flash_attention_bwd_dkv_tf32x3_plain`) or raise."""
    offset, entry = _offset(offset), _entry(entry)
    if not _check(q, k, v, dout):
        return flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                             causal, scale, offset)
    args = _kernel_args(q, k, v, dout)
    B, Sq, nH, _ = q.shape
    dk, dv = _empty(k.shape, k), _empty(v.shape, v)
    _run("bwd_dkv",
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          _stats(lse, B, nH, Sq).data_ptr(),
          _stats(delta, B, nH, Sq).data_ptr(), dk.data_ptr(),
          dv.data_ptr()], args, _scale(q, scale), causal, offset, q.device,
         entry)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                           scale: Optional[float] = None, offset: int = 0,
                           entry: str = "flash_attention"):
    """dq, contiguous [B, Sq, nH, hD].  CPU tensors run the plain
    version; CUDA tensors launch the dQ kernel (counted under
    ``LAUNCHES[entry + "_bwd_dq"]``; float32 as three TF32 products a
    product, :func:`flash_attention_bwd_dq_tf32x3_plain`) or raise."""
    offset, entry = _offset(offset), _entry(entry)
    if not _check(q, k, v, dout):
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                            causal, scale, offset)
    args = _kernel_args(q, k, v, dout)
    B, Sq, nH, _ = q.shape
    dq = _empty(q.shape, q)
    _run("bwd_dq",
         [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          _stats(lse, B, nH, Sq).data_ptr(),
          _stats(delta, B, nH, Sq).data_ptr(), dq.data_ptr()],
         args, _scale(q, scale), causal, offset, q.device, entry)
    return dq


def _backward(ctx, dout, g_lse=None):
    """(dq, dk, dv) from the saved (q, k, v, out, lse): delta =
    rowsum(dO * O) - g_lse in plain torch, then the dK/dV and dQ
    kernels at the forward's offset, counted under its entry."""
    q, k, v, out, lse = ctx.saved_tensors
    dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # [B,nH,Sq]
    if g_lse is not None:
        delta = delta - g_lse
    delta = delta.contiguous()
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal,
                                     ctx.scale, ctx.offset, ctx.entry)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, ctx.causal,
                                ctx.scale, ctx.offset, ctx.entry)
    return dq, dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, scale: Optional[float], offset: int,
                       entry: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable forward as one dispatcher op,
    ``torch.ops.paddle_tpu_torch.flash_attention_fwd``: (out, lse) of
    :func:`flash_attention_fwd` (CPU tensors: the plain version; CUDA
    tensors: the kernel, counted under ``LAUNCHES[entry + "_fwd"]``, or
    a raise).  Its backward is registered with it (the dK/dV and dQ
    kernels).  The kernel launches through ``ctypes``, which no
    dispatch mode sees; as an op, the forward itself is visible to one,
    so a selective-checkpoint policy can save its outputs and the
    backward of a rematerialized layer does not run it again (the JAX
    package's ``checkpoint_name(attn, "attn_out")``)."""
    return flash_attention_fwd(q, k, v, causal, scale, offset, entry)


@flash_attention_op.register_fake
def _(q, k, v, causal, scale, offset, entry):
    _check(q, k, v, fake=True)
    B, Sq, nH, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((B, nH, Sq), dtype=torch.float32))


def _op_setup(ctx, inputs, output):
    q, k, v, causal, scale, offset, entry = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.scale, ctx.offset, ctx.entry = causal, scale, offset, entry


def _op_backward(ctx, dout, g_lse):
    return (*_backward(ctx, dout, g_lse), None, None, None, None)


flash_attention_op.register_autograd(_op_backward, setup_context=_op_setup)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Flash attention on [B, S, nH, hD] tensors (k/v may be longer or
    shorter than q; causal masks key j from query i unless j <= i).
    Differentiable: both passes are kernels on the card and plain
    PyTorch on the CPU.  ``scale`` defaults to 1/sqrt(hD)."""
    return flash_attention_op(q, k, v, causal, scale, 0,
                              "flash_attention")[0]


def flash_attention_with_lse(q, k, v, offset: int,
                             scale: Optional[float] = None,
                             causal: bool = True):
    """The ring variant: flash attention on [B, S, nH, hD] tensors with
    key j visible to query i iff j <= i + ``offset`` (a host int: the
    position of q's chunk less k's).  Returns ``(out [B, Sq, nH, hD],
    lse [B, nH, Sq] float32)``; differentiable in q, k and v through
    both outputs (the lse cotangent folds into delta).  CPU tensors run
    :func:`flash_attention_with_lse_plain` and the plain backward, CUDA
    tensors the kernels (counted under ``flash_attention_with_lse_*``)
    or raise."""
    return flash_attention_op(q, k, v, causal, scale, _offset(offset),
                              "flash_attention_with_lse")
