"""Shared model-family helpers (port of ``paddle_tpu/models/common.py``).

The JAX package runs the decoder stack as ``lax.scan`` over per-layer
weights stacked on a leading L axis.  PyTorch runs eagerly, so the scan
becomes a Python loop over that axis; the stacked layout stays, so the
weights bridge (:func:`params_from_numpy`, shared by every model family)
maps the JAX tree one to one.  The causal-attention composition and the
KV-cache format (zeroed caches, per-layer views, the quantize-on-write
seam, the prefill row writer) are family-neutral too: every model
family's serving entry points take them from here.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..incubate.nn.kernels.flash_attention import (default_use_flash,
                                                   flash_attention)
from ..incubate.nn.kv_quant import (byte_view, cast_kv, kv_has_scales,
                                    kv_storage_dtype, kv_zeros, quantize_kv,
                                    resolve_kv_dtype)

__all__ = ["layer_slices", "scan_layers_with_remat", "matmul_f32out",
           "params_from_numpy", "param_count"]


def params_from_numpy(tree, device=None,
                      dtype: Optional[torch.dtype] = None):
    """The weights bridge: a parameter tree of numpy arrays (the JAX
    pytree passed through ``np.asarray``) -> the port's tree of tensors
    on ``device`` (CUDA by default), same nesting and shapes; tuple
    leaves (the int8 ``(weight, scale)`` pairs of
    ``gpt.quantize_decode_params``) stay tuples.  Floating arrays are
    cast to ``dtype`` when given; bfloat16 numpy arrays (``ml_dtypes``)
    pass through float32, which holds them exactly."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        t = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
             if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return conv(node)

    return walk(tree)


def param_count(params) -> int:
    """Stored elements of the tree (int8 scales included)."""
    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, tuple):
            return sum(walk(v) for v in node)
        return node.numel()
    return walk(params)


def _causal_attention(q, k, v, head_dim, use_flash: Optional[bool] = False):
    """[B, S, nH, hD] causal attention.  ``use_flash`` (or ``None`` on a
    CUDA tensor, as ``default_use_flash``) routes to
    :func:`flash_attention`; otherwise the plain softmax composition in
    float32 (the JAX XLA branch)."""
    if use_flash is None:
        use_flash = default_use_flash(q.device)
    if use_flash:
        return flash_attention(q, k, v, causal=True)
    S = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(head_dim))
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check_attn_kernel(attn_kernel: Optional[str]) -> Optional[str]:
    """Validate the serving attention-kernel knob.  None/"xla" is the
    plain composition; "flash" routes decode and prefill attention
    through the flash_decode kernel."""
    if attn_kernel not in (None, "xla", "flash"):
        raise ValueError(
            f"attn_kernel must be 'xla' or 'flash', got {attn_kernel!r}")
    return attn_kernel


def _zero_cache(shape, kv_dtype: str, model_dtype, device):
    """Zeroed {"k", "v"} of ``shape`` [..., heads, hD] in the storage
    dtype of ``kv_dtype``, with int8's float32 scale planes {"ks", "vs"}
    [..., heads, 1]; shared by every model family's cache."""
    dev = resolve_device(device)
    kv_dtype = resolve_kv_dtype(kv_dtype)
    dt = kv_storage_dtype(kv_dtype, model_dtype)
    cache = {"k": kv_zeros(shape, dt, dev), "v": kv_zeros(shape, dt, dev)}
    if kv_has_scales(kv_dtype):
        # per-head, per-token scales: trailing axis 1 so every token-axis
        # index expression that addresses the data addresses the scale
        cache["ks"] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                  device=dev)
        cache["vs"] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                  device=dev)
    return cache


def _kv_layer(cache, l: int):
    """Layer ``l`` of the cache as (K, V): bare tensors, or (data,
    scale) pairs for int8 (the JAX ``_kv_xs`` convention)."""
    if "ks" in cache:
        return ((cache["k"][l], cache["ks"][l]),
                (cache["v"][l], cache["vs"][l]))
    return cache["k"][l], cache["v"][l]


def _kv_write(c, val, write):
    """Quantize-on-write seam shared by every cache-writing entry point:
    ``c`` is one layer's K or V (bare tensor or (data, scale) pair),
    ``val`` the freshly computed rows [..., hD] in compute precision,
    and ``write(arr, rows)`` stores rows already in ``arr``'s dtype at
    this entry point's index expression, in place.  Only this step's
    rows ever exist in the compute precision."""
    if isinstance(c, tuple):
        q, s = quantize_kv(val, "int8")
        write(c[0], q)
        write(c[1], s)
    else:
        write(c, cast_kv(val, c.dtype))


def _slot_rows_writer(slots, S):
    """Prefill writes: rows [0, S) of each listed slot."""
    def write(arr, rows):
        byte_view(arr)[slots, :S] = byte_view(rows)
    return write


def layer_slices(layers: Dict[str, torch.Tensor]
                 ) -> Iterator[Dict[str, Any]]:
    """Per-layer views {name: layers[name][l]} for l in 0..L-1.

    The views come from one ``unbind`` per stacked tensor, so under
    autograd each stack receives its per-layer gradients in one stack
    op rather than one full-size scatter per layer.  A tuple leaf (an
    int8 weight and its scale) yields a tuple of per-layer views."""
    def unbind(w):
        if isinstance(w, tuple):
            return tuple(zip(*(c.unbind(0) for c in w)))
        return w.unbind(0)

    per = {name: unbind(w) for name, w in layers.items()}
    n = len(next(iter(per.values())))
    for l in range(n):
        yield {name: ws[l] for name, ws in per.items()}


def scan_layers_with_remat(body: Callable, h: Any,
                           layers: Dict[str, torch.Tensor],
                           remat: Union[bool, str] = False) -> Any:
    """``h = body(h, lp)`` over the stacked layers, with the remat plan
    of the JAX function; the carry h is a tensor, or a tuple of them
    (LLaMA's residual pair without remat, its add pending):

      False — save everything;
      True  — full per-layer recompute: each layer runs under
              ``torch.utils.checkpoint`` (non-reentrant), which keeps
              only the layer's input and re-runs the layer in the
              backward (the kernels inside launch twice).

    The JAX plans ``'partial:K'`` and the named checkpoint policies
    (``dots_saveable_attn``, ...) are not ported and raise."""
    if isinstance(remat, str):
        raise NotImplementedError(
            f"remat={remat!r}: only False and True are ported (partial "
            f"and policy remat plans: ROADMAP Queue 1 item 10)")
    for lp in layer_slices(layers):
        if remat:
            h = checkpoint(body, h, lp, use_reentrant=False)
        else:
            h = body(h, lp)
    return h


class _MatmulF32Out(torch.autograd.Function):
    """The CUDA float32-output product under autograd: ``mm.dtype`` has
    no derivative, so the backward is written out (float32 cotangents,
    cast to each operand's dtype)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32out_cuda(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().t() @ g).to(b.dtype)
        return ga, gb


def _mm_f32out_cuda(a, b):
    try:
        return torch.mm(a, b, out_dtype=torch.float32)
    except TypeError as e:
        raise RuntimeError(
            f"matmul_f32out needs torch.mm(..., out_dtype=) (PyTorch "
            f"{torch.__version__} lacks it); a {a.dtype} product rounded "
            f"to {a.dtype} is not an acceptable substitute") from e


def matmul_f32out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D a [M, K], b [K, N] with a float32 result: the
    ``preferred_element_type=float32`` product of the JAX package.

    Float32 operands take the plain product.  For bfloat16 operands on
    CUDA it is ``torch.mm(a, b, out_dtype=torch.float32)`` (cuBLAS with
    float32 accumulation and a float32 store, no bf16 rounding of the
    result); on the CPU, where that overload has no kernel, it is
    ``a.float() @ b.float()`` — products of bf16 values are exact in
    float32, so both agree with the JAX product up to summation
    order."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32Out.apply(a, b)
        return _mm_f32out_cuda(a, b)
    return a.float() @ b.float()
