"""Shared model-family helpers (port of ``paddle_tpu/models/common.py``).

The JAX package runs the decoder stack as ``lax.scan`` over per-layer
weights stacked on a leading L axis.  PyTorch runs eagerly, so the scan
becomes a Python loop over that axis; the stacked layout stays, so the
weights bridge maps the JAX tree one to one.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Union

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["layer_slices", "scan_layers_with_remat", "matmul_f32out"]


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


def scan_layers_with_remat(body: Callable, h: torch.Tensor,
                           layers: Dict[str, torch.Tensor],
                           remat: Union[bool, str] = False) -> torch.Tensor:
    """``h = body(h, lp)`` over the stacked layers, with the remat plan
    of the JAX function:

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
