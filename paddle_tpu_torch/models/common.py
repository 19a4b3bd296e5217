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

import functools
import math
from typing import Any, Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..incubate.nn.kernels.flash_attention import (default_use_flash,
                                                   flash_attention)
from ..incubate.nn.kv_quant import (byte_view, cast_kv, kv_has_scales,
                                    kv_storage_dtype, kv_zeros, quantize_kv,
                                    resolve_kv_dtype)

__all__ = ["layer_slices", "scan_layers_with_remat", "remat_policy",
           "matmul_f32out",
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


def _aten_ops(*names):
    """The aten overloads ``"op.overload"`` this PyTorch has (the
    ``out_dtype`` overload ``mm.dtype`` is recent)."""
    out = set()
    for name in names:
        op, overload = name.split(".")
        packet = getattr(torch.ops.aten, op, None)
        if packet is not None and hasattr(packet, overload):
            out.add(getattr(packet, overload))
    return frozenset(out)


#: products with no batch dimension: ``x @ w`` of a layer (a 3-D by 2-D
#: ``matmul`` dispatches ``view`` + ``mm``), ``F.linear``'s ``addmm`` and
#: ``matmul_f32out``'s CUDA product ``mm.dtype``
_NO_BATCH_DOTS = _aten_ops("mm.default", "mm.dtype", "addmm.default",
                           "addmm.dtype")
#: every product: the above and the batched ones (the plain attention's
#: ``einsum`` dispatches ``bmm``)
_DOTS = _NO_BATCH_DOTS | _aten_ops("bmm.default", "bmm.dtype",
                                   "baddbmm.default", "baddbmm.dtype")


def _flash_ops():
    return frozenset({torch.ops.paddle_tpu_torch.flash_attention_fwd.default})


def _saving(ops):
    """A selective-checkpoint policy that saves the outputs of ``ops``
    (a frozenset, or None for every op) and recomputes the rest."""
    def policy(ctx, func, *args, **kwargs):
        if ops is None or func in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


#: the argument-free policies of ``jax.checkpoint_policies`` and what
#: each saves; the products the layer bodies dispatch, logged once with a
#: ``TorchDispatchMode`` over GPT's and LLaMA's layers (float32 and
#: bfloat16, flash and plain attention): ``aten.mm.default`` for every
#: ``x @ w``, ``aten.bmm.default`` for the plain attention's two
#: ``einsum``s, and ``paddle_tpu_torch.flash_attention_fwd.default`` for
#: the flash forward (no ``addmm``/``baddbmm``; ``mm.dtype`` only in the
#: heads' ``matmul_f32out`` on CUDA, outside the layers)
_POLICIES = {
    "everything_saveable": lambda: None,
    "nothing_saveable": lambda: frozenset(),
    "dots_saveable": lambda: _DOTS,
    "checkpoint_dots": lambda: _DOTS,
    "dots_with_no_batch_dims_saveable": lambda: _NO_BATCH_DOTS,
    "checkpoint_dots_with_no_batch_dims": lambda: _NO_BATCH_DOTS,
    # dots_saveable + the flash forward's outputs (JAX: save_from_both_
    # policies(dots_saveable, save_only_these_names("attn_out")))
    "dots_saveable_attn": lambda: _DOTS | _flash_ops(),
}


def remat_policy(name: str):
    """The selective-checkpoint policy of a named remat plan (a policy
    function for ``create_selective_checkpoint_contexts``).  An unknown
    name raises ``AttributeError``, as JAX's
    ``getattr(jax.checkpoint_policies, name)`` does."""
    if name not in _POLICIES:
        raise AttributeError(
            f"remat={name!r}: no such checkpoint policy (the plans are "
            f"False, True, 'partial:K' and {sorted(_POLICIES)})")
    return _saving(_POLICIES[name]())


def _checkpointed(body, policy=None):
    """``body`` run under ``torch.utils.checkpoint`` (non-reentrant);
    with ``policy``, selectively: the ops it saves keep their outputs,
    the rest re-run in the backward."""
    kw = {} if policy is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, policy)}
    return lambda h, lp: checkpoint(body, h, lp, use_reentrant=False, **kw)


def scan_layers_with_remat(body: Callable, h: Any,
                           layers: Dict[str, torch.Tensor],
                           remat: Union[bool, str] = False) -> Any:
    """``h = body(h, lp)`` over the stacked layers, with the remat plans
    of the JAX function; the carry h is a tensor, or a tuple of them
    (LLaMA's residual pair without remat, its add pending):

      False        — save everything;
      True         — full per-layer recompute: each layer runs under
                     ``torch.utils.checkpoint`` (non-reentrant), which
                     keeps only the layer's input and re-runs the layer
                     in the backward (the kernels inside launch twice);
      '<policy>'   — selective: a named policy of :func:`remat_policy`
                     (JAX's ``jax.checkpoint_policies`` names without
                     arguments) through PyTorch's selective activation
                     checkpointing; the saved ops' outputs are kept, the
                     rest re-run in the backward;
      'dots_saveable_attn' — ``dots_saveable`` and the flash forward's
                     outputs (the flash op, ``flash_attention_op``): its
                     kernel does not run again in the backward;
      'partial:K'  — the first K layers under ``dots_saveable_attn``,
                     the rest saving everything: recompute scales with
                     K/L.  K >= L is the uniform policy; K <= 0 raises
                     ``ValueError``."""
    n_layers = next(iter(layers.values()))
    n_layers = (n_layers[0] if isinstance(n_layers, tuple)
                else n_layers).shape[0]
    first = 0
    if isinstance(remat, str) and remat.startswith("partial:"):
        k = int(remat.split(":", 1)[1])
        if k <= 0:
            raise ValueError(f"remat={remat!r}: K must be >= 1")
        remat = "dots_saveable_attn"
        first = min(k, n_layers)
    elif remat:
        first = n_layers
    if isinstance(remat, str):
        wrapped = _checkpointed(body, remat_policy(remat))
    else:
        wrapped = _checkpointed(body) if remat else body
    for l, lp in enumerate(layer_slices(layers)):
        h = wrapped(h, lp) if l < first else body(h, lp)
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
