"""The float32 kernels' product rule in plain PyTorch: a float32 product
as three TF32 products on the tensor cores.

The H100's float32 rate outside the tensor cores (67 TFLOP/s) is a
seventh of its TF32 tensor rate (495).  A TF32 operand keeps 10 bits of
mantissa, so the float32 kernels of ``csrc/fused_ce.cu`` and
``csrc/flash_attention.cu`` (forward) split each operand x into
hi = tf32(x) and lo = tf32(x - hi) and sum three products,
hi.hi + hi.lo + lo.hi, in float32; lo.lo (at most 2^-22 of the product)
is dropped.  Each product of two TF32 values is exact in float32, so
what the kernels keep of each operand is hi + lo, within 2^-22 |x|.

:func:`tf32_split` is the rounding the kernels do, bit for bit (round
to nearest, ties away from zero, by the integer bits of the float32
pattern: the same result as ``cvt.rna.tf32.f32``); :func:`mm_tf32x3`
and :func:`einsum_tf32x3` are the three products with float32 sums.
The kernels add the three per 8-wide step of the contraction, these sum
each product over the whole contraction first: the same terms, another
summation order.  The wrappers' plain versions stay true float32 and
remain the limits' reference; these emulate the kernels for the tests.
"""
from __future__ import annotations

import torch

__all__ = ["tf32_round", "tf32_split", "mm_tf32x3", "einsum_tf32x3"]

#: the half unit of the 13 low bits TF32 drops, and the mask that clears them
_HALF, _MASK = 0x1000, 0xFFFFE000


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32 (1 + 8 + 10 bits): add half of the
    dropped 13 bits' unit to the magnitude bits, then clear them.  Ties
    go away from zero; subnormals round by the same bits; +-inf stay;
    a finite value past the largest TF32 becomes inf; NaN stays NaN."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + _HALF) & _MASK
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return torch.where(torch.isnan(x), x, r.view(torch.float32))


def tf32_split(x: torch.Tensor):
    """(hi, lo) of float32 x: hi = tf32(x), lo = tf32(x - hi), both with
    13 zero low bits; |x - hi - lo| <= 2^-22 |x| for normal x.  Where hi
    is not finite, lo is 0."""
    hi = tf32_round(x)
    lo = tf32_round(x - hi)
    return hi, torch.where(torch.isfinite(hi), lo, torch.zeros_like(lo))


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the float32 kernels compute it:
    (a_hi b_hi + a_hi b_lo) + a_lo b_hi, each product in float32."""
    ah, al = tf32_split(a.float())
    bh, bl = tf32_split(b.float())
    return (ah @ bh + ah @ bl) + al @ bh


def einsum_tf32x3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` with the three split products."""
    ah, al = tf32_split(a.float())
    bh, bl = tf32_split(b.float())
    return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, al, bh)
