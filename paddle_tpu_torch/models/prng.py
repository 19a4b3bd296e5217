"""JAX's threefry PRNG in torch: the parts of ``jax.random`` that the
samplers use (port of ``jax._src.prng`` / ``jax.random`` as the
installed JAX runs them: ``threefry2x32`` keys, 32-bit integers, and
``jax_threefry_partitionable=True``).

A key is an int64 tensor of shape [..., 2] holding two uint32 words
(torch's ``uint32`` lacks most operations on the CPU, so every word is
kept in int64 and masked to 32 bits after each step).  Leading
dimensions broadcast, so one call keys many rows at once.

Bit for bit with JAX: :func:`threefry2x32`, :func:`PRNGKey`,
:func:`fold_in`, :func:`split`, :func:`random_bits` and :func:`uniform`
are integer operations and a float32 subtraction, and give JAX's words.
:func:`gumbel` takes two ``torch.log``: XLA:CPU's ``log`` is not
correctly rounded, so the noise is JAX's within 5e-7 (one float32 ulp
where |g| >= 8) but not bit for bit, and a Gumbel-max draw
(``incubate/nn/kernels/sampling.py``'s ``gumbel_argmax_plain``, which
is ``jax.random.categorical``) gives JAX's token except where two
candidates' perturbed scores lie within that of each other (a
near-tie).

This is the plain version of the sampler kernel
(``incubate/nn/kernels/sampling.py``): the CPU path runs it, and the
card's kernel is held to it.
"""
from __future__ import annotations

import torch

__all__ = ["threefry2x32", "PRNGKey", "fold_in", "split", "random_bits",
           "uniform", "gumbel", "TINY"]

MASK32 = 0xFFFFFFFF
#: the key schedule's parity word (Threefish's C240)
_PARITY = 0x1BD11BDA
#: rotation distances of the two four-round groups
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32 smallest normal: the uniform's lower bound in ``gumbel``
TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 words held in int64
    tensors (or ints), broadcast together: returns the two output
    words.  A key injection follows every 4 rounds; the injection
    after group i adds the key words rotated by i + 1 and the count
    i + 1, as ``jax._src.prng._threefry2x32_lowering`` does."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def _words(x, device=None):
    """x as an int64 tensor of uint32 words (two's complement for a
    negative int32)."""
    t = torch.as_tensor(x, device=device)
    return t.to(torch.int64) & MASK32


def PRNGKey(seed, device=None):
    """``jax.random.PRNGKey(seed)`` as JAX runs it with 32-bit
    integers: [0, seed mod 2^32].  ``seed`` is an int or an integer
    tensor (one key per element, shape [..., 2]); a negative seed gives
    its two's complement."""
    lo = _words(seed, device)
    return torch.stack((torch.zeros_like(lo), lo), dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: ``threefry2x32(key, [0,
    data])``; ``data`` (an int or an integer tensor) broadcasts against
    the key's leading dimensions."""
    d = _words(data, key.device)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def _counters(shape, device):
    """(hi, lo) words of the linear index over ``shape``
    (``jax._src.prng.iota_2x32_shape``)."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device).view(*shape)
    return idx >> 32, idx & MASK32


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` in the partitionable ("foldlike")
    mode: key i is threefry2x32(key, (0, i)).  key [2] -> [num, 2]."""
    hi, lo = _counters((num,), key.device)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], hi, lo)
    return torch.stack((o0, o1), dim=-1)


def random_bits(key, shape):
    """``jax.random.bits(key, shape)`` (uint32): the two output words of
    the linear index's counter, XORed.  A key [..., 2] with leading
    dimensions draws ``shape`` for each: [..., *shape] (the same counters
    under every key, as ``vmap`` of the JAX function gives)."""
    shape = tuple(shape)
    hi, lo = _counters(shape, key.device)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k1 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    o0, o1 = threefry2x32(k0, k1, hi, lo)
    return o0 ^ o1


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    bits' top 23 as a mantissa of [1, 2), minus 1, scaled and shifted in
    float32, and at least ``minval``."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key, shape):
    """``jax.random.gumbel(key, shape)`` in float32, mode "low":
    ``-log(-log(uniform(tiny, 1)))`` (JAX's within 5e-7 or an ulp, see
    the module note)."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0)))

