"""Port parity: paddle_tpu_torch's flash_attention against the JAX
package's ``flash_attention`` (Pallas, interpret mode on the CPU, as
tests/test_kernels.py runs it).

Inputs come from numpy with a seed.  Float32: the output is held at
atol 1e-5 and dq/dk/dv (``jax.grad`` against torch autograd, with a
random cotangent) at atol 1e-4 — same math, another summation order.

bfloat16: JAX's streaming kernels (explicit ``block_q`` 32 and
``block_k`` 64, so ``_fwd_kernel`` and ``_flash_bwd`` run, with delta =
rowsum(dO * O)) round P and dS to bf16 before their products; the port
keeps them in float32 (its tensor-core kernels carry each as two bf16
halves, see ``csrc/flash_attention.cu``).  So each element is held to
one bf16 step of itself plus half a step of the largest value,
|got - want| <= 2^-7 |want| + 2^-8 max |want| (JAX's rounding of P and
dS moves each term by at most 2^-9 of itself), and the whole to 2^-8 in
norm.  On the CPU the port runs the Function's plain forward and
backward; the card tests (tests/test_torch_cuda.py) hold the kernels to
those.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn.kernels.flash_attention import \
    flash_attention as jax_flash
from paddle_tpu.incubate.nn.kernels.flash_attention import \
    flash_attention_with_lse as jax_flash_lse
from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa


def _inputs(seed, B, S, nH, hD):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, nH, hD)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,hD", [(64, 32), (128, 64)])
def test_flash_attention_matches_jax(causal, S, hD):
    q, k, v, g = _inputs(S + hD + causal, 2, S, 2, hD)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal) * g)

    jout = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal)
    jgrads = jax.grad(jloss, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(g))
    assert fa.LAUNCHES == before       # CPU tensors never launch
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def _torch_bf16(x):
    return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16)


def _assert_bf16_near_jax(got, want):
    """Per element within 2^-7 |want| + 2^-8 max |want|, and within 2^-8
    of ||want|| in norm (see the module docstring)."""
    g = got.detach().float()
    w = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    assert g.shape == w.shape
    diff = (g - w).abs()
    limit = 2 ** -7 * w.abs() + 2 ** -8 * w.abs().max()
    assert bool((diff <= limit).all()), (diff / limit).max().item()
    assert (g - w).norm().item() <= 2 ** -8 * w.norm().item()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,hD", [(64, 32), (128, 64)])
def test_flash_attention_bf16_matches_jax_kernels(causal, S, hD):
    q, k, v, g = (_bf16(x) for x in _inputs(S + hD + causal, 2, S, 2, hD))
    jout, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=32, block_k=64), q, k, v)
    jgrads = vjp(g)
    tq, tk, tv = (_torch_bf16(x).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(_torch_bf16(g))
    assert out.dtype == tq.grad.dtype == torch.bfloat16
    _assert_bf16_near_jax(out, jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _assert_bf16_near_jax(got, want)


@pytest.mark.parametrize("offset", [-37, 37])
def test_flash_attention_with_lse_bf16_matches_jax_kernels(offset):
    """The ring variant at a run-time offset (rows 0..36 see no key at
    -37) with an lse cotangent, against JAX's ``flash_attention_with_lse``
    on [B*nH, S, hD]."""
    B, S, nH, hD = 2, 128, 2, 64
    rng = np.random.default_rng(5)
    q, k, v, g = (_bf16(x) for x in _inputs(5, B, S, nH, hD))
    g_lse = rng.standard_normal((B, nH, S)).astype(np.float32)

    def bh(x):
        return jnp.moveaxis(x, 2, 1).reshape(B * nH, S, hD)

    (jout, jlse), vjp = jax.vjp(lambda q, k, v: jax_flash_lse(
        bh(q), bh(k), bh(v), offset, None, True, 32, 64), q, k, v)
    jgrads = vjp((bh(g), jnp.asarray(g_lse).reshape(B * nH, S)))
    tq, tk, tv = (_torch_bf16(x).requires_grad_(True) for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, offset)
    torch.autograd.backward([out, lse], [_torch_bf16(g),
                                         torch.from_numpy(g_lse)])
    _assert_bf16_near_jax(out, jnp.moveaxis(
        jout.reshape(B, nH, S, hD), 1, 2))
    np.testing.assert_allclose(lse.detach().numpy().reshape(B * nH, S),
                               np.asarray(jlse), rtol=0, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _assert_bf16_near_jax(got, want)


def test_lse_is_the_row_logsumexp():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 1, 40, 2, 32))
    _, lse = fa.flash_attention_with_lse_plain(q, k, v, 0, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(32)
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(),
                      float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)


def test_ragged_kv_length_masks_causally():
    """Sk != Sq: key j is visible to query i iff j <= i (the JAX
    streaming kernel's rule at a zero offset)."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 24, 1, 32),
                                             dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 40, 1, 32),
                                              dtype=np.float32))
    out, _ = fa.flash_attention_with_lse_plain(q, kv, kv, 0, causal=True)
    want, _ = fa.flash_attention_with_lse_plain(q, kv[:, :24], kv[:, :24],
                                                0, causal=True)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


def test_operand_checks():
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="4-D"):
        fa.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="share"):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3,
                                                                    32))
    with pytest.raises(ValueError, match="devices"):
        fa.flash_attention(q, q.to("meta"), q)
