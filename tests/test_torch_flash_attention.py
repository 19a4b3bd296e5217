"""Port parity: paddle_tpu_torch's flash_attention against the JAX
package's ``flash_attention`` (Pallas, interpret mode on the CPU, as
tests/test_kernels.py runs it).

Inputs come from numpy with a seed.  Float32 throughout: the output is
held at atol 1e-5 and dq/dk/dv (``jax.grad`` against torch autograd,
with a random cotangent) at atol 1e-4 — same math, another summation
order.  On the CPU the port runs the Function's plain forward and
backward; the card tests (tests/test_torch_cuda.py) hold the kernels
to those.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn.kernels.flash_attention import \
    flash_attention as jax_flash
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
