"""The float32 kernels' product rule (``tf32x3.py``: each float32
product as three TF32 products of split operands) against the rounding
it names and against the JAX package's float32 kernels.

* ``tf32_split`` bit by bit: hi and lo keep 13 zero low bits, hi + lo is
  x within 2^-22 |x|, ties round away from zero, zeros, subnormals and
  +-inf are kept.
* ``fused_ce_fwd_tf32x3_plain`` against JAX's ``fused_ce_fwd`` (Pallas,
  interpret mode, as tests/test_chunked_ce.py runs it) and
  ``flash_attention_fwd_tf32x3_plain`` against JAX's
  ``flash_attention_with_lse`` in float32, at atol 1e-5: the split keeps
  each operand to 2^-22 of itself, so over H <= 256 (hD <= 64) the logits
  and scores move by ~1e-6, within the float32 summation-order room the
  existing parity tests allow (1e-5).  One TF32 pass, the negative
  control, misses that bound on the same inputs.
* ``flash_attention_bwd_{dkv,dq}_tf32x3_plain`` (the float32 backward
  kernels' arithmetic) against the gradients of JAX's
  ``flash_attention_with_lse`` in float32 (``jax.vjp`` through its
  custom VJP, whose backward kernels run in interpret mode), with an
  lse cotangent, at 1e-5 of max(1, max |grad|) for the same reason:
  every operand of the four products keeps 2^-22 of itself, and P and
  dS stay float32.  The grads are ~1 but for the rows with no visible
  key (offset -64: P = 1 on all 128 keys), where they reach ~45 and the
  same relative error is ~2e-5 absolute, so the bound is taken of the
  largest value, as the card holds the kernels.  One TF32 pass over
  q * scale, k, v and dO misses that bound.
* ``ce_plan`` of the float32 kernel fills the H100's 132 SMs at the
  eval shape of gpt3_1p3b's default-dtype training (N 2048).

The card tests (tests/test_torch_cuda.py) hold the kernels to these.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn.kernels.flash_attention import \
    flash_attention_with_lse as jax_flash_lse
from paddle_tpu.incubate.nn.kernels.fused_ce import \
    fused_ce_fwd as jax_fused_ce_fwd
from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
from paddle_tpu_torch.incubate.nn.kernels import fused_ce as fce
from paddle_tpu_torch.incubate.nn.kernels.tf32x3 import (tf32_round,
                                                          tf32_split)

TOL = dict(rtol=0, atol=1e-5)


def _bits(x):
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _one_pass(x):
    """A single TF32 pass's operand: tf32(x), no lo."""
    return tf32_round(x.float())


def test_tf32_split_keeps_22_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(20000)
                          * 2.0 ** rng.integers(-60, 60, 20000))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    assert bool(((_bits(hi) & 0x1FFF) == 0).all())
    assert bool(((_bits(lo) & 0x1FFF) == 0).all())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # a single pass keeps 11 bits: its error reaches 2^-12 of x
    one = (x.double() - hi.double()).abs() / x.double().abs()
    assert one.max().item() > 2.0 ** -13


def test_tf32_split_rounds_ties_away_from_zero():
    ulp = 2.0 ** -10                         # TF32's unit at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp,
                      1 + ulp / 2 - 2.0 ** -23, 2 - ulp / 2],
                     dtype=torch.float32)
    hi, lo = tf32_split(x)
    assert hi.tolist() == [1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0, 2.0]
    # lo of a tie is exact; 2^-11 - 2^-23 keeps 11 of its 13 bits
    assert (hi + lo)[[0, 1, 2, 4]].tolist() == x[[0, 1, 2, 4]].tolist()
    assert abs((hi + lo)[3].item() - x[3].item()) <= 2.0 ** -22


def test_tf32_split_keeps_zeros_subnormals_and_infinities():
    sub = torch.tensor([2.0 ** -130, -(2.0 ** -135), 2.0 ** -149],
                       dtype=torch.float32)
    x = torch.cat([torch.tensor([0.0, -0.0, float("inf"), -float("inf")]),
                   sub])
    hi, lo = tf32_split(x)
    assert hi[:4].tolist() == [0.0, -0.0, float("inf"), -float("inf")]
    assert torch.signbit(hi[1])
    assert lo[:4].tolist() == [0.0, 0.0, 0.0, 0.0]
    # 2^-130 and -2^-135 lie on TF32's grid (no flush to zero); 2^-149,
    # the smallest subnormal, sits below its 13 dropped bits
    assert hi[4:6].tolist() == sub[:2].tolist()
    assert hi[6].item() == 0.0
    assert bool(torch.isnan(tf32_split(torch.tensor([float("nan")]))[0]))


def _ce_data(seed, N, V, H):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, H)).astype(np.float32)
    W = (rng.standard_normal((V, H)) * 0.1).astype(np.float32)
    lbl = rng.integers(0, V, N).astype(np.int32)
    lbl[:4] = [-3, V, V + 7, 5000]
    return h, W, lbl


@pytest.mark.parametrize("N,H", [(128, 256), (256, 128)])
def test_fused_ce_tf32x3_matches_jax(N, H):
    """V 1000: a ragged tail in the kernels' vocabulary tiles (128 rows)
    and JAX's blocks; labels outside [0, V) pick nothing."""
    V = 1000
    h, W, lbl = _ce_data(N + H, N, V, H)
    jz, jp = jax_fused_ce_fwd(jnp.asarray(h), jnp.asarray(W),
                              jnp.asarray(lbl))
    th, tW, tl = (torch.from_numpy(x) for x in (h, W, lbl))
    z, picked = fce.fused_ce_fwd_tf32x3_plain(th, tW, tl)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(picked.numpy(), np.asarray(jp), **TOL)
    assert (picked[:4] == 0).all()
    # the negative control: one TF32 pass over the same operands
    oz, op = fce.fused_ce_fwd_plain(_one_pass(th), _one_pass(tW), tl)
    assert max(np.abs(oz.numpy() - np.asarray(jz)).max(),
               np.abs(op.numpy() - np.asarray(jp)).max()) > TOL["atol"]


def _bh(x):
    B, S, nH, hD = x.shape
    return jnp.asarray(np.moveaxis(x, 2, 1).reshape(B * nH, S, hD))


@pytest.mark.parametrize("causal,offset,S", [
    (True, 0, 100), (False, 0, 100), (True, -64, 128), (True, 64, 128),
    (True, 0, 128)])
def test_flash_forward_tf32x3_matches_jax(causal, offset, S):
    """Ragged S (100) at offset 0, and at S 128 (a multiple of JAX's key
    blocks) offsets -64 (rows 0-63 see no key: out the mean of v, lse
    -1e30) and 64; hD 64, two heads."""
    B, nH, hD = 1, 2, 64
    rng = np.random.default_rng(S + offset + causal)
    q, k, v = (rng.standard_normal((B, S, nH, hD)).astype(np.float32)
               for _ in range(3))
    jout, jlse = jax_flash_lse(_bh(q), _bh(k), _bh(v), offset, None, causal)
    jout = np.moveaxis(np.asarray(jout).reshape(B, nH, S, hD), 1, 2)
    jlse = np.asarray(jlse).reshape(B, nH, S)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = fa.flash_attention_fwd_tf32x3_plain(tq, tk, tv, offset,
                                                   causal=causal)
    np.testing.assert_allclose(out.numpy(), jout, **TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, **TOL)
    if offset < 0:
        assert (lse[:, :, :-offset] == -1e30).all()
    one, _ = fa.flash_attention_with_lse_plain(
        _one_pass(tq * (1 / hD ** 0.5)), _one_pass(tk), _one_pass(tv),
        offset, scale=1.0, causal=causal)
    assert np.abs(one.numpy() - jout).max() > TOL["atol"]


@functools.partial(jax.jit, static_argnums=5)
def _jax_flash_grads(q, k, v, g, g_lse, causal, offset):
    """dq, dk, dv of JAX's flash_attention_with_lse for the cotangents g
    and g_lse; the offset is traced, so the S 128 causal cases share one
    compile."""
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_lse(q, k, v, offset, None,
                                                   causal), q, k, v)
    return vjp((g, g_lse))


@pytest.mark.parametrize("causal,offset,S", [
    (True, 0, 100), (False, 0, 100), (True, -64, 128), (True, 64, 128),
    (True, 0, 128)])
def test_flash_backward_tf32x3_matches_jax(causal, offset, S):
    """The inputs of the forward's test, a cotangent dO and one of lse:
    dq, dk and dv of the emulations from the plain forward's out and lse
    (delta = rowsum(dO * O) - g_lse, as the port's backward has it)
    against JAX's vjp."""
    B, nH, hD = 1, 2, 64
    rng = np.random.default_rng(S + offset + causal + 1)
    q, k, v, g = (rng.standard_normal((B, S, nH, hD)).astype(np.float32)
                  for _ in range(4))
    g_lse = rng.standard_normal((B, nH, S)).astype(np.float32)
    jgrads = [np.moveaxis(np.asarray(x).reshape(B, nH, S, hD), 1, 2)
              for x in _jax_flash_grads(
                  _bh(q), _bh(k), _bh(v), _bh(g),
                  jnp.asarray(g_lse.reshape(B * nH, S)), causal, offset)]
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = fa.flash_attention_with_lse_plain(tq, tk, tv, offset,
                                                 causal=causal)
    delta = ((tg * out).sum(-1).transpose(1, 2)
             - torch.from_numpy(g_lse)).contiguous()
    args = (tq, tk, tv, tg, lse, delta, causal, None, offset)
    dk, dv = fa.flash_attention_bwd_dkv_tf32x3_plain(*args)
    dq = fa.flash_attention_bwd_dq_tf32x3_plain(*args)
    atol = [TOL["atol"] * max(1.0, np.abs(w).max()) for w in jgrads]
    for got, want, tol in zip((dq, dk, dv), jgrads, atol):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    scale = 1 / hD ** 0.5
    one = (_one_pass(tq * scale), _one_pass(tk), _one_pass(tv),
           _one_pass(tg), lse, delta, causal, 1.0, offset)
    odk, odv = fa.flash_attention_bwd_dkv_plain(*one)
    odq = fa.flash_attention_bwd_dq_plain(*one) * scale
    assert max(np.abs(o.numpy() - w).max() / tol
               for o, w, tol in zip((odq, odk, odv), jgrads, atol)) > 1


def test_float32_ce_plan_fills_the_h100():
    """33 splits of 12 tiles of 128 rows at N 2048, V 50304: 16 row
    tiles x 33 = 528 blocks, 4 full waves of 132."""
    tile = fce.VOCAB_TILES[torch.float32]
    splits, per = fce.ce_plan(2048, 50304, 132, tile)
    v_tiles = -(-50304 // tile)
    assert splits == -(-v_tiles // per)
    assert (2048 // fce.ROW_TILE * splits) % 132 == 0
    assert (splits, per) == (33, 12)
