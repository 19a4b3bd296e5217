"""Port parity: paddle_tpu_torch's RMSNorm and rotary helpers
(``incubate/nn/kernels/fused_norm_rope.py``) against the JAX module and
``paddle_tpu.models.llama._rms_norm``.

The JAX ``rms_norm_pallas`` runs its Pallas kernel in interpret mode.
On the CPU the port's wrapper runs the plain version, which is held:

* ``"fused"`` in float32 within 1e-6 of each value (out and rstd).  In
  bfloat16 the output equals JAX's except where rstd's last float32 bit
  differs: XLA:CPU's ``rsqrt`` is not correctly rounded (it is an
  estimate refined once, off the correctly rounded value by one unit on
  about 12 % of inputs on an x86 CPU) and its row sums run in another
  order, so rstd is held within 1e-6 relative and the output to one
  bfloat16 step on at most 1e-3 of the elements.
* ``"llama"`` in bfloat16 bit for bit against ``_rms_norm`` (rstd is
  rounded to bfloat16 before use, which hides a last-bit difference of
  the float32 rstd at these inputs), and in float32 within 1e-6.

Under autograd both policies' backward (plain PyTorch) is held to the
JAX gradient: see ``test_rms_norm_backward_matches_jax``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn.kernels import fused_norm_rope as jfnr
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.incubate.nn.kernels import fused_norm_rope as fnr

SHAPES = [(64, 512), (7, 1100), (5, 11)]
EPS = 1e-6


def _inputs(N, H, seed=0):
    rng = np.random.default_rng(seed + N * H)
    x = rng.standard_normal((N, H)).astype(np.float32) * 2
    w = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    return x, w


def _pair(a, jdt, tdt):
    """The same values in JAX (jdt) and torch (tdt)."""
    j = jnp.asarray(a, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _as_np(j):
    return np.asarray(jnp.asarray(j, jnp.float32))


def _bf16_steps(got, want):
    def ordered(a):
        b = a.astype(np.float32).view(np.int32) >> 16
        return np.where(b < 0, -(b & 0x7FFF), b)
    return np.abs(ordered(got) - ordered(want))


@pytest.mark.parametrize("N,H", SHAPES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rms_norm_pallas_matches_jax(N, H, dt):
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    x, w = _inputs(N, H)
    jx, tx = _pair(x, jdt, tdt)
    jw, tw = _pair(w, jdt, tdt)
    jout, jrstd = jfnr._rms_fwd(jx, jw, EPS, block_rows=256)
    before = dict(fnr.LAUNCHES)
    out, rstd = fnr.rms_norm(tx, tw, EPS, "fused")
    assert fnr.LAUNCHES == before          # CPU tensors: the plain version
    assert out.dtype == tdt and rstd.dtype == torch.float32
    assert rstd.shape == (N,)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), rtol=1e-6,
                               atol=0)
    got, want = out.float().numpy(), _as_np(jout)
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        steps = _bf16_steps(got, want)
        assert steps.max() <= 1 and (steps > 0).mean() <= 1e-3, \
            (steps.max(), (steps > 0).mean())
    # the public wrapper: any leading shape
    x3 = tx.reshape(1, N, H)
    np.testing.assert_array_equal(
        fnr.rms_norm_pallas(x3, tw, EPS).reshape(N, H).float().numpy(),
        got)
    np.testing.assert_allclose(
        _as_np(jfnr.rms_norm_pallas(jx.reshape(1, N, H), jw, EPS)).reshape(
            N, H), want, rtol=0, atol=0)


@pytest.mark.parametrize("N,H", [(8, 128), (3, 40)])
def test_rms_norm_pallas_grads_match_jax(N, H):
    x, w = _inputs(N, H, seed=1)
    g = np.random.default_rng(2).standard_normal((N, H)).astype(np.float32)

    def jloss(x, w):
        return jnp.sum(jfnr.rms_norm_pallas(x, w, EPS) * g)

    jdx, jdw = jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    (fnr.rms_norm_pallas(tx, tw, EPS) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("policy", fnr.POLICIES)
@pytest.mark.parametrize("N,H", [(64, 512), (7, 1100)])
def test_rms_norm_backward_matches_jax(policy, N, H):
    """``rms_norm`` under autograd, both policies, against the JAX
    gradient of its counterpart: "fused" the custom VJP of
    ``rms_norm_pallas`` (interpret mode), "llama" autodiff through
    ``llama._rms_norm``.  float32 within 1e-5 of each gradient's largest
    value; bfloat16 no farther from the float32 gradient than JAX's own
    bfloat16 gradient is, plus one bfloat16 step of the largest value.
    The port takes JAX's steps in JAX's order, but XLA:CPU sums the
    gradient's two bfloat16 ``reduce_sum``s in bfloat16 where the port
    sums in float32 and rounds once, so JAX's bfloat16 gradient on the
    CPU is not a per-element reference."""
    x, w = _inputs(N, H, seed=6)
    g = np.random.default_rng(7).standard_normal((N, H)).astype(np.float32)
    jfn = ((lambda a, b: jllama._rms_norm(a, b, EPS)) if policy == "llama"
           else (lambda a, b: jfnr.rms_norm_pallas(a, b, EPS)))
    grads = {}
    for dt in ("float32", "bfloat16"):
        jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
        (jx, tx), (jw, tw), (jg, tg) = (_pair(a, jdt, tdt) for a in (x, w, g))
        _, vjp = jax.vjp(jfn, jx, jw)
        tx.requires_grad_(True)
        tw.requires_grad_(True)
        out, rstd = fnr.rms_norm(tx, tw, EPS, policy)
        assert (rstd is None) == (policy == "llama")
        out.backward(tg)
        grads[dt] = ([_as_np(a) for a in vjp(jg)],
                     [tx.grad.float().numpy(), tw.grad.float().numpy()])
    want32 = grads["float32"][0]
    for got, want in zip(grads["float32"][1], want32):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    for jgot, got, want in zip(*grads["bfloat16"], want32):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= np.abs(jgot - want).max() \
            + 2 ** -8 * scale


@pytest.mark.parametrize("N,H", [(64, 4096), (7, 1100), (5, 11)])
def test_llama_policy_matches_jax_rms_norm(N, H):
    x, w = _inputs(N, H, seed=3)
    for dt in ("bfloat16", "float32"):
        jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
        jx, tx = _pair(x, jdt, tdt)
        jw, tw = _pair(w, jdt, tdt)
        want = _as_np(jax.jit(lambda a, b: jllama._rms_norm(a, b, EPS))(jx,
                                                                        jw))
        out, rstd = fnr.rms_norm(tx, tw, EPS, "llama")
        assert rstd is None and out.dtype == tdt
        if dt == "bfloat16":
            np.testing.assert_array_equal(out.float().numpy(), want)
        else:
            np.testing.assert_allclose(out.numpy(), want, rtol=1e-6,
                                       atol=1e-7)


def test_policies_are_one_function_in_f32_only():
    """The two rounding policies agree in float32 and part in bfloat16
    (about a third of the elements at unit-scale inputs)."""
    x, w = _inputs(32, 1024, seed=4)
    a = fnr.rms_norm_plain(torch.from_numpy(x), torch.from_numpy(w), EPS,
                           "fused")[0]
    b = fnr.rms_norm_plain(torch.from_numpy(x), torch.from_numpy(w), EPS,
                           "llama")[0]
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    a = fnr.rms_norm_plain(xb, wb, EPS, "fused")[0]
    b = fnr.rms_norm_plain(xb, wb, EPS, "llama")[0]
    share = (a != b).float().mean().item()
    assert 0.1 < share < 0.6, share


def test_rms_norm_rejects():
    x, w = torch.ones(4, 8), torch.ones(8)
    with pytest.raises(ValueError, match="policy"):
        fnr.rms_norm(x, w, EPS, "layer")
    with pytest.raises(ValueError, match=r"\[N, H\]"):
        fnr.rms_norm(x, torch.ones(7), EPS, "fused")
    with pytest.raises(ValueError, match=r"\[N, H\]"):
        fnr.rms_norm(x[None], w, EPS, "llama")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fnr.rms_norm(x.to("meta"), w.to("meta"), EPS, "llama")


def test_rope_helpers_match_jax():
    """rope_tables, the rotate-half apply_rope and
    fused_rotary_position_embedding (generated tables, given tables,
    position ids) against the JAX module, float32 at 1e-6."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pid = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5], np.int32)
    jc, js = jfnr.rope_tables(9, 16, position_ids=jnp.asarray(pid))
    tc, ts = fnr.rope_tables(9, 16, position_ids=torch.from_numpy(pid))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    jc, js = jfnr.rope_tables(9, 16)
    tc, ts = fnr.rope_tables(9, 16, device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(
        fnr.apply_rope(torch.from_numpy(q), tc, ts).numpy(),
        np.asarray(jfnr.apply_rope(jnp.asarray(q), jc, js)), atol=1e-6)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = fnr.fused_rotary_position_embedding(tq, tk, tv)
    want = jfnr.fused_rotary_position_embedding(jq, jk, jv)
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # given tables in the reference's [1, S, 1, D] layout
    big_c = np.concatenate([np.asarray(jc)] * 2, -1)[None, :, None, :]
    big_s = np.concatenate([np.asarray(js)] * 2, -1)[None, :, None, :]
    got = fnr.fused_rotary_position_embedding(
        tq, sin=torch.from_numpy(big_s), cos=torch.from_numpy(big_c))
    want = jfnr.fused_rotary_position_embedding(
        jq, sin=jnp.asarray(big_s), cos=jnp.asarray(big_c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    got = fnr.fused_rotary_position_embedding(
        tq, position_ids=torch.from_numpy(pid))
    want = jfnr.fused_rotary_position_embedding(
        jq, position_ids=jnp.asarray(pid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
