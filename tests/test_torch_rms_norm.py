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


@pytest.mark.parametrize("N,H", [(8, 4096), (7, 1100), (5, 11)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_add_rms_norm_plain_matches_jax(N, H, dt):
    """The fused instance's plain version against JAX's ``h + delta``
    followed by ``llama._rms_norm`` (each its own jitted program): s bit
    for bit in both dtypes; out
    bit for bit in bfloat16 and, in float32, within the bar of the
    unfused norm (``test_llama_policy_matches_jax_rms_norm``: 1e-6, the
    row sums run in another order); and through the wrapper (no launch
    on the CPU) the same values."""
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    h, w = _inputs(N, H, seed=8)
    delta = np.random.default_rng(9).standard_normal((N, H)).astype(
        np.float32)
    (jh, th), (jd, td), (jw, tw) = (_pair(a, jdt, tdt) for a in (h, delta, w))
    # two programs: in one, XLA:CPU fuses the bfloat16 add into the
    # norm's float32 math and skips the add's rounding
    js = jax.jit(lambda a, b: a + b)(jh, jd)
    jout = jax.jit(lambda a, c: jllama._rms_norm(a, c, EPS))(js, jw)
    s, out = fnr.add_rms_norm_plain(th, td, tw, EPS, "llama")
    np.testing.assert_array_equal(s.float().numpy(), _as_np(js))
    if dt == "bfloat16":
        np.testing.assert_array_equal(out.float().numpy(), _as_np(jout))
    else:
        np.testing.assert_allclose(out.numpy(), _as_np(jout), rtol=1e-6,
                                   atol=1e-7)
    before = dict(fnr.LAUNCHES)
    s2, out2 = fnr.add_rms_norm(th, td, tw, EPS, "llama")
    assert fnr.LAUNCHES == before
    assert torch.equal(s2, s) and torch.equal(out2, out)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("policy", fnr.POLICIES)
@pytest.mark.parametrize("N,H", [(7, 1100)])
def test_add_rms_norm_backward_matches_jax(residual, policy, N, H):
    """``add_rms_norm`` under autograd (the plain backward on the CPU),
    with the residual's cotangent g_s (``residual``) and without it (only
    out is used), against ``jax.vjp`` of h + delta followed by the
    policy's JAX norm, float32 within 1e-5 of each gradient's largest
    value (the bar of ``test_rms_norm_backward_matches_jax``); h and
    delta receive the same gradient."""
    x, w = _inputs(N, H, seed=10)
    rng = np.random.default_rng(11)
    delta, g, g_s = (rng.standard_normal((N, H)).astype(np.float32)
                     for _ in range(3))
    jnorm = ((lambda a, b: jllama._rms_norm(a, b, EPS)) if policy == "llama"
             else (lambda a, b: jfnr.rms_norm_pallas(a, b, EPS)))
    if residual:
        def jfn(a, b, c):
            return a + b, jnorm(a + b, c)
        cot = (jnp.asarray(g_s), jnp.asarray(g))
    else:
        def jfn(a, b, c):
            return jnorm(a + b, c)
        cot = jnp.asarray(g)
    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(delta), jnp.asarray(w))
    want = [_as_np(a) for a in vjp(cot)]
    th, td, tw = (torch.tensor(a, requires_grad=True) for a in (x, delta, w))
    s, out = fnr.add_rms_norm(th, td, tw, EPS, policy)
    if residual:
        torch.autograd.backward([s, out], [torch.from_numpy(g_s),
                                           torch.from_numpy(g)])
    else:
        out.backward(torch.from_numpy(g))
    assert torch.equal(th.grad, td.grad)
    for got, ref in zip((th.grad, td.grad, tw.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dt,remat", [("float32", False),
                                      ("bfloat16", True)])
def test_llama_fused_route_equals_unfused_bitwise(dt, remat, monkeypatch):
    """llama_tiny on the CPU: the forward's logits, the train step's loss
    and every gradient through the fused residual-add route equal bit for
    bit those of the unfused route (the add, then ``rms_norm``: autograd
    sums the residual's two cotangents, as the fused backward does), in
    float32 and in bfloat16 (under remat, whose checkpointed layers carry
    the residual sum and fuse only the ffn norms)."""
    from paddle_tpu_torch.models import llama as tl
    cfg = tl.llama_tiny(initializer_range=0.3, dtype=getattr(torch, dt),
                        vocab_size=256, hidden_size=64, num_layers=3)
    params = tl.init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(12)
    ids, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
                   for _ in range(2))

    def unfused(h, delta, w, eps, policy):
        s = h + delta
        return s, fnr.rms_norm(s, w, eps, policy)[0]

    runs = []
    for route in ("fused", "unfused"):
        if route == "unfused":
            monkeypatch.setattr(tl, "add_rms_norm", unfused)
        p = {k: ({n: t.detach().requires_grad_(True) for n, t in v.items()}
                 if isinstance(v, dict) else v.detach().requires_grad_(True))
             for k, v in params.items()}
        leaves = [t for v in p.values()
                  for t in (v.values() if isinstance(v, dict) else [v])]
        logits = tl.forward(p, ids, cfg)
        loss = tl.loss_fn(p, ids, labels, cfg, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        runs.append([logits, loss, *grads])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_llama_remat_checkpoints_one_tensor_a_layer(monkeypatch):
    """Under remat each layer's checkpoint keeps its input, the residual
    sum, as one tensor (the unfused stack's): the pending pair is summed
    before each checkpoint, and the fused route's ffn norms still fuse."""
    from paddle_tpu_torch.models import common
    from paddle_tpu_torch.models import llama as tl
    cfg = tl.llama_tiny(vocab_size=256, hidden_size=64, num_layers=3)
    params = tl.init_params(cfg, seed=2, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 8)))
    kept, inner = [], common.checkpoint

    def spy(body, h, lp, **kw):
        kept.append(h)
        return inner(body, h, lp, **kw)

    monkeypatch.setattr(common, "checkpoint", spy)
    calls = []
    real = tl.add_rms_norm
    monkeypatch.setattr(tl, "add_rms_norm",
                        lambda *a: calls.append(1) or real(*a))
    tl.loss_fn(params, ids, ids, cfg, remat=True)
    assert len(kept) == cfg.num_layers
    assert all(isinstance(h, torch.Tensor) for h in kept)
    assert len(calls) == cfg.num_layers


def test_rms_plan_holds_the_row():
    """The kernels' plans: a row slot of a multiple of 32 threads covers
    the row within 256 threads wherever 16 vectors a thread (the
    forward) or 8 (the backward, dw partials in registers) allow; the sum
    order (vpt, group) does not move with N; rows past 512 x 8 vectors
    raise."""
    for H in (11, 128, 1100, 4096, 5120, 8192, 11008, 16384, 40000):
        for nv in (1, 4, 8):
            if H % nv:
                continue
            for kind in (0, 1):
                if H // nv > fnr.MAX_GROUP * 8:
                    with pytest.raises(ValueError, match="exceeds"):
                        fnr.rms_plan(8, H, nv, kind)
                    continue
                vpt, group, threads = fnr.rms_plan(8192, H, nv, kind)
                assert vpt in (fnr.VPTS if kind == 0 else fnr.VPTS[:-1])
                assert group % 32 == 0 and group * vpt * nv >= H
                assert threads % group == 0
                assert threads <= (256 if vpt == 16 else fnr.MAX_GROUP)
                if H // nv <= 256 * (16 if kind == 0 else 8):
                    assert group <= 256
                assert fnr.rms_plan(8, H, nv, kind)[:2] == (vpt, group)
    assert fnr.rms_plan(8, 4096, 8) == (2, 256, 256)         # llama_7b bf16
    assert fnr.rms_plan(8, 128, 8) == (1, 32, 32)            # a row a block
    assert fnr.rms_plan(2048, 128, 8) == (1, 32, 256)        # 8 rows a block
    assert fnr.rms_plan(8192, 4096, 8, 1) == (2, 256, 256)


def test_add_rms_norm_rejects():
    h, w = torch.ones(4, 8), torch.ones(8)
    with pytest.raises(ValueError, match="h and delta"):
        fnr.add_rms_norm(h, torch.ones(4, 7), w, EPS, "llama")
    with pytest.raises(ValueError, match="h and delta"):
        fnr.add_rms_norm(h, h.double(), w, EPS, "llama")
    with pytest.raises(ValueError, match="policy"):
        fnr.add_rms_norm(h, h, w, EPS, "layer")
    with pytest.raises(ValueError, match="rstd"):
        fnr.rms_norm_bwd(h, w, h, EPS, "fused")
