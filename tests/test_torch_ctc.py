"""Port parity for ``paddle_tpu_torch.nn.functional.ctc_loss`` against the
JAX package (``_ctc_impl`` through ``jax.vjp``, and the public
``F.ctc_loss``) on the same numpy-made log-probabilities, float32, on
the CPU, with the cases of ``tests/test_ctc.py``: varied lengths, an
input length past T (clamped), repeated labels, a zero label length,
every reduction; and against torch's own ``ctc_loss`` through the
logits.

Tolerances, float32: the loss at rel 1e-6 against JAX (the same
recursion, the same operations in the same order) and every gradient
element at 1e-6 of max(1, max |grad|); against torch's independent
implementation at rel 1e-4 on the loss and 1e-3 / 1e-5 on the logits'
gradient (tests/test_ctc.py's limits).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.functional import _ctc_jitted
from paddle_tpu_torch.nn.functional import ctc_loss

REDUCTIONS = ("mean", "sum", "none")


def _case(B, T, L, C, seed, vary_lengths):
    """tests/test_ctc.py's inputs."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T, B, C)).astype("f4")
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(1, C, (B, L))
    if vary_lengths:
        ilen = rng.integers(T // 2, T + 1, (B,))
        llen = rng.integers(1, L + 1, (B,))
    else:
        ilen = np.full((B,), T)
        llen = np.full((B,), L)
    return lp.astype("f4"), labels, ilen.astype("i8"), llen.astype("i8")


def _compare(lp, labels, ilen, llen, reduction, blank=0):
    """The port's loss and d(sum loss)/d log_probs against JAX's
    (``_ctc_impl``, jitted as ``F.ctc_loss`` jits it)."""
    jctc = _ctc_jitted(blank, reduction)
    jl, vjp = jax.vjp(lambda x: jctc(x, jnp.asarray(labels),
                                     jnp.asarray(ilen), jnp.asarray(llen)),
                      jnp.asarray(lp))
    jg = vjp(jnp.ones_like(jl))[0]
    x = torch.tensor(lp, requires_grad=True)
    tl = ctc_loss(x, torch.tensor(labels), torch.tensor(ilen),
                  torch.tensor(llen), blank=blank, reduction=reduction)
    tg, = torch.autograd.grad(tl.sum(), x)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-6)
    g = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), g, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(g).max()))
    return tl.detach().numpy()


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("vary", [False, True])
def test_matches_jax(vary, reduction):
    _compare(*_case(B=4, T=30, L=8, C=12, seed=0, vary_lengths=vary),
             reduction)


# the cases below share test_matches_jax's shapes, so JAX's jitted
# recursion compiles once a reduction


def test_overlong_input_length_is_clamped():
    """input_lengths > T read the final frame, as JAX's clip does."""
    lp, labels, ilen, llen = _case(B=4, T=30, L=8, C=12, seed=6,
                                   vary_lengths=True)
    over = _compare(lp, labels, np.where(ilen == ilen.max(), 37, ilen),
                    llen, "none")
    exact = _compare(lp, labels, np.where(ilen == ilen.max(), 30, ilen),
                     llen, "none")
    np.testing.assert_allclose(over, exact, rtol=1e-6)


def test_repeated_labels():
    """No skip between equal labels: torch's loss too."""
    lp, labels, ilen, llen = _case(B=4, T=30, L=8, C=12, seed=7,
                                   vary_lengths=False)
    labels[:, 1] = labels[:, 0]
    labels[2, 2:5] = labels[2, 1]
    ours = _compare(lp, labels, ilen, llen, "mean")
    ref = torch.nn.functional.ctc_loss(
        torch.tensor(lp), torch.tensor(labels), torch.tensor(ilen),
        torch.tensor(llen), blank=0, reduction="mean")
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-4)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_zero_label_length(reduction):
    """A sequence with no labels: the all-blank path (mean divides by
    max(0, 1)), beside sequences with labels and an input length of 1."""
    lp, labels, _, _ = _case(B=4, T=30, L=8, C=12, seed=3,
                             vary_lengths=False)
    _compare(lp, labels, np.array([30, 1, 14, 22]), np.array([0, 1, 8, 3]),
             reduction)


def test_blank_other_than_zero():
    lp, labels, ilen, llen = _case(B=4, T=30, L=8, C=12, seed=4,
                                   vary_lengths=True)
    _compare(lp, np.where(labels == 11, 1, labels), ilen, llen, "mean",
             blank=11)


def test_int32_labels():
    """Paddle's int32 labels and lengths (its documented dtype), as
    JAX's recursion takes them."""
    lp, labels, ilen, llen = _case(B=4, T=30, L=8, C=12, seed=8,
                                   vary_lengths=True)
    _compare(lp, labels.astype("i4"), ilen.astype("i4"), llen.astype("i4"),
             "mean")


def test_matches_the_public_jax_entry():
    """The port against ``paddle_tpu.nn.functional.ctc_loss`` (its
    Tensor API, its gradient through ``backward``)."""
    lp, labels, ilen, llen = _case(B=4, T=30, L=8, C=12, seed=2,
                                   vary_lengths=True)
    x = paddle.to_tensor(lp, stop_gradient=False)
    want = JF.ctc_loss(x, paddle.to_tensor(labels), paddle.to_tensor(ilen),
                       paddle.to_tensor(llen))
    want.backward()
    t = torch.tensor(lp, requires_grad=True)
    got = ctc_loss(t, torch.tensor(labels), torch.tensor(ilen),
                   torch.tensor(llen))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want.numpy()), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), x.grad.numpy(), rtol=0,
                               atol=1e-6)


def test_grad_matches_torch_through_logits():
    """torch returns the gradient that assumes a log-softmax input; the
    port's is the exact derivative: through the logits they agree."""
    rng = np.random.default_rng(1)
    B, T, L, C = 3, 20, 5, 10
    logits = rng.normal(size=(T, B, C)).astype("f4")
    labels = torch.tensor(rng.integers(1, C, (B, L)))
    ilen = torch.tensor(rng.integers(T // 2, T + 1, (B,)))
    llen = torch.tensor(rng.integers(1, L + 1, (B,)))
    grads = []
    for fn in (ctc_loss, torch.nn.functional.ctc_loss):
        x = torch.tensor(logits, requires_grad=True)
        loss = fn(torch.log_softmax(x, -1), labels, ilen, llen, blank=0,
                  reduction="mean")
        grads.append(torch.autograd.grad(loss, x)[0])
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-3, atol=1e-5)


def test_rejects_bad_arguments():
    lp, labels, ilen, llen = _case(B=2, T=10, L=3, C=5, seed=5,
                                   vary_lengths=False)
    args = [torch.tensor(a) for a in (lp, labels, ilen, llen)]
    with pytest.raises(ValueError, match="reduction"):
        ctc_loss(*args, reduction="max")
    with pytest.raises(ValueError, match="different devices"):
        ctc_loss(args[0], args[1].to("meta"), *args[2:])
