"""Port parity: the fused-CE forward and the chunked vocabulary NLL of
paddle_tpu_torch against the JAX package's (``fused_ce_fwd`` in
Pallas interpret mode, as tests/test_chunked_ce.py runs it;
``chunked_vocab_nll`` with its custom VJP).

Float32 inputs from numpy with a seed.  z and picked are held at atol
1e-5, the NLL at 1e-5 and its gradients at 1e-5 (float32 logits over
H <= 128, another summation order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn.functional import chunked_ce as jce
from paddle_tpu.incubate.nn.kernels.fused_ce import \
    fused_ce_fwd as jax_fused_ce_fwd
from paddle_tpu.incubate.nn.kernels.fused_ce import \
    fused_ce_supported as jax_fused_ce_supported
from paddle_tpu_torch.incubate.nn.functional import chunked_ce as tce
from paddle_tpu_torch.incubate.nn.kernels import fused_ce as fce

TOL = dict(rtol=0, atol=1e-5)


def _data(seed, N, V, H):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, H)).astype(np.float32)
    W = (rng.standard_normal((V, H)) * 0.1).astype(np.float32)
    lbl = rng.integers(0, V, N).astype(np.int32)
    return h, W, lbl


@pytest.mark.parametrize("N", [128, 256])
def test_fused_ce_fwd_matches_jax(N):
    """V = 300 leaves a ragged tail in the JAX kernel's vocabulary
    blocks; labels outside [0, V) — negative, in the padded tail, past
    it — pick nothing."""
    V = 300
    h, W, lbl = _data(N, N, V, 128)
    lbl[:4] = [-3, V, V + 7, 1000]
    jz, jp = jax_fused_ce_fwd(jnp.asarray(h), jnp.asarray(W),
                              jnp.asarray(lbl))
    before = fce.LAUNCHES
    z, picked = fce.fused_ce_fwd(torch.from_numpy(h), torch.from_numpy(W),
                                 torch.from_numpy(lbl))
    assert fce.LAUNCHES == before
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(picked.numpy(), np.asarray(jp), **TOL)
    assert (picked[:4] == 0).all()


@pytest.mark.parametrize("N,V,H", [(128, 50304, 2048), (256, 300, 128),
                                   (8192, 128, 1024), (100, 300, 128),
                                   (128, 100, 128), (128, 300, 4096),
                                   (128, 300, 96)])
def test_fused_ce_shape_gate_matches_jax(N, V, H):
    assert fce.fused_ce_supported(N, V, H) == jax_fused_ce_supported(N, V, H)


def test_fused_ce_rejects_ragged_rows():
    with pytest.raises(ValueError, match="multiple of 128"):
        fce.fused_ce_fwd(torch.zeros(100, 128), torch.zeros(300, 128),
                         torch.zeros(100, dtype=torch.int32))


@pytest.mark.parametrize("num_chunks", [1, 3])
@pytest.mark.parametrize("offset", [0, 50])
def test_chunked_vocab_nll_value_and_grads_match_jax(num_chunks, offset):
    N, V, H = 96, 300, 64
    h, W, lbl = _data(num_chunks, N, V, H)
    lbl = lbl + offset             # GLOBAL ids; some fall outside
    lbl[:3] = [-1, offset + V, offset - 1]
    g = np.random.default_rng(9).standard_normal(N).astype(np.float32)

    def jfun(h, W):
        nll = jce.chunked_vocab_nll(h, W, jnp.asarray(lbl),
                                    jnp.int32(offset), num_chunks, None)
        return jnp.sum(nll * g), nll

    (_, jnll), (jdh, jdW) = jax.value_and_grad(jfun, (0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(W))
    th = torch.from_numpy(h).requires_grad_(True)
    tW = torch.from_numpy(W).requires_grad_(True)
    nll = tce.chunked_vocab_nll(th, tW, torch.from_numpy(lbl), offset,
                                num_chunks)
    (nll * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(tW.grad.numpy(), np.asarray(jdW), **TOL)


def test_no_grad_primal_on_cpu_is_the_scan():
    """Without autograd on the CPU the primal runs the scan (the fused
    kernel is the card's path) and equals the differentiated value."""
    h, W, lbl = (torch.from_numpy(x) for x in _data(4, 128, 512, 128))
    before = fce.LAUNCHES
    with torch.no_grad():
        got = tce.chunked_vocab_nll(h, W, lbl, 0, 2)
    want = tce.chunked_vocab_nll(h.requires_grad_(True), W, lbl, 0, 1)
    assert fce.LAUNCHES == before
    torch.testing.assert_close(got, want.detach(), **TOL)


@pytest.mark.parametrize("n,v", [(64, 1000), (16384, 50304),
                                 (4 * 16384, 50304), (1 << 20, 50304)])
def test_pick_num_chunks_matches_jax(n, v, monkeypatch):
    monkeypatch.delenv("PT_CE_CHUNKS", raising=False)
    assert tce.pick_num_chunks(n, v) == jce.pick_num_chunks(n, v)


# ---------------------------------------------------------------------------
# the vocabulary split of the card's bf16 kernel: partials per split,
# merged in a fixed order (the CUDA kernel itself is held to the plain
# version in test_torch_cuda.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles_per_split,splits", [(1, None), (2, None),
                                                    (1, 5)])
def test_split_rule_matches_jax_kernel_and_unsplit(tiles_per_split, splits):
    """V = 300 in the kernel's vocabulary tiles (fused_ce.VOCAB_TILE,
    256): at one tile a split the last split holds only the ragged tail
    (44 rows); splits 5 adds three empty ones.  Labels outside [0, V)
    pick nothing.  Tolerance 1e-5: float32 logits, merged in another
    order."""
    N, V = 128, 300
    h, W, lbl = _data(7, N, V, 128)
    lbl[:5] = [-3, V, V + 7, 1000, V - 1]
    jz, jp = jax_fused_ce_fwd(jnp.asarray(h), jnp.asarray(W),
                              jnp.asarray(lbl))
    z, picked = fce.fused_ce_fwd_split_plain(
        torch.from_numpy(h), torch.from_numpy(W), torch.from_numpy(lbl),
        tiles_per_split, splits)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(picked.numpy(), np.asarray(jp), **TOL)
    uz, up = fce.fused_ce_fwd(torch.from_numpy(h), torch.from_numpy(W),
                              torch.from_numpy(lbl))
    np.testing.assert_allclose(z.numpy(), uz.numpy(), **TOL)
    np.testing.assert_allclose(picked.numpy(), up.numpy(), **TOL)
    assert (picked[:4] == 0).all()


def test_split_rule_label_in_the_ragged_tail_split():
    """A label on the last vocabulary row is picked from the split that
    holds only the ragged tail, once."""
    N, V = 128, 300
    h, W, lbl = _data(8, N, V, 64)
    lbl[:] = V - 1
    z, picked = fce.fused_ce_fwd_split_plain(
        torch.from_numpy(h), torch.from_numpy(W), torch.from_numpy(lbl), 1)
    want = torch.from_numpy(h) @ torch.from_numpy(W)[V - 1]
    torch.testing.assert_close(picked, want, **TOL)


@pytest.mark.parametrize("N,V,want", [(8192, 50304, (33, 6)),
                                      (128, 50304, (99, 2)),
                                      (128, 300, (2, 1))])
def test_ce_plan_at_the_eval_and_test_shapes(N, V, want):
    assert fce.ce_plan(N, V, 132) == want


@pytest.mark.parametrize("N,V", [(128, 300), (8192, 50304), (256, 1000),
                                 (128, 50257), (4096, 128)])
def test_ce_plan_covers_the_vocabulary(N, V):
    """Every split holds at least one real tile; together they cover V."""
    splits, per = fce.ce_plan(N, V, 132)
    v_tiles = -(-V // fce.VOCAB_TILE)
    assert (splits - 1) * per < v_tiles <= splits * per
