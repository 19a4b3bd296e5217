"""Port parity: paddle_tpu_torch's flash_decode against paddle_tpu's.

The same numpy inputs go through the JAX ``flash_decode_attention``
(the Pallas kernel, in interpret mode on the CPU) and the XLA
compositions ``_window_decode_attention`` / ``_decode_attention``, and
through the port's wrapper, which runs its plain version on CPU
tensors.  Tolerance rtol = atol = 1e-5: float32, the same math in a
different reduction order.  The CUDA kernel itself is held to the
plain version in ``test_torch_cuda.py``, which needs a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.nn.functional import (
    _decode_attention as jax_decode_attention,
    _window_decode_attention as jax_window_attention)
from paddle_tpu.incubate.nn.kernels.flash_decode import (
    flash_decode_attention as jax_flash_decode)
from paddle_tpu_torch.incubate.nn import functional as tfunc
from paddle_tpu_torch.incubate.nn.kernels import _build
from paddle_tpu_torch.incubate.nn.kernels import flash_decode as tfd

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, W, T, nH, nKV, hD):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, W, nH, hD)).astype(np.float32)
    k = rng.standard_normal((B, T, nKV, hD)).astype(np.float32)
    v = rng.standard_normal((B, T, nKV, hD)).astype(np.float32)
    # ragged: an empty slot, two middles, and the last valid window
    pos = np.array([0, 5, T // 2, T - W], np.int32)[:B]
    return q, k, v, pos


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("nKV", [4, 2])
@pytest.mark.parametrize("W", [1, 3, 8, 16])
def test_plain_matches_jax_kernel_and_window(W, nKV):
    # T = 40 is not a power of two
    q, k, v, pos = _inputs(W * 10 + nKV, 4, W, 40, 4, nKV, 16)
    out = tfd.flash_decode_attention(*_t(q, k, v, pos)).numpy()
    ref_kernel = np.asarray(jax_flash_decode(*_j(q, k, v, pos)))
    ref_window = np.asarray(jax_window_attention(*_j(q, k, v, pos)))
    np.testing.assert_allclose(out, ref_kernel, **TOL)
    np.testing.assert_allclose(out, ref_window, **TOL)
    # the port's own window composition (the "xla" knob) agrees too
    win = tfunc._window_decode_attention(*_t(q, k, v, pos)).numpy()
    np.testing.assert_allclose(win, ref_window, **TOL)


@pytest.mark.parametrize("nKV", [4, 2])
def test_w1_matches_decode_attention(nKV):
    q, k, v, pos = _inputs(7, 4, 1, 48, 4, nKV, 32)
    out = tfd.flash_decode_attention(*_t(q, k, v, pos)).numpy()[:, 0]
    ref = np.asarray(jax_decode_attention(*_j(q[:, 0], k, v, pos + 1)))
    np.testing.assert_allclose(out, ref, **TOL)
    dec = tfunc._decode_attention(
        *_t(q[:, 0], k, v, pos + 1)).numpy()
    np.testing.assert_allclose(dec, ref, **TOL)


def test_strided_operands_match_contiguous():
    """Prefill hands the wrapper strided slices of the packed qkv."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 24, 3, 64)).astype(np.float32))
    q, k, v = (qkv[:, :, i].view(2, 24, 4, 16) for i in range(3))
    pos = torch.zeros(2, dtype=torch.int32)
    a = tfd.flash_decode_attention(q, k, v, pos)
    b = tfd.flash_decode_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), pos)
    assert torch.equal(a, b)


def test_cpu_path_does_not_count_launches():
    q, k, v, pos = _t(*_inputs(1, 2, 1, 16, 2, 2, 16))
    before = tfd.LAUNCHES
    tfd.flash_decode_attention(q, k, v, pos)
    assert tfd.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "pos", "heads",
                                 "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, pos = _t(*_inputs(2, 2, 1, 16, 4, 2, 16))
    if bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "head_dim":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "pos":
        pos = pos.long()
    elif bad == "heads":
        q = q[:, :, :3]
    else:
        v = v[:, :8]
    with pytest.raises((TypeError, ValueError)):
        tfd.flash_decode_attention(q, k, v, pos)


def test_other_devices_raise_instead_of_running_plain():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel or raises (here: meta tensors)."""
    q = torch.empty(1, 1, 2, 16, device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfd.flash_decode_attention(q, q, q, pos)


def test_missing_toolkit_raises(monkeypatch, tmp_path):
    """Without nvcc the kernel build raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_decode"])
    assert not (tmp_path / "_build").exists()
