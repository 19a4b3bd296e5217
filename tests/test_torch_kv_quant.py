"""Port parity: paddle_tpu_torch's quantized KV storage against
paddle_tpu's ``incubate/nn/kv_quant.py``.

``quantize_kv`` must store the same bytes as JAX: int8 data and float32
scales bit for bit, and float8_e4m3fn bit for bit in range and at the
overflow threshold, where JAX's cast gives NaN (|x| > 464; 464 itself
is the tie and rounds down to 448) and ``Tensor.to`` would saturate to
±448.  Then the unit cases of ``tests/test_quantized_serving.py``
``TestKvQuant`` and the cache layouts and byte counts of both engines.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn import kv_quant as jkvq
from paddle_tpu.inference.serving import (
    ContinuousBatchingEngine as JaxEngine,
    PagedContinuousBatchingEngine as JaxPagedEngine)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.incubate.nn import kv_quant as tkvq
from paddle_tpu_torch.inference.serving import (
    ContinuousBatchingEngine, PagedContinuousBatchingEngine)
from paddle_tpu_torch.models import gpt as tgpt


def _bytes_jax(a):
    return np.asarray(a).view(np.uint8)


def _bytes_torch(t):
    return t.view(torch.uint8).numpy()


def _x(seed, shape, scale):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantize_bit_identical(dtype):
    x = _x(0, (3, 7, 2, 16), 4.0)
    x[0, 0, 0] = 0.0                   # an all-zero row: scale 1e-8/127
    x[1, 2, 1, :] = 0.5                # ties of x/s at .5 steps
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jkvq.quantize_kv(jx, "int8")
    tq, ts = tkvq.quantize_kv(tx, "int8")
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_quantize_in_range_bit_identical(dtype):
    x = _x(1, (4, 9, 2, 32), 120.0)
    x = np.clip(x, -440.0, 440.0)
    x[0, 0, 0, :4] = [448.0, -448.0, 1e-4, -3e-3]   # max and subnormals
    jq, js = jkvq.quantize_kv(jnp.asarray(x).astype(dtype), "fp8")
    tq, ts = tkvq.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)),
                              "fp8")
    assert js is None and ts is None
    assert tq.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bytes_torch(tq), _bytes_jax(jq))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_fp8_overflow_gives_nan_like_jax(sign):
    """The threshold sits between 464 (the tie: 448) and 465 (NaN), on
    both sides of zero; infinities give NaN too, NaN stays NaN."""
    x = sign * np.array([447.0, 448.0, 449.0, 463.0, 464.0, 465.0, 470.0,
                         480.0, 500.0, 1e4, np.inf, np.nan], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)
                      .astype(jnp.float32))
    got = tkvq.quantize_kv(torch.from_numpy(x), "fp8")[0].float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)],
                                  want[~np.isnan(want)])
    assert got[4] == sign * 448.0 and np.isnan(got[5])
    # the plain cast this guards against saturates instead
    assert torch.from_numpy(x[5:6]).to(torch.float8_e4m3fn).float().item() \
        == sign * 448.0
    # bf16 input: 464 is representable; 465 rounds to 464 in bf16 first
    xb = sign * np.array([463.0, 464.0, 466.0], np.float32)
    got_b = tkvq.quantize_kv(torch.from_numpy(xb).bfloat16(), "fp8")[0]
    want_b = jnp.asarray(xb).astype(jnp.bfloat16).astype(jnp.float8_e4m3fn)
    np.testing.assert_array_equal(
        np.isnan(got_b.float().numpy()),
        np.isnan(np.asarray(want_b.astype(jnp.float32))))


def test_round_trip_error_bound():
    """Symmetric per-head scales: the worst-case error is half a
    quantization step, s/2, element-wise (TestKvQuant)."""
    x = torch.from_numpy(_x(0, (3, 7, 2, 16), 4.0))
    q, s = tkvq.quantize_kv(x, "int8")
    err = (tkvq.dequantize_kv((q, s)) - x).abs()
    assert bool((err <= s / 2 + 1e-7).all())
    assert torch.equal(tkvq.dequantize_kv(q, s), tkvq.dequantize_kv((q, s)))


def test_resolve_rejects_unknown():
    assert tkvq.resolve_kv_dtype(None) == "bf16"
    assert tkvq.resolve_kv_dtype("INT8") == "int8"
    with pytest.raises(ValueError):
        tkvq.resolve_kv_dtype("int4")


def test_nbytes_counts_scales():
    x = torch.zeros(2, 8, 2, 16)
    q, s = tkvq.quantize_kv(x, "int8")
    assert tkvq.kv_nbytes((q, s)) == q.numel() + 4 * s.numel()
    assert tkvq.kv_nbytes(x) == 4 * x.numel()
    assert tkvq.kv_map(lambda a: a[:1], (q, s))[1].shape == (1, 8, 2, 1)
    assert tkvq.kv_components(x) == (x,)


@pytest.mark.parametrize("kd", ["bf16", "int8", "fp8"])
def test_init_decode_cache_layout_matches_jax(kd):
    jcfg = jgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=2, max_position_embeddings=128,
                          dtype=jnp.bfloat16)
    tcfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=2, max_position_embeddings=128,
                          dtype=torch.bfloat16)
    jc = jgpt.init_decode_cache(jcfg, 3, 16, kv_dtype=kd)
    tc = tgpt.init_decode_cache(tcfg, 3, 16, kd, device="cpu")
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert tc[name].element_size() == jc[name].dtype.itemsize
        assert not bool(tc[name].float().any())
    assert tkvq.kv_cache_dtype(tc) == jkvq.kv_cache_dtype(jc) == kd


@pytest.mark.parametrize("kd", ["bf16", "int8", "fp8"])
def test_engine_cache_bytes_match_jax(kd):
    """cache_bytes() equals the JAX engines' at every kv_dtype (scale
    planes charged), for both layouts, and the int8/bf16 ratio is the
    density 4·hD/(2·hD + 8) exactly."""
    jcfg = jgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=2, max_position_embeddings=128,
                          dtype=jnp.bfloat16, unroll_layers=False)
    tcfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=2, max_position_embeddings=128,
                          dtype=torch.bfloat16)
    jp = jgpt.init_params(jcfg, seed=0)
    tp = tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    got = {}
    for J, T, kw in ((JaxEngine, ContinuousBatchingEngine, {}),
                     (JaxPagedEngine, PagedContinuousBatchingEngine,
                      {"block_size": 16})):
        want = J(jp, jcfg, max_batch=2, max_len=64, kv_dtype=kd,
                 **kw).cache_bytes()
        eng = T(tp, tcfg, max_batch=2, max_len=64, kv_dtype=kd,
                device="cpu", **kw)
        got[T] = eng.cache_bytes()
        assert got[T] == want
        assert eng.metrics()["kv_dtype"] == kd
        assert eng.metrics()["cache_bytes"] == want
    assert got[PagedContinuousBatchingEngine] * 2 == \
        got[ContinuousBatchingEngine]
    if kd == "int8":
        bf16 = ContinuousBatchingEngine(tp, tcfg, max_batch=2, max_len=64,
                                        device="cpu").cache_bytes()
        hd = tcfg.head_dim
        assert bf16 / got[ContinuousBatchingEngine] == pytest.approx(
            4 * hd / (2 * hd + 8))
