"""Port parity: paddle_tpu_torch's flash_decode against paddle_tpu's.

The same numpy inputs go through the JAX ``flash_decode_attention``
(the Pallas kernel, in interpret mode on the CPU) and ``flash_decode_paged``
and the XLA compositions ``_window_decode_attention`` /
``_decode_attention``, and through the port's wrappers, which run their
plain versions on CPU tensors — over dense float32 caches, int8
``(data, scale)`` pairs and float8_e4m3fn caches, whose stored bytes
both sides share.  Tolerance rtol = atol = 1e-5: float32, the same math in a
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
    flash_decode_attention as jax_flash_decode,
    flash_decode_paged as jax_flash_decode_paged)
from paddle_tpu.incubate.nn import kv_quant as jkvq
from paddle_tpu_torch.incubate.nn import functional as tfunc
from paddle_tpu_torch.incubate.nn import kv_quant as tkvq
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


# ---------------------------------------------------------------------------
# paged layout and quantized storage
# ---------------------------------------------------------------------------

def _quantized(k, kd):
    """The same stored K (or V) for both packages: JAX quantizes, the
    port receives the identical bytes."""
    if kd == "dense":
        return jnp.asarray(k), torch.from_numpy(k)
    q, s = jkvq.quantize_kv(jnp.asarray(k), "int8" if kd == "int8"
                            else "fp8")
    if kd == "int8":
        return (q, s), (torch.from_numpy(np.array(q)),
                        torch.from_numpy(np.array(s)))
    raw = torch.from_numpy(np.asarray(q).view(np.uint8).copy())
    return q, raw.view(torch.float8_e4m3fn)


# the shuffled table of tests/test_flash_decode_multi.py: a straddle
# (pos 17 crosses into the slot's third page), a first fed position at
# a page boundary, and -1 tail pages
_BT = np.array([[3, 7, 1, -1],
                [2, 0, -1, -1],
                [5, 9, 11, 4]], np.int32)
_POS = np.array([17, 8, 30], np.int32)


@pytest.mark.parametrize("kd", ["dense", "int8", "fp8"])
def test_paged_plain_matches_jax_kernel(kd):
    rng = np.random.default_rng(4)
    B, W, nH, nKV, hD, nb, bs = 3, 3, 4, 2, 16, 16, 8
    q = rng.standard_normal((B, W, nH, hD)).astype(np.float32)
    pk = rng.standard_normal((nb, bs, nKV, hD)).astype(np.float32)
    pv = rng.standard_normal((nb, bs, nKV, hD)).astype(np.float32)
    jk, tk = _quantized(pk, kd)
    jv, tv = _quantized(pv, kd)
    ref = np.asarray(jax_flash_decode_paged(
        jnp.asarray(q), jk, jv, jnp.asarray(_BT), jnp.asarray(_POS)))
    out = tfd.flash_decode_paged(torch.from_numpy(q), tk, tv,
                                 torch.from_numpy(_BT),
                                 torch.from_numpy(_POS))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("kd", ["int8", "fp8"])
@pytest.mark.parametrize("W", [1, 5])
def test_quantized_contiguous_matches_jax(kd, W):
    q, k, v, pos = _inputs(11 + W, 4, W, 40, 4, 2, 32)
    jk, tk = _quantized(k, kd)
    jv, tv = _quantized(v, kd)
    jpos = jnp.asarray(pos)
    ref_kernel = np.asarray(jax_flash_decode(jnp.asarray(q), jk, jv, jpos))
    ref_window = np.asarray(jax_window_attention(jnp.asarray(q), jk, jv,
                                                 jpos))
    out = tfd.flash_decode_attention(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(out, ref_kernel, **TOL)
    np.testing.assert_allclose(out, ref_window, **TOL)
    win = tfunc._window_decode_attention(torch.from_numpy(q), tk, tv,
                                         torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(win, ref_window, **TOL)
    if W == 1:
        ref = np.asarray(jax_decode_attention(jnp.asarray(q[:, 0]), jk, jv,
                                              jpos + 1))
        dec = tfunc._decode_attention(torch.from_numpy(q[:, 0]), tk, tv,
                                      torch.from_numpy(pos) + 1).numpy()
        np.testing.assert_allclose(dec, ref, **TOL)
        np.testing.assert_allclose(out[:, 0], ref, **TOL)


def test_quantized_output_in_q_dtype():
    """A quantized cache dequantizes to float32; the output comes back
    in q's dtype (bf16 here), as the JAX composition casts it."""
    q, k, v, pos = _inputs(5, 2, 1, 16, 2, 2, 16)
    tq = torch.from_numpy(q).bfloat16()
    kq = tkvq.quantize_kv(torch.from_numpy(k), "int8")
    vq = tkvq.quantize_kv(torch.from_numpy(v), "int8")
    out = tfd.flash_decode_attention(tq, kq, vq, torch.from_numpy(pos))
    dec = tfunc._decode_attention(tq[:, 0], kq, vq,
                                  torch.from_numpy(pos) + 1)
    assert out.dtype == dec.dtype == torch.bfloat16


@pytest.mark.parametrize("kd", ["dense", "int8", "fp8"])
def test_paged_identity_table_equals_contiguous(kd):
    """A paged call whose table lays each slot's pages in order is the
    contiguous call on the same rows, bit for bit."""
    q, k, v, pos = _inputs(6, 4, 2, 32, 4, 2, 16)
    _, tk = _quantized(k, kd)
    _, tv = _quantized(v, kd)
    B, T, bs = 4, 32, 8
    def paged(x):
        return tkvq.kv_map(lambda a: a.reshape((B * T // bs, bs)
                                               + tuple(a.shape[2:])), x)

    bt = torch.arange(B * T // bs, dtype=torch.int32).view(B, T // bs)
    a = tfd.flash_decode_attention(torch.from_numpy(q), tk, tv,
                                   torch.from_numpy(pos))
    b = tfd.flash_decode_paged(torch.from_numpy(q), paged(tk), paged(tv),
                               bt, torch.from_numpy(pos))
    assert torch.equal(a, b)


def test_paged_cpu_path_does_not_count_launches():
    before = (tfd.LAUNCHES, tfd.PAGED_LAUNCHES, dict(tfd.MODE_LAUNCHES))
    tfd.flash_decode_paged(*_t(np.zeros((3, 1, 4, 16), np.float32),
                               np.zeros((16, 8, 2, 16), np.float32),
                               np.zeros((16, 8, 2, 16), np.float32), _BT,
                               _POS))
    assert (tfd.LAUNCHES, tfd.PAGED_LAUNCHES,
            dict(tfd.MODE_LAUNCHES)) == before


@pytest.mark.parametrize("bad", ["int8_bare", "scale_shape", "scale_dtype",
                                 "scaled_float", "mixed", "f16_cache"])
def test_quantized_operands_rejected(bad):
    q, k, v, pos = _t(*_inputs(2, 2, 1, 16, 4, 2, 16))
    kq = tkvq.quantize_kv(k, "int8")
    vq = tkvq.quantize_kv(v, "int8")
    if bad == "int8_bare":
        kq, vq = kq[0], vq[0]
    elif bad == "scale_shape":
        kq = (kq[0], kq[1][:, :, :1])
    elif bad == "scale_dtype":
        kq = (kq[0], kq[1].double())
    elif bad == "scaled_float":
        kq, vq = (k, kq[1]), (v, vq[1])
    elif bad == "mixed":
        vq = tkvq.quantize_kv(v, "fp8")[0]
    else:
        kq, vq = k.half(), v.half()
    with pytest.raises((TypeError, ValueError)):
        tfd.flash_decode_attention(q, kq, vq, pos)


@pytest.mark.parametrize("bad", ["bt_dtype", "bt_batch", "bt_rank",
                                 "pos_dtype"])
def test_paged_wrapper_rejects(bad):
    q, pk, pv, bt, pos = _t(np.zeros((3, 1, 4, 16), np.float32),
                            np.zeros((16, 8, 2, 16), np.float32),
                            np.zeros((16, 8, 2, 16), np.float32), _BT, _POS)
    if bad == "bt_dtype":
        bt = bt.long()
    elif bad == "bt_batch":
        bt = bt[:2]
    elif bad == "bt_rank":
        bt = bt.reshape(-1)
    else:
        pos = pos.long()
    with pytest.raises(ValueError):
        tfd.flash_decode_paged(q, pk, pv, bt, pos)


def test_paged_plain_clamps_ids_into_the_pool():
    """-1 reads page 0 and an id past the pool its last page, as the
    JAX gather clamps (the CUDA kernel clamps the same way)."""
    rng = np.random.default_rng(9)
    q, pk, pv = _t(rng.standard_normal((3, 2, 4, 16)).astype(np.float32),
                   rng.standard_normal((16, 8, 2, 16)).astype(np.float32),
                   rng.standard_normal((16, 8, 2, 16)).astype(np.float32))
    bt = torch.from_numpy(_BT.copy())
    pos = torch.from_numpy(_POS)
    bt[:, 0] = torch.tensor([-1, 16, 99], dtype=torch.int32)
    clamped = bt.clone()
    clamped[:, 0] = torch.tensor([0, 15, 15], dtype=torch.int32)
    assert torch.equal(tfd.flash_decode_paged(q, pk, pv, bt, pos),
                       tfd.flash_decode_paged(q, pk, pv, clamped, pos))


# ---------------------------------------------------------------------------
# the split-KV rule (partials per split, merged in a fixed order), which
# the card's decode instance implements; the CUDA kernel itself is held
# to the plain version in test_torch_cuda.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split_len,n_split", [(8, None), (16, None),
                                               (32, None), (8, 9)])
@pytest.mark.parametrize("W", [1, 3])
def test_split_rule_matches_jax_kernel_and_unsplit(W, split_len, n_split):
    """T = 40 is not a multiple of the split; slot 0 (pos 0, W 1) sees
    only the first split, so every other split of it is empty; n_split 9
    adds four splits past T.  Tolerance 1e-5: float32, the same math
    merged in another order."""
    q, k, v, pos = _inputs(W + split_len, 4, W, 40, 4, 2, 16)
    ref = np.asarray(jax_flash_decode(*_j(q, k, v, pos)))
    out = tfd.flash_decode_split_plain(*_t(q, k, v, pos), split_len,
                                       n_split)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    unsplit = tfd.flash_decode_attention(*_t(q, k, v, pos))
    np.testing.assert_allclose(out.numpy(), unsplit.numpy(), **TOL)


@pytest.mark.parametrize("kd", ["dense", "int8", "fp8"])
def test_split_rule_paged_matches_jax_kernel(kd):
    """The paged layout splits the slot's logical history the same way:
    the rule on the gathered pages equals JAX's paged kernel (-1 tail
    pages, a straddling position) at split 8 (one page a split)."""
    rng = np.random.default_rng(14)
    B, W, nH, nKV, hD, nb, bs = 3, 3, 4, 2, 16, 16, 8
    q = rng.standard_normal((B, W, nH, hD)).astype(np.float32)
    pk = rng.standard_normal((nb, bs, nKV, hD)).astype(np.float32)
    pv = rng.standard_normal((nb, bs, nKV, hD)).astype(np.float32)
    jk, tk = _quantized(pk, kd)
    jv, tv = _quantized(pv, kd)
    ref = np.asarray(jax_flash_decode_paged(
        jnp.asarray(q), jk, jv, jnp.asarray(_BT), jnp.asarray(_POS)))
    bt = torch.from_numpy(_BT)
    out = tfd.flash_decode_split_plain(
        torch.from_numpy(q), tfd._gather_pages(tk, bt),
        tfd._gather_pages(tv, bt), torch.from_numpy(_POS), 8)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_split_rule_empty_splits_add_nothing():
    """Splits a slot cannot see (every split but the first at pos 0,
    W 1) give l = 0 and leave the output bit for bit what the one split
    that holds the slot's rows gives."""
    q, k, v, _ = _inputs(21, 4, 1, 64, 4, 4, 32)
    pos = torch.zeros(4, dtype=torch.int32)
    one = tfd.flash_decode_split_plain(*_t(q, k, v), pos, 64)
    many = tfd.flash_decode_split_plain(*_t(q, k, v), pos, 16, 6)
    assert torch.equal(one, many)


@pytest.mark.parametrize("B,nKV,T", [(8, 16, 1024), (8, 32, 1024),
                                     (8, 4, 1024), (1, 32, 600), (4, 2, 64),
                                     (2, 2, 20), (64, 16, 4096)])
def test_decode_plan_covers_the_history_in_whole_stages(B, nKV, T):
    """The split plan depends on (B, nKV, T) and the SM count only: the
    splits are whole 32-row stages, cover T, and none starts past it."""
    n_split, split_len = tfd.decode_plan(B, nKV, T, 132)
    assert split_len % tfd.SPLIT_ROWS == 0
    assert n_split * split_len >= T > (n_split - 1) * split_len
    stages = -(-T // tfd.SPLIT_ROWS)
    assert split_len // tfd.SPLIT_ROWS >= min(2, stages)


def test_decode_plan_at_the_serving_shapes():
    # GPT 8-slot decode (16 kv heads) and llama_7b's (32)
    assert tfd.decode_plan(8, 16, 1024, 132) == (8, 128)
    assert tfd.decode_plan(8, 32, 1024, 132) == (5, 224)


@pytest.mark.parametrize("W,nH,nKV,qd,kd,hD,want", [
    (1, 16, 16, torch.bfloat16, torch.bfloat16, 128, "split"),
    (16, 4, 4, torch.bfloat16, torch.bfloat16, 128, "split"),
    (17, 4, 4, torch.bfloat16, torch.bfloat16, 128, "tc"),
    (4, 16, 4, torch.bfloat16, torch.bfloat16, 128, "split"),
    (3, 16, 2, torch.bfloat16, torch.bfloat16, 64, "tc"),
    (600, 32, 32, torch.bfloat16, torch.bfloat16, 128, "tc"),
    (600, 32, 32, torch.bfloat16, torch.int8, 128, "simt"),
    (600, 4, 2, torch.float32, torch.float32, 32, "simt"),
    (24, 4, 4, torch.bfloat16, torch.bfloat16, 16, "simt"),
    (1, 4, 2, torch.float32, torch.float8_e4m3fn, 32, "split"),
])
def test_kernel_instance_by_shape_and_dtype(W, nH, nKV, qd, kd, hD, want):
    """Small windows (nH/nKV x W <= 16 queries a kv head) split the KV
    axis; larger bf16 windows run on the tensor cores; the rest on the
    query-tile kernel."""
    assert tfd.kernel_instance(qd, kd, W, nH, nKV, hD) == want


def test_build_key_covers_the_shared_headers(monkeypatch, tmp_path):
    """A changed csrc/*.cuh changes every library's name, so a stale
    build is never loaded after a header edit."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build._target("k")
    assert _build._target("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("k") != before
