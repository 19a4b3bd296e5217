"""The port's CUDA kernels on the card (skipped without one).

This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same inputs.
The attention kernels and their plain versions both compute in float32
and round once to the output dtype, so in bfloat16 they may differ by
one rounding step: each element is held to
|got - want| <= 2^-7 |want| + 1e-3 (one bf16 ulp of the reference
value, plus room for float32 summation order near zero).  In float32
(another summation order) flash_decode is held at atol 1e-4, and the
training kernels, whose gradients grow with S, at 1e-4 of the largest
reference value.  fused_ce's float32 outputs are held at atol 1e-3.
The RMS kernel is held by ``chip_smoke._rms_errors``, the limits the
card run uses (float32 per element at 1e-6 relative + 1e-7; bfloat16
equal or one step apart on at most 1e-3 of the elements; rstd at 1e-6
relative), and its backward by ``chip_smoke.rms_backward_check``.  The
ring variant of flash attention (a run-time offset) is held by
``chip_smoke.ring_kernels_check`` (the limits above, lse at 1e-3, offset
0 bit for bit to the zero-offset kernels) and ``chip_smoke.ring_replay``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import collective, hybrid
from paddle_tpu_torch.incubate.nn import kv_quant
from paddle_tpu_torch.incubate.nn.functional.chunked_ce import (
    chunked_vocab_nll)
from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
from paddle_tpu_torch.incubate.nn.kernels import flash_decode as fd
from paddle_tpu_torch.incubate.nn.kernels import fused_ce as fce
from paddle_tpu_torch.incubate.nn.kernels import fused_norm_rope as fnr
from paddle_tpu_torch.incubate.nn.kernels import ring_attention as ra
from paddle_tpu_torch.models import gpt, llama

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_rel(got, want, rel):
    """max |got - want| <= rel * max(1, max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    bound = rel * max(1.0, want.float().abs().max().item())
    assert err <= bound, (err, bound)


def _assert_kernel(got, want, f32_tol, of_max=False):
    """bfloat16: each element within one rounding step of the reference
    (2^-7 of it, + 1e-3); float32: max |got - want| <= f32_tol, times
    max(1, max |want|) when ``of_max``."""
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-3)
    elif of_max:
        _assert_rel(got, want, f32_tol)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=f32_tol)


def _rand(rng, shape, dtype, device):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,T,nH,nKV,hD", [
    (4, 1, 100, 8, 8, 128),      # decode, T not a multiple of the chunk
    (2, 37, 37, 4, 2, 64),       # prefill-shaped, GQA, ragged tile
    (3, 4, 64, 4, 4, 16),        # verify-shaped, small head dim
    (2, 5, 40, 2, 1, 32),        # multi-query
    (8, 1, 1024, 32, 32, 128),   # llama_7b slot decode step
    (1, 600, 600, 32, 32, 128),  # llama_7b prefill_into_slots, W = T
])
def test_flash_decode_kernel_matches_plain(cuda, dtype, B, W, T, nH, nKV,
                                           hD):
    rng = np.random.default_rng(B * W + T)
    q = _rand(rng, (B, W, nH, hD), dtype, cuda)
    k = _rand(rng, (B, T, nKV, hD), dtype, cuda)
    v = _rand(rng, (B, T, nKV, hD), dtype, cuda)
    pos = torch.tensor(rng.integers(0, T - W + 1, B), dtype=torch.int32,
                       device=cuda)
    pos[0] = 0
    before = fd.LAUNCHES
    got = fd.flash_decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == before + 1
    want = fd.flash_decode_attention_plain(q, k, v, pos)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_kernel(got, want, 1e-4)


def test_cuda_tensor_never_reaches_plain(cuda, monkeypatch):
    def refuse(*_):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(fd, "flash_decode_attention_plain", refuse)
    monkeypatch.setattr(fd, "flash_decode_split_plain", refuse)
    qkv = torch.randn(2, 24, 3, 64, device=cuda)
    q, k, v = (qkv[:, :, i].view(2, 24, 4, 16) for i in range(3))
    out = fd.flash_decode_attention(
        q, k, v, torch.zeros(2, dtype=torch.int32, device=cuda))
    assert out.is_cuda and torch.isfinite(out).all()


def _kv_store(rng, shape, mode, dtype, device):
    """One K or V operand in a storage mode: "dense" in ``dtype``, int8
    ``(data, scale)`` or bare fp8, quantized on the card."""
    x = _rand(rng, shape, torch.float32, device)
    if mode == "dense":
        return x.to(dtype)
    data, scale = kv_quant.quantize_kv(x, mode)
    return data if scale is None else (data, scale)


def _paged_case(rng, B, W, T, nKV, hD, bs, mode, dtype, device):
    """Pools of shuffled pages behind each slot's table, -1 past the
    pages its last query needs, and positions with pos[0] = 0 and
    pos[-1] = T - W."""
    mb = -(-T // bs)
    nb = B * mb + 2
    pk = _kv_store(rng, (nb, bs, nKV, hD), mode, dtype, device)
    pv = _kv_store(rng, (nb, bs, nKV, hD), mode, dtype, device)
    pos = rng.integers(0, T - W + 1, B)
    pos[0], pos[-1] = 0, T - W
    order = rng.permutation(nb)[:B * mb].reshape(B, mb)
    bt = np.full((B, mb), -1, np.int32)
    for b in range(B):
        used = (pos[b] + W - 1) // bs + 1
        bt[b, :used] = order[b, :used]
    return (pk, pv, torch.tensor(bt, device=device),
            torch.tensor(pos, dtype=torch.int32, device=device))


_MODES = [("dense", torch.float32), ("dense", torch.bfloat16),
          ("int8", torch.float32), ("int8", torch.bfloat16),
          ("fp8", torch.bfloat16)]


@pytest.mark.parametrize("mode,dtype", _MODES)
@pytest.mark.parametrize("bs", [8, 16, 64])
@pytest.mark.parametrize("B,W,T,nH,nKV,hD", [
    (3, 1, 200, 4, 4, 128),      # decode, a ragged last page
    (2, 1, 130, 16, 4, 64),      # GQA: 16 query heads over 4 kv heads
    (3, 4, 96, 4, 2, 32),        # verify-shaped window
    (2, 2, 96, 2, 1, 16),        # one 16-byte load per int8/fp8 row
])
def test_flash_decode_paged_kernel_matches_plain(cuda, mode, dtype, bs, B,
                                                 W, T, nH, nKV, hD):
    rng = np.random.default_rng(B * T + bs + hD)
    q = _rand(rng, (B, W, nH, hD), dtype, cuda)
    pk, pv, bt, pos = _paged_case(rng, B, W, T, nKV, hD, bs, mode, dtype,
                                  cuda)
    assert (bt < 0).any()      # -1 tail pages are part of every case
    before = (fd.LAUNCHES, fd.PAGED_LAUNCHES, fd.MODE_LAUNCHES[mode])
    got = fd.flash_decode_paged(q, pk, pv, bt, pos)
    torch.cuda.synchronize()
    assert (fd.LAUNCHES, fd.PAGED_LAUNCHES, fd.MODE_LAUNCHES[mode]) == (
        before[0], before[1] + 1, before[2] + 1)
    want = fd.flash_decode_paged_plain(q, pk, pv, bt, pos)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_kernel(got, want, 1e-4)


@pytest.mark.parametrize("mode,dtype", _MODES[2:])
@pytest.mark.parametrize("B,W,T,nH,nKV,hD", [
    (4, 1, 100, 8, 8, 128),
    (2, 37, 37, 4, 2, 64),
    (3, 4, 64, 4, 4, 16),
])
def test_flash_decode_quantized_kernel_matches_plain(cuda, mode, dtype, B, W,
                                                     T, nH, nKV, hD):
    rng = np.random.default_rng(B * W + T + hD)
    q = _rand(rng, (B, W, nH, hD), dtype, cuda)
    k = _kv_store(rng, (B, T, nKV, hD), mode, dtype, cuda)
    v = _kv_store(rng, (B, T, nKV, hD), mode, dtype, cuda)
    pos = torch.tensor(rng.integers(0, T - W + 1, B), dtype=torch.int32,
                       device=cuda)
    pos[0] = 0
    before = (fd.LAUNCHES, fd.MODE_LAUNCHES[mode])
    got = fd.flash_decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert (fd.LAUNCHES, fd.MODE_LAUNCHES[mode]) == (before[0] + 1,
                                                     before[1] + 1)
    want = fd.flash_decode_attention_plain(q, k, v, pos)
    assert got.dtype == dtype
    _assert_kernel(got, want, 1e-4)


@pytest.mark.parametrize("mode,dtype", _MODES)
def test_paged_identity_table_is_contiguous_bit_for_bit(cuda, mode, dtype):
    """The paged kernel over an identity table computes exactly what the
    contiguous kernel computes on the same rows."""
    rng = np.random.default_rng(17)
    B, W, T, nH, nKV, hD, bs = 4, 3, 256, 8, 4, 64, 16
    q = _rand(rng, (B, W, nH, hD), dtype, cuda)
    k = _kv_store(rng, (B, T, nKV, hD), mode, dtype, cuda)
    v = _kv_store(rng, (B, T, nKV, hD), mode, dtype, cuda)
    pos = torch.tensor(rng.integers(0, T - W + 1, B), dtype=torch.int32,
                       device=cuda)

    def pages(x):
        return kv_quant.kv_map(
            lambda a: a.reshape((B * T // bs, bs) + tuple(a.shape[2:])), x)

    bt = torch.arange(B * T // bs, dtype=torch.int32,
                      device=cuda).view(B, T // bs)
    a = fd.flash_decode_attention(q, k, v, pos)
    b = fd.flash_decode_paged(q, pages(k), pages(v), bt, pos)
    assert torch.equal(a, b)


def test_paged_ids_past_the_pool_read_its_last_page(cuda):
    """A table id past the pool reads the pool's last page, as the plain
    version's gather clamps it: no read leaves the pool."""
    rng = np.random.default_rng(13)
    q = _rand(rng, (3, 1, 4, 64), torch.bfloat16, cuda)
    pk, pv, bt, pos = _paged_case(rng, 3, 1, 64, 4, 64, 16, "int8",
                                  torch.bfloat16, cuda)
    nb = pk[0].shape[0]
    bt[:, 0] = torch.tensor([nb, nb + 7, 1 << 20], dtype=torch.int32)
    got = fd.flash_decode_paged(q, pk, pv, bt, pos)
    torch.cuda.synchronize()
    want = fd.flash_decode_paged_plain(q, pk, pv, bt, pos)
    _assert_kernel(got, want, 1e-4)
    last = torch.full_like(bt[:, :1], nb - 1)
    torch.testing.assert_close(
        want, fd.flash_decode_paged_plain(
            q, pk, pv, torch.cat([last, bt[:, 1:]], 1), pos))


def test_paged_cuda_tensor_never_reaches_plain(cuda, monkeypatch):
    def refuse(*_):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(fd, "flash_decode_paged_plain", refuse)
    monkeypatch.setattr(fd, "flash_decode_attention_plain", refuse)
    rng = np.random.default_rng(3)
    q = _rand(rng, (2, 1, 4, 32), torch.bfloat16, cuda)
    pk, pv, bt, pos = _paged_case(rng, 2, 1, 40, 2, 32, 8, "int8",
                                  torch.bfloat16, cuda)
    out = fd.flash_decode_paged(q, pk, pv, bt, pos)
    assert out.is_cuda and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("bad", [
    "kv_row_stride", "kv_last_axis", "head_dim", "f16_cache", "int8_bare",
    "scale_dtype", "bt_int64", "bt_on_cpu", "pos_on_cpu"])
def test_flash_decode_paged_rejects(cuda, bad):
    """A CUDA call the kernel does not take raises; nothing falls back."""
    rng = np.random.default_rng(5)
    B, nKV, hD, bs = 2, 2, 32, 8
    q = _rand(rng, (B, 1, 4, hD), torch.bfloat16, cuda)
    (k, ks), (v, vs), bt, pos = _paged_case(rng, B, 1, 32, nKV, hD, bs,
                                            "int8", torch.bfloat16, cuda)
    if bad == "kv_row_stride":
        # rows of 40 int8 values: not a whole number of 16-byte loads
        wide = torch.zeros(k.shape[:3] + (hD + 8,), dtype=torch.int8,
                           device=cuda)
        k = wide[..., :hD]
    elif bad == "kv_last_axis":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "head_dim":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif bad == "f16_cache":
        k, v = k.half(), v.half()
        ks = vs = None
    elif bad == "int8_bare":
        ks = vs = None
    elif bad == "scale_dtype":
        ks = ks.double()
    elif bad == "bt_int64":
        bt = bt.long()
    elif bad == "bt_on_cpu":
        bt = bt.cpu()
    else:
        pos = pos.cpu()
    keys = k if ks is None else (k, ks)
    values = v if vs is None else (v, vs)
    before = (fd.LAUNCHES, fd.PAGED_LAUNCHES)
    with pytest.raises((TypeError, ValueError)):
        fd.flash_decode_paged(q, keys, values, bt, pos)
    assert (fd.LAUNCHES, fd.PAGED_LAUNCHES) == before


# ---------------------------------------------------------------------------
# flash_decode's instances: split-KV (small windows) and tensor cores (bf16
# prefill windows), held to the plain version at their edges
# ---------------------------------------------------------------------------

def _decode_case(rng, B, W, T, nH, nKV, hD, mode, dtype, device, pos=None):
    q = _rand(rng, (B, W, nH, hD), dtype, device)
    k = _kv_store(rng, (B, T, nKV, hD), mode, dtype, device)
    v = _kv_store(rng, (B, T, nKV, hD), mode, dtype, device)
    if pos is None:
        pos = rng.integers(0, T - W + 1, B)
        pos[0], pos[-1] = 0, T - W
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device=device)


def _instance_run(call, plain, args, q, keys, bt=None):
    """Launch once, check the instance the plan names ran (one count in
    INSTANCE_LAUNCHES) and that a second call is bit for bit the first;
    returns (got, want, plan)."""
    plan = fd.kernel_plan(q, keys, bt)
    before = dict(fd.INSTANCE_LAUNCHES)
    got = call(*args)
    again = call(*args)
    torch.cuda.synchronize()
    assert fd.INSTANCE_LAUNCHES[plan["instance"]] == \
        before[plan["instance"]] + 2
    assert torch.equal(got, again)          # deterministic
    return got, plain(*args), plan


@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("hD", [32, 64, 128])
def test_flash_decode_instances_at_their_window_boundary(cuda, rep, hD):
    """bf16 at the last window split-KV takes (nH/nKV x W = 16 queries a
    kv head) and the first the tensor cores take, GQA rep 1-8, T not a
    multiple of the split, pos[-1] = T - W."""
    rng = np.random.default_rng(rep * hD)
    nKV, T = 2, 300
    for W, want in ((16 // rep, "split"), (16 // rep + 1, "tc")):
        q, k, v, pos = _decode_case(rng, 3, W, T, rep * nKV, nKV, hD,
                                    "dense", torch.bfloat16, cuda)
        got, ref, plan = _instance_run(fd.flash_decode_attention,
                                       fd.flash_decode_attention_plain,
                                       (q, k, v, pos), q, k)
        assert plan["instance"] == want
        _assert_kernel(got, ref, 1e-4)


@pytest.mark.parametrize("mode,dtype", _MODES)
@pytest.mark.parametrize("B,W,T,nH,nKV,hD", [
    (8, 1, 1000, 16, 16, 128),   # decode, T not a multiple of the split
    (4, 1, 1024, 32, 32, 128),   # llama_7b heads
    (3, 4, 257, 8, 2, 64),       # verify-shaped, GQA 4, a 1-row tail
    (5, 2, 100, 16, 2, 32),      # GQA 8
])
def test_flash_decode_split_kv_matches_plain(cuda, mode, dtype, B, W, T, nH,
                                             nKV, hD):
    rng = np.random.default_rng(B * T + hD)
    q, k, v, pos = _decode_case(rng, B, W, T, nH, nKV, hD, mode, dtype, cuda)
    got, want, plan = _instance_run(fd.flash_decode_attention,
                                    fd.flash_decode_attention_plain,
                                    (q, k, v, pos), q, k)
    assert plan["instance"] == "split" and plan["splits"] > 1
    _assert_kernel(got, want, 1e-4)


@pytest.mark.parametrize("mode,dtype", _MODES)
@pytest.mark.parametrize("hD", [16, 32, 64, 128])
@pytest.mark.parametrize("W,nH,nKV", [
    (1, 1, 1), (3, 1, 1), (4, 2, 1), (5, 1, 1), (8, 2, 2), (2, 8, 2),
    (16, 1, 1), (1, 16, 1), (3, 10, 2)])
def test_flash_decode_split_kv_every_query_count(cuda, mode, dtype, hD, W,
                                                 nH, nKV):
    """Queries a kv head (nH/nKV x W) from 1 to 16, both split instances
    (at most 4 and at most 16 queries), T 4 (fewer rows than a stage: the
    llama_tiny prefill of a 5-token prompt) and 100, pos 0 and T - W."""
    for T in (max(4, W), 100):
        rng = np.random.default_rng(T * W + nH + hD)
        q, k, v, pos = _decode_case(rng, 2, W, T, nH, nKV, hD, mode, dtype,
                                    cuda, pos=np.array([0, T - W]))
        got, want, plan = _instance_run(fd.flash_decode_attention,
                                        fd.flash_decode_attention_plain,
                                        (q, k, v, pos), q, k)
        assert plan["instance"] == "split"
        _assert_kernel(got, want, 1e-4)


@pytest.mark.parametrize("mode,dtype", _MODES)
def test_flash_decode_split_kv_first_split_only(cuda, mode, dtype):
    """pos 0 and W 1 in every slot: every split but the first is empty
    (l = 0 partials the merge weights by 0)."""
    rng = np.random.default_rng(11)
    q, k, v, pos = _decode_case(rng, 8, 1, 1024, 16, 16, 128, mode, dtype,
                                cuda, pos=np.zeros(8, np.int64))
    got, want, plan = _instance_run(fd.flash_decode_attention,
                                    fd.flash_decode_attention_plain,
                                    (q, k, v, pos), q, k)
    assert plan["splits"] > 1
    _assert_kernel(got, want, 1e-4)


@pytest.mark.parametrize("mode,dtype", _MODES)
@pytest.mark.parametrize("W,nH,nKV", [(1, 16, 16), (4, 8, 2), (40, 4, 2)])
def test_flash_decode_instances_paged(cuda, mode, dtype, W, nH, nKV):
    """Both instances over shuffled pages with -1 tail pages against the
    plain version, and over an identity table bit for bit the contiguous
    call (the plan never depends on the layout)."""
    rng = np.random.default_rng(W * nH + nKV)
    B, T, hD, bs = 4, 320, 64, 16
    q = _rand(rng, (B, W, nH, hD), dtype, cuda)
    pk, pv, bt, pos = _paged_case(rng, B, W, T, nKV, hD, bs, mode, dtype,
                                  cuda)
    assert (bt < 0).any()
    got, want, plan = _instance_run(fd.flash_decode_paged,
                                    fd.flash_decode_paged_plain,
                                    (q, pk, pv, bt, pos), q, pk, bt)
    assert plan["instance"] == fd.kernel_instance(
        dtype, kv_quant.kv_components(pk)[0].dtype, W, nH, nKV, hD)
    _assert_kernel(got, want, 1e-4)
    k = _kv_store(rng, (B, T, nKV, hD), mode, dtype, cuda)
    v = _kv_store(rng, (B, T, nKV, hD), mode, dtype, cuda)

    def pages(x):
        return kv_quant.kv_map(
            lambda a: a.reshape((B * T // bs, bs) + tuple(a.shape[2:])), x)

    ident = torch.arange(B * T // bs, dtype=torch.int32,
                         device=cuda).view(B, T // bs)
    assert torch.equal(fd.flash_decode_paged(q, pages(k), pages(v), ident,
                                             pos),
                       fd.flash_decode_attention(q, k, v, pos))


def test_flash_decode_split_kernel_follows_the_plain_rule(cuda):
    """The card's split and merge against the same rule in plain PyTorch
    (flash_decode_split_plain) at the kernel's own plan, float32."""
    rng = np.random.default_rng(8)
    q, k, v, pos = _decode_case(rng, 8, 2, 1000, 16, 4, 64, "dense",
                                torch.float32, cuda)
    plan = fd.kernel_plan(q, k)
    got = fd.flash_decode_attention(q, k, v, pos)
    want = fd.flash_decode_split_plain(q, k, v, pos, plan["split_len"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_engine_on_card_matches_cpu(cuda):
    """The flash engine on the card gives the CPU engine's greedy
    streams (gpt_tiny, float32)."""
    from paddle_tpu_torch.inference.serving import \
        ContinuousBatchingEngine
    cfg = gpt.gpt_tiny(use_flash=False)
    cpu = gpt.init_params(cfg, seed=2, device="cpu")
    dev = {k: ({n: w.to(cuda) for n, w in v.items()}
               if isinstance(v, dict) else v.to(cuda))
           for k, v in cpu.items()}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (4, 33, 17)]
    streams = []
    for params, device in ((cpu, "cpu"), (dev, cuda)):
        eng = ContinuousBatchingEngine(params, cfg, max_batch=2,
                                       max_len=64, device=device)
        rids = [eng.submit(p, max_new=10) for p in prompts]
        out = eng.run(steps_per_sync=4)
        streams.append([out[r] for r in rids])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nH,hD,causal,packed", [
    (2, 100, 3, 32, True, False),    # ragged S (not a tile multiple)
    (1, 200, 2, 64, False, True),    # non-causal, strided q/k/v of qkv
    (2, 128, 2, 128, True, True),    # the training layout
    (1, 1000, 2, 64, True, False),   # ragged S at length
    (4, 512, 32, 128, True, False),  # llama_7b generate prefill
])
def test_flash_attention_kernels_match_plain(cuda, dtype, B, S, nH, hD,
                                             causal, packed):
    rng = np.random.default_rng(S + hD)
    if packed:
        qkv = _rand(rng, (B, S, 3, nH * hD), dtype, cuda)
        q, k, v = (qkv[:, :, i].view(B, S, nH, hD) for i in range(3))
    else:
        q, k, v = (_rand(rng, (B, S, nH, hD), dtype, cuda) for _ in range(3))
    dout = _rand(rng, (B, S, nH, hD), dtype, cuda)
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n in fa.launches()) for n in before}
    w_out, w_lse = fa.flash_attention_with_lse_plain(q, k, v, 0,
                                                     causal=causal)
    w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                                  causal)
    w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, causal)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    _assert_kernel(out, w_out, 1e-4, of_max=True)
    _assert_rel(lse, w_lse, 1e-4)
    for got, want in ((dq, w_dq), (dk, w_dk), (dv, w_dv)):
        assert got.shape == want.shape and got.is_contiguous()
        _assert_kernel(got, want, 1e-4, of_max=True)


def _flash_passes(q, k, v, dout, causal):
    """Forward, then the backward pair twice on the same inputs."""
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = [(*fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal),
              fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal))
             for _ in range(2)]
    torch.cuda.synchronize()
    return out, lse, delta, grads


@pytest.mark.parametrize("hD", [32, 64, 128])
@pytest.mark.parametrize("Sq,Sk,causal", [
    (100, 100, True),     # ragged: one partial 64-row tile
    (1000, 1000, True),   # ragged at length, many tiles
    (100, 300, True),     # Sk > Sq: key tiles past every row skip
    (300, 100, True),     # Sq > Sk
    (300, 100, False),
    (64, 1000, False),
])
def test_flash_attention_tc_kernels_match_plain(cuda, hD, Sq, Sk, causal):
    """The bf16 tensor-core kernels against the plain versions per element
    (one bf16 step), launch counts exact, and the backward deterministic:
    two runs give the same bits."""
    rng = np.random.default_rng(Sq + 7 * Sk + hD + causal)
    q, dout = (_rand(rng, (2, Sq, 2, hD), torch.bfloat16, cuda)
               for _ in range(2))
    k, v = (_rand(rng, (2, Sk, 2, hD), torch.bfloat16, cuda)
            for _ in range(2))
    before = dict(fa.LAUNCHES)
    out, lse, delta, grads = _flash_passes(q, k, v, dout, causal)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dkv": 2,
        "flash_attention_bwd_dq": 2, "flash_attention_with_lse_fwd": 0,
        "flash_attention_with_lse_bwd_dkv": 0,
        "flash_attention_with_lse_bwd_dq": 0}
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    dk, dv, dq = grads[0]
    w_out, w_lse = fa.flash_attention_with_lse_plain(q, k, v, 0,
                                                     causal=causal)
    w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                                  causal)
    w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, causal)
    _assert_rel(lse, w_lse, 1e-4)
    for got, want in ((out, w_out), (dq, w_dq), (dk, w_dk), (dv, w_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _assert_kernel(got, want, 1e-4)


@pytest.mark.parametrize("offset", [-1024, -37, 37])
def test_flash_attention_offsets_under_the_tc_tiles(cuda, offset):
    """The ring variant in bf16 at one chunk of 1024 rows and keys (16 key
    tiles of 64, 16 dK/dV query tiles): every row fully masked (-1024),
    rows 0..36 fully masked (-37), every row seeing 37 keys ahead;
    chip_smoke.ring_kernels_check holds each output per element."""
    rng = np.random.default_rng(1024 + offset)
    q, k, v, dout = (_rand(rng, (1, 1024, 2, 128), torch.bfloat16, cuda)
                     for _ in range(4))
    g_lse = _rand(rng, (1, 2, 1024), torch.float32, cuda)
    before = fa.launches("flash_attention_with_lse")
    chip_smoke.ring_kernels_check(fa, q, k, v, dout, g_lse, offset)
    after = fa.launches("flash_attention_with_lse")
    assert {n: after[n] - before[n] for n in before} == {
        n: 1 for n in before}


def test_flash_attention_dtype_picks_the_kernels(cuda):
    """bf16 runs the tensor-core kernels (*_tc_kernel), float32 the CUDA-
    core ones, as the profiler's kernel names show."""
    from torch.profiler import ProfilerActivity, profile
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(1, 128, 2, 64, device=cuda).to(dtype)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _flash_passes(x, x, x, x, True)
        names[dtype] = {e.key for e in prof.key_averages()
                        if "flash_attention" in e.key}
    assert len(names[torch.bfloat16]) == 3
    assert all("_tc_kernel" in n for n in names[torch.bfloat16])
    assert len(names[torch.float32]) == 3
    assert not any("_tc_" in n for n in names[torch.float32])


def test_flash_attention_autograd_on_card(cuda):
    """The Function's gradients on the card against autograd of the
    plain composition (float32, causal, packed qkv)."""
    rng = np.random.default_rng(7)
    B, S, nH, hD = 2, 96, 2, 64
    qkv = _rand(rng, (B, S, 3, nH * hD), torch.float32, cuda)
    g = _rand(rng, (B, S, nH, hD), torch.float32, cuda)
    grads = []
    for flash in (True, False):
        x = qkv.clone().requires_grad_(True)
        q, k, v = (x[:, :, i].view(B, S, nH, hD) for i in range(3))
        out = (fa.flash_attention(q, k, v) if flash
               else gpt._causal_attention(q, k, v, hD, use_flash=False))
        out.backward(g)
        grads.append((out.detach(), x.grad))
    for got, want in zip(*grads):
        _assert_rel(got, want, 1e-4)


def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q)
    h = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(h, h, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,V,H", [(128, 300, 128), (256, 1000, 256),
                                   (128, 50304, 2048)])
def test_fused_ce_kernel_matches_plain(cuda, dtype, N, V, H):
    rng = np.random.default_rng(N + V)
    h = _rand(rng, (N, H), dtype, cuda)
    W = (_rand(rng, (V, H), torch.float32, cuda) * 0.05).to(dtype)
    lbl = torch.tensor(rng.integers(0, V, N), dtype=torch.int32, device=cuda)
    lbl[:4] = torch.tensor([-1, V, V + 5, -7], dtype=torch.int32)
    before = fce.LAUNCHES
    z, picked = fce.fused_ce_fwd(h, W, lbl)
    torch.cuda.synchronize()
    assert fce.LAUNCHES == before + 1
    wz, wp = fce.fused_ce_fwd_plain(h, W, lbl)
    torch.testing.assert_close(z, wz, rtol=0, atol=1e-3)
    torch.testing.assert_close(picked, wp, rtol=0, atol=1e-3)
    assert (picked[:4] == 0).all()


@pytest.mark.parametrize("N,V,H", [(128, 50257, 2048), (128, 300, 128),
                                   (256, 50304, 128), (384, 1000, 2048)])
def test_fused_ce_tc_kernel_matches_plain(cuda, N, V, H):
    """bf16 on the tensor cores, split over the vocabulary: ragged V,
    N 128 (one row tile), H 128 and 2048, labels out of range and on the
    last vocabulary row, deterministic (two calls bit for bit)."""
    rng = np.random.default_rng(N + V + H)
    h = _rand(rng, (N, H), torch.bfloat16, cuda)
    W = (_rand(rng, (V, H), torch.float32, cuda) * 0.05).to(torch.bfloat16)
    lbl = torch.tensor(rng.integers(0, V, N), dtype=torch.int32, device=cuda)
    lbl[:6] = torch.tensor([-1, V, V + 5, -7, V - 1, V - 1],
                           dtype=torch.int32)
    before = fce.LAUNCHES
    z, picked = fce.fused_ce_fwd(h, W, lbl)
    z2, picked2 = fce.fused_ce_fwd(h, W, lbl)
    torch.cuda.synchronize()
    assert fce.LAUNCHES == before + 2        # one a call, merge included
    assert torch.equal(z, z2) and torch.equal(picked, picked2)
    wz, wp = fce.fused_ce_fwd_plain(h, W, lbl)
    torch.testing.assert_close(z, wz, rtol=0, atol=1e-3)
    torch.testing.assert_close(picked, wp, rtol=0, atol=1e-3)
    assert (picked[:4] == 0).all() and (picked[4:6] != 0).all()
    # the same split-and-merge rule in plain PyTorch, at the kernel's plan
    splits, per = fce.ce_plan(N, V, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    sz, sp = fce.fused_ce_fwd_split_plain(h, W, lbl, per)
    torch.testing.assert_close(z, sz, rtol=0, atol=1e-3)
    torch.testing.assert_close(picked, sp, rtol=0, atol=1e-3)


def test_fused_ce_cuda_tensor_never_reaches_plain(cuda, monkeypatch):
    def refuse(*_):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(fce, "fused_ce_fwd_plain", refuse)
    monkeypatch.setattr(fce, "fused_ce_fwd_split_plain", refuse)
    monkeypatch.setattr(fce, "matmul_f32out", refuse)
    for dtype in (torch.bfloat16, torch.float32):
        h = torch.randn(128, 64, device=cuda).to(dtype)
        W = torch.randn(200, 64, device=cuda).to(dtype)
        z, picked = fce.fused_ce_fwd(h, W, torch.zeros(
            128, dtype=torch.int32, device=cuda))
        assert z.is_cuda and torch.isfinite(z).all()


def test_chunked_nll_no_grad_runs_the_kernel(cuda):
    rng = np.random.default_rng(5)
    h = _rand(rng, (256, 128), torch.bfloat16, cuda)
    W = (_rand(rng, (500, 128), torch.float32, cuda) * 0.05).to(
        torch.bfloat16)
    lbl = torch.tensor(rng.integers(0, 500, 256), device=cuda)
    before = fce.LAUNCHES
    with torch.no_grad():
        got = chunked_vocab_nll(h, W, lbl, 0, 1)
    assert fce.LAUNCHES == before + 1
    want = chunked_vocab_nll(h.requires_grad_(True), W, lbl, 0, 3)
    assert fce.LAUNCHES == before + 1
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=1e-3)


def test_train_steps_on_card_match_cpu(cuda):
    """gpt_tiny float32 with bfloat16 AdamW moments and four
    micro-batches (chip_smoke.py covers float32 moments at one and two):
    three steps on the card (flash kernels) equal three steps on the CPU
    (plain versions), losses at rel 1e-4; then the eval loss, which on
    the card runs the fused_ce kernel, equals the CPU's at rel 1e-4."""
    cfg = gpt.gpt_tiny()
    params = gpt.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 64)))
    lbl = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 64)))
    losses, evals = {}, {}
    for dev in ("cpu", cuda):
        step, shard, init_opt = hybrid.build_train_step(
            cfg, num_micro=4, remat=False, moment_dtype=torch.bfloat16,
            device=dev)
        p = shard(params)
        o = init_opt(p)
        out = []
        for _ in range(3):
            loss, p, o = step(p, o, ids.to(dev), lbl.to(dev))
            out.append(loss.item())
        losses[str(dev)] = out
        before = fce.LAUNCHES
        with torch.no_grad():
            evals[str(dev)] = gpt.loss_fn(p, ids.to(dev), lbl.to(dev),
                                          cfg).item()
        assert fce.LAUNCHES == before + (dev != "cpu")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    np.testing.assert_allclose(evals["cuda"], evals["cpu"], rtol=1e-4)


def test_matmul_f32out_under_autograd_on_card(cuda):
    """The bf16 x bf16 -> f32 product (the tied head) differentiates on
    the card: its written-out backward against autograd of the float32
    product of the same bf16 values."""
    from paddle_tpu_torch.models.common import matmul_f32out
    rng = np.random.default_rng(11)
    a = _rand(rng, (64, 128), torch.bfloat16, cuda).requires_grad_(True)
    b = _rand(rng, (128, 96), torch.bfloat16, cuda).requires_grad_(True)
    g = _rand(rng, (64, 96), torch.float32, cuda)
    out = matmul_f32out(a, b)
    assert out.dtype == torch.float32
    out.backward(g)
    a32 = a.detach().float().requires_grad_(True)
    b32 = b.detach().float().requires_grad_(True)
    (a32 @ b32).backward(g)
    torch.testing.assert_close(out, (a32 @ b32).detach(), rtol=0, atol=1e-4)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    torch.testing.assert_close(a.grad.float(), a32.grad, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(b.grad.float(), b32.grad, rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# fused_decode: the whole int8 layer stack of a b1 step in one launch
# ---------------------------------------------------------------------------

from paddle_tpu_torch.incubate.nn.kernels import fused_decode as fdl  # noqa: E402

_FUSED_MODES = ("f32", "bf16", "int8", "fp8")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)


def _fused_case(rng, device, L, H, nH, F, T, mode, param_dtype, pos):
    """Seeded inputs of fused_decode_layers: a random int8 layer stack
    (scales ~ 1/(127 sqrt(K)), so activations stay O(1)), h0 row 0, and
    a [L, T, H] cache whose rows hold random K/V in ``mode``'s storage
    (f32 / bf16 model-dtype caches, int8 with scales, fp8)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 30)))

    def w(K, N):
        q = torch.randint(-127, 128, (L, K, N), generator=gen,
                          device=device, dtype=torch.int8)
        s = torch.from_numpy((rng.uniform(0.5, 1.5, (L, N)) / (127 * K ** 0.5))
                             .astype(np.float32))
        return q, s.to(device)

    def small(*shape, base=0.0):
        return (_rand(rng, shape, torch.float32, device) * 0.1 + base).to(
            param_dtype)

    qlayers = {"qkv_w": w(H, 3 * H), "proj_w": w(H, H), "fc1_w": w(H, F),
               "fc2_w": w(F, H), "qkv_b": small(L, 3, H),
               "proj_b": small(L, H), "fc1_b": small(L, F),
               "fc2_b": small(L, H), "ln1_g": small(L, H, base=1.0),
               "ln1_b": small(L, H), "ln2_g": small(L, H, base=1.0),
               "ln2_b": small(L, H)}
    h0 = torch.zeros((8, H), dtype=torch.float32, device=device)
    h0[0] = _rand(rng, (H,), torch.float32, device)
    x = _rand(rng, (2, L, T, nH, H // nH), torch.float32, device)
    scales = None
    if mode == "int8":
        (ck, ks), (cv, vs) = (kv_quant.quantize_kv(x[i], "int8")
                              for i in range(2))
        ck, cv = ck.reshape(L, T, H), cv.reshape(L, T, H)
        scales = (ks.reshape(L, T, nH).contiguous(),
                  vs.reshape(L, T, nH).contiguous())
    elif mode == "fp8":
        ck, cv = (kv_quant.quantize_kv(x[i], "fp8")[0].reshape(L, T, H)
                  for i in range(2))
    else:
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        ck, cv = (x[i].reshape(L, T, H).to(dt) for i in range(2))
    return h0, qlayers, ck, cv, scales, torch.tensor(
        [pos], dtype=torch.int32, device=device)


def _clone_cache(ck, cv, scales):
    return (ck.clone(), cv.clone(),
            None if scales is None else tuple(s.clone() for s in scales))


def _assert_fused(got, want, before, pos, mode):
    """h_out row 0 within 2^-6 of its largest value (the two versions
    sum in other orders, so a bf16 rounding point — LN output, q, p, the
    GELU output — may flip by one step, and the step's effect carries
    through the following layers); rows 1-7 zero; the written row in
    storage units (model dtype: one bf16 step, 2^-7 |want| + 2^-7 of the
    row's largest value; int8: one quantum and scales to 2^-7; fp8: one
    e4m3 step, 2^-3 |want| + 2^-9); every other row bit for bit."""
    h, w = got[0][0], want[0][0]
    assert torch.isfinite(h).all()
    assert (h - w).abs().max().item() <= 2 ** -6 * w.abs().max().item()
    assert not got[0][1:].any()
    for i, (g, x, b) in enumerate(zip(got[1:3], want[1:3], before[:2])):
        gb, xb, bb = (kv_quant.byte_view(t) for t in (g, x, b))
        keep = torch.ones(g.shape[1], dtype=torch.bool, device=g.device)
        keep[pos] = False
        assert torch.equal(gb[:, keep], bb[:, keep]), f"cache {i}: rows " \
            "other than pos changed"
        gr, xr = g[:, pos].float(), x[:, pos].float()
        if mode == "int8":
            assert (gr - xr).abs().max().item() <= 1
        elif mode == "fp8":
            assert ((gr - xr).abs() <= 2 ** -3 * xr.abs() + 2 ** -9).all()
        else:
            assert ((gr - xr).abs() <= 2 ** -7 * xr.abs()
                    + 2 ** -7 * xr.abs().max()).all()
    if mode == "int8":
        for g, x, b in zip(got[3:], want[3:], before[2]):
            keep = torch.ones(g.shape[1], dtype=torch.bool, device=g.device)
            keep[pos] = False
            assert torch.equal(g[:, keep], b[:, keep])
            assert ((g[:, pos] - x[:, pos]).abs()
                    <= 2 ** -7 * x[:, pos].abs()).all()


@pytest.mark.parametrize("mode", _FUSED_MODES)
@pytest.mark.parametrize("pos", [0, 7, 8, 255, 256, 700, 1023,
                                 # the edges of the attention items: one
                                 # row, a chunk and a row, tile sizes
                                 1, 257, 511, 512, 767])
def test_fused_decode_kernel_matches_plain(cuda, mode, pos):
    rng = np.random.default_rng(pos + 7)
    L, H, nH, F, T = 2, 256, 2, 1024, 1024
    h0, ql, ck, cv, sc, p = _fused_case(rng, cuda, L, H, nH, F, T, mode,
                                        torch.bfloat16, pos)
    before = _clone_cache(ck, cv, sc)
    wk, wv, ws = _clone_cache(ck, cv, sc)
    n0 = (fdl.LAUNCHES, dict(fdl.MODE_LAUNCHES))
    got = fdl.fused_decode_layers(h0, ql, ck, cv, p, nH, eps=1e-5,
                                  scales=sc)
    torch.cuda.synchronize()
    key = "dense" if mode in ("f32", "bf16") else mode
    assert fdl.LAUNCHES == n0[0] + 1
    assert fdl.MODE_LAUNCHES[key] == n0[1][key] + 1
    assert got[1] is ck and got[2] is cv
    want = fdl.fused_decode_layers_plain(h0, ql, wk, wv, p, nH, eps=1e-5,
                                         scales=ws)
    _assert_fused(got, want, before, pos, mode)


@pytest.mark.parametrize("mode", _FUSED_MODES)
@pytest.mark.parametrize("H,nH,F,param_dtype", [
    (64, 4, 256, torch.float32),      # hD 16
    (96, 3, 160, torch.float32),      # hD 32, widths not a tile multiple
    (192, 3, 768, torch.bfloat16),    # hD 64
])
def test_fused_decode_head_dims_and_params(cuda, mode, H, nH, F,
                                           param_dtype):
    rng = np.random.default_rng(H + F)
    pos = 300
    h0, ql, ck, cv, sc, p = _fused_case(rng, cuda, 3, H, nH, F, 512, mode,
                                        param_dtype, pos)
    before = _clone_cache(ck, cv, sc)
    wk, wv, ws = _clone_cache(ck, cv, sc)
    got = fdl.fused_decode_layers(h0, ql, ck, cv, p, nH, eps=1e-5,
                                  scales=sc)
    want = fdl.fused_decode_layers_plain(h0, ql, wk, wv, p, nH, eps=1e-5,
                                         scales=ws)
    _assert_fused(got, want, before, pos, mode)


@pytest.mark.parametrize("H,nH,F,T,pos", [
    (16384, 128, 16384, 8, 7),        # widths at MAX_WIDTH, shortest T
    (128, 1, 16384, 256, 255),        # F at the limit, T at the chunk
    (256, 2, 512, 8, 0),
])
def test_fused_decode_cooperative_launch_at_the_limits(cuda, H, nH, F, T,
                                                       pos):
    rng = np.random.default_rng(T)
    h0, ql, ck, cv, sc, p = _fused_case(rng, cuda, 1, H, nH, F, T, "bf16",
                                        torch.bfloat16, pos)
    before = _clone_cache(ck, cv, sc)
    wk, wv, ws = _clone_cache(ck, cv, sc)
    got = fdl.fused_decode_layers(h0, ql, ck, cv, p, nH, scales=sc)
    want = fdl.fused_decode_layers_plain(h0, ql, wk, wv, p, nH, scales=ws)
    _assert_fused(got, want, before, pos, "bf16")


@pytest.mark.parametrize("mode", _FUSED_MODES)
def test_fused_decode_two_launches_give_the_same_bits(cuda, mode):
    """Deterministic: at a width where every column tile's sum has
    several parts (and a different block may finish it last), two
    launches from the same seeded state give bit-equal h_out, cache
    and scale bytes."""
    rng = np.random.default_rng(11)
    L, H, nH, F, T, pos = 2, 2048, 16, 8192, 1024, 700
    h0, ql, ck, cv, sc, p = _fused_case(rng, cuda, L, H, nH, F, T, mode,
                                        torch.bfloat16, pos)
    outs = []
    for _ in range(2):
        k, v, s = _clone_cache(ck, cv, sc)
        got = fdl.fused_decode_layers(h0, ql, k, v, p, nH, scales=s)
        torch.cuda.synchronize()
        outs.append([got[0]] + [kv_quant.byte_view(t) for t in got[1:]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.isfinite(outs[0][0]).all()


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_fused_decode_gemv_takes_every_int8_value(cuda, mode):
    """Weights that hold every int8 value from -128 to 127 (a seeded
    shuffle of each in equal numbers), against the plain version with
    chip_smoke's limits: layer 0's new K/V row comes straight from the
    qkv GEMV, and is held to 2^-16 of its largest value (float32 sum
    order only), so a byte converted wrongly shows."""
    rng = np.random.default_rng(5)
    L, H, nH, F, T, pos = 2, 512, 4, 2048, 256, 100
    h0, ql, ck, cv, sc, p = _fused_case(rng, cuda, L, H, nH, F, T, mode,
                                        torch.float32, pos)
    for name, (q, s) in list(ql.items()):
        if name.endswith("_w"):
            full = np.resize(np.arange(-128, 128, dtype=np.int8), q.numel())
            ql[name] = (torch.from_numpy(rng.permutation(full)).reshape(
                q.shape).to(cuda), s)
            assert set(ql[name][0].unique().tolist()) == set(range(-128, 128))
    before = _clone_cache(ck, cv, sc)
    wk, wv, ws = _clone_cache(ck, cv, sc)
    got = fdl.fused_decode_layers(h0, ql, ck, cv, p, nH, scales=sc)
    want = fdl.fused_decode_layers_plain(h0, ql, wk, wv, p, nH, scales=ws)
    torch.cuda.synchronize()
    flat = [before[0], before[1], *(before[2] or ())]
    errs = chip_smoke._fused_errors(kv_quant, got, want, flat, pos, mode)
    assert errs["row_share_layer0"] <= 1


@pytest.mark.parametrize("L,pos", [(1, 0), (3, 300), (24, 5)])
def test_fused_decode_barrier_count_and_plan(cuda, L, pos):
    """The kernel counts its grid barriers: barriers_per_token(L) = 6 L
    - 1, at most 6 a layer; the plan is one block an SM, the scratch
    and sync sizes equal the wrapper's mirror of the kernel's layout,
    every column-tile counter is back at 0 after the launch and the
    barrier's arrival count grew by grid x barriers."""
    rng = np.random.default_rng(L)
    H, nH, F, T = 256, 2, 1024, 512
    h0, ql, ck, cv, sc, p = _fused_case(rng, cuda, L, H, nH, F, T, "bf16",
                                        torch.bfloat16, pos)
    fdl.fused_decode_layers(h0, ql, ck, cv, p, nH, scales=sc)
    count0 = fdl._SYNC[(h0.device.index, H, F)][:2].view(torch.int64).item()
    fdl.fused_decode_layers(h0, ql, ck, cv, p, nH, scales=sc)
    assert fdl.last_barriers() == fdl.barriers_per_token(L) <= 6 * L
    plan = fdl.kernel_plan(h0.device, H, F, T, nH)
    sms = torch.cuda.get_device_properties(h0.device).multi_processor_count
    assert plan["grid"] == sms and plan["threads"] == 512
    assert plan["stages"] >= 2 and plan["tile"] == fdl.GEMV_TILE
    assert plan["scratch_floats"] == fdl.scratch_layout(
        H, F, T, nH, plan["grid"])["total"]
    assert plan["sync_ints"] == fdl.sync_ints(H, F)
    sync = fdl._SYNC[(h0.device.index, H, F)].cpu()
    count = sync[:2].view(torch.int64).item()
    assert count - count0 == plan["grid"] * fdl.barriers_per_token(L)
    assert count % plan["grid"] == 0 and not sync[4:].any()


def test_fused_decode_cuda_tensor_never_reaches_plain(cuda, monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(fdl, "fused_decode_layers_plain", refuse)
    monkeypatch.setattr(fdl, "_plain", refuse)
    rng = np.random.default_rng(1)
    h0, ql, ck, cv, sc, p = _fused_case(rng, cuda, 2, 64, 2, 256, 64,
                                        "int8", torch.float32, 5)
    out = fdl.fused_decode_layers(h0, ql, ck, cv, p, 2, scales=sc)
    assert out[0].is_cuda and torch.isfinite(out[0]).all()


def test_fused_decode_pos_out_of_range_writes_nothing(cuda):
    rng = np.random.default_rng(2)
    h0, ql, ck, cv, sc, _ = _fused_case(rng, cuda, 2, 64, 2, 256, 64,
                                        "bf16", torch.float32, 0)
    before = ck.clone(), cv.clone()
    for bad in (-1, 64):
        out = fdl.fused_decode_layers(
            h0, ql, ck, cv, torch.tensor([bad], dtype=torch.int32,
                                         device=cuda), 2)
        assert torch.isnan(out[0][0]).all() and not out[0][1:].any()
    assert torch.equal(ck, before[0]) and torch.equal(cv, before[1])


@pytest.mark.parametrize("bad", [
    "h0_bf16", "weight_int16", "weight_noncontiguous", "params_mixed",
    "cache_f16", "T_not_8", "T_not_256", "int8_no_scales", "pos_int64",
    "pos_on_cpu", "cache_misaligned"])
def test_fused_decode_rejects(cuda, bad):
    """A call the kernel does not take raises before any launch."""
    rng = np.random.default_rng(4)
    T = 264 if bad == "T_not_256" else (12 if bad == "T_not_8" else 64)
    h0, ql, ck, cv, sc, p = _fused_case(rng, cuda, 2, 64, 2, 256, T,
                                        "int8", torch.float32, 3)
    if bad == "h0_bf16":
        h0 = h0.to(torch.bfloat16)
    elif bad == "weight_int16":
        ql["fc1_w"] = (ql["fc1_w"][0].to(torch.int16), ql["fc1_w"][1])
    elif bad == "weight_noncontiguous":
        q = ql["proj_w"][0]
        ql["proj_w"] = (q.transpose(1, 2).contiguous().transpose(1, 2),
                        ql["proj_w"][1])
    elif bad == "params_mixed":
        ql["ln2_b"] = ql["ln2_b"].to(torch.bfloat16)
    elif bad == "cache_f16":
        ck, cv, sc = ck.half(), cv.half(), None
    elif bad == "int8_no_scales":
        sc = None
    elif bad == "pos_int64":
        p = p.long()
    elif bad == "pos_on_cpu":
        p = p.cpu()
    elif bad == "cache_misaligned":     # contiguous, 8 bytes off 16
        flat = torch.zeros(ck.numel() + 8, dtype=torch.int8, device=cuda)
        ck = flat[8:].view(ck.shape)
    before = fdl.LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        fdl.fused_decode_layers(h0, ql, ck, cv, p, 2, scales=sc)
    assert fdl.LAUNCHES == before


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_fused_engine_on_card_matches_cpu(cuda, kv_dtype):
    """FusedB1Engine on the card gives the CPU engine's greedy streams
    (gpt_tiny, float32, int8 weights), one fused launch a decode step."""
    from paddle_tpu_torch.inference.serving import FusedB1Engine
    cfg = gpt.gpt_tiny(use_flash=False)
    cpu = gpt.quantize_decode_params(
        gpt.init_params(cfg, seed=2, device="cpu"), cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (4, 33, 17)]
    streams = []
    for params, device in ((cpu, "cpu"), (_to(cpu, cuda), cuda)):
        eng = FusedB1Engine(params, cfg, max_len=64, kv_dtype=kv_dtype,
                            device=device)
        before = fdl.LAUNCHES
        rids = [eng.submit(p, max_new=10) for p in prompts]
        out = eng.run(steps_per_sync=4)
        streams.append([out[r] for r in rids])
        launched = fdl.LAUNCHES - before
        assert launched == (eng.metrics()["decode_steps"]
                            if device == cuda else 0)
    assert streams[0] == streams[1]


@pytest.mark.parametrize("policy", ["fused", "llama"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H", [
    (8, 4096),      # llama_7b decode rows
    (2048, 4096),   # prefill rows
    (8, 128),       # llama_tiny
    (7, 11008),     # odd N, FFN width
    (5, 11),        # H under and not a multiple of the vector width
    (3, 1100),      # rows not 16-byte aligned (bf16: 2200 bytes)
])
def test_rms_norm_kernel_matches_plain(cuda, policy, dtype, N, H):
    rng = np.random.default_rng(N + H)
    x = _rand(rng, (N, H), dtype, cuda)
    w = (1 + 0.1 * _rand(rng, (H,), torch.float32, cuda)).to(dtype)
    before = dict(fnr.LAUNCHES)
    got, rstd = fnr.rms_norm(x, w, 1e-6, policy)
    torch.cuda.synchronize()
    assert fnr.LAUNCHES[policy] == before[policy] + 1
    assert sum(fnr.LAUNCHES.values()) == sum(before.values()) + 1
    want, want_rstd = fnr.rms_norm_plain(x, w, 1e-6, policy)
    assert got.dtype == dtype and got.shape == (N, H)
    assert (rstd is None) == (policy == "llama")
    chip_smoke._rms_errors(got, want, rstd, want_rstd)


@pytest.mark.parametrize("layout", ["row_stride", "misaligned"])
def test_rms_norm_kernel_strides(cuda, layout):
    """x with rows wider than H (a column slice) or a base 2 bytes off
    16: the kernel reads it in place."""
    rng = np.random.default_rng(9)
    if layout == "row_stride":
        x = _rand(rng, (6, 4096 + 64), torch.bfloat16, cuda)[:, 64:]
    else:
        flat = _rand(rng, (6 * 4096 + 1,), torch.bfloat16, cuda)
        x = flat[1:].view(6, 4096)
    w = _rand(rng, (4096,), torch.bfloat16, cuda)
    for policy in fnr.POLICIES:
        got, rstd = fnr.rms_norm(x, w, 1e-6, policy)
        want, want_rstd = fnr.rms_norm_plain(x, w, 1e-6, policy)
        chip_smoke._rms_errors(got, want, rstd, want_rstd)


@pytest.mark.parametrize("bad", ["float16", "w_dtype", "last_axis_strided",
                                 "w_strided", "under_grad"])
def test_rms_norm_rejects(cuda, bad):
    """A call the kernel does not take raises before any launch."""
    x = torch.randn(4, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    if bad == "float16":
        x, w = x.half(), w.half()
    elif bad == "w_dtype":
        w = w.bfloat16()
    elif bad == "last_axis_strided":
        x = torch.randn(64, 4, device=cuda).t()
    elif bad == "w_strided":
        w = torch.ones(128, device=cuda)[::2]
    elif bad == "under_grad":
        # the autograd entry checks as the plain one does
        x, w = x.half().requires_grad_(True), w.half()
    before = dict(fnr.LAUNCHES)
    for policy in fnr.POLICIES:
        with pytest.raises((TypeError, ValueError, NotImplementedError)):
            fnr.rms_norm(x, w, 1e-6, policy)
    assert fnr.LAUNCHES == before


def test_rms_norm_cuda_tensor_never_reaches_plain(cuda, monkeypatch):
    def refuse(*_):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(fnr, "rms_norm_plain", refuse)
    out, _ = fnr.rms_norm(torch.randn(3, 40, device=cuda),
                          torch.ones(40, device=cuda), 1e-6, "llama")
    assert out.is_cuda and torch.isfinite(out).all()


def test_rms_norm_pallas_autograd_on_card(cuda):
    """rms_norm_pallas: the "fused" kernel forward (one launch), the plain
    backward; gradients equal the CPU's within 1e-5."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    w = rng.standard_normal(96).astype(np.float32)
    g = rng.standard_normal((2, 5, 96)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda):
        tx = torch.tensor(x, device=dev, requires_grad=True)
        tw = torch.tensor(w, device=dev, requires_grad=True)
        before = fnr.LAUNCHES["fused"]
        out = fnr.rms_norm_pallas(tx, tw)
        assert fnr.LAUNCHES["fused"] == before + (dev == cuda)
        (out * torch.tensor(g, device=dev)).sum().backward()
        grads.append((tx.grad.cpu(), tw.grad.cpu()))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_llama_forward_on_card_matches_cpu(cuda):
    """llama_tiny (GQA 4/2) float32: the card's route (the RMS kernel,
    flash_attention over the repeated KV heads) against the CPU's plain
    route, logits within 1e-4 of their largest value."""
    cfg = llama.llama_tiny(initializer_range=0.3)
    cpu = llama.init_params(cfg, seed=3, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 40)))
    before = fa.LAUNCHES["flash_attention_fwd"]
    got = llama.forward(_to(cpu, cuda), ids.to(cuda), cfg)
    assert fa.LAUNCHES["flash_attention_fwd"] == before + cfg.num_layers
    want = llama.forward(cpu, ids, cfg)
    _assert_rel(got.cpu(), want, 1e-4)


def test_llama_tiny_card_streams_match_cpu(cuda):
    """chip_smoke's reference phase: generate and the slot loop (kv_dtype
    bf16 and int8) on the card equal the CPU's plain route, with the
    launch counts held exactly."""
    chip_smoke.llama_reference_phase(llama, fnr, fd)


# ---------------------------------------------------------------------------
# The ring variant of flash attention and LLaMA training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [-200, -100, -37, 0, 37, 150, 300])
def test_flash_attention_offset_kernels_match_plain(cuda, dtype, offset):
    """q 100 rows against k 200 (ragged tiles, Sq != Sk), 2 heads of 64:
    fully masked rows (offset <= -100), partly masked ones, every key
    visible (300); offset 0 also bit for bit to the zero-offset call."""
    rng = np.random.default_rng(offset + 500)
    q = _rand(rng, (2, 100, 2, 64), dtype, cuda)
    k, v = (_rand(rng, (2, 200, 2, 64), dtype, cuda) for _ in range(2))
    dout = _rand(rng, (2, 100, 2, 64), dtype, cuda)
    g_lse = _rand(rng, (2, 2, 100), torch.float32, cuda)
    before = fa.launches("flash_attention_with_lse")
    (out, lse, *_), _, _, _ = chip_smoke.ring_kernels_check(
        fa, q, k, v, dout, g_lse, offset)
    after = fa.launches("flash_attention_with_lse")
    assert {n: after[n] - before[n] for n in before} == {
        n: 1 for n in before}
    if offset <= -100:                       # no row sees a key
        assert (lse <= -1e29).all()
        torch.testing.assert_close(out.float(), v.float().mean(
            1, keepdim=True).expand_as(out), rtol=2 ** -7, atol=1e-3)


def test_flash_attention_with_lse_autograd_on_card(cuda):
    """The ring variant's Function on the card (kernels) against the CPU
    (plain forward and backward), float32, with an lse cotangent."""
    rng = np.random.default_rng(12)
    x = [rng.standard_normal((1, 96, 2, 64)).astype(np.float32)
         for _ in range(4)]
    gl = rng.standard_normal((1, 2, 96)).astype(np.float32)
    res = []
    for dev in ("cpu", cuda):
        leaves = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in x[:3]]
        out, lse = fa.flash_attention_with_lse(*leaves, -37)
        torch.autograd.backward([out, lse], [torch.tensor(x[3], device=dev),
                                             torch.tensor(gl, device=dev)])
        res.append([t.detach().cpu() for t in (out, lse)]
                   + [t.grad.cpu() for t in leaves])
    for got, want in zip(res[1], res[0]):
        _assert_rel(got, want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_replay_on_card_matches_dense(cuda, dtype):
    """Four ranks of 100 positions replayed through ring_attention_loop
    against dense flash attention over 400 (chip_smoke.ring_replay)."""
    row = chip_smoke.ring_replay(fa, ra, 2, 100, 2, 64, dtype, seed=3)
    assert row["launches"] == {
        n: 16 for n in fa.launches("flash_attention_with_lse")}


def test_ring_pass_refuses_cuda_tensors_on_gloo(cuda):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        k = torch.zeros(1, 8, 1, 32, device=cuda)
        with pytest.raises(RuntimeError, match="gloo"):
            collective.ring_pass(k, k)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("policy", ["fused", "llama"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H", [(64, 4096), (7, 1100)])
def test_rms_norm_backward_on_card(cuda, policy, dtype, N, H):
    rng = np.random.default_rng(N + H + 1)
    x, g = (_rand(rng, (N, H), dtype, cuda) for _ in range(2))
    w = (1 + 0.1 * _rand(rng, (H,), torch.float32, cuda)).to(dtype)
    chip_smoke.rms_backward_check(fnr, x, w, g, policy)


def test_llama_train_steps_on_card_match_cpu(cuda):
    """chip_smoke's LLaMA reference phase: three steps of llama_tiny on
    the card equal the CPU's, remat False and True, launches exact."""
    chip_smoke.llama_train_reference_phase(llama, hybrid, fa, fnr)


def test_llama_sp_on_a_one_rank_nccl_group(cuda):
    """loss_fn(sp_group=g) on a one-rank NCCL group (the offset kernels,
    one block a layer) against loss_fn without a group."""
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, seed=4, device=cuda)
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 64))).to(cuda)
    row = chip_smoke.llama_sp_check(llama, fa, cfg, params, ids, ids)
    assert row["offset_launches"] == {
        n: cfg.num_layers for n in fa.launches("flash_attention_with_lse")}


# ---------------------------------------------------------------------------
# speculative decoding: the verify window through the decode kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("mode", ["dense", "int8", "fp8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_verify_rows_are_w1_calls_bit_for_bit(cuda, layout, mode, k):
    """At gpt3_1p3b's decode shape (B 8, T 1024, 16 heads of 128, q
    bf16), each row j of a W = k+1 window equals, bit for bit, a W = 1
    call at pos + j on the same cache: the split plan depends on (B, nKV,
    T) alone and a query's reduction order does not depend on W, so the
    speculative verify gives the decode step's attention."""
    rng = np.random.default_rng(k)
    B, W, T, nH, hD, bs = 8, k + 1, 1024, 16, 128, 64
    if layout == "paged":
        kc, vc, bt, pos = _paged_case(rng, B, W, T, nH, hD, bs, mode,
                                      torch.bfloat16, cuda)
    else:
        _, kc, vc, pos = _decode_case(rng, B, W, T, nH, nH, hD, mode,
                                      torch.bfloat16, cuda)
        bt = None
    q = _rand(rng, (B, W, nH, hD), torch.bfloat16, cuda)

    def call(qq, p):
        if bt is None:
            return fd.flash_decode_attention(qq, kc, vc, p)
        return fd.flash_decode_paged(qq, kc, vc, bt, p)

    assert fd.kernel_plan(q, kc, bt)["instance"] == "split"
    assert fd.kernel_plan(q, kc, bt) == fd.kernel_plan(q[:, :1], kc, bt)
    window = call(q, pos)
    rows = torch.cat([call(q[:, j:j + 1].contiguous(), pos + j)
                      for j in range(W)], dim=1)
    torch.cuda.synchronize()
    assert torch.equal(window, rows)


def _spec_models(device):
    """gpt_tiny f32 (hD 32) and a smaller GPT draft (hD 16) on
    ``device``, from the same seeds on every device."""
    cfg = gpt.gpt_tiny(use_flash=False)
    dcfg = gpt.gpt_tiny(hidden_size=64, num_layers=2, num_heads=4,
                        use_flash=False)
    return (cfg, _to(gpt.init_params(cfg, seed=2, device="cpu"), device),
            dcfg, _to(gpt.init_params(dcfg, seed=5, device="cpu"), device))


@pytest.mark.parametrize("draft", ["gpt", "ngram"])
@pytest.mark.parametrize("paged", [False, True])
def test_speculative_engine_on_card_matches_cpu(cuda, paged, draft):
    """A speculative engine on the card (flash kernels) gives the CPU
    engine's streams, which are the non-speculative streams; the verify
    runs through flash_decode (paged: flash_decode_paged), L launches a
    round."""
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, PagedContinuousBatchingEngine,
        SpeculativeConfig)
    E = PagedContinuousBatchingEngine if paged else ContinuousBatchingEngine
    kw = dict(block_size=8, num_blocks=40) if paged else {}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 1024, (n,)) for n in (4, 33, 17)]
    streams = []
    for device, ak in (("cpu", "xla"), (cuda, "flash")):
        cfg, params, dcfg, dparams = _spec_models(device)
        spec = True if draft == "ngram" else SpeculativeConfig(
            k=3, draft_params=dparams, draft_cfg=dcfg)
        for s in (None, spec):
            eng = E(params, cfg, max_batch=2, max_len=64, device=device,
                    attn_kernel=ak, speculative=s, **kw)
            before = (fd.LAUNCHES, fd.PAGED_LAUNCHES)
            rids = [eng.submit(p, max_new=10) for p in prompts]
            out = eng.run(steps_per_sync=4)
            streams.append([out[r] for r in rids])
            if device == cuda and s is not None:
                m = eng.metrics()
                rounds = m["launches"]["verify"]
                got = (fd.PAGED_LAUNCHES - before[1]) if paged else \
                    (fd.LAUNCHES - before[0])
                want = cfg.num_layers * (m["decode_steps"] + rounds)
                if not paged:
                    want += cfg.num_layers * m["launches"]["prefill"]
                    want += dcfg.num_layers * (
                        m["draft_steps"]
                        + m["launches"].get("draft_prefill", 0))
                assert rounds >= 1 and got == want
    assert all(s == streams[0] for s in streams)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_verify_fused_rows_are_the_fused_steps(cuda, kv_dtype):
    """verify_fused on the card equals successive decode_step_fused
    calls on a copy of the cache, logits and written rows bit for bit
    (gpt_tiny with int8 weights), one fused launch a window position."""
    from paddle_tpu_torch.incubate.nn.kernels import fused_decode as fdl
    cfg = gpt.gpt_tiny(use_flash=False)
    qp = _to(gpt.quantize_decode_params(
        gpt.init_params(cfg, seed=2, device="cpu"), cfg), cuda)
    rng = np.random.default_rng(4)
    cache = gpt.init_decode_cache(cfg, 1, 256, kv_dtype, device=cuda)
    ids = torch.tensor(rng.integers(0, 1024, (1, 40)), device=cuda)
    gpt.prefill_into_slots(qp, ids, cfg, cache,
                           torch.zeros(1, dtype=torch.long, device=cuda),
                           attn_kernel="flash")
    flat = gpt.flatten_decode_cache(cache, cfg)
    copy = {n: a.clone() for n, a in flat.items()}
    toks = torch.tensor(rng.integers(0, 1024, (1, 4)), dtype=torch.int32,
                        device=cuda)
    pos = torch.tensor([40], dtype=torch.int32, device=cuda)
    before = fdl.LAUNCHES
    got, _ = gpt.verify_fused(qp, flat, toks, pos, cfg)
    assert fdl.LAUNCHES == before + 4
    want = torch.stack([gpt.decode_step_fused(qp, copy, toks[:, j], pos + j,
                                              cfg)[0] for j in range(4)], 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for n, a in flat.items():
        assert torch.equal(kv_quant.byte_view(a), kv_quant.byte_view(copy[n]))
