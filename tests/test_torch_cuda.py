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
The float32 forward and fused_ce (three TF32 products a product on the
tensor cores) are also held to their own arithmetic
(``*_tf32x3_plain``, chip_smoke.TF32X3_REL / TF32X3_ATOL), and a
witness shows one TF32 pass missing the float32 limits they keep.
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
from paddle_tpu_torch.models import bert, gpt, llama
from paddle_tpu_torch.nn import functional as nnf

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
    (2, 512, 16, 64, False, True),   # bert_large's attention
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
    """bf16 runs the tensor-core kernels (*_tc_kernel); float32 its
    forward, dK/dV and dQ as three TF32 products on the tensor cores
    (flash_attention_{fwd,bwd_dkv,bwd_dq}_tf32x3_kernel), as the
    profiler's kernel names show."""
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
    for kernel in ("fwd", "bwd_dkv", "bwd_dq"):
        found = [n for n in names[torch.float32] if f"_{kernel}_" in n]
        assert len(found) == 1, (kernel, found)
        assert f"flash_attention_{kernel}_tf32x3_kernel" in found[0]
    assert sum("_tf32x3_" in n for n in names[torch.float32]) == 3


@pytest.mark.parametrize("B,Sq,Sk,nH,hD,causal", [
    (2, 1024, 1024, 16, 128, True),   # the float32 training row
    (2, 1000, 1000, 3, 64, True),     # ragged at length
    (1, 100, 100, 2, 32, True),       # ragged: one partial query tile
    (1, 100, 300, 2, 128, True),      # Sk > Sq: key tiles past every row
    (1, 300, 100, 2, 64, False),
    (1, 64, 1000, 2, 32, False),
])
def test_flash_attention_f32_forward_on_tf32x3(cuda, B, Sq, Sk, nH, hD,
                                               causal):
    """The float32 forward (three TF32 products a product) against the
    true float32 plain version (out 1e-4 of max, lse 1e-4 relative) and
    against its own arithmetic (chip_smoke.tf32x3_forward_share); the
    float32 backward pair (three TF32 products a product too) on this
    forward's lse against the true float32 plain versions (1e-4 of max)
    and against its own arithmetic (chip_smoke.tf32x3_backward_share:
    TF32X3_REL of max); repeat runs give the same bits."""
    rng = np.random.default_rng(Sq + 3 * Sk + hD + causal)
    q, dout = (_rand(rng, (B, Sq, nH, hD), torch.float32, cuda)
               for _ in range(2))
    k, v = (_rand(rng, (B, Sk, nH, hD), torch.float32, cuda)
            for _ in range(2))
    out, lse, delta, grads = _flash_passes(q, k, v, dout, causal)
    out2, lse2 = fa.flash_attention_fwd(q, k, v, causal)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    w_out, w_lse = fa.flash_attention_with_lse_plain(q, k, v, 0,
                                                     causal=causal)
    _assert_kernel(out, w_out, 1e-4, of_max=True)
    _assert_rel(lse, w_lse, 1e-4)
    share = chip_smoke.tf32x3_forward_share(fa, q, k, v, out, lse, causal, 0)
    assert max(share.values()) <= 1, share
    dk, dv, dq = grads[0]
    w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                                  causal)
    w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, causal)
    for got, want in ((dq, w_dq), (dk, w_dk), (dv, w_dv)):
        _assert_kernel(got, want, 1e-4, of_max=True)
    share = chip_smoke.tf32x3_backward_share(fa, q, k, v, dout, lse, delta,
                                             (dk, dv, dq), causal, 0)
    assert max(share.values()) <= 1, share


@pytest.mark.parametrize("offset", [-1024, -64, -37, 0, 37, 64])
def test_flash_attention_f32_offsets_on_tf32x3(cuda, offset):
    """The ring variant in float32 at one chunk of 1024 rows and keys:
    chip_smoke.ring_kernels_check holds forward, dK/dV and dQ (this
    forward's lse, the lse cotangent folded into delta) to their plain
    versions and offset 0 bit for bit to the zero-offset call; all three
    against their emulations too, and a second backward gives the same
    bits."""
    rng = np.random.default_rng(2048 + offset)
    q, k, v, dout = (_rand(rng, (1, 1024, 2, 128), torch.float32, cuda)
                     for _ in range(4))
    g_lse = _rand(rng, (1, 2, 1024), torch.float32, cuda)
    (out, lse, *grads), delta, _, _ = chip_smoke.ring_kernels_check(
        fa, q, k, v, dout, g_lse, offset)
    share = {**chip_smoke.tf32x3_forward_share(fa, q, k, v, out, lse, True,
                                               offset),
             **chip_smoke.tf32x3_backward_share(fa, q, k, v, dout, lse,
                                                delta, grads, True, offset)}
    assert max(share.values()) <= 1, share
    args = (q, k, v, dout, lse, delta, True, None, offset)
    again = (*fa.flash_attention_bwd_dkv(*args),
             fa.flash_attention_bwd_dq(*args))
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


def test_flash_attention_f32_cuda_tensor_never_reaches_plain(cuda,
                                                            monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("a CUDA tensor reached a plain version")
    for name in ("flash_attention_with_lse_plain",
                 "flash_attention_fwd_tf32x3_plain", "einsum_tf32x3",
                 "flash_attention_bwd_dkv_plain",
                 "flash_attention_bwd_dq_plain",
                 "flash_attention_bwd_dkv_tf32x3_plain",
                 "flash_attention_bwd_dq_tf32x3_plain"):
        monkeypatch.setattr(fa, name, refuse)
    x = torch.randn(1, 128, 2, 64, device=cuda, requires_grad=True)
    out = fa.flash_attention(x, x, x)
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(x.grad).all()


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
    monkeypatch.setattr(fce, "fused_ce_fwd_tf32x3_plain", refuse)
    monkeypatch.setattr(fce, "mm_tf32x3", refuse)
    monkeypatch.setattr(fce, "matmul_f32out", refuse)
    for dtype in (torch.bfloat16, torch.float32):
        h = torch.randn(128, 64, device=cuda).to(dtype)
        W = torch.randn(200, 64, device=cuda).to(dtype)
        z, picked = fce.fused_ce_fwd(h, W, torch.zeros(
            128, dtype=torch.int32, device=cuda))
        assert z.is_cuda and torch.isfinite(z).all()


@pytest.mark.parametrize("N,V,H", [(2048, 50304, 2048), (128, 1000, 128),
                                   (256, 129, 256), (384, 50257, 2048)])
def test_fused_ce_f32_kernel_on_tf32x3(cuda, N, V, H):
    """float32 as three TF32 products on wgmma, split over the vocabulary
    (tiles of 128 rows): the eval shape of gpt3_1p3b's default-dtype
    training, ragged V (1000; 129, one row past a tile; 50257), labels out
    of range and on the last row; against the true float32 plain version
    (atol 1e-3), its own arithmetic (chip_smoke.TF32X3_ATOL) and the
    split-and-merge rule at the kernel's plan; two calls bit for bit."""
    rng = np.random.default_rng(N + V + H)
    h = _rand(rng, (N, H), torch.float32, cuda)
    W = _rand(rng, (V, H), torch.float32, cuda) * 0.05
    lbl = torch.tensor(rng.integers(0, V, N), dtype=torch.int32, device=cuda)
    lbl[:6] = torch.tensor([-1, V, V + 5, -7, V - 1, V - 1],
                           dtype=torch.int32)
    before = fce.LAUNCHES
    z, picked = fce.fused_ce_fwd(h, W, lbl)
    z2, picked2 = fce.fused_ce_fwd(h, W, lbl)
    torch.cuda.synchronize()
    assert fce.LAUNCHES == before + 2
    assert torch.equal(z, z2) and torch.equal(picked, picked2)
    wz, wp = fce.fused_ce_fwd_plain(h, W, lbl)
    torch.testing.assert_close(z, wz, rtol=0, atol=1e-3)
    torch.testing.assert_close(picked, wp, rtol=0, atol=1e-3)
    assert (picked[:4] == 0).all() and (picked[4:6] != 0).all()
    ez, ep = fce.fused_ce_fwd_tf32x3_plain(h, W, lbl)
    tol = chip_smoke.TF32X3_ATOL
    torch.testing.assert_close(z, ez, rtol=0, atol=tol)
    torch.testing.assert_close(picked, ep, rtol=0, atol=tol)
    tile = fce.VOCAB_TILES[torch.float32]
    splits, per = fce.ce_plan(N, V, torch.cuda.get_device_properties(
        cuda).multi_processor_count, tile)
    sz, sp = fce.fused_ce_fwd_split_plain(h, W, lbl, per, vocab_tile=tile)
    torch.testing.assert_close(z, sz, rtol=0, atol=1e-3)
    torch.testing.assert_close(picked, sp, rtol=0, atol=1e-3)


def test_single_pass_tf32_witness(cuda):
    """On chip_smoke.tf32_witness's inputs one TF32 pass leaves the
    float32 limits (CE atol 1e-3, forward and each grad of the backward
    1e-4 of max) and the kernels stay within them; the kernels ignore
    torch's TF32 switch (the same bits with allow_tf32 on)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    w = chip_smoke.tf32_witness(fa, fce, gen)
    for name, r in w.items():
        assert r["kernel"] <= 1 < r["one_pass"], (name, r)
    h = torch.randn(256, 256, device=cuda)
    W = torch.randn(1000, 256, device=cuda) * 0.1
    lbl = torch.zeros(256, dtype=torch.int32, device=cuda)
    q = torch.randn(1, 256, 2, 64, device=cuda)
    got = []
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        out, lse = fa.flash_attention_fwd(q, q, q, True)
        delta = (q * out).sum(-1).transpose(1, 2).contiguous()
        got.append((*fce.fused_ce_fwd(h, W, lbl), out, lse,
                    *fa.flash_attention_bwd_dkv(q, q, q, q, lse, delta),
                    fa.flash_attention_bwd_dq(q, q, q, q, lse, delta)))
    torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip(*got):
        assert torch.equal(a, b)


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
    """The norm, the fused residual-add instance and the backward (under
    autograd, both policies) launch kernels for CUDA tensors: no plain
    version is called."""
    def refuse(*_):
        raise AssertionError("a CUDA tensor reached the plain version")
    for name in ("rms_norm_plain", "add_rms_norm_plain",
                 "rms_norm_bwd_plain", "_llama_bwd", "_fused_bwd"):
        monkeypatch.setattr(fnr, name, refuse)
    out, _ = fnr.rms_norm(torch.randn(3, 40, device=cuda),
                          torch.ones(40, device=cuda), 1e-6, "llama")
    assert out.is_cuda and torch.isfinite(out).all()
    for policy in fnr.POLICIES:
        h, d = (torch.randn(3, 40, device=cuda, requires_grad=True)
                for _ in range(2))
        w = torch.ones(40, device=cuda, requires_grad=True)
        s, out = fnr.add_rms_norm(h, d, w, 1e-6, policy)
        (s.sum() + out.square().sum()).backward()
        assert all(torch.isfinite(t.grad).all() for t in (h, d, w))


_RMS_ROWS = [
    (8, 4096),      # llama_7b decode rows
    (2048, 4096),   # prefill rows
    (8, 128),       # llama_tiny
    (7, 11008),     # odd N, FFN width
    (5, 11),        # H under and not a multiple of the vector width
    (3, 1100),      # rows not 16-byte aligned (bf16: 2200 bytes)
]


@pytest.mark.parametrize("policy", ["fused", "llama"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H", _RMS_ROWS)
def test_add_rms_norm_matches_the_kernels_it_fuses(cuda, policy, dtype, N,
                                                   H):
    """The fused residual-add instance (one launch): s bit for bit
    ``h + delta``, out bit for bit the forward kernel on that s, its
    backward with the residual's cotangent bit for bit T(dx + g_s)
    (``chip_smoke.add_rms_check``); out within the forward's limits of
    ``add_rms_norm_plain``."""
    rng = np.random.default_rng(N + H + 2)
    h, delta, g, g_s = (_rand(rng, (N, H), dtype, cuda) for _ in range(4))
    w = (1 + 0.1 * _rand(rng, (H,), torch.float32, cuda)).to(dtype)
    before = dict(fnr.LAUNCHES)
    s, out = fnr.add_rms_norm(h, delta, w, 1e-6, policy)
    torch.cuda.synchronize()
    assert {k: fnr.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == f"add_{policy}") for k in before}
    chip_smoke.add_rms_check(fnr, h, delta, w, g, g_s, policy)
    want_s, want = fnr.add_rms_norm_plain(h, delta, w, 1e-6, policy)
    assert torch.equal(s, want_s)
    chip_smoke._rms_errors(out, want)


@pytest.mark.parametrize("policy", ["fused", "llama"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H", _RMS_ROWS + [(8192, 4096)])
def test_rms_norm_bwd_kernel_matches_plain(cuda, policy, dtype, N, H):
    """The backward kernel (one count for its two launches) against
    ``rms_norm_bwd_plain`` on the card under ``_rms_bwd_errors``' rule
    (dw one bf16 step per element; dx one step of max(|dx|,
    ``_rms_bwd_floor``): 2 |g w rstd| for "llama", 2^-8 of the float32
    terms' scale for "fused"); dw is the same bits on a second call (no
    atomics)."""
    rng = np.random.default_rng(N + H + 3)
    x, g = (_rand(rng, (N, H), dtype, cuda) for _ in range(2))
    w = (1 + 0.1 * _rand(rng, (H,), torch.float32, cuda)).to(dtype)
    _, rstd = fnr.rms_norm(x, w, 1e-6, policy)
    before = dict(fnr.LAUNCHES)
    dx, dw = fnr.rms_norm_bwd(x, w, g, 1e-6, policy, rstd)
    torch.cuda.synchronize()
    assert {k: fnr.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == f"bwd_{policy}") for k in before}
    want = fnr.rms_norm_bwd_plain(x, w, g, 1e-6, policy, rstd)
    chip_smoke._rms_bwd_errors((dx, dw), want,
                               chip_smoke._rms_bwd_floor(x, w, g, policy),
                               f"rms_norm_bwd {policy}")
    again = fnr.rms_norm_bwd(x, w, g, 1e-6, policy, rstd)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.parametrize("layout", ["row_stride", "misaligned",
                                    "g_transposed"])
def test_rms_norm_bwd_kernel_strides(cuda, layout):
    """The backward reads x through a row stride or from a base 2 bytes
    off 16, and a cotangent whose last axis is not contiguous (copied
    first), within the rule against the plain version."""
    rng = np.random.default_rng(13)
    H = 4096
    if layout == "row_stride":
        x = _rand(rng, (6, H + 64), torch.bfloat16, cuda)[:, 64:]
    elif layout == "misaligned":
        x = _rand(rng, (6 * H + 1,), torch.bfloat16, cuda)[1:].view(6, H)
    else:
        x = _rand(rng, (6, H), torch.bfloat16, cuda)
    g = (_rand(rng, (H, 6), torch.bfloat16, cuda).t()
         if layout == "g_transposed" else _rand(rng, (6, H), torch.bfloat16,
                                                cuda))
    w = _rand(rng, (H,), torch.bfloat16, cuda)
    for policy in fnr.POLICIES:
        _, rstd = fnr.rms_norm(x, w, 1e-6, policy)
        got = fnr.rms_norm_bwd(x, w, g, 1e-6, policy, rstd)
        want = fnr.rms_norm_bwd_plain(x, w, g, 1e-6, policy, rstd)
        floor = chip_smoke._rms_bwd_floor(x, w, g, policy)
        chip_smoke._rms_bwd_errors(got, want, floor,
                                   f"rms_norm_bwd {policy} {layout}")


def test_llama_decode_step_fuses_the_residual_adds(cuda):
    """llama_tiny in bfloat16: one ``decode_step_multi`` launches the norm
    alone once (layer 0's attention norm) and the fused residual-add
    instance 2L times — 2L + 1 norms — and no separate residual add
    (``aten::add`` of two [B, H] tensors, by the profiler)."""
    cfg = llama.llama_tiny(dtype=torch.bfloat16, initializer_range=0.3)
    L, B = cfg.num_layers, 4
    params = llama.init_params(cfg, seed=5, device=cuda)
    cache = llama.init_decode_cache(cfg, B, 64, device=cuda)
    tok = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=cuda)
    pos = torch.tensor([3, 5, 7, 9], dtype=torch.int32, device=cuda)

    def step():
        with torch.inference_mode():
            return llama.decode_step_multi(params, cache, tok, pos, cfg,
                                           attn_kernel="flash")

    before = dict(fnr.LAUNCHES)
    step()
    torch.cuda.synchronize()
    assert {k: fnr.LAUNCHES[k] - before[k] for k in before} == {
        k: {"llama": 1, "add_llama": 2 * L}.get(k, 0) for k in before}
    prof = chip_smoke.norm_add_profile(step, B, cfg.hidden_size, n=2)
    assert prof["residual_adds"] == 0
    assert prof["rms_launches"] == 2 * L + 1


@pytest.mark.parametrize("kind,kd,pages", [("contiguous", "bf16", None),
                                           ("paged", "bf16", 64)])
def test_captured_engine_with_llama_draft(cuda, kind, kd, pages):
    """A LLaMA draft (GQA 4/2, H 64, 2 layers, bf16): its k steps run in
    the captured draft program, which replays the norm kernel once a
    step and the fused residual-add instance 2L times; the captured
    engine's streams and every kernel counter equal the eager engine's,
    twice over, and the RMS counts are exactly those of its draft steps
    and draft prefills."""
    from paddle_tpu_torch.inference import programs
    from paddle_tpu_torch.inference.serving import SpeculativeConfig
    models = _graph_models(cuda)
    cfg = models[0]
    lcfg = llama.llama_tiny(vocab_size=cfg.vocab_size, hidden_size=64,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            dtype=torch.bfloat16, initializer_range=0.3)
    spec = SpeculativeConfig(k=3, family="llama", draft_cfg=lcfg,
                             draft_params=_to(llama.init_params(
                                 lcfg, seed=4, device="cpu"), cuda))
    prompts = _graph_prompts(cfg, kind, seed=9)
    idx = [m for m, _ in programs.COUNTERS].index(fnr)
    runs = {}
    for cuda_graphs in (None, False):
        eng = _graph_engine(models, kind, kd, pages, "greedy", cuda,
                            cuda_graphs, speculative=spec)
        runs[cuda_graphs] = [_graph_run(eng, prompts) for _ in range(2)]
        m = eng.metrics()
        rms = {k: sum(n[idx][k] for _, n in runs[cuda_graphs])
               for k in ("llama", "add_llama")}
        steps, prefills = m["draft_steps"], m["launches"]["draft_prefill"]
        want = chip_smoke._rms_launches(lcfg.num_layers, steps, prefills)
        assert steps > 0 and rms == {"llama": want["rms_llama"],
                                     "add_llama": want["rms_add_llama"]}
        if cuda_graphs is None:
            assert any(k.startswith("draft:") for k in m["graphs"])
            assert m["graph_replays"] > 0
    assert runs[None] == runs[False]


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


# ---------------------------------------------------------------------------
# row_gemm: the decode block's products, the same rows at any M
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N,head", [(256, 200, False), (2048, 512, False),
                                      (96, 136, False), (200, 136, True),
                                      (2048, 1024, True)])
def test_row_gemm_rows_bit_identical_across_m(cuda, dtype, K, N, head):
    """Every row of row_gemm is the same bits at each M of
    ``chip_smoke.ROW_GEMM_CHECK_ROWS`` (1 to 257: group and chunk edges),
    in a permuted order and across 256-row launches (520 rows), in both
    weight layouts ([K, N] and wte.t(), float32 output), one split and
    several (K 2048: 8), a ragged last tile (N 136, 200), and within its
    limits of the plain version and the float32 product."""
    from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    x, w = chip_smoke._row_gemm_operands(gen, K, N, dtype, head)
    out = torch.float32 if head else None
    chip_smoke.row_gemm_rows_check(rg, x, w, out)
    for M in (1, 8, 13, 32, 64, 65, 200, 256):
        chip_smoke.row_gemm_check(rg, x[:M], w, out)


@pytest.mark.parametrize("M", [8, 64, 256])
@pytest.mark.parametrize("name,K,N", chip_smoke.ROW_GEMM_SHAPES)
def test_row_gemm_matches_plain_at_the_serving_shapes(cuda, name, K, N, M):
    """gpt3_1p3b's five decode products at M 8, 64 and 256 (bf16; the
    head with float32 output) against the plain version and the float32
    product (``chip_smoke.row_gemm_check``'s limits), one launch a
    call."""
    from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
    gen = torch.Generator(device=cuda).manual_seed(1)
    x, w = chip_smoke._row_gemm_operands(gen, K, N, torch.bfloat16,
                                         name == "head", rows=M)
    before = rg.LAUNCHES
    chip_smoke.row_gemm_check(rg, x, w,
                              torch.float32 if name == "head" else None)
    assert rg.LAUNCHES == before + 1


def test_row_gemm_rejects(cuda):
    from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
    x = torch.zeros(4, 36, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        rg.row_gemm(x, torch.zeros(36, 16, device=cuda))
    with pytest.raises(ValueError, match="neither"):
        rg.row_gemm(torch.zeros(4, 32, device=cuda),
                    torch.zeros(32, 32, device=cuda)[:, ::2])
    # rows 36 elements apart: no 16-byte tensor-map rows
    with pytest.raises(ValueError, match="aligned"):
        rg.row_gemm(torch.zeros(4, 32, device=cuda, dtype=torch.bfloat16),
                    torch.zeros(32, 36, device=cuda,
                                dtype=torch.bfloat16)[:, :32])
    with pytest.raises(TypeError):
        rg.row_gemm(x.half(), torch.zeros(36, 16, device=cuda).half())


def test_row_gemm_cuda_tensor_never_reaches_plain(cuda, monkeypatch):
    """A CUDA tensor launches the kernel: neither the plain version nor a
    library product runs, in either dtype or layout."""
    from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg

    def fail(*a, **k):
        pytest.fail("a CUDA tensor reached a plain or library product")

    monkeypatch.setattr(rg, "row_gemm_plain", fail)
    monkeypatch.setattr(rg, "matmul_f32out", fail)
    monkeypatch.setattr(torch, "matmul", fail)
    monkeypatch.setattr(torch, "mm", fail)
    monkeypatch.setattr(torch.Tensor, "__matmul__", fail)
    before = rg.LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        out = rg.row_gemm(torch.ones(3, 64, device=cuda, dtype=dtype),
                          torch.ones(64, 16, device=cuda, dtype=dtype))
        head = rg.row_gemm(torch.ones(3, 64, device=cuda, dtype=dtype),
                           torch.ones(16, 64, device=cuda, dtype=dtype).t(),
                           out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(out.float(),
                           torch.full((3, 16), 64.0, device=cuda))
        assert torch.equal(head, torch.full((3, 16), 64.0, device=cuda))
    assert rg.LAUNCHES == before + 4


def test_row_gemm_tensor_map_cache_follows_the_shape(cuda):
    """Two weights at one address with other shapes get maps of their
    own: the cache is keyed by address, shape and stride, so the second
    product is right and the cache holds one map more."""
    from paddle_tpu_torch.incubate.nn.kernels import _build
    from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
    gen = torch.Generator(device=cuda).manual_seed(5)
    buf = torch.randn(512 * 384, generator=gen, device=cuda).to(
        torch.bfloat16)
    x = torch.randn(8, 512, generator=gen, device=cuda).to(torch.bfloat16)
    cached = _build.load("row_gemm").pt_row_gemm_cached_maps
    w1 = buf[:256 * 384].view(256, 384)
    chip_smoke.row_gemm_check(rg, x[:, :256].contiguous(), w1)
    n1 = cached()
    w2 = buf.view(512, 384)
    assert w2.data_ptr() == w1.data_ptr()
    chip_smoke.row_gemm_check(rg, x, w2)
    assert cached() == n1 + 2      # w2's map and the new x's


def test_flash_decode_launch_raises_for_a_head_dim_without_instance(cuda):
    """hD 8 runs on the CPU (the plain version, as the JAX kernel takes
    it); the card's launch has no instance for it and raises."""
    q = torch.zeros(2, 1, 2, 8, device=cuda)
    k = torch.zeros(2, 16, 2, 8, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim 8"):
        fd.flash_decode_attention(q, k, k, pos)
    fd.flash_decode_attention(q.cpu(), k.cpu(), k.cpu(), pos.cpu())


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("paged", [False, True])
def test_verify_rows_equal_decode_steps_bit_for_bit(cuda, paged, k):
    """A verify window's row j equals, logits and written K/V included,
    the decode step fed the same token at pos + j after steps 0..j-1:
    the attention rows (flash_decode's split plan ignores W) and every
    product (row_gemm) are the same bits whatever the rows a call
    carries (gpt_tiny in bf16, 8 slots, ragged positions)."""
    cfg = gpt.gpt_tiny(dtype=torch.bfloat16, use_flash=False)
    params = _to(gpt.init_params(cfg, seed=3, device="cpu"), cuda)
    rng = np.random.default_rng(k)
    B, T, bs = 8, 256, 16
    pos = torch.tensor(rng.integers(20, 200, B), dtype=torch.int32,
                       device=cuda)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, k + 1)),
                        dtype=torch.int32, device=cuda)
    if paged:
        pages = torch.randperm(B * T // bs, generator=torch.Generator()
                               .manual_seed(k)).view(B, T // bs)
        tables = pages.to(torch.int32).to(cuda)
        cache = gpt.init_decode_cache(cfg, B * T // bs, bs, device=cuda)
    else:
        tables = None
        cache = gpt.init_decode_cache(cfg, B, T, device=cuda)
    for name, a in cache.items():
        a.copy_(torch.randn(a.shape, generator=torch.Generator()
                            .manual_seed(len(name))).to(a.dtype))
    copy = {n: a.clone() for n, a in cache.items()}
    if paged:
        got, _ = gpt.verify_paged(params, cache, tables, toks, pos, cfg,
                                  attn_kernel="flash")
    else:
        got, _ = gpt.verify_into_slots(params, cache, toks, pos, cfg,
                                       attn_kernel="flash")
    for j in range(k + 1):
        if paged:
            want, _ = gpt.decode_step_paged(params, copy, tables, toks[:, j],
                                            pos + j, cfg, attn_kernel="flash")
        else:
            want, _ = gpt.decode_step_multi(params, copy, toks[:, j],
                                            pos + j, cfg, attn_kernel="flash")
        torch.cuda.synchronize()
        assert torch.equal(got[:, j], want), j
    for n in cache:
        assert torch.equal(cache[n], copy[n])


@pytest.mark.parametrize("paged", [False, True])
def test_prefix_hits_on_card_match_cold_and_cpu(cuda, paged):
    """A shared-prefix load on the card's flash engine with the prefix
    cache (hits, a partial hit and a full hit) gives the cold card
    engine's streams and the CPU engine's (gpt_tiny f32)."""
    from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, PagedContinuousBatchingEngine)
    E = PagedContinuousBatchingEngine if paged else ContinuousBatchingEngine
    kw = dict(block_size=8, num_blocks=64) if paged else {}
    cfg = gpt.gpt_tiny(use_flash=False)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 1024, 40)
    prompts = [np.concatenate([shared, rng.integers(0, 1024, n)])
               for n in (7, 19, 0, 3)]
    streams, hits = [], None
    for device, budget in (("cpu", 0), (cuda, 0), (cuda, 1 << 30)):
        params = _to(gpt.init_params(cfg, seed=2, device="cpu"), device)
        eng = E(params, cfg, max_batch=2, max_len=128, device=device,
                attn_kernel="xla" if device == "cpu" else "flash",
                prefix_cache_bytes=budget, **kw)
        before = rg.LAUNCHES
        rids = [eng.submit(p, max_new=12) for p in prompts]
        out = eng.run(steps_per_sync=4)
        streams.append([out[r] for r in rids])
        if budget:
            hits = [eng.request(r).prefix_hit for r in rids]
            assert eng.metrics()["launches"]["prefix"] >= 1
            assert rg.LAUNCHES > before
    assert streams[1] == streams[0] and streams[2] == streams[0]
    assert sum(h > 0 for h in hits) >= 2


# ---------------------------------------------------------------------------
# the sampler: temperature, top-k, top-p and the keyed Gumbel-max draw of
# JAX's threefry stream in one launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", [s[0] for s in chip_smoke.SAMPLINGS])
@pytest.mark.parametrize("rule", ["pos", "key"])
@pytest.mark.parametrize("V", [50304, 32000])
@pytest.mark.parametrize("R", [1, 8, 32, 64])
def test_sampling_kernel_matches_plain(cuda, R, V, rule, label):
    """The kernel against its plain version on raw logits, both keyings
    (the engines' rule with 4 window rows a slot at R 32): the exact
    rule's kept values, the plain draw's token, or a reported near-tie
    (``chip_smoke.sampling_check``)."""
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    from paddle_tpu_torch.models import prng
    kw = dict(chip_smoke.SAMPLINGS)[label]
    if rule == "pos" and R == 32:
        rule = "window"
    gen = torch.Generator(device=cuda).manual_seed(R + V)
    for rep in range(2):
        logits = torch.randn(R, V, generator=gen, device=cuda) * 3
        args = chip_smoke._sample_args(prng, rule, R, gen, rep)
        chip_smoke.sampling_check(sm, logits, args, kw)


def test_sampling_kernel_edge_rows(cuda):
    """The draw alone: one finite logit among -inf, a whole -inf row,
    +inf and NaN ties, an exact tie of two finite perturbed scores (the
    first index); the filter's edge rows (NaN, +inf, -0 / +0 and ties
    at the k-th value, all -inf, all equal) exactly as the plain
    version (``chip_smoke.sampling_edge_check``)."""
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    from paddle_tpu_torch.models import prng
    chip_smoke.sampling_edge_check(sm, prng)


def test_sampling_rows_do_not_move_with_r(cuda):
    """Each row drawn alone gives its token among R 8 / 32 / 64
    (``chip_smoke.sampling_rows_alone_check``)."""
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    chip_smoke.sampling_rows_alone_check(sm)


def test_sampling_concurrent_streams_give_the_draws_alone(cuda):
    """Draws on two streams of one device, released together by one
    event so that they run at once, give the tokens the same draws give
    alone: a launch holds nothing outside its own blocks."""
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    from paddle_tpu_torch.models import prng
    gen = torch.Generator(device=cuda).manual_seed(13)
    draws = []
    for _ in range(2):
        logits = torch.randn(256, 50304, generator=gen, device=cuda) * 3
        draws.append((logits, chip_smoke._sample_args(prng, "window", 256,
                                                      gen, 0)))
    kw = chip_smoke.SAMPLE_SERVE
    want = [sm.sample_rows(logits, **kw, **args) for logits, args in draws]
    for logits, args in draws:
        chip_smoke.sampling_check(sm, logits, args, kw)
    streams = [torch.cuda.Stream(device=cuda) for _ in draws]
    go = torch.cuda.Event()
    torch.cuda._sleep(4_000_000)
    go.record()
    for s in streams:
        s.wait_event(go)
    got = [[], []]
    for _ in range(8):
        for i, s in enumerate(streams):
            logits, args = draws[i]
            with torch.cuda.stream(s):
                got[i].append(sm.sample_rows(logits, **kw, **args))
    torch.cuda.synchronize()
    for i, outs in enumerate(got):
        for out in outs:
            assert torch.equal(out, want[i]), i


def test_sampling_generate_rule_counts_over_the_whole_draw(cuda):
    """A key draws [B, V] with counters b V + j (``jax.random.
    categorical(key, logits)``): the kernel gives the plain version's
    tokens, and not the tokens of each row drawn alone from counter 0."""
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    from paddle_tpu_torch.models import prng
    gen = torch.Generator(device=cuda).manual_seed(11)
    logits = torch.randn(16, 50304, generator=gen, device=cuda)
    key = prng.split(prng.PRNGKey(3, cuda))[1]
    got = sm.gumbel_argmax(logits, key=key)
    want = sm.gumbel_argmax_plain(logits, key=key)
    alone = torch.stack([sm.gumbel_argmax_plain(logits[b:b + 1], key=key)[0]
                         for b in range(16)])
    assert torch.equal(got, want)
    assert not torch.equal(got[1:], alone[1:])
    assert int(got[0]) == int(alone[0])


def _fail_plain(monkeypatch):
    """Make every plain piece of the sampler fail if it runs."""
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    from paddle_tpu_torch.models import decoding

    def fail(*a, **k):
        pytest.fail("a CUDA tensor reached the plain sampler")

    for name in ("gumbel_argmax_plain", "perturbed_scores",
                 "filter_logits_plain", "sample_rows_plain"):
        monkeypatch.setattr(sm, name, fail)
    monkeypatch.setattr(decoding, "_filter_logits", fail)


def test_sampling_cuda_tensor_never_reaches_plain(cuda, monkeypatch):
    """A CUDA tensor launches the kernel, one count a draw, in the three
    decoding functions and in a sampled engine with and without
    speculation; the plain filter and draw never run."""
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models import decoding, prng
    cfg, params, _, _ = _spec_models(cuda)
    _fail_plain(monkeypatch)
    logits = torch.zeros(8, 4, 1000, device=cuda)
    logits[..., 17] = 50.0
    seeds = torch.arange(8, dtype=torch.int32, device=cuda)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)
    before = sm.LAUNCHES
    a = decoding.sample_token_pos(logits[:, 0], seeds, pos, 1.0)
    b = decoding.sample_window(logits, seeds, pos, 0.9, 5, 0.5)
    c = decoding.sample_token(logits[:, 1], prng.PRNGKey(2, cuda), 0.8, 20,
                              0.95)
    torch.cuda.synchronize()
    for got in (a, b, c):
        assert (got == 17).all() and got.dtype == torch.int32
    assert sm.LAUNCHES == before + 3
    with pytest.raises(ValueError, match="int32"):
        sm.sample_rows(logits[:, 0], 1.0, seeds=seeds.long(), pos=pos)
    with pytest.raises(TypeError, match="float32"):
        sm.sample_rows(logits[:, 0].half(), 1.0, seeds=seeds, pos=pos)
    rng = np.random.default_rng(4)
    for spec in (None, True):
        eng = ContinuousBatchingEngine(params, cfg, max_batch=2, max_len=64,
                                       device=cuda, speculative=spec,
                                       **chip_smoke.SAMPLE_SERVE)
        before = sm.LAUNCHES
        rids = [eng.submit(rng.integers(0, 1024, (n,)), max_new=6, seed=n)
                for n in (5, 12)]
        out = eng.run()
        m = eng.metrics()
        assert all(len(out[r]) == 6 for r in rids)
        assert sm.LAUNCHES - before == m["decode_steps"] + m[
            "launches"].get("verify", 0)


def test_sampling_raises_no_sync_and_replays_in_a_graph(cuda):
    """A sampled draw raises nothing under ``set_sync_debug_mode("error")``
    (no host sync: the launch allocates only its output), and one draw
    captured in a CUDA graph, replayed on new logits and positions,
    equals the eager draw."""
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    from paddle_tpu_torch.models import decoding, prng
    gen = torch.Generator(device=cuda).manual_seed(29)
    R, V = 8, 50304
    logits = torch.randn(R, V, generator=gen, device=cuda) * 3
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (R,), generator=gen,
                          device=cuda, dtype=torch.int32)
    pos = torch.randint(0, 1024, (R,), generator=gen, device=cuda,
                        dtype=torch.int32)
    key = prng.PRNGKey(5, cuda)
    kw = chip_smoke.SAMPLE_SERVE
    decoding.sample_token_pos(logits, seeds, pos, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decoding.sample_token_pos(logits, seeds, pos, **kw)
        decoding.sample_window(logits.view(2, 4, V), seeds[:2], pos[:2],
                               **kw)
        decoding.sample_token(logits, key, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    static_l, static_p = logits.clone(), pos.clone()
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sm.sample_rows(static_l, **kw, seeds=seeds, pos=static_p)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = sm.LAUNCHES
    with torch.cuda.graph(graph):
        static_out = sm.sample_rows(static_l, **kw, seeds=seeds, pos=static_p)
    for _ in range(3):
        static_l.copy_(torch.randn(R, V, generator=gen, device=cuda) * 3)
        static_p.copy_(torch.randint(0, 1024, (R,), generator=gen,
                                     device=cuda, dtype=torch.int32))
        graph.replay()
        eager = sm.sample_rows(static_l, **kw, seeds=seeds, pos=static_p)
        assert torch.equal(static_out, eager)
    assert sm.LAUNCHES == before + 4


def test_sampled_engine_on_card_is_partition_invariant(cuda):
    """The sampled contiguous engine on the card gives the same streams
    at steps_per_sync 1 and 8, the sampler launched once a decode
    step."""
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    cfg, params, _, _ = _spec_models(cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 1024, (n,)) for n in (4, 33, 17, 9)]
    streams = []
    for steps in (1, 8):
        eng = ContinuousBatchingEngine(params, cfg, max_batch=2, max_len=64,
                                       device=cuda, **chip_smoke.SAMPLE_SERVE)
        before = sm.LAUNCHES
        rids = [eng.submit(p, max_new=12, seed=i + 1)
                for i, p in enumerate(prompts)]
        out = eng.run(steps_per_sync=steps)
        streams.append([out[r] for r in rids])
        assert sm.LAUNCHES - before == eng.metrics()["decode_steps"]
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# compiled decode programs: CUDA graphs against the same rounds run eagerly
# ---------------------------------------------------------------------------

# (prompt length, max_new) of the graph A/B: three prefill buckets,
# slots that refill, and enough decode growth to outgrow a small pool
_GRAPH_REQS = ((20, 40), (40, 40), (17, 40), (50, 40), (3, 40), (60, 30))
# engine, kv_dtype, paged pool (block size 8): 64 pages hold every
# admission, 26 pages defer and evict
_GRAPH_ENGINES = (("contiguous", "bf16", None), ("paged", "bf16", 64),
                  ("paged", "int8", 64), ("paged", "fp8", 64),
                  ("paged", "bf16", 26), ("fused", "int8", None))
_GRAPH_MODES = ("greedy", "sampled", "ngram", "self")


def _graph_models(device):
    """gpt_tiny in bfloat16 (hD 32) at initializer_range 0.3, so greedy
    streams move, and its int8 serving weights."""
    cfg = gpt.gpt_tiny(dtype=torch.bfloat16, initializer_range=0.3,
                       use_flash=False)
    params = _to(gpt.init_params(cfg, seed=3, device="cpu"), device)
    return cfg, params, gpt.quantize_decode_params(params, cfg)


def _graph_engine(models, kind, kd, pages, mode, device, cuda_graphs,
                  **kw):
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, FusedB1Engine,
        PagedContinuousBatchingEngine, SpeculativeConfig)
    cfg, params, qparams = models
    p = qparams if kind == "fused" else params
    if mode == "self":
        kw["speculative"] = SpeculativeConfig(k=3, draft_params=p,
                                              draft_cfg=cfg)
    elif mode == "ngram":
        kw["speculative"] = SpeculativeConfig(k=3)
    elif mode == "sampled":
        kw.update(chip_smoke.SAMPLE_SERVE)
    kw.update(kv_dtype=kd, device=device, cuda_graphs=cuda_graphs)
    if kind == "fused":
        return FusedB1Engine(p, cfg, max_len=256, **kw)
    if kind == "paged":
        return PagedContinuousBatchingEngine(
            p, cfg, max_batch=4, max_len=256, block_size=8,
            num_blocks=pages, **kw)
    return ContinuousBatchingEngine(p, cfg, max_batch=4, max_len=256, **kw)


def _graph_run(eng, prompts, steps=8):
    """Serve ``prompts`` ((ids, max_new) pairs, seeds 1..n); returns the
    streams and every kernel counter's change over the run."""
    from paddle_tpu_torch.inference import programs
    before = programs.snapshot()
    rids = [eng.submit(p, max_new=m, seed=i + 1)
            for i, (p, m) in enumerate(prompts)]
    out = eng.run(steps_per_sync=steps)
    torch.cuda.synchronize()
    return ([list(map(int, out[r])) for r in rids],
            programs.difference(programs.snapshot(), before))


def _graph_prompts(cfg, kind, seed=6):
    rng = np.random.default_rng(seed)
    reqs = _GRAPH_REQS[:3] if kind == "fused" else _GRAPH_REQS
    return [(rng.integers(0, cfg.vocab_size, (n,)), m) for n, m in reqs]


@pytest.mark.parametrize("mode", _GRAPH_MODES)
@pytest.mark.parametrize("kind,kd,pages", _GRAPH_ENGINES)
def test_captured_engine_equals_eager(cuda, kind, kd, pages, mode):
    """A default (captured) engine and a ``cuda_graphs=False`` engine
    give bit-identical streams and equal launch counts of every kernel,
    twice over (the second run replays the first run's graphs); every
    decode round, verify pass and draft proposal past a program's first
    runs is one replay."""
    models = _graph_models(cuda)
    prompts = _graph_prompts(models[0], kind)
    graph = _graph_engine(models, kind, kd, pages, mode, cuda, None)
    eager = _graph_engine(models, kind, kd, pages, mode, cuda, False)
    for _ in range(2):
        got, got_n = _graph_run(graph, prompts)
        want, want_n = _graph_run(eager, prompts)
        assert got == want
        assert got_n == want_n
    m, e = graph.metrics(), eager.metrics()
    assert m["launches"] == e["launches"]
    assert m["graph_replays"] > 0 and e["graph_replays"] == 0
    assert all(g["captured"] == (g["runs"] > 1)
               for g in m["graphs"].values())
    runs = sum(g["runs"] for g in m["graphs"].values())
    assert m["graph_replays"] == runs - len(m["graphs"])
    assert m["graph_pool_bytes"] > 0 and m["capture_seconds"] > 0
    if mode in ("ngram", "self"):
        assert any(k.startswith("verify:") for k in m["graphs"])
    if mode == "self":
        assert any(k.startswith("draft:") for k in m["graphs"])
    if pages == 26:
        assert m["evictions"] >= 1 and m["deferred_admissions"] >= 1
        assert m["evictions"] == e["evictions"]
    if kind == "paged":
        assert m["free_blocks"] == m["num_blocks"]


@pytest.mark.parametrize("mode", ["greedy", "self"])
@pytest.mark.parametrize("kind,kd,pages", [("contiguous", "bf16", None),
                                           ("paged", "int8", 64),
                                           ("fused", "int8", None)])
def test_captured_engine_after_reset_cache(cuda, kind, kd, pages, mode):
    """``_reset_cache`` replaces the storage the graphs bind: it drops
    them, and the next run captures anew and still equals eager."""
    models = _graph_models(cuda)
    prompts = _graph_prompts(models[0], kind, seed=7)
    graph = _graph_engine(models, kind, kd, pages, mode, cuda, None)
    eager = _graph_engine(models, kind, kd, pages, mode, cuda, False)
    first = _graph_run(graph, prompts)
    assert first == _graph_run(eager, prompts)
    for eng in (graph, eager):
        eng._reset_cache()
    assert graph.metrics()["graphs"] == {}
    got, want = _graph_run(graph, prompts), _graph_run(eager, prompts)
    assert got == want and got[0] == first[0]
    assert any(g["captured"] for g in graph.metrics()["graphs"].values())


@pytest.mark.parametrize("kind,kd,pages", [("contiguous", "bf16", None),
                                           ("paged", "bf16", 64),
                                           ("fused", "int8", None)])
def test_captured_engine_after_prefix_install(cuda, kind, kd, pages):
    """With the prefix cache on (unbounded), a primer then requests that
    share its prefix: installs and suffix fills write the cache in place
    outside the graphs, and the captured streams equal eager."""
    models = _graph_models(cuda)
    cfg = models[0]
    rng = np.random.default_rng(8)
    shared = rng.integers(0, cfg.vocab_size, (48,))
    prompts = [(np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                     (n,))]), 8)
               for n in ((5, 17, 30) if kind != "fused" else (5, 17))]
    runs = []
    for cuda_graphs in (None, False):
        eng = _graph_engine(models, kind, kd, pages, "greedy", cuda,
                            cuda_graphs, prefix_cache_bytes=None)
        _graph_run(eng, [(shared, 4)])
        runs.append(_graph_run(eng, prompts))
        assert eng.metrics()["prefix_hit_tokens"] > 0
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# serving robustness and lifecycle on the card: chip_smoke's serving_faults
# checks on gpt3_1p3b's captured engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def robust():
    """gpt3_1p3b bf16 (seed 0) and its int8 serving weights, the captured
    engines of ``chip_smoke.FAULT_CASES`` warmed by two runs of the serving
    cell's requests (``chip_smoke.fault_engines``), their fault-free
    streams, and a lazily filled map of each engine's fault-free launch
    deltas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, FusedB1Engine,
        PagedContinuousBatchingEngine, SpeculativeConfig)
    engines = (ContinuousBatchingEngine, PagedContinuousBatchingEngine,
               FusedB1Engine)
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    qparams = gpt.quantize_decode_params(params, cfg)
    keep = chip_smoke.fault_engines(engines, cfg, params, qparams)
    state = {"cfg": cfg, "params": params, "engines": engines,
             "spec": SpeculativeConfig, "keep": keep, "base": {}}
    yield state
    keep.clear()
    torch.cuda.empty_cache()


def _robust_case(robust, label):
    """(engine, requests, fault-free streams, fault-free launch deltas)."""
    eng, reqs, want = robust["keep"][label]
    if label not in robust["base"]:
        robust["base"][label] = chip_smoke.fault_free_run(eng, reqs, want,
                                                          label)[0]
    return eng, reqs, want, robust["base"][label]


@pytest.mark.parametrize("label,kind", [
    ("contiguous bf16", "prefill"), ("contiguous bf16", "decode"),
    ("paged bf16", "prefill"), ("paged bf16", "decode"),
    ("sampled contiguous bf16", "decode"),
    ("ngram contiguous bf16", "prefill"), ("ngram contiguous bf16", "verify"),
    ("fused int8", "prefill"), ("fused int8", "decode")])
def test_robust_fail_times_keeps_streams(robust, label, kind):
    """``fail_times=2`` on one call kind: streams bit for bit, retries as
    injected, the fault-free prefill counts."""
    eng, reqs, want, base = _robust_case(robust, label)
    chip_smoke.fault_schedule_check(eng, reqs, want, base, label,
                                    fail_times=2, kinds=(kind,))


@pytest.mark.parametrize("label,kind", [
    ("contiguous bf16", "decode"), ("paged bf16", "decode"),
    ("ngram contiguous bf16", "verify"), ("fused int8", "decode")])
def test_robust_fail_after_runs_again_in_place(robust, label, kind):
    """``fail_after_times=1``: the call ran, its result is dropped and the
    retry runs it again on unchanged host state — streams bit for bit and
    no extra prefill (JAX, whose caches are donated, re-prefills)."""
    eng, reqs, want, base = _robust_case(robust, label)
    chip_smoke.fault_schedule_check(eng, reqs, want, base, label,
                                    fail_after_times=1, kinds=(kind,))


@pytest.mark.parametrize("label", ["contiguous bf16", "paged bf16",
                                   "fused int8"])
def test_robust_cancel_and_ttl(robust, label):
    """Cancel after the first round and a TTL that expires mid-decode:
    the next occupants' streams exact, the page pool whole."""
    eng, reqs, want, _ = _robust_case(robust, label)
    chip_smoke.cancel_ttl_check(eng, reqs, want, label)


def test_robust_breaker_opens_and_resets(robust):
    eng, reqs, want, _ = _robust_case(robust, "contiguous bf16")
    chip_smoke.breaker_check(eng, reqs, want, "contiguous bf16")


def test_robust_prefill_stall_trips_the_next_decode(robust):
    eng, reqs, want, _ = _robust_case(robust, "paged bf16")
    chip_smoke.prefill_stall_check(eng, reqs, want, "paged bf16")


def test_robust_draft_and_prefix_faults(robust):
    """The 2-layer model draft with the prefix cache: ``fail_times=2`` on
    the draft calls and on the prefix installs, streams bit for bit."""
    label = "draft prefix"
    eng = chip_smoke._draft_prefix_engine(
        gpt, robust["engines"][0], robust["spec"], robust["cfg"],
        robust["params"])
    reqs = robust["keep"]["contiguous bf16"][1]
    _, first = chip_smoke._serve_reqs(eng, reqs)
    base, _ = chip_smoke.fault_free_run(eng, reqs, first, label)
    assert eng.metrics()["prefix_hit_tokens"] > 0
    for kind in ("draft", "prefix"):
        chip_smoke.fault_schedule_check(eng, reqs, first, base, label,
                                        fail_times=2, kinds=(kind,))


def test_robust_device_stall_trips_step_timeout_and_drain_returns(robust):
    """A fresh contiguous engine, warmed (kernels built, programs
    captured), then every decode call stalled 2 s on the device against
    ``step_timeout=0.5``: the breaker opens and ``drain(60)`` returns
    every request FAILED."""
    Engine = robust["engines"][0]
    eng = Engine(robust["params"], robust["cfg"], max_batch=8, max_len=1024,
                 attn_kernel="flash", device="cuda")
    reqs = robust["keep"]["contiguous bf16"][1]
    for _ in range(2):
        chip_smoke._serve_reqs(eng, reqs)
    chip_smoke.decode_stall_check(eng, reqs, "fresh contiguous bf16")


def test_robust_funnel_host_cost(robust):
    """The funnel adds host microseconds, not milliseconds, a call."""
    eng = robust["keep"]["contiguous bf16"][0]
    cost = chip_smoke.funnel_host_us(eng, n=2000)
    assert 0 < cost["funnel_watchdog_us"] < 1000, cost


# ---------------------------------------------------------------------------
# the prefix cache's host tier and the live handoff on the card: the gates
# of chip_smoke's tiered_serving and handoff_serving at a small size
# ---------------------------------------------------------------------------

TIER_SIZE = dict(max_len=256, max_batch=4, block=16, pages=48, prefix=64,
                 tails=(8, 64), fused_requests=3)


@pytest.fixture(scope="module")
def tier():
    """gpt_tiny bf16 at initializer_range 0.3 (seed 0), its int8 serving
    weights, the three engines, the kernels' counters and a shared-prefix
    load: a 64-token prefix, a primer and 6 requests with tails of 8-64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.incubate.nn.kernels import fused_decode as fdl
    from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, FusedB1Engine, PagedContinuousBatchingEngine)
    cfg = gpt.gpt_tiny(dtype=torch.bfloat16, initializer_range=0.3,
                       max_position_embeddings=1024)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    load = chip_smoke._shared_prefix_load(
        np.random.default_rng(7), cfg.vocab_size, 7, TIER_SIZE["prefix"],
        TIER_SIZE["tails"])
    return {"cfg": cfg, "params": params,
            "qparams": gpt.quantize_decode_params(params, cfg),
            "engines": (ContinuousBatchingEngine,
                        PagedContinuousBatchingEngine, FusedB1Engine),
            "counters": (fd, rg, fdl), "primer": load[0], "prompts": load[1:]}


def _tier_args(tier, kind):
    fused = kind == "fused"
    use = tier["prompts"][:TIER_SIZE["fused_requests"]] if fused \
        else tier["prompts"]
    return (tier["qparams"] if fused else tier["params"]), use


@pytest.mark.parametrize("kind,kd", chip_smoke.TIER_CELLS)
def test_tiered_host_warm_equals_device_warm(tier, kind, kd):
    """Cold, device-warm and host-warm runs of the load: host-warm
    streams equal device-warm bit for bit (cold's under the near-tie
    rule), every request a host hit, exact launches, the same captured
    programs, the pool whole; on contiguous and paged bf16 the slow
    copy, the failed reinstall, the install timeout and the cancel
    mid-install keep the streams and free the slot."""
    tree, use = _tier_args(tier, kind)
    row, eng, bound = chip_smoke.tiered_cell(
        gpt, tier["engines"], tier["counters"], tier["cfg"], tree, kind, kd,
        tier["primer"], use, TIER_SIZE)
    assert row["host_equals_device"] == f"{len(use)}/{len(use)}"
    if (kind, kd) in chip_smoke.TIER_FAULT_CELLS:
        faults = chip_smoke.tier_fault_checks(
            gpt, eng, tree, tier["cfg"], kd, tier["primer"], use, row, bound,
            f"card {kind} {kd}", TIER_SIZE)
        assert faults["reinstall_failures"] == 2
    chip_smoke._pool_cleared(eng, f"card {kind} {kd}")


def test_tiered_copies_and_decode_with_a_copy_in_flight(tier):
    """A span's demotion, its reinstall copies on the side stream and a
    pinned copy_ of the same bytes all move it; decode rounds go on with
    a reinstall's copies in flight."""
    eng = chip_smoke._tier_engine(tier["engines"], "contiguous",
                                  tier["params"], tier["cfg"], "bf16", 1,
                                  chip_smoke.TIER_HOST_BYTES, TIER_SIZE)
    eng.submit(tier["prompts"][0], max_new=4)
    eng.run()
    copies, host = chip_smoke.tier_copy_rates(eng, TIER_SIZE)
    assert copies["bytes"] > 0 and host.tier == "host"
    assert all(copies[k] > 0 for k in ("demote_ms", "reinstall_h2d_ms",
                                       "pinned_copy_ms"))
    overlap = chip_smoke.tier_overlap_tok_s(tier["engines"], tier["cfg"],
                                            tier["params"], host, TIER_SIZE)
    assert all(v > 0 for v in overlap["tok_s_median"].values())


@pytest.mark.parametrize("old_kind,kd,new_kinds", [
    ("contiguous", "bf16", ("contiguous", "paged")),
    ("fused", "int8", ("fused",))])
def test_handoff_restore_keeps_the_streams(tier, tmp_path, old_kind, kd,
                                           new_kinds):
    """A donor snapshotted after 8 rounds, restored into each successor:
    the uninterrupted streams (or near-ties, counted), fewer prefills
    than a cold restart, nothing left over."""
    tree, use = _tier_args(tier, old_kind)
    _, bound = chip_smoke._prefix_kv_delta(
        gpt, tree, tier["cfg"], kd, tier["primer"], use[0],
        old_kind == "fused", TIER_SIZE["prefix"])
    row, _ = chip_smoke.handoff_cell(
        gpt, tier["engines"], tier["counters"], tier["cfg"], tree, kd,
        old_kind, new_kinds, tier["primer"], use, bound, str(tmp_path),
        TIER_SIZE)
    for n in new_kinds:
        assert row["successors"][n]["spans_installed"] > 0
        assert row["successors"][n]["prefills"] < \
            row["successors"]["cold"]["prefills"]


# ---------------------------------------------------------------------------
# The rest of the one-device train step: remat plans, the prefetcher,
# the training checkpoint
# ---------------------------------------------------------------------------

REMAT_WANT = {False: 1, True: 2, "dots_saveable": 2, "dots_saveable_attn": 1,
              "partial:2": 1}


@pytest.mark.parametrize("plan", list(REMAT_WANT))
def test_remat_plan_flash_launches_on_card(cuda, plan):
    """Selective checkpointing saves the flash op's outputs under
    dots_saveable_attn and partial:K: L forward launches a step, 2L under
    True and dots_saveable; the backward kernels L each under every
    plan; the gradients equal remat=False's within 1e-2 of each leaf's
    largest value (bfloat16; the embedding gradient's index-accumulate
    is not deterministic on CUDA)."""
    cfg = gpt.gpt_tiny(dtype=torch.bfloat16)
    params = gpt.init_params(cfg, seed=5, device=cuda)
    rng = np.random.default_rng(5)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 128)),
                       device=cuda)
    leaves = [t.requires_grad_(True) for t in hybrid._leaves(params)]

    def grads(remat):
        loss = gpt.loss_fn(params, ids, ids.roll(-1, 1), cfg, remat=remat)
        return torch.autograd.grad(loss, leaves)

    ref = grads(False)
    fa.reset_launches()
    got = grads(plan)
    L = cfg.num_layers
    assert fa.launches() == {
        "flash_attention_fwd": REMAT_WANT[plan] * L,
        "flash_attention_bwd_dkv": L, "flash_attention_bwd_dq": L}, plan
    for a, b in zip(got, ref):
        _assert_rel(a, b, 1e-2)


def test_flash_op_under_dots_saveable_attn_matches_plain(cuda):
    """The flash custom op's CUDA kernel under dots_saveable_attn against
    its plain version (the CPU run of the same loss and gradients):
    float32 gpt_tiny, loss at rel 1e-4, each gradient within 1e-4 of
    its largest value."""
    cfg = gpt.gpt_tiny(use_flash=True)
    params = gpt.init_params(cfg, seed=6, device="cpu")
    rng = np.random.default_rng(6)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 128)))
    out = {}
    for dev in ("cpu", cuda):
        p = chip_smoke._to_device(params, dev)
        leaves = [t.requires_grad_(True) for t in hybrid._leaves(p)]
        fa.reset_launches()
        loss = gpt.loss_fn(p, ids.to(dev), ids.roll(-1, 1).to(dev), cfg,
                           remat="dots_saveable_attn")
        out[str(dev)] = (loss.item(), [g.cpu() for g in torch.autograd.grad(
            loss, leaves)], fa.launches()["flash_attention_fwd"])
    assert out["cuda"][2] == cfg.num_layers and out["cpu"][2] == 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        _assert_rel(a, b, 1e-4)


def test_prefetch_to_device_on_card(cuda, monkeypatch):
    """The prefetcher's batches equal the source's; each leaf was copied
    on the prefetcher's side stream (not the consumer's), and the
    consumer's stream waited on the copy's event before the batch came
    out."""
    from paddle_tpu_torch import io as tio
    streams, waited = [], []
    put = tio.device_put_async

    def recording_put(x, device, stream=None, counter=None):
        streams.append(stream)
        return put(x, device, stream, counter)

    consume = tio._consume

    def recording_consume(batch, event, device):
        waited.append(event)
        return consume(batch, event, device)
    monkeypatch.setattr(tio, "device_put_async", recording_put)
    monkeypatch.setattr(tio, "_consume", recording_consume)
    rng = np.random.default_rng(7)
    src = [(rng.integers(0, 50304, (8, 1024)),
            torch.from_numpy(rng.standard_normal((8, 64)).astype(
                np.float32)).bfloat16()) for _ in range(5)]
    got = []
    for ids, x in tio.prefetch_to_device(iter(src), device=cuda, depth=2):
        assert ids.is_cuda and x.is_cuda
        got.append((ids * 1, x * 1))      # work on the consumer's stream
    cur = torch.cuda.current_stream(cuda)
    assert len(streams) == 10 and all(s is not None and s != cur
                                      for s in streams)
    assert len(waited) == 5 and all(e is not None for e in waited)
    for (a, b), (ga, gb) in zip(src, got):
        assert torch.equal(ga.cpu(), torch.from_numpy(a))
        assert torch.equal(gb.cpu(), b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_checkpoint_round_trip_on_card(cuda, tmp_path, dtype):
    """CUDA params and float32 moments through save_checkpoint and
    load_latest bit for bit; an AsyncCheckpointer save keeps the values
    of save() time though the next kernels overwrite the tensors."""
    from paddle_tpu_torch.distributed import checkpoint as dist_cp
    g = torch.Generator(device=cuda).manual_seed(8)
    state = {"params": {"w": torch.randn(256, 512, device=cuda, generator=g,
                                         dtype=dtype)},
             "opt": {"m": torch.randn(256, 512, device=cuda, generator=g),
                     "step": torch.tensor(3, device=cuda)}}
    want = {k: v.clone() for k, v in
            dist_cp.flatten_state_dict(state)[0].items()}
    dist_cp.save_checkpoint(state, str(tmp_path / "sync"), 3)
    with dist_cp.AsyncCheckpointer(str(tmp_path / "async")) as ac:
        ac.save(state, 3)
        state["params"]["w"].mul_(2)      # the next step, in place
        state["opt"]["m"].zero_()
        ac.drain()
    for root in ("sync", "async"):
        fresh = {"params": {"w": torch.zeros(256, 512, device=cuda,
                                             dtype=dtype)},
                 "opt": {"m": torch.zeros(256, 512, device=cuda),
                         "step": torch.tensor(0, device=cuda)}}
        assert dist_cp.load_latest(fresh, str(tmp_path / root)) == 3
        for k, v in dist_cp.flatten_state_dict(fresh)[0].items():
            assert v.is_cuda and torch.equal(v, want[k]), (root, k)


def test_async_checkpointer_reuses_its_pinned_buffers(cuda, tmp_path):
    """Four saves with in-place steps between them, the second while the
    first still commits (slow writes): the two take the two pinned
    buffer sets, the later saves reuse them (no new pinned memory), and
    each step loads bit for bit its own values."""
    from paddle_tpu_torch.distributed import checkpoint as dist_cp
    from paddle_tpu_torch.testing.faults import inject_io
    g = torch.Generator(device=cuda).manual_seed(9)
    state = {"params": {"w": torch.randn(128, 256, device=cuda, generator=g,
                                         dtype=torch.bfloat16)},
             "opt": {"m": torch.randn(128, 256, device=cuda, generator=g)}}
    root = str(tmp_path / "ckpt")
    want, ptrs = {}, []

    def buffer_ptrs(ac):
        return {t.data_ptr() for bufs in list(ac._free.queue)
                for t in bufs.values()}
    with inject_io(slow_write=0.05), dist_cp.AsyncCheckpointer(root) as ac:
        for step in range(1, 5):
            want[step] = {k: v.clone() for k, v in
                          dist_cp.flatten_state_dict(state)[0].items()}
            ac.save(state, step)
            state["params"]["w"].add_(1)      # the next step, in place
            state["opt"]["m"].mul_(0.5)
            if step >= 2:
                ac.drain()
                ptrs.append(buffer_ptrs(ac))
    assert len(ptrs[0]) == 4 and ptrs[0] == ptrs[1] == ptrs[2]
    assert [s for s, name, *_ in ac.spans if name == "commit"] == [1, 2, 3, 4]
    for step in range(1, 5):
        fresh = {"params": {"w": torch.zeros(128, 256, device=cuda,
                                             dtype=torch.bfloat16)},
                 "opt": {"m": torch.zeros(128, 256, device=cuda)}}
        dist_cp.load_state_dict(fresh, dist_cp.step_dir(root, step))
        for k, v in dist_cp.flatten_state_dict(fresh)[0].items():
            assert torch.equal(v, want[step][k]), (step, k)


def test_bert_train_steps_on_card_match_cpu(cuda):
    """A small BERT (bert_tiny, 2 layers, float32, head dim 32) through
    ``bert_stage_model`` at num_micro 2 with dict labels: three AdamW
    steps on the card (the non-causal flash kernels, 2 launches of each a
    micro-batch) against the same steps on the CPU (the plain
    composition), losses at rel 1e-4."""
    cfg = bert.bert_tiny(num_layers=2)
    params = bert.init_params(cfg, seed=3, device="cpu")
    batch = next(chip_smoke.bert_batches(cfg, 3, 1, 4, 64))
    losses = {}
    for dev in ("cpu", cuda):
        step, shard, init_opt = hybrid.build_train_step(
            cfg, num_micro=2, model=hybrid.bert_stage_model(cfg),
            device=dev)
        p = shard(params)
        o = init_opt(p)
        ids = torch.from_numpy(batch[0]).to(dev)
        lbl = {k: torch.from_numpy(v).to(dev) for k, v in batch[1].items()}
        fa.reset_launches()
        losses[str(dev)] = [step(p, o, ids, lbl)[0].item() for _ in range(3)]
        want = 0 if dev == "cpu" else 3 * 2 * cfg.num_layers
        assert fa.launches() == {f"flash_attention_{k}": want
                                 for k in ("fwd", "bwd_dkv", "bwd_dq")}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert losses["cpu"][2] < losses["cpu"][0]


def test_ctc_loss_on_card_matches_cpu(cuda):
    """``ctc_loss`` (varied lengths, repeated labels, a zero label
    length) on the card against the CPU: the loss at CTC_LOSS_REL, the
    gradient at CTC_GRAD_REL of its largest value, every reduction."""
    rng = np.random.default_rng(4)
    T, B, L, C = 60, 5, 12, 20
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((T, B, C)).astype(np.float32)), -1)
    labels = torch.from_numpy(rng.integers(1, C, (B, L)))
    labels[0, 1] = labels[0, 0]
    ilen = torch.tensor([60, 41, 70, 30, 1])
    llen = torch.tensor([12, 5, 0, 12, 1])
    for reduction in ("mean", "sum", "none"):
        out = []
        for dev in ("cpu", cuda):
            x = lp.to(dev).requires_grad_(True)
            loss = nnf.ctc_loss(x, labels.to(dev), ilen.to(dev),
                                llen.to(dev), reduction=reduction)
            out.append((loss.detach().cpu(),
                        torch.autograd.grad(loss.sum(), x)[0].cpu()))
        (lc, gc), (lg, gg) = out
        torch.testing.assert_close(lg, lc, rtol=chip_smoke.CTC_LOSS_REL,
                                   atol=0)
        assert (gg - gc).abs().max() <= chip_smoke.CTC_GRAD_REL * \
            gc.abs().max()
