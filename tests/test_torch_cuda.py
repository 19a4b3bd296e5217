"""The port's CUDA kernels on the card (skipped without one).

This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same inputs:
bfloat16 output against the plain float32 math at atol 2e-2, float32
at atol 1e-4 (same math, another summation order).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn.kernels import flash_decode as fd
from paddle_tpu_torch.models import gpt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, device):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,W,T,nH,nKV,hD", [
    (4, 1, 100, 8, 8, 128),      # decode, T not a multiple of the chunk
    (2, 37, 37, 4, 2, 64),       # prefill-shaped, GQA, ragged tile
    (3, 4, 64, 4, 4, 16),        # verify-shaped, small head dim
    (2, 5, 40, 2, 1, 32),        # multi-query
])
def test_flash_decode_kernel_matches_plain(cuda, dtype, atol, B, W, T, nH,
                                           nKV, hD):
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
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=atol)


def test_cuda_tensor_never_reaches_plain(cuda, monkeypatch):
    def refuse(*_):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(fd, "flash_decode_attention_plain", refuse)
    qkv = torch.randn(2, 24, 3, 64, device=cuda)
    q, k, v = (qkv[:, :, i].view(2, 24, 4, 16) for i in range(3))
    out = fd.flash_decode_attention(
        q, k, v, torch.zeros(2, dtype=torch.int32, device=cuda))
    assert out.is_cuda and torch.isfinite(out).all()


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
