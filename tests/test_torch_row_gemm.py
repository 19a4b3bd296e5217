"""Port parity: the row_gemm products of the decode block against JAX.

``row_gemm`` is a port-only kernel (the JAX package takes these products
as XLA einsums, ``paddle_tpu/models/gpt.py`` ``_wmm`` and the tied head).
On the CPU its wrapper runs the plain version, which is exactly what the
CPU serving path computed before the kernel: ``x @ w`` and
``matmul_f32out``.  So these tests hold (1) the plan: the K order and the
split count come from (K, N, dtype) only, never from M; (2) the plain
version bit for bit against ``x @ w`` and ``matmul_f32out``, and against
JAX's ``_wmm`` and tied head on the same numpy inputs (float32, rtol =
atol = 1e-5: the same products in another summation order); (3) the
kernel's summation rule (``row_gemm_split_plain``) against the plain
product within float32 rounding; (4) the routing: the decode, verify and
suffix-fill paths take every product of the decode block and the head
through ``row_gemm``, training and prefill none.  The kernel itself is
held to its plain version, bit for bit across M, on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.common import matmul_f32out

TOL = dict(rtol=1e-5, atol=1e-5)
# (K, N) of gpt3_1p3b's decode products: qkv, proj, fc1, fc2, the head
SERVING = ((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048),
           (2048, 50304))


def _rand(rng, shape, dtype=torch.float32):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _fixed(plan):
    return {k: v for k, v in plan.items()
            if k not in ("row_chunks", "m_tiles")}


@pytest.mark.parametrize("K,N", SERVING + ((32, 96), (128, 1024), (96, 40)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_does_not_depend_on_rows(K, N, dtype):
    """Every field that decides a row's arithmetic (column tiles, K
    stages, splits and their length) is the same at every M; only the
    launches that carry the rows change."""
    plans = {M: rg.row_gemm_plan(M, K, N, dtype)
             for M in (1, 8, 13, 32, 64, 65, 200)}
    assert len({tuple(sorted(_fixed(p).items())) for p in plans.values()}) \
        == 1
    p = plans[1]
    # the runs cover the K stages with no empty split
    assert (p["splits"] - 1) * p["split_stages"] < p["k_stages"] \
        <= p["splits"] * p["split_stages"]
    assert [plans[M]["row_chunks"] for M in (1, 64, 65, 200)] == [1, 1, 2, 4]
    assert [plans[M]["m_tiles"] for M in (1, 8, 13, 32, 64)] == \
        [1, 1, 1, 2, 4]


def test_plan_at_the_serving_shapes():
    got = [(rg.row_gemm_plan(8, K, N, torch.bfloat16)["splits"],
            rg.row_gemm_plan(8, K, N, torch.bfloat16)["split_stages"])
           for K, N in SERVING]
    # qkv, proj, fc1, fc2, head: at least ~2 blocks an SM where the
    # columns alone give fewer
    assert got == [(3, 11), (8, 4), (3, 11), (9, 15), (1, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_cpu_product_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    x = _rand(rng, (3, 4, 64), dtype)
    w = _rand(rng, (64, 48), dtype)
    assert torch.equal(rg.row_gemm(x, w), x @ w)
    wte = _rand(rng, (40, 64), dtype)
    got = rg.row_gemm(x, wte.t(), out_dtype=torch.float32)
    want = matmul_f32out(x.reshape(-1, 64), wte.t()).view(3, 4, 40)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_plain_matches_jax_products():
    """The layer product (dense and the int8 pair through ``_wmm``) and
    the tied head, on the same numpy inputs as JAX's functions."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 2, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    qw = rng.integers(-127, 128, (32, 24)).astype(np.int8)
    s = rng.random(24).astype(np.float32) / 100
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(
        tgpt._wmm(tx, tw, rg.row_gemm).numpy(),
        np.asarray(jgpt._wmm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        tgpt._wmm(tx, (torch.from_numpy(qw), torch.from_numpy(s)),
                  rg.row_gemm).numpy(),
        np.asarray(jgpt._wmm(jnp.asarray(x), (jnp.asarray(qw),
                                              jnp.asarray(s)))), **TOL)
    wte = rng.standard_normal((40, 32)).astype(np.float32)
    got = tgpt._tied_logits(tx, torch.from_numpy(wte), rows=True)
    want = jnp.einsum("bsh,vh->bsv", jnp.asarray(x), jnp.asarray(wte),
                      preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("K,N", [(64, 64), (200, 72), (1024, 48),
                                 (2048, 64)])
def test_split_rule_matches_the_product(K, N):
    """The kernel's rule (runs of K summed, then the splits in order)
    is the product up to float32 summation order."""
    rng = np.random.default_rng(K + N)
    x = _rand(rng, (7, K))
    w = _rand(rng, (K, N))
    got = rg.row_gemm_split_plain(x, w)
    want = x.double() @ w.double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * np.sqrt(K))


def test_weight_layouts():
    w = torch.zeros(64, 32)
    assert rg.weight_layout(w) == "kn"
    assert rg.weight_layout(torch.zeros(32, 64).t()) == "nk"
    with pytest.raises(ValueError, match="neither"):
        rg.weight_layout(torch.zeros(64, 64)[:, ::2])


@pytest.mark.parametrize("bad", ["dtype", "mixed", "out", "shape"])
def test_wrapper_rejects(bad):
    x, w, out = torch.zeros(2, 16), torch.zeros(16, 8), None
    if bad == "dtype":
        x, w = x.double(), w.double()
    elif bad == "mixed":
        w = w.bfloat16()
    elif bad == "out":
        out = torch.float16
    else:
        w = torch.zeros(8, 8)
    with pytest.raises((TypeError, ValueError)):
        rg.row_gemm(x, w, out_dtype=out)


def test_other_devices_raise_instead_of_running_plain():
    x = torch.empty(2, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rg.row_gemm(x, torch.empty(16, 8, device="meta"))


def test_cpu_path_does_not_count_launches():
    before = rg.LAUNCHES
    rg.row_gemm(torch.zeros(2, 16), torch.zeros(16, 8))
    assert rg.LAUNCHES == before


def test_decode_paths_route_every_product_through_row_gemm(monkeypatch):
    """4 products a layer plus the head in every decode step and verify
    pass (dense and int8 weights), the layer products only in the suffix
    fill (no head), none in training or prefill."""
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=2, max_position_embeddings=64)
    params = tgpt.init_params(cfg, seed=0, device="cpu")
    calls = []

    def spy(x, w, out_dtype=None):
        calls.append(out_dtype)
        return rg.row_gemm_plain(x, w, out_dtype)

    monkeypatch.setattr(tgpt, "row_gemm", spy)
    L, B = cfg.num_layers, 2
    tok = torch.tensor([3, 5], dtype=torch.int32)
    pos = torch.tensor([4, 9], dtype=torch.int32)
    toks = torch.tensor([[3, 4, 5], [6, 7, 8]], dtype=torch.int32)
    for p in (params, tgpt.quantize_decode_params(params, cfg)):
        cache = tgpt.init_decode_cache(cfg, B, 32, device="cpu")
        for run in (
                lambda: tgpt.decode_step_multi(p, cache, tok, pos, cfg,
                                               attn_kernel="flash"),
                lambda: tgpt.verify_into_slots(p, cache, toks, pos, cfg,
                                               attn_kernel="flash")):
            calls.clear()
            run()
            assert len(calls) == 4 * L + 1
            assert calls[-1] == torch.float32
        calls.clear()
        tgpt.verify_into_slots(p, cache, toks, pos, cfg, logits=False)
        assert len(calls) == 4 * L
    calls.clear()
    ids = torch.zeros((B, 8), dtype=torch.long)
    tgpt.loss_fn(params, ids, ids, cfg)
    tgpt.prefill_into_slots(params, ids, cfg, cache,
                            torch.arange(B), attn_kernel="flash")
    assert calls == []
