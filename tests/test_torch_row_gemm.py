"""Port parity: the row_gemm products of the decode block against JAX.

``row_gemm`` is a port-only kernel (the JAX package takes these products
as XLA einsums, ``paddle_tpu/models/gpt.py`` ``_wmm`` and the tied head).
On the CPU its wrapper runs the plain version, which is exactly what the
CPU serving path computed before the kernel: ``x @ w`` and
``matmul_f32out``.  So these tests hold (1) the plan: the K order, the
split count and the grid come from (K, N, dtype) and the card's SM and
cluster counts only, never from M, and every SM streams an equal share
of the weight bytes; (2) the plain
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


# (K, N) of llama_7b's decode products: qkv, o, gate/up, down, the head
LLAMA_7B = ((4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096),
            (4096, 32000))
# a card with fewer SMs (an H100 PCIe's 114), clusters as on the SXM part
SMALLER = (114, {c: 114 // c for c in rg.CLUSTER_SIZES})
ROWS = (1, 8, 13, 32, 63, 64, 65, 128, 129, 200, 256, 257, 520, 1024)


def _fixed(plan):
    return {k: v for k, v in plan.items()
            if k not in ("row_chunks", "groups")}


@pytest.mark.parametrize("K,N", SERVING + ((32, 96), (128, 1024), (96, 40)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_does_not_depend_on_rows(K, N, dtype):
    """Every field that decides a row's arithmetic (column tiles, K
    stages, the splits, the grid) is the same at every M from 1 to 1024;
    only the launches and the row groups that carry the rows change."""
    plans = {M: rg.row_gemm_plan(M, K, N, dtype) for M in ROWS}
    assert len({tuple(sorted(_fixed(p).items())) for p in plans.values()}) \
        == 1
    p = plans[1]
    # the splits cover the K stages in order, none empty, lengths within
    # one stage of each other
    bounds = rg.split_bounds(K, p["splits"])
    assert bounds[0][0] == 0 and bounds[-1][1] == p["k_stages"] * 64
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    lens = {(k1 - k0) // 64 for k0, k1 in bounds}
    assert min(lens) >= 1 and max(lens) - min(lens) <= 1
    assert max(lens) == p["split_stages"]
    assert [plans[M]["row_chunks"] for M in (1, 256, 257, 520, 1024)] == \
        [1, 1, 2, 3, 4]
    assert [plans[M]["groups"] for M in (1, 64, 65, 128, 129, 256, 1024)] \
        == [1, 1, 2, 2, 3, 4, 4]


@pytest.mark.parametrize("K,N", SERVING + LLAMA_7B)
def test_plan_is_a_function_of_shape_and_card(K, N):
    """The plan comes from (K, N, dtype) and the card's SM and cluster
    counts alone: the same inputs give the same plan at any M, a card is
    all it reads of the device, and float32 and bfloat16 share it."""
    for card in (rg.H100, SMALLER):
        plans = [rg.row_gemm_plan(M, K, N, dt, (card[0], dict(card[1])))
                 for M in (1, 300) for dt in (torch.float32,
                                              torch.bfloat16)]
        assert len({tuple(sorted(_fixed(p).items())) for p in plans}) == 1
        assert plans[0]["sms"] == card[0]
        assert plans[0]["clusters"] <= card[1][plans[0]["splits"]]
        assert plans[0]["sms_used"] <= card[0]
    assert rg.row_gemm_plan(1, K, N, torch.bfloat16) == \
        rg.row_gemm_plan(1, K, N, torch.bfloat16, rg.H100)


def _sm_stages(plan):
    """The K stages each SM of the plan's grid streams: rank r of cluster
    q takes split r of tiles q, q + clusters, ..."""
    out = []
    for q in range(plan["clusters"]):
        tiles = len(range(q, plan["n_tiles"], plan["clusters"]))
        for r in range(plan["splits"]):
            k0 = r * plan["k_stages"] // plan["splits"]
            k1 = (r + 1) * plan["k_stages"] // plan["splits"]
            out.append(tiles * (k1 - k0))
    return out


@pytest.mark.parametrize("card", [rg.H100, SMALLER], ids=["132", "114"])
@pytest.mark.parametrize("K,N", SERVING + LLAMA_7B)
def test_every_sm_streams_an_equal_share(card, K, N):
    """Each SM of the grid streams the same weight bytes to within one
    unit (one tile's split) of the grid's mean, the grid's clusters all
    fit the card at once, and together they stream every weight once.
    The SMs left idle are those no more cluster of the plan's size fits
    (clusters stay inside a GPC) or that no tile is left for."""
    plan = rg.row_gemm_plan(8, K, N, torch.bfloat16, card)
    stages = _sm_stages(plan)
    unit = plan["split_stages"]
    assert len(stages) == plan["sms_used"] <= card[0]
    assert plan["clusters"] <= card[1][plan["splits"]]
    assert max(stages) == plan["sm_stages"]
    mean = sum(stages) / len(stages)
    assert all(abs(s - mean) <= unit for s in stages)
    assert sum(stages) == plan["n_tiles"] * plan["k_stages"]


def test_plan_at_the_serving_shapes():
    got = [tuple(rg.row_gemm_plan(8, K, N, torch.bfloat16)[k]
                 for k in ("splits", "clusters", "tiles_per_cluster",
                           "sm_stages"))
           for K, N in SERVING]
    # qkv, proj, fc1, fc2, head on the H100 (clusters of 4 and 8 fit 30
    # and 15 times): 96, 64, 128, 64 and 131 SMs
    assert got == [(2, 48, 1, 16), (4, 16, 1, 8), (2, 64, 1, 16),
                   (4, 16, 1, 32), (1, 131, 3, 96)]


@pytest.mark.parametrize("K,N", SERVING + LLAMA_7B + ((128, 128),))
def test_plan_takes_the_fewest_stages_then_the_smallest_cluster(K, N):
    """No cluster size that fits the card gives the busiest SM fewer K
    stages, and no smaller one gives it as few: a larger cluster only
    adds partials to sum."""
    p = rg.row_gemm_plan(8, K, N, torch.bfloat16)
    for c in rg.CLUSTER_SIZES:
        if c > p["k_stages"]:
            continue
        fit = rg.H100[1][c]
        tiles = -(-p["n_tiles"] // min(fit, p["n_tiles"]))
        load = tiles * -(-p["k_stages"] // c)
        assert load >= p["sm_stages"]
        if c < p["splits"]:
            assert load > p["sm_stages"]


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
                                 (2048, 64), (8192, 136)])
def test_split_rule_matches_the_product(K, N):
    """The kernel's rule (runs of K summed, then the splits in rank
    order) is the product up to float32 summation order: against the
    float64 product, and within 2 K 2^-24 (|x| @ |w|) an element of the
    float32 product (the bound of two float32 sums of K products)."""
    rng = np.random.default_rng(K + N)
    x = _rand(rng, (7, K))
    w = _rand(rng, (K, N))
    got = rg.row_gemm_split_plain(x, w)
    np.testing.assert_allclose(got.numpy(), (x.double() @ w.double()).numpy(),
                               rtol=1e-4, atol=1e-4 * np.sqrt(K))
    tol = 2 * K * 2.0 ** -24 * (x.abs() @ w.abs())
    assert bool(((got - x @ w).abs() <= tol).all())


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
