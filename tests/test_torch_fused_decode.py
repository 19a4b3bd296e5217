"""Port parity: the b1 int8 serving path of paddle_tpu_torch against
paddle_tpu — weight-only int8 (``quantize_decode_params``, the int8
branch of the GPT stack), the fused layer-stack kernel
(``fused_decode_layers``), ``decode_step_fused`` and ``FusedB1Engine``.

Kernel: the port's plain version against the JAX Pallas kernel in
interpret mode, at the JAX test's config (vocab 128, H 256, 3 layers, 2
heads, bfloat16) on a seeded [L, 512, H] cache.  Both keep the same
rounding points and differ only in float32 summation order (~1e-7 of the
largest value); where a bfloat16 rounding point flips by one step the
hidden state moves by ~1e-5 of it.  So h_out row 0 is held at 1e-4 of
its largest value, the written rows within one bf16 step, int8 rows
within one quantum with scales at 1e-5 relative, fp8 rows within one
e4m3 step; every other cache row bit for bit.

Engines: greedy streams of the port's ``FusedB1Engine`` must be
IDENTICAL to the JAX ``FusedB1Engine``'s at every kv_dtype and both
attention knobs, and the port's int8 ``ContinuousBatchingEngine`` to the
JAX one, on the tiny serving-test GPT (vocab 128, H 32, 2 layers, 2
heads, float32) with weights at ``initializer_range`` 0.3, whose streams
vary token to token.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn import kv_quant as jkvq
from paddle_tpu.incubate.nn.kernels.fused_decode import \
    fused_decode_layers as jax_fused
from paddle_tpu.inference.serving import (
    ContinuousBatchingEngine as JaxEngine, FusedB1Engine as JaxFused)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.incubate.nn.kernels import fused_decode as tfd
from paddle_tpu_torch.incubate.nn.kv_quant import byte_view
from paddle_tpu_torch.inference.serving import (
    ContinuousBatchingEngine, FusedB1Engine, RequestStatus)
from paddle_tpu_torch.models import gpt as tgpt

KV_DTYPES = ("bf16", "int8", "fp8")


def _torch(a):
    """A JAX array as a CPU tensor of the same dtype and bytes."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bridge(tree):
    return tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


@pytest.fixture(scope="module")
def qmodel():
    """The JAX test's fused-decode config (bfloat16) in both packages,
    quantized by JAX and bridged."""
    common = dict(vocab_size=128, hidden_size=256, num_layers=3,
                  num_heads=2, max_position_embeddings=512, use_flash=False)
    jcfg = jgpt.GPTConfig(dtype=jnp.bfloat16, unroll_layers=False, **common)
    tcfg = tgpt.GPTConfig(dtype=torch.bfloat16, **common)
    jp = jgpt.init_params(jcfg, seed=0)
    jq = jgpt.quantize_decode_params(jp, jcfg)
    return jcfg, jp, jq, tcfg, _bridge(jp), _bridge(jq)


@pytest.fixture(scope="module")
def tiny():
    """The tiny serving-test GPT in float32 at initializer_range 0.3."""
    common = dict(vocab_size=128, hidden_size=32, num_layers=2,
                  num_heads=2, max_position_embeddings=128,
                  initializer_range=0.3, use_flash=False)
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, unroll_layers=False, **common)
    tcfg = tgpt.GPTConfig(dtype=torch.float32, **common)
    jp = jgpt.init_params(jcfg, seed=0)
    jq = jgpt.quantize_decode_params(jp, jcfg)
    return jcfg, jq, tcfg, _bridge(jq), jp


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["qmodel", "tiny"])
def test_quantize_decode_params_bit_identical(model, qmodel, tiny):
    """The port's quantization of the bridged dense weights equals JAX's
    quantization, int8 values and scales, bit for bit (bfloat16 and
    float32 weights)."""
    if model == "qmodel":
        jcfg, jp, jq, tcfg, tp, _ = qmodel
    else:
        jcfg, jq, tcfg, _, jp = tiny
        tp = _bridge(jp)
    got = tgpt.quantize_decode_params(tp, tcfg)
    want = jax.tree_util.tree_map(np.asarray, jq)
    pairs = [(got["wte"], want["wte"])] + [
        (got["layers"][n], want["layers"][n])
        for n in ("qkv_w", "proj_w", "fc1_w", "fc2_w")]
    for (gq, gs), (wq, ws) in pairs:
        assert gq.dtype == torch.int8 and gs.dtype == torch.float32
        np.testing.assert_array_equal(gq.numpy(), wq)
        np.testing.assert_array_equal(gs.numpy(), ws)
    # everything else is carried over as it is
    assert got["layers"]["ln1_g"] is tp["layers"]["ln1_g"]
    assert got["wpe"] is tp["wpe"]


def test_params_from_numpy_carries_int8_pairs(qmodel):
    *_, tq = qmodel
    qw, s = tq["layers"]["fc1_w"]
    assert (qw.dtype, s.dtype, tuple(qw.shape), tuple(s.shape)) == (
        torch.int8, torch.float32, (3, 256, 1024), (3, 1024))
    assert isinstance(tq["wte"], tuple) and tq["wte"][0].shape == (128, 256)
    # scales count as stored elements
    dense = tgpt.param_count(qmodel[4])
    assert tgpt.param_count(tq) == dense + 3 * (3 * 256 + 256 + 1024 + 256) \
        + 128


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _kernel_case(mode, pos, seed):
    L, T, nH, H = 3, 512, 2, 256
    rng = np.random.default_rng(seed)
    h0 = np.zeros((8, H), np.float32)
    h0[0] = rng.standard_normal(H)
    x = rng.standard_normal((2, L, T, nH, H // nH)).astype(np.float32)
    scales = None
    if mode == "int8":
        (k, ks), (v, vs) = (jkvq.quantize_kv(jnp.asarray(x[i]), "int8")
                            for i in range(2))
        ck, cv = k.reshape(L, T, H), v.reshape(L, T, H)
        scales = (ks.reshape(L, T, nH), vs.reshape(L, T, nH))
    elif mode == "fp8":
        ck, cv = (jkvq.quantize_kv(jnp.asarray(x[i]), "fp8")[0]
                  .reshape(L, T, H) for i in range(2))
    else:
        ck, cv = (jnp.asarray(x[i].reshape(L, T, H), jnp.bfloat16)
                  for i in range(2))
    return h0, ck, cv, scales


@pytest.mark.parametrize("mode,pos", [
    ("bf16", 0), ("bf16", 7), ("bf16", 8), ("bf16", 255), ("bf16", 256),
    ("bf16", 300), ("int8", 300), ("fp8", 255)])
def test_plain_kernel_matches_pallas_kernel(qmodel, mode, pos):
    *_, jq, _, _, tq = qmodel
    h0, ck, cv, scales = _kernel_case(mode, pos, seed=pos)
    want = [np.asarray(a) for a in jax_fused(
        jnp.asarray(h0), jq["layers"], ck, cv, pos, 2, eps=1e-5,
        scales=scales)]
    tck, tcv = _torch(ck), _torch(cv)
    tsc = None if scales is None else tuple(_torch(s) for s in scales)
    before = [t.clone() for t in (tck, tcv) + (tsc or ())]
    launches = tfd.LAUNCHES
    got = tfd.fused_decode_layers(torch.from_numpy(h0), tq["layers"], tck,
                                  tcv, pos, 2, eps=1e-5, scales=tsc)
    assert tfd.LAUNCHES == launches          # the CPU runs the plain version
    assert got[1] is tck and got[2] is tcv   # in place
    h, hw = got[0][0].numpy(), want[0][0]
    assert np.abs(h - hw).max() <= 1e-4 * np.abs(hw).max()
    assert not got[0][1:].any()
    rows = np.ones(512, bool)
    rows[pos] = False
    for g, w, b in zip(got[1:], want[1:], before):
        gw = _torch(w)
        assert torch.equal(byte_view(g)[:, rows], byte_view(b)[:, rows])
        gr, wr = g[:, pos].float(), gw[:, pos].float()
        if g.dtype == torch.int8:
            assert (gr - wr).abs().max() <= 1
        elif g.dtype == torch.float8_e4m3fn:
            assert ((gr - wr).abs() <= 2 ** -3 * wr.abs() + 2 ** -9).all()
        elif g.dtype == torch.bfloat16:
            assert ((gr - wr).abs() <= 2 ** -8 * wr.abs() + 1e-6).all()
        else:                                 # int8 scale planes
            assert ((gr - wr).abs() <= 1e-5 * wr.abs()).all()


# ---------------------------------------------------------------------------
# the fused decode step against the per-op int8 step
# ---------------------------------------------------------------------------

def test_decode_step_fused_matches_per_op_step(qmodel):
    """decode_step_fused on a flattened prefill cache against the port's
    int8 decode_step_multi on the standard cache (the JAX test's bar: rel
    0.02 of the largest logit, the same argmax; the new K/V rows within
    0.02; history rows untouched)."""
    _, _, _, tcfg, _, tq = qmodel
    S = 37
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 128, (1, S)))
    cache = tgpt.init_decode_cache(tcfg, 1, 512, device="cpu")
    tgpt.prefill(tq, ids, tcfg, cache)
    flat = tgpt.flatten_decode_cache(
        {k: v.clone() for k, v in cache.items()}, tcfg)
    tok = ids[0, -1:].to(torch.int32)
    pos = torch.tensor([S - 1], dtype=torch.int32)
    ref, _ = tgpt.decode_step_multi(tq, cache, tok, pos, tcfg)
    got, flat2 = tgpt.decode_step_fused(tq, flat, tok, pos, tcfg)
    assert flat2 is flat and got.shape == (1, 128)
    assert got.dtype == torch.float32
    rel = (got - ref).abs().max() / ref.abs().max()
    assert rel < 0.02
    assert int(got.argmax()) == int(ref.argmax())
    want = tgpt.flatten_decode_cache(cache, tcfg)
    for name in ("k", "v"):
        torch.testing.assert_close(flat[name][:, S - 1].float(),
                                   want[name][:, S - 1].float(),
                                   rtol=0.02, atol=0.02)
        assert torch.equal(flat[name][:, :S - 1], want[name][:, :S - 1])


def test_flatten_decode_cache_is_a_view():
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=64, num_layers=2,
                         num_heads=4, max_position_embeddings=64)
    cache = tgpt.init_decode_cache(cfg, 1, 32, kv_dtype="int8", device="cpu")
    flat = tgpt.flatten_decode_cache(cache, cfg)
    assert flat["k"].shape == (2, 32, 64) and flat["ks"].shape == (2, 32, 4)
    for name in cache:
        assert flat[name].data_ptr() == cache[name].data_ptr()
    flat["k"][1, 5, 17] = 3
    assert cache["k"][1, 0, 5, 1, 1] == 3      # head 1, dim 1 of H 64


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, 128, (n,)).astype(np.int32)
            for n in (9, 21, 14, 30)]


def _serve(eng, prompts, max_new=10):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    out = eng.run(steps_per_sync=4)
    assert all(eng.status(r) == RequestStatus.DONE for r in rids)
    return [out[r] for r in rids]


@pytest.mark.parametrize("kd,attn_kernel", [
    ("bf16", "flash"), ("int8", "xla"), ("fp8", "flash")])
def test_fused_engine_streams_identical_to_jax(tiny, kd, attn_kernel):
    jcfg, jq, tcfg, tq, _ = tiny
    kw = dict(max_len=64, kv_dtype=kd, attn_kernel=attn_kernel)
    want = _serve(JaxFused(jq, jcfg, **kw), _prompts())
    eng = FusedB1Engine(tq, tcfg, device="cpu", **kw)
    got = _serve(eng, _prompts())
    assert got == want
    assert len({t for s in got for t in s}) > 12   # the streams vary
    m = eng.metrics()
    assert m["launches"]["prefill_fused"] == 4 and m["kv_dtype"] == kd
    assert m["cache_bytes"] == sum(c.numel() * c.element_size()
                                   for c in eng._cache.values())


@pytest.mark.parametrize("kd", KV_DTYPES)
def test_fused_engine_against_per_op_int8_engine(tiny, kd):
    """The fused engine against the port's per-op int8 engine at
    max_batch 1: identical at the bf16 (here float32) and int8 caches.
    At fp8 the fused kernel attends the history rounded to bfloat16
    (rounding point 2 of the module docstring of ``fused_decode``)
    where the per-op step attends the fp8 values in float32, and the
    fourth request's stream departs after four tokens; the per-op
    stream there is the JAX per-op engine's, and the fused one the JAX
    fused engine's (test_fused_engine_streams_identical_to_jax)."""
    jcfg, jq, tcfg, tq, _ = tiny
    fused = _serve(FusedB1Engine(tq, tcfg, max_len=64, kv_dtype=kd,
                                 device="cpu"), _prompts())
    per_op = _serve(ContinuousBatchingEngine(tq, tcfg, max_batch=1,
                                             max_len=64, kv_dtype=kd,
                                             device="cpu"), _prompts())
    if kd != "fp8":
        assert fused == per_op
    else:
        jax_per_op = _serve(JaxEngine(jq, jcfg, max_batch=1, max_len=64,
                                      kv_dtype=kd), _prompts())
        assert per_op == jax_per_op
        assert fused[:3] == per_op[:3]
        assert fused[3][:4] == per_op[3][:4] and fused[3] != per_op[3]


@pytest.mark.parametrize("kd", ["bf16", "int8"])
def test_int8_weight_engine_streams_identical_to_jax(tiny, kd):
    """The port's contiguous engine on the JAX-quantized tree (int8
    weights through _wmm, _embed_rows and the int8 tied head) gives the
    JAX engine's streams, two slots at a time."""
    jcfg, jq, tcfg, tq, _ = tiny
    kw = dict(max_batch=2, max_len=64, kv_dtype=kd, attn_kernel="flash")
    want = _serve(JaxEngine(jq, jcfg, **kw), _prompts())
    got = _serve(ContinuousBatchingEngine(tq, tcfg, device="cpu", **kw),
                 _prompts())
    assert got == want


def test_fused_engine_checks(tiny):
    _, _, tcfg, tq, _ = tiny
    dense = tgpt.init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        FusedB1Engine(dense, tcfg, max_len=64, device="cpu")
    for bad in (0, -8, 12, 264):
        with pytest.raises(ValueError, match="multiple of 8"):
            FusedB1Engine(tq, tcfg, max_len=bad, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        FusedB1Engine(tq, tcfg, max_len=64)
    eng = FusedB1Engine(tq, tcfg, max_len=64, kv_dtype="int8", device="cpu")
    assert eng.max_batch == 1
    assert {k: tuple(v.shape) for k, v in eng._cache.items()} == {
        "k": (2, 64, 32), "v": (2, 64, 32), "ks": (2, 64, 2),
        "vs": (2, 64, 2)}


def _wrapper_case(tq, T=64, H=32):
    L = 2
    h0 = torch.zeros((8, H))
    ck = torch.zeros((L, T, H))
    return h0, dict(tq["layers"]), ck, ck.clone()


@pytest.mark.parametrize("bad", [
    "T_not_8", "T_not_256", "H3", "scale_shape", "int8_without_scales",
    "scales_with_bf16", "h0_dtype", "weight_dtype", "dense_weight",
    "head_dim", "pos"])
def test_fused_decode_wrapper_checks(tiny, bad):
    """The JAX function's input checks (:345-382) and the port's dtype
    and shape checks, on the CPU path."""
    _, _, _, tq, _ = tiny
    T = {"T_not_8": 60, "T_not_256": 264}.get(bad, 64)
    h0, ql, ck, cv = _wrapper_case(tq, T)
    scales, pos, nH = None, 3, 2
    if bad == "H3":
        q, s = ql["qkv_w"]
        ql["qkv_w"] = (q[..., :80], s[..., :80])
    elif bad == "scale_shape":
        ck = cv = torch.zeros((2, T, 32), dtype=torch.int8)
        scales = (torch.zeros((2, T, 3)), torch.zeros((2, T, 3)))
    elif bad == "int8_without_scales":
        ck = cv = torch.zeros((2, T, 32), dtype=torch.int8)
    elif bad == "scales_with_bf16":
        scales = (torch.zeros((2, T, 2)), torch.zeros((2, T, 2)))
    elif bad == "h0_dtype":
        h0 = h0.double()
    elif bad == "weight_dtype":
        ql["fc2_w"] = (ql["fc2_w"][0].float(), ql["fc2_w"][1])
    elif bad == "dense_weight":
        ql["proj_w"] = ql["proj_w"][0].float()
    elif bad == "head_dim":
        nH = 4                                  # hD 8
    elif bad == "pos":
        pos = T
    with pytest.raises((TypeError, ValueError)):
        tfd.fused_decode_layers(h0, ql, ck, cv, pos, nH, scales=scales)


# ---------------------------------------------------------------------------
# the kernel's plan (mirrored in the wrapper): GEMV ownership, attention
# items, scratch
# ---------------------------------------------------------------------------

GRIDS = (132, 264, 7, 1)
WIDTHS = ((2048, 8192), (64, 256), (96, 160), (16384, 16384))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("H,F", WIDTHS)
def test_gemv_parts_cover_every_weight_row_once(H, F, grid):
    """Every (column tile, K row) of each GEMV lies in exactly one part;
    a tile's parts come in part order 0..m-1, cut its K rows evenly
    (their sizes differ by at most one row) and fit the scratch's
    [tile, part] slots; with no more tiles than blocks every block has
    at most one part (so it finishes one tile), and all but fewer than
    a tile's parts' worth of blocks have one, unless the parts are at
    their floor of 16 rows."""
    lay = tfd.scratch_layout(H, F, 1024, 16, grid)
    for K, N in tfd._gemvs(H, F):
        tiles, m = tfd.gemv_plan(K, N, grid)
        parts = tfd.gemv_parts(K, N, grid)
        assert sorted(parts) == list(range(tiles))
        owners = {}
        for t, ps in parts.items():
            assert [j for _, j, _, _ in ps] == list(range(m))
            bounds = [k for _, _, k0, k1 in ps for k in (k0, k1)]
            assert bounds[0] == 0 and bounds[-1] == K
            assert bounds[1:-1:2] == bounds[2:-1:2]      # contiguous
            sizes = [k1 - k0 for *_, k0, k1 in ps]
            assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 16
            assert (t * m + m) * tfd.GEMV_TILE <= lay["part"][1]
            for b, *_ in ps:
                owners[b] = owners.get(b, 0) + 1
        assert all(0 <= b < grid for b in owners)
        if tiles <= grid:
            assert set(owners.values()) == {1}
            assert grid - len(owners) < tiles or m == K // 16
        else:
            assert len(owners) == grid


@pytest.mark.parametrize("grid", (132, 7))
@pytest.mark.parametrize("nH", (16, 2, 128))
@pytest.mark.parametrize("T", (8, 256, 1024))
def test_attention_items_cover_every_history_row_once(T, nH, grid):
    """At every pos < T each (head, history row < pos) falls in exactly
    one item, no item crosses a KV_CHUNK boundary, tiles are powers of 2
    from MIN_TILE_ROWS to KV_CHUNK, and the items fill the grid without
    exceeding it where a tile of KV_CHUNK rows allows."""
    for pos in range(T):
        tr, nt = tfd.attention_plan(pos, nH, grid)
        assert tr in (16, 32, 64, 128, 256) and nt == -(-pos // tr)
        assert nH * nt <= grid or tr == tfd.KV_CHUNK
        assert tr == tfd.MIN_TILE_ROWS or nH * -(-pos // (tr // 2)) > grid
        items = tfd.attention_items(pos, nH, grid)
        seen = np.zeros((nH, T), np.int32)
        for b, hh, j, r0, r1 in items:
            assert 0 <= b < grid and 0 <= r0 < r1 <= pos
            assert r0 == j * tr and r1 - r0 <= tr
            assert r0 // tfd.KV_CHUNK == (r1 - 1) // tfd.KV_CHUNK
            seen[hh, r0:r1] += 1
        assert (seen[:, :pos] == 1).all() and not seen[:, pos:].any()


@pytest.mark.parametrize("grid", (132, 7))
@pytest.mark.parametrize("T", (8, 256, 1024))
@pytest.mark.parametrize("H,nH,F", ((2048, 16, 8192), (64, 4, 256),
                                    (96, 3, 160)))
def test_scratch_covers_what_the_plan_writes(H, nH, F, T, grid):
    """The regions of scratch_layout are disjoint, 16-byte aligned and
    within "total", and each holds every index the kernel writes at any
    pos < T: the scores [head, row], the tile maxima and sums [head,
    tile], the tiles' P.V [head, tile, hD] and every block's GEMV parts
    [block, tile index, GEMV_TILE]."""
    lay = tfd.scratch_layout(H, F, T, nH, grid)
    regions = sorted(v for k, v in lay.items() if k != "total")
    for (a, n), (b, _) in zip(regions, regions[1:]):
        assert a % 4 == 0 and a + n <= b
    assert regions[-1][0] + regions[-1][1] == lay["total"]
    hD = H // nH
    most_tiles = max(tfd.attention_plan(pos, nH, grid)[1]
                     for pos in range(T))
    for hh in (0, nH - 1):
        assert hh * T + T - 1 < lay["s"][1]
        assert hh * -(-T // tfd.MIN_TILE_ROWS) + most_tiles - 1 \
            < lay["tm"][1] == lay["ls"][1]
        assert (hh * -(-T // tfd.MIN_TILE_ROWS) + most_tiles) * hD \
            <= lay["acc"][1]
    for K, N in tfd._gemvs(H, F):
        tiles, m = tfd.gemv_plan(K, N, grid)
        for t, ps in tfd.gemv_parts(K, N, grid).items():
            for _, j, *_ in ps:
                assert (t * m + j + 1) * tfd.GEMV_TILE <= lay["part"][1]
    for name, n in (("qkv", 3 * H), ("g", F), ("vn", H), ("sn", nH)):
        assert lay[name][1] == n
    assert tfd.sync_ints(H, F) == 4 + max(-(-3 * H // tfd.GEMV_TILE),
                                          -(-F // tfd.GEMV_TILE))


@pytest.mark.parametrize("L", (1, 3, 24))
def test_barriers_per_token_at_most_six_a_layer(L):
    assert tfd.barriers_per_token(L) == 6 * L - 1 <= 6 * L
