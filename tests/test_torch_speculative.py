"""Port parity: greedy speculative decoding against the JAX engines.

The six greedy cases of ``tests/test_speculative.py::TestBitIdentityGreedy``
(a GPT draft on the contiguous engine, the n-gram proposer, the target
as its own draft, a LLaMA draft, the paged engine with a GPT draft and
with n-gram, the fused engine with both) on the same weights
(``init_params`` in JAX, bridged by ``params_from_numpy``): each port
speculative stream must equal the JAX speculative engine's stream and
the port's own non-speculative stream, and the speculative counters
must equal JAX's; the port runs both attention knobs where the draft's
head dim is one the ``flash_decode`` kernel takes.  Then the verify functions
against JAX's in float32 (logits within rtol/atol 2e-5, written rows
within one storage step), W = 1 against the decode steps bit for bit,
a junk slot whose window runs past the cache, the n-gram proposer,
the constructor's validation, and GPT's ``decode_step`` and
``generate``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn import kv_quant as jkvq
from paddle_tpu.inference.serving import (
    ContinuousBatchingEngine as JaxEngine, FusedB1Engine as JaxFused,
    PagedContinuousBatchingEngine as JaxPaged,
    SpeculativeConfig as JaxSpec)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.incubate.nn.kv_quant import byte_view
from paddle_tpu_torch.inference.serving import (
    ContinuousBatchingEngine, FusedB1Engine, PagedContinuousBatchingEngine,
    RequestStatus, SpeculativeConfig)
from paddle_tpu_torch.models import decoding
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

TOL = dict(rtol=2e-5, atol=2e-5)
KV_DTYPES = ("bf16", "int8", "fp8")
COUNTERS = ("proposed", "accepted", "emitted", "launches", "slot_launches",
            "rollbacks")
# (prompt length, max_new) of the JAX test's requests
_REQS = ((5, 9), (16, 4), (9, 12), (3, 5))
_PAGED = dict(block_size=8, num_blocks=24)


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


def _gpt_cfgs(**kw):
    common = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                  max_position_embeddings=128, use_flash=False)
    common.update(kw)
    dt = common.pop("dtype", "float32")
    return (jgpt.GPTConfig(dtype=getattr(jnp, dt), unroll_layers=False,
                           **common),
            tgpt.GPTConfig(dtype=getattr(torch, dt), **common))


@pytest.fixture(scope="module")
def models():
    """The JAX test's target, GPT draft, LLaMA draft and fused model, in
    both packages on the same weights."""
    jcfg, tcfg = _gpt_cfgs()
    jp = jgpt.init_params(jcfg, seed=0)
    jdcfg, tdcfg = _gpt_cfgs(hidden_size=16, num_layers=1)
    jdp = jgpt.init_params(jdcfg, 7)
    lkw = dict(vocab_size=128, hidden_size=16, num_layers=1, num_heads=2,
               num_kv_heads=1, max_position_embeddings=128, use_flash=False)
    jlcfg = jllama.LlamaConfig(dtype=jnp.float32, **lkw)
    tlcfg = tllama.LlamaConfig(dtype=torch.float32, **lkw)
    jlp = jllama.init_params(jlcfg, 3)
    jfcfg, tfcfg = _gpt_cfgs(num_layers=1, max_position_embeddings=64,
                             dtype="bfloat16")
    jq = jgpt.quantize_decode_params(jgpt.init_params(jfcfg, seed=0), jfcfg)
    return {"target": (jcfg, jp, tcfg, _bridge(jp)),
            "draft": (jdcfg, jdp, tdcfg, _bridge(jdp)),
            "llama": (jlcfg, jlp, tlcfg, _bridge(jlp)),
            "fused": (jfcfg, jq, tfcfg, _bridge(jq))}


def _specs(models, case):
    """(JAX SpeculativeConfig, port SpeculativeConfig) of a case."""
    jcfg, jp, tcfg, tp = models["target"]
    if case in ("model", "paged_model", "fused_model"):
        jdcfg, jdp, tdcfg, tdp = models["draft"]
        return (JaxSpec(k=3, draft_params=jdp, draft_cfg=jdcfg),
                SpeculativeConfig(k=3, draft_params=tdp, draft_cfg=tdcfg))
    if case == "self":
        return (JaxSpec(k=3, draft_params=jp, draft_cfg=jcfg),
                SpeculativeConfig(k=3, draft_params=tp, draft_cfg=tcfg))
    if case == "llama":
        jlcfg, jlp, tlcfg, tlp = models["llama"]
        return (JaxSpec(k=2, family="llama", draft_params=jlp,
                        draft_cfg=jlcfg),
                SpeculativeConfig(k=2, family="llama", draft_params=tlp,
                                  draft_cfg=tlcfg))
    return True, True                                   # n-gram


def _requests(case):
    if case.startswith("fused"):
        rng = np.random.default_rng(1)
        return [(rng.integers(1, 128, (n,)).astype(np.int32), 8)
                for n in (5, 9, 12)]
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 128, (n,)).astype(np.int32), m)
            for n, m in _REQS]


def _engine(pkg, models, case, spec, attn_kernel="xla"):
    """The case's engine of ``pkg`` ("jax" or "port")."""
    jax_side = pkg == "jax"
    if case.startswith("fused"):
        jcfg, jq, tcfg, tq = models["fused"]
        E = JaxFused if jax_side else FusedB1Engine
        args = (jq, jcfg) if jax_side else (tq, tcfg)
        kw = dict(max_len=64)
    else:
        jcfg, jp, tcfg, tp = models["target"]
        paged = case.startswith("paged")
        E = ((JaxPaged if paged else JaxEngine) if jax_side
             else (PagedContinuousBatchingEngine if paged
                   else ContinuousBatchingEngine))
        args = (jp, jcfg) if jax_side else (tp, tcfg)
        kw = dict(max_batch=2, max_len=64, **(_PAGED if paged else {}))
    if not jax_side:
        kw["device"] = "cpu"
    return E(*args, speculative=spec, attn_kernel=attn_kernel, **kw)


def _serve(eng, case):
    reqs = _requests(case)
    rids = [eng.submit(p, max_new=m) for p, m in reqs]
    out = eng.run(steps_per_sync=8)
    for rid, (_, m) in zip(rids, reqs):
        assert eng.request(rid).status == RequestStatus.DONE
        assert len(out[rid]) == m
    return [out[r] for r in rids]


CASES = ("model", "ngram", "self", "llama", "paged_model", "paged_ngram",
         "fused_model", "fused_ngram")
# the JAX engines' knob is "xla"; the port runs both knobs, except that
# the JAX test's drafts have head dim 8, which flash_decode does not take
RUNS = [(case, "xla") for case in CASES] + [
    (case, "flash") for case in ("ngram", "self", "paged_ngram",
                                 "fused_ngram")]


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each case's JAX speculative engine, run once for the module:
    {case: (streams, speculative metrics)}."""
    out = {}
    for case in CASES:
        eng = _engine("jax", models, case, _specs(models, case)[0])
        out[case] = (_serve(eng, case), eng.metrics()["speculative"])
    return out


@pytest.fixture(scope="module")
def port_base(models):
    """The port's non-speculative streams of each engine family."""
    return {fam: _serve(_engine("port", models, case, None), case)
            for fam, case in (("contiguous", "model"),
                              ("paged", "paged_model"),
                              ("fused", "fused_model"))}


@pytest.mark.parametrize("case,attn_kernel", RUNS)
def test_speculative_streams_and_counters_match_jax(models, jax_runs,
                                                    port_base, case,
                                                    attn_kernel):
    want, jmetrics = jax_runs[case]
    eng = _engine("port", models, case, _specs(models, case)[1],
                  attn_kernel)
    got = _serve(eng, case)
    assert got == want
    fam = "paged" if case.startswith("paged") else \
        "fused" if case.startswith("fused") else "contiguous"
    assert got == port_base[fam]
    m = eng.metrics()
    s = m["speculative"]
    assert {c: s[c] for c in COUNTERS} == {c: jmetrics[c] for c in COUNTERS}
    assert (s["k"], s["draft"]) == (jmetrics["k"], jmetrics["draft"])
    assert s["accept_ratio"] == pytest.approx(jmetrics["accept_ratio"])
    assert s["tokens_per_launch"] == pytest.approx(
        jmetrics["tokens_per_launch"])
    assert s["proposed"] > 0 and s["emitted"] > 0
    launches = m["launches"]
    model_draft = not case.endswith("ngram")
    rounds = s["launches"] - launches.get("draft", 0)
    assert launches["verify"] == rounds >= 1
    assert launches.get("draft", 0) == (rounds if model_draft else 0)
    if model_draft:
        prefill = "prefill_fused" if fam == "fused" else "prefill"
        assert launches["draft_prefill"] == launches[prefill]
        assert m["draft_steps"] > 0
    if case == "self":
        # the target as its own draft: only the budget cuts a window
        assert s["rollbacks"] == 0
    if fam == "paged":
        assert m["free_blocks"] == m["num_blocks"]


def test_speculative_round_reads_the_device_once(models, monkeypatch):
    """A round's draft steps and verify make no host sync; the fed
    window and the target tokens come back in one readback."""
    eng = _engine("port", models, "model", _specs(models, "model")[1])
    reads = []
    real = torch.Tensor.cpu

    def counting(t, *a, **kw):
        reads.append(tuple(t.shape))
        return real(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    monkeypatch.setattr(torch.Tensor, "item", lambda t: pytest.fail(
        "a host sync inside the speculative round"))
    _serve(eng, "model")
    rounds = eng.metrics()["launches"]["verify"]
    decodes = eng.metrics()["launches"].get("decode", 0)
    spec_reads = [r for r in reads if len(r) == 3]
    assert len(spec_reads) == rounds and len(reads) == rounds + decodes
    assert all(r[0] == 2 for r in spec_reads)


# ---------------------------------------------------------------------------
# the verify functions
# ---------------------------------------------------------------------------

def _random_cache(rng, jcfg, lead, kd):
    """A JAX cache {"k", "v"(, scales)} of shape [L, *lead, nH, hD] with
    seeded random content in kd's storage, and its port copy."""
    shape = (jcfg.num_layers,) + lead + (jcfg.num_heads, jcfg.head_dim)
    jc = {}
    for name in ("k", "v"):
        x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
        if kd == "bf16":
            jc[name] = x.astype(jcfg.dtype)
        else:
            q, s = jkvq.quantize_kv(x, kd)
            jc[name] = q
            if s is not None:
                jc[name[0] + "s"] = s
    return jc, {k: _torch(v) for k, v in jc.items()}


def _assert_written(got, want, before):
    """What JAX left unchanged the port left unchanged, and every element
    is within one storage step of JAX's."""
    for name in want:
        g, w, b = got[name], _torch(want[name]), before[name]
        kept = byte_view(w) == byte_view(b)
        assert torch.equal(byte_view(g)[kept], byte_view(b)[kept]), name
        gf, wf = g.float(), w.float()
        if g.dtype == torch.int8:
            assert (gf - wf).abs().max() <= 1, name
        elif g.dtype == torch.float8_e4m3fn:
            assert ((gf - wf).abs() <= 2 ** -3 * wf.abs() + 2 ** -9).all()
        else:
            torch.testing.assert_close(gf, wf, **TOL)


def _window(rng, B, W):
    return rng.integers(0, 128, (B, W)).astype(np.int32)


@pytest.mark.parametrize("kd", KV_DTYPES)
@pytest.mark.parametrize("attn_kernel", ["xla", "flash"])
def test_verify_into_slots_matches_jax(models, kd, attn_kernel):
    jcfg, jp, tcfg, tp = models["target"]
    rng = np.random.default_rng(11)
    B, T, W = 3, 48, 4
    jc, tc = _random_cache(rng, jcfg, (B, T), kd)
    before = {k: v.clone() for k, v in tc.items()}
    toks = _window(rng, B, W)
    # slot 2 is an inactive slot at the junk row: its window runs past T
    pos = np.array([17, 40, T - 1], np.int32)
    jl, jc2 = jgpt.verify_into_slots(jp, jc, jnp.asarray(toks),
                                     jnp.asarray(pos), jcfg,
                                     attn_kernel=attn_kernel)
    tl, tc2 = tgpt.verify_into_slots(tp, tc, torch.from_numpy(toks),
                                     torch.from_numpy(pos), tcfg,
                                     attn_kernel=attn_kernel)
    assert tc2 is tc and tl.shape == (B, W, 128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_written(tc, jc2, before)


@pytest.mark.parametrize("kd", KV_DTYPES)
@pytest.mark.parametrize("attn_kernel", ["xla", "flash"])
def test_verify_paged_matches_jax(models, kd, attn_kernel):
    jcfg, jp, tcfg, tp = models["target"]
    rng = np.random.default_rng(12)
    B, bs, nb, mb, W = 3, 8, 12, 6, 4
    jc, tc = _random_cache(rng, jcfg, (nb, bs), kd)
    before = {k: v.clone() for k, v in tc.items()}
    perm = rng.permutation(nb).astype(np.int32)
    table = np.full((B, mb), -1, np.int32)
    table[0, :3] = perm[:3]          # rows 0..23: the window 17..20
    table[1, :5] = perm[3:8]         # the window 36..39 crosses a page
    # slot 2 inactive: all -1, its writes drop
    toks = _window(rng, B, W)
    pos = np.array([17, 36, mb * bs - 1], np.int32)
    jl, jc2 = jgpt.verify_paged(jp, jc, jnp.asarray(table),
                                jnp.asarray(toks), jnp.asarray(pos), jcfg,
                                attn_kernel=attn_kernel)
    tl, tc2 = tgpt.verify_paged(tp, tc, torch.from_numpy(table),
                                torch.from_numpy(toks),
                                torch.from_numpy(pos), tcfg,
                                attn_kernel=attn_kernel)
    assert tc2 is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_written(tc, jc2, before)


@pytest.mark.parametrize("kd", KV_DTYPES)
def test_verify_fused_matches_jax_and_the_fused_steps(models, kd):
    jcfg, jq, tcfg, tq = models["fused"]
    rng = np.random.default_rng(13)
    L, T, H, W = jcfg.num_layers, 64, jcfg.hidden_size, 4
    jc, _ = _random_cache(rng, jcfg, (1, T), kd)
    jflat = jgpt.flatten_decode_cache(jc, jcfg)
    tflat = {k: _torch(v) for k, v in jflat.items()}
    before = {k: v.clone() for k, v in tflat.items()}
    toks = _window(rng, 1, W)
    pos = np.array([30], np.int32)
    jl, jflat2 = jgpt.verify_fused(jq, jflat, jnp.asarray(toks),
                                   jnp.asarray(pos), jcfg)
    tl, out = tgpt.verify_fused(tq, tflat, torch.from_numpy(toks),
                                torch.from_numpy(pos), tcfg)
    assert out is tflat and tl.shape == (1, W, 128)
    jl = np.asarray(jl)
    # bfloat16 weights: the fused plain version against the Pallas
    # kernel, at the fused tests' bar (0.02 of the largest logit)
    assert np.abs(tl.numpy() - jl).max() <= 0.02 * np.abs(jl).max()
    assert (tl.argmax(-1).numpy() == jl.argmax(-1)).all()
    for name in tflat:
        untouched = np.ones(T, bool)
        untouched[30:30 + W] = False
        assert torch.equal(byte_view(tflat[name])[:, untouched],
                           byte_view(before[name])[:, untouched])
    # the window is the fused decode steps, bit for bit
    steps = {k: v.clone() for k, v in before.items()}
    for j in range(W):
        lj, _ = tgpt.decode_step_fused(
            tq, steps, torch.from_numpy(toks[:, j]),
            torch.tensor([30 + j], dtype=torch.int32), tcfg)
        assert torch.equal(lj, tl[:, j])
    for name in tflat:
        assert torch.equal(byte_view(steps[name]), byte_view(tflat[name]))


@pytest.mark.parametrize("kd", KV_DTYPES)
@pytest.mark.parametrize("attn_kernel", ["xla", "flash"])
def test_w1_verify_is_the_decode_step_bit_for_bit(models, kd, attn_kernel):
    jcfg, _, tcfg, tp = models["target"]
    rng = np.random.default_rng(14)
    B, T = 3, 48
    _, c1 = _random_cache(rng, jcfg, (B, T), kd)
    c2 = {k: v.clone() for k, v in c1.items()}
    tok = torch.from_numpy(_window(rng, B, 1))
    pos = torch.tensor([0, 29, T - 1], dtype=torch.int32)
    want, _ = tgpt.decode_step_multi(tp, c1, tok[:, 0], pos, tcfg,
                                     attn_kernel=attn_kernel)
    got, _ = tgpt.verify_into_slots(tp, c2, tok, pos, tcfg,
                                    attn_kernel=attn_kernel)
    assert torch.equal(got[:, 0], want)
    for name in c1:
        assert torch.equal(byte_view(c1[name]), byte_view(c2[name]))
    # the paged pair, on a shuffled table with -1 tail pages
    bs, nb = 8, 16
    _, p1 = _random_cache(rng, jcfg, (nb, bs), kd)
    p2 = {k: v.clone() for k, v in p1.items()}
    table = np.full((B, 6), -1, np.int32)
    table[0, :1], table[1, :4] = [5], [9, 2, 14, 7]
    bt = torch.from_numpy(table)
    pos = torch.tensor([3, 29, 47], dtype=torch.int32)
    want, _ = tgpt.decode_step_paged(tp, p1, bt, tok[:, 0], pos, tcfg,
                                     attn_kernel=attn_kernel)
    got, _ = tgpt.verify_paged(tp, p2, bt, tok, pos, tcfg,
                               attn_kernel=attn_kernel)
    assert torch.equal(got[:, 0], want)
    for name in p1:
        assert torch.equal(byte_view(p1[name]), byte_view(p2[name]))


@pytest.mark.parametrize("kd", KV_DTYPES)
def test_junk_slot_window_past_the_cache(models, kd):
    """A slot fed at max_len - 1 with W = 4: nothing raises, only row
    max_len - 1 of that slot changes (the three rows past the cache are
    dropped), and the other slots' caches change only in their windows."""
    jcfg, _, tcfg, tp = models["target"]
    rng = np.random.default_rng(15)
    B, T, W = 2, 32, 4
    _, tc = _random_cache(rng, jcfg, (B, T), kd)
    before = {k: v.clone() for k, v in tc.items()}
    pos = torch.tensor([10, T - 1], dtype=torch.int32)
    logits, _ = tgpt.verify_into_slots(tp, tc, torch.from_numpy(
        _window(rng, B, W)), pos, tcfg, attn_kernel="flash")
    assert torch.isfinite(logits).all()
    changed = np.zeros((B, T), bool)
    changed[0, 10:14] = changed[1, T - 1] = True
    for name in tc:
        diff = (byte_view(tc[name]) != byte_view(before[name]))
        diff = diff.reshape(diff.shape[0], B, T, -1).any(-1).any(0)
        assert not diff.numpy()[~changed].any(), name
        assert diff.numpy()[changed].all(), name


def test_sample_window_is_greedy_per_position():
    logits = torch.randn(3, 4, 50)
    g = decoding.sample_window(logits, None, torch.zeros(3), 0.0)
    assert g.dtype == torch.int32 and torch.equal(g, logits.argmax(-1).int())
    with pytest.raises(NotImplementedError, match="threefry"):
        decoding.sample_window(logits, None, torch.zeros(3), 0.7)


# ---------------------------------------------------------------------------
# n-gram proposer, validation, GPT decode_step and generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_ngram_one_matches_jax(models, ngram):
    jcfg, jp, tcfg, tp = models["target"]
    jeng = JaxEngine(jp, jcfg, max_batch=1, max_len=64,
                     speculative=JaxSpec(k=3, ngram=ngram))
    teng = ContinuousBatchingEngine(
        tp, tcfg, max_batch=1, max_len=64, device="cpu",
        speculative=SpeculativeConfig(k=3, ngram=ngram))
    rng = np.random.default_rng(ngram)
    for _ in range(60):
        n = int(rng.integers(1, 30))
        ctx = rng.integers(0, int(rng.integers(2, 9)), n).tolist()
        for k in (1, 3, 5):
            np.testing.assert_array_equal(teng._ngram_one(ctx, k),
                                          jeng._ngram_one(ctx, k))


def test_flash_needs_a_draft_head_dim_the_kernel_takes(models):
    _, _, tcfg, tp = models["target"]
    spec = _specs(models, "model")[1]        # head dim 8
    with pytest.raises(ValueError, match="head dim 8"):
        ContinuousBatchingEngine(tp, tcfg, max_batch=1, max_len=64,
                                 device="cpu", attn_kernel="flash",
                                 speculative=spec)


@pytest.mark.parametrize("bad,match", [
    ("vocab", "vocab"), ("k", "speculative.k"),
    ("family", "unknown draft model family"), ("positions", "cannot cover")])
def test_validation_errors_match_jax(models, bad, match):
    jcfg, jp, tcfg, tp = models["target"]
    if bad == "k":
        specs = (JaxSpec(k=0), SpeculativeConfig(k=0))
    elif bad == "family":
        specs = (JaxSpec(family="bert"), SpeculativeConfig(family="bert"))
    else:
        kw = ({"vocab_size": 64} if bad == "vocab"
              else {"max_position_embeddings": 32})
        jdcfg, tdcfg = _gpt_cfgs(hidden_size=16, num_layers=1, **kw)
        specs = (JaxSpec(draft_params=jgpt.init_params(jdcfg, 0),
                         draft_cfg=jdcfg),
                 SpeculativeConfig(
                     draft_params=tgpt.init_params(tdcfg, 0, device="cpu"),
                     draft_cfg=tdcfg))
    with pytest.raises(ValueError, match=match):
        JaxEngine(jp, jcfg, max_batch=1, max_len=64, speculative=specs[0])
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(tp, tcfg, max_batch=1, max_len=64,
                                 device="cpu", speculative=specs[1])


def test_speculative_flag_values(models):
    _, _, tcfg, tp = models["target"]
    on = ContinuousBatchingEngine(tp, tcfg, max_batch=1, max_len=64,
                                  device="cpu", speculative=True)
    off = ContinuousBatchingEngine(tp, tcfg, max_batch=1, max_len=64,
                                   device="cpu", speculative=False)
    assert on.metrics()["speculative"]["draft"] == "ngram"
    assert on.metrics()["speculative"]["k"] == 3
    assert on.metrics()["speculative"]["accept_ratio"] is None
    assert "speculative" not in off.metrics()


def test_decode_step_matches_jax(models):
    jcfg, jp, tcfg, tp = models["target"]
    rng = np.random.default_rng(16)
    ids = rng.integers(0, 128, (2, 9)).astype(np.int32)
    _, jc, _ = jgpt.prefill(jp, jnp.asarray(ids), jcfg,
                            jgpt.init_decode_cache(jcfg, 2, 32))
    tc = tgpt.init_decode_cache(tcfg, 2, 32, device="cpu")
    tgpt.prefill(tp, torch.from_numpy(ids), tcfg, tc)
    tok = np.array([4, 77], np.int32)
    # one compile for the three positions (pos traced)
    jstep = jax.jit(lambda c, t, p: jgpt.decode_step(jp, c, t, p, jcfg))
    for pos in (9, 10, 11):
        jl, jc = jstep(jc, jnp.asarray(tok), jnp.int32(pos))
        tl, out = tgpt.decode_step(tp, tc, torch.from_numpy(tok), pos, tcfg)
        assert out is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tc["k"][:, :, :pos + 1].numpy(),
                                   np.asarray(jc["k"])[:, :, :pos + 1],
                                   **TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("eos", [None, "third"])
def test_generate_streams_identical(models, eos):
    jcfg, jp, tcfg, tp = models["target"]
    ids = np.random.default_rng(17).integers(0, 128, (3, 7)).astype(np.int32)
    free = np.asarray(jgpt.generate(jp, ids, jcfg, max_new_tokens=12))
    eos_id = None if eos is None else int(free[0, 2])
    want = np.asarray(jgpt.generate(jp, ids, jcfg, max_new_tokens=12,
                                    eos_token_id=eos_id))
    got = tgpt.generate(tp, ids, tcfg, max_new_tokens=12,
                        eos_token_id=eos_id)
    assert got.dtype == torch.int32 and got.shape == (3, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_checks(models):
    _, _, tcfg, tp = models["target"]
    ids = np.zeros((1, 5), np.int32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tgpt.generate(tp, ids, tcfg, max_new_tokens=200)
    with pytest.raises(ValueError, match="cannot hold"):
        tgpt.generate(tp, ids, tcfg, max_new_tokens=8, max_len=10)
    with pytest.raises(NotImplementedError, match="threefry"):
        tgpt.generate(tp, ids, tcfg, max_new_tokens=4, temperature=0.8)
