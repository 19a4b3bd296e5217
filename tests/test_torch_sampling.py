"""Port parity: seeded sampling against the JAX package.

``paddle_tpu_torch.models.decoding``'s sampling branch (``_filter_logits``,
``sample_token`` with a key, ``sample_token_pos``, ``sample_window``,
``generate_loop``), both ``generate``s and the three serving engines with
``temperature`` / ``top_k`` / ``top_p`` and per-request seeds, with and
without speculation, against the same JAX functions and engines on the
same inputs and weights (``init_params`` in JAX, bridged by
``params_from_numpy``).  On the CPU the draw is the sampler's plain
version (``models/prng.py``).

The bar: identical tokens, except at a near-tie — two candidates whose
perturbed scores (filtered logits + Gumbel noise) lie within 2e-6 of each
other, since the port's Gumbel noise is JAX's within an ulp and not bit
for bit (XLA:CPU's ``log`` is not correctly rounded).  A stream may leave
the JAX stream only at such a near-tie, which the test reports
(``warnings``); nothing is re-seeded away.  The filter is held exactly
(its top-p cutoff may move only where the cumulative mass lies within
rounding of ``top_p``, reported the same way).  The engine cases mirror
``tests/test_speculative.py::TestBitIdentitySampled``; each JAX engine
runs once a module.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.serving import (
    ContinuousBatchingEngine as JaxEngine, FusedB1Engine as JaxFused,
    PagedContinuousBatchingEngine as JaxPaged)
from paddle_tpu.models import decoding as jdec
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.serving import (
    ContinuousBatchingEngine, FusedB1Engine, PagedContinuousBatchingEngine,
    SpeculativeConfig)
from paddle_tpu_torch.models import decoding, prng
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

TIE = 2e-6
SAMP = dict(temperature=0.8, top_k=20, top_p=0.95)
SETTINGS = [dict(temperature=0.8, top_k=20, top_p=0.95),
            dict(temperature=1.0), dict(temperature=0.7, top_p=0.9),
            dict(temperature=1.3, top_k=50)]
# (prompt length, max_new, seed) of the JAX test's requests
_REQS = ((5, 9, 11), (16, 4, 22), (9, 12, 33), (3, 5, 44))
_PAGED = dict(block_size=8, num_blocks=24)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module's tiny engines (the tier-1 run
    has six processes); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _near_tie(what, scores, a, b):
    """Tokens a (port) and b (JAX) differ: their perturbed scores must be
    within ``TIE``; the case is reported."""
    margin = abs(float(scores[a] - scores[b]))
    assert margin < TIE, (what, a, b, margin)
    warnings.warn(f"near-tie in {what}: tokens {a} / {b}, perturbed "
                  f"scores {margin} apart")


def _check_tokens(what, got, want, scores):
    """got / want token arrays [R]; scores [R, V] the port's perturbed
    scores of each row."""
    for r in np.nonzero(np.asarray(got) != np.asarray(want))[0]:
        _near_tie(f"{what} row {r}", scores[r], int(got[r]), int(want[r]))


def _jit(fn, **kw):
    """``fn`` compiled as one program with its keyword arguments fixed
    (eager JAX compiles one an op)."""
    return jax.jit(lambda *a: fn(*a, **kw))


def _init(family, cfg, seed):
    """``family.init_params(cfg, seed)``, compiled as one program."""
    return _jit(family.init_params, cfg=cfg, seed=seed)()


def _filter_both(logits, kw):
    t, k, p = kw["temperature"], kw.get("top_k", 0), kw.get("top_p", 1.0)
    return (np.asarray(jdec._filter_logits(jnp.asarray(logits), t, k, p)),
            decoding._filter_logits(torch.from_numpy(logits), t, k, p))


# every setting at a small vocabulary; at GPT's and LLaMA's the serving
# setting and the bare temperature (top-k and top-p alone are the same
# code as in the serving setting, and JAX's eager sorts of a full
# vocabulary take seconds on the CPU)
SAMPLE_CASES = ([(4, 128, kw) for kw in SETTINGS]
                + [(B, V, kw) for B, V in ((8, 50304), (3, 32000))
                   for kw in SETTINGS[:2]])


@pytest.mark.parametrize("B,V,kw", SAMPLE_CASES, ids=lambda a: "-".join(
    f"{k}{v}" for k, v in a.items()) if isinstance(a, dict) else str(a))
def test_sample_functions_match_jax(B, V, kw):
    """``_filter_logits`` exactly, and the tokens of ``sample_token``
    (one key over [B, V]), ``sample_token_pos`` (a seed and a position a
    row, negative seeds among them) and ``sample_window`` ([2, 4, V]:
    the first two rows' seeds, positions pos + w)."""
    rng = np.random.default_rng(B * V)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    jf, tf = _filter_both(logits, kw)
    differ = ~((jf == tf.numpy()) | (np.isneginf(jf) & np.isneginf(
        tf.numpy())))
    for r in np.nonzero(differ.any(-1))[0]:
        # only the top-p cutoff may move, where the mass is at top_p
        desc = np.sort(jf[r][np.isfinite(jf[r])])[::-1]
        e = np.exp((desc - desc[0]).astype(np.float64))
        cum = np.cumsum(e / e.sum())
        gap = np.abs(cum - kw["top_p"]).min()
        assert gap < 1e-6, (r, gap)
        warnings.warn(f"near-tie of the top-p cutoff: row {r}, mass "
                      f"{gap} from top_p")
    filt = torch.from_numpy(np.where(differ, jf, tf.numpy()))
    key = prng.PRNGKey(B + V)
    want = np.asarray(jdec.sample_token(
        jnp.asarray(logits), jax.random.PRNGKey(B + V), **kw))
    got = decoding.sample_token(torch.from_numpy(logits), key, **kw)
    assert got.dtype == torch.int32 and got.shape == (B,)
    _check_tokens("sample_token", got.numpy(), want,
                  filt + prng.gumbel(key, (B, V)))
    seeds = rng.integers(-2 ** 31, 2 ** 31, B).astype(np.int32)
    pos = rng.integers(0, 1024, B).astype(np.int32)
    want = np.asarray(jdec.sample_token_pos(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(pos), **kw))
    got = decoding.sample_token_pos(torch.from_numpy(logits), seeds, pos,
                                    **kw)
    keys = prng.fold_in(prng.PRNGKey(torch.from_numpy(seeds)),
                        torch.from_numpy(pos))
    _check_tokens("sample_token_pos", got.numpy(), want,
                  filt + prng.gumbel(keys, (V,)))
    B, W, seeds, pos = 2, 4, seeds[:2], pos[:2]
    lw = (rng.standard_normal((B, W, V)) * 3).astype(np.float32)
    want = np.asarray(jdec.sample_window(
        jnp.asarray(lw), jnp.asarray(seeds), jnp.asarray(pos), **kw))
    got = decoding.sample_window(torch.from_numpy(lw), seeds, pos, **kw)
    assert got.shape == (B, W)
    fw = decoding._filter_logits(torch.from_numpy(lw), kw["temperature"],
                                 kw.get("top_k", 0), kw.get("top_p", 1.0))
    pw = torch.from_numpy(pos)[:, None] + torch.arange(W, dtype=torch.int32)
    kw_keys = prng.fold_in(prng.PRNGKey(torch.from_numpy(seeds))[:, None],
                           pw)
    _check_tokens("sample_window", got.reshape(-1).numpy(),
                  want.reshape(-1), (fw + prng.gumbel(kw_keys, (V,)))
                  .reshape(B * W, V))


def test_sampling_support_cases_of_jax():
    """``tests/test_decoding.py::TestSampling``: greedy ignores the key;
    top-k 2 and top-p 0.5 restrict the support; every draw is JAX's."""
    logits = np.asarray([[0.0, 1.0, 2.0, 3.0], [3.0, 2.0, 1.0, 0.0]],
                        np.float32)
    t = torch.from_numpy(logits)
    assert decoding.sample_token(t, None, temperature=0.0).tolist() == [3, 0]
    seen = set()
    for s in range(50):
        got = decoding.sample_token(t, prng.PRNGKey(s), temperature=1.0,
                                    top_k=2).tolist()
        want = np.asarray(jdec.sample_token(
            jnp.asarray(logits), jax.random.PRNGKey(s), temperature=1.0,
            top_k=2)).tolist()
        assert got == want
        seen.update(zip(range(2), got))
    assert {t for b, t in seen if b == 0} <= {2, 3}
    assert {t for b, t in seen if b == 1} <= {0, 1}
    peaked = np.asarray([[10.0, 0.0, 0.0, 0.0]], np.float32)
    for s in range(20):
        assert decoding.sample_token(torch.from_numpy(peaked),
                                     prng.PRNGKey(s), temperature=1.0,
                                     top_p=0.5).tolist() == [0]


def _gen_tie(what, forward, ids, got, want, seed, n, kw):
    """Where a sampled ``generate`` first leaves JAX's: row b, step t;
    the port's perturbed scores there under the step's key (k0 for the
    prefill's draw, else ``split(kr, n - 1)[t - 1]``; counters over the
    whole [B, V] draw) must put the two tokens within ``TIE``."""
    B = ids.shape[0]
    for b in range(B):
        diff = np.nonzero(got[b] != want[b])[0]
        if not diff.size:
            continue
        t = int(diff[0])
        seqs = np.concatenate([ids, got[:, :t]], axis=1)
        logits = forward(torch.from_numpy(seqs.astype(np.int64)))[:, -1]
        k0, kr = prng.split(prng.PRNGKey(seed))
        key = k0 if t == 0 else prng.split(kr, n - 1)[t - 1]
        filt = decoding._filter_logits(logits, kw["temperature"],
                                       kw["top_k"], kw["top_p"])
        scores = filt + prng.gumbel(key, filt.shape)
        _near_tie(f"{what} row {b} step {t}", scores[b], int(got[b, t]),
                  int(want[b, t]))


GEN = dict(temperature=0.8, top_k=50, top_p=0.9)


def test_gpt_generate_sampled_matches_jax(models):
    """``test_decoding.py``'s sampled generate setting (temperature 0.8,
    top-k 50, top-p 0.9, seed 3) on GPT (the engines' target): JAX's
    tokens."""
    jcfg, jp, tcfg, tp = models["target"]
    ids = np.random.default_rng(17).integers(0, 128, (3, 7)).astype(np.int32)
    want = np.asarray(jgpt.generate(jp, ids, jcfg, max_new_tokens=12,
                                    seed=3, **GEN))
    got = tgpt.generate(tp, ids, tcfg, max_new_tokens=12, seed=3, **GEN)
    assert got.dtype == torch.int32 and got.shape == (3, 12)
    _gen_tie("gpt generate", lambda x: tgpt.forward(tp, x, tcfg), ids,
             got.numpy(), want, 3, 12, GEN)
    # another seed draws another stream; greedy still ignores it
    assert not torch.equal(got, tgpt.generate(
        tp, ids, tcfg, max_new_tokens=12, seed=4, **GEN))
    assert torch.equal(
        tgpt.generate(tp, ids, tcfg, max_new_tokens=6, seed=9),
        tgpt.generate(tp, ids, tcfg, max_new_tokens=6, seed=1))


def test_llama_generate_sampled_matches_jax():
    kw = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
              num_kv_heads=2, max_position_embeddings=64,
              initializer_range=0.3, use_flash=False)
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **kw)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **kw)
    jp = _init(jllama, jcfg, 0)
    tp = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    ids = np.zeros((2, 3), np.int32)
    want = np.asarray(jllama.generate(jp, ids, jcfg, max_new_tokens=8,
                                      seed=3, **GEN))
    got = tllama.generate(tp, ids, tcfg, max_new_tokens=8, seed=3, **GEN)
    assert got.shape == (2, 8)
    _gen_tie("llama generate", lambda x: tllama.forward(tp, x, tcfg), ids,
             got.numpy(), want, 3, 8, GEN)


# ---------------------------------------------------------------------------
# the engines (TestBitIdentitySampled)
# ---------------------------------------------------------------------------

def _gpt_cfgs(**kw):
    common = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                  max_position_embeddings=128, use_flash=False)
    common.update(kw)
    dt = common.pop("dtype", "float32")
    return (jgpt.GPTConfig(dtype=getattr(jnp, dt), unroll_layers=False,
                           **common),
            tgpt.GPTConfig(dtype=getattr(torch, dt), **common))


def _bridge(tree):
    return tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


@pytest.fixture(scope="module")
def models():
    """The JAX test's target, GPT draft and fused model, both packages."""
    jcfg, tcfg = _gpt_cfgs()
    jp = _init(jgpt, jcfg, 0)
    jdcfg, tdcfg = _gpt_cfgs(hidden_size=16, num_layers=1)
    jdp = _init(jgpt, jdcfg, 7)
    jfcfg, tfcfg = _gpt_cfgs(num_layers=1, max_position_embeddings=64,
                             dtype="bfloat16")
    jq = _jit(jgpt.quantize_decode_params, cfg=jfcfg)(_init(jgpt, jfcfg, 0))
    return {"target": (jcfg, jp, tcfg, _bridge(jp)),
            "draft": (jdcfg, jdp, tdcfg, _bridge(jdp)),
            "fused": (jfcfg, jq, tfcfg, _bridge(jq))}


def _requests(kind):
    if kind == "fused":
        rng = np.random.default_rng(2)
        return [(rng.integers(1, 128, (n,)).astype(np.int32), 6, i + 1)
                for i, n in enumerate((5, 9))]
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 128, (n,)).astype(np.int32), m, s)
            for n, m, s in _REQS]


def _engine(pkg, models, kind, spec=None, **samp):
    jax_side = pkg == "jax"
    name = "fused" if kind == "fused" else "target"
    jcfg, jp, tcfg, tp = models[name]
    args = (jp, jcfg) if jax_side else (tp, tcfg)
    if kind == "fused":
        E, kw = (JaxFused if jax_side else FusedB1Engine), dict(max_len=64)
    elif kind == "paged":
        E = JaxPaged if jax_side else PagedContinuousBatchingEngine
        kw = dict(max_batch=2, max_len=64, **_PAGED)
    else:
        E = JaxEngine if jax_side else ContinuousBatchingEngine
        kw = dict(max_batch=2, max_len=64)
    if not jax_side:
        kw["device"] = "cpu"
    return E(*args, speculative=spec, **kw, **(samp or SAMP))


def _serve(eng, reqs, steps=8):
    rids = [eng.submit(p, max_new=m, seed=s) for p, m, s in reqs]
    out = eng.run(steps_per_sync=steps)
    return [list(map(int, out[r])) for r in rids]


@pytest.fixture(scope="module")
def jax_streams(models):
    """Each engine family's sampled JAX stream (no speculation), run once
    for the module."""
    return {kind: _serve(_engine("jax", models, kind), _requests(kind))
            for kind in ("contiguous", "paged", "fused")}


def _stream_tie(models, kind, reqs, got, want):
    """The first difference of each port stream from JAX's must be a
    near-tie: the port's prefill logits of the common prefix, filtered,
    plus the noise of the request's key at that position."""
    name = "fused" if kind == "fused" else "target"
    _, _, tcfg, tp = models[name]
    for (prompt, _, seed), g, w in zip(reqs, got, want):
        if g == w:
            continue
        t = next(i for i, (x, y) in enumerate(zip(g, w)) if x != y)
        seq = np.concatenate([prompt, np.asarray(w[:t], np.int32)])
        cache = tgpt.init_decode_cache(tcfg, 1, seq.size, device="cpu")
        logits, _, _ = tgpt.prefill(tp, torch.from_numpy(seq[None]).long(),
                                    tcfg, cache)
        filt = decoding._filter_logits(logits.float(), **{
            "temperature": SAMP["temperature"], "top_k": SAMP["top_k"],
            "top_p": SAMP["top_p"]})[0]
        key = prng.fold_in(prng.PRNGKey(seed), seq.size - 1)
        _near_tie(f"{kind} seed {seed} token {t}",
                  filt + prng.gumbel(key, filt.shape), g[t], w[t])


def _spec(models, kind, draft):
    if draft is None or draft == "ngram":
        return None if draft is None else True
    _, _, tdcfg, tdp = models["draft"]
    return SpeculativeConfig(k=3, draft_params=tdp, draft_cfg=tdcfg)


ENGINE_CASES = [("contiguous", 1, None), ("contiguous", 8, None),
                ("contiguous", 8, "draft"), ("contiguous", 8, "ngram"),
                ("paged", 8, None), ("paged", 8, "draft"),
                ("paged", 8, "ngram"), ("fused", 1, None),
                ("fused", 8, "draft"), ("fused", 8, "ngram")]


@pytest.mark.parametrize("kind,steps,draft", ENGINE_CASES)
def test_sampled_engine_streams_match_jax(models, jax_streams, kind, steps,
                                          draft):
    """The sampled port engine — at steps_per_sync 1 or 8, plain or
    speculative (a GPT draft, n-gram) — gives the JAX engine's plain
    sampled stream: the scan partition and speculation move no token."""
    reqs = _requests(kind)
    eng = _engine("port", models, kind, _spec(models, kind, draft))
    got = _serve(eng, reqs, steps)
    for (_, m, _), g in zip(reqs, got):
        assert len(g) == m
    if draft is not None:
        assert eng.metrics()["launches"]["verify"] >= 1
    _stream_tie(models, kind, reqs, got, jax_streams[kind])


def test_different_seeds_differ(models):
    """Sampling is real: one prompt under two seeds diverges (temperature
    2.0), and a seed's stream does not depend on its slot or batch."""
    p = np.arange(1, 20, dtype=np.int32)
    eng = _engine("port", models, "contiguous", temperature=2.0)
    a = eng.submit(p, max_new=12, seed=1)
    b = eng.submit(p, max_new=12, seed=2)
    out = eng.run()
    assert out[a] != out[b]
    alone = _engine("port", models, "contiguous", temperature=2.0)
    c = alone.submit(p, max_new=12, seed=2)
    assert alone.run()[c] == out[b]


def test_submit_checks_the_seed(models):
    eng = _engine("port", models, "contiguous")
    with pytest.raises(ValueError, match="int32"):
        eng.submit([1, 2, 3], max_new=2, seed=2 ** 31)
    eng.submit([1, 2, 3], max_new=2, seed=-2 ** 31)
    assert (eng.temperature, eng.top_k, eng.top_p) == (0.8, 20, 0.95)
