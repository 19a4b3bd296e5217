"""Port parity: the device prefix cache against the JAX package.

Mirrors ``tests/test_prefix_cache.py`` (``TestRadixTrie``,
``TestContiguousEnginePrefix``, ``TestPagedEnginePrefix``) and
``tests/test_speculative.py::TestPrefixExtension``, and adds the fused
engine.  The trie runs the JAX test's operation script beside JAX's own
trie, step for step.  Each engine case serves the same requests on the
same weights (``init_params`` in JAX, bridged by ``params_from_numpy``)
through JAX's warm engine (run once for the module), the port's warm
engine and the port's cold engine: streams must be identical, and the
prefix hits, trie counters, evictions, page refcounts and free pages
must equal JAX's.  The config is the JAX test's (vocab 128, H 32, 2
layers, float32) at ``initializer_range=0.3``: the default 0.02 gives
near-constant greedy streams that would hide a wrong cache row.  The
port runs its default ``attn_kernel="flash"`` (the plain flash_decode
on the CPU) and, where noted, "xla" too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.prefix_cache import (
    KVSpanPayload as JaxSpan, PagePayload as JaxPages,
    RadixPrefixCache as JaxTrie)
from paddle_tpu.inference.serving import (
    ContinuousBatchingEngine as JaxEngine, FusedB1Engine as JaxFused,
    PagedContinuousBatchingEngine as JaxPaged,
    SpeculativeConfig as JaxSpec)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference.prefix_cache import (KVSpanPayload,
                                                     PagePayload,
                                                     RadixPrefixCache)
from paddle_tpu_torch.inference.serving import (
    ContinuousBatchingEngine, FusedB1Engine, PagedContinuousBatchingEngine,
    RequestStatus, SpeculativeConfig)
from paddle_tpu_torch.models import gpt as tgpt

BIG = 1 << 30
_PAGED = dict(block_size=8, num_blocks=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's engines here run tiny products: one intra-op thread
    keeps them from contending with the other test workers' threads
    (the tier-1 run has six processes); the module leaves the setting as
    it found it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    common = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                  max_position_embeddings=128, use_flash=False,
                  initializer_range=0.3)
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
    jcfg, tcfg = _cfgs()
    jp = jgpt.init_params(jcfg, seed=0)
    # the JAX speculative test's draft: head dim 8
    jdcfg, tdcfg = _cfgs(hidden_size=16, num_layers=1)
    jdp = jgpt.init_params(jdcfg, 7)
    jfcfg, tfcfg = _cfgs(num_layers=1, max_position_embeddings=64,
                         dtype="bfloat16")
    jq = jgpt.quantize_decode_params(jgpt.init_params(jfcfg, seed=0), jfcfg)
    return {"target": (jcfg, jp, tcfg, _bridge(jp)),
            "draft": (jdcfg, jdp, tdcfg, _bridge(jdp)),
            "fused": (jfcfg, jq, tfcfg, _bridge(jq))}


# ---------------------------------------------------------------------------
# the trie, against JAX's on one operation script
# ---------------------------------------------------------------------------

def _spans(pkg):
    """make_payload of the JAX test (a span's values are its positions,
    two float32 planes) in the package's tensors."""
    def mk(a, b):
        arr = np.arange(a, b, dtype=np.float32)[None]
        if pkg == "jax":
            return JaxSpan(arr, arr.copy())
        t = torch.from_numpy(arr)
        return KVSpanPayload(t, t.clone())
    return mk


def _trie_script(trie, mk):
    """The JAX TestRadixTrie cases as one script; returns every
    observation."""
    seen = []

    def look(key):
        length, spans = trie.match(key)
        vals = [np.asarray(p.k[0][:m]).tolist() for p, m in spans]
        seen.append((length, [m for _, m in spans], vals))

    def ins(key, extend=False):
        seen.append(("insert", trie.insert(key, mk, extend=extend)))

    a = np.arange(100, 130, dtype=np.int32)
    ins(a)
    look(a)
    look(a[:11])
    look(np.arange(5, dtype=np.int32))
    b = np.concatenate([a[:12], np.arange(500, 510, dtype=np.int32)])
    ins(b)
    for key in (a, b):
        look(key)
    ins(a[:10])
    ins(a)
    ins(np.concatenate([b, np.arange(7, 12, dtype=np.int32)]), extend=True)
    look(np.concatenate([b, np.arange(7, 9, dtype=np.int32)]))
    seen.append(("probe", trie.probe(b)))
    st = trie.stats()
    seen.append({k: st[k] for k in ("bytes", "entries", "hits", "misses",
                                    "hit_tokens", "extended_tokens",
                                    "evictions")})
    return seen


def test_trie_script_matches_jax():
    got = _trie_script(RadixPrefixCache(), _spans("port"))
    want = _trie_script(JaxTrie(), _spans("jax"))
    assert got == want


@pytest.mark.parametrize("capacity", [0, 200, 450])
def test_trie_lru_eviction_matches_jax(capacity):
    """The JAX LRU case (each 10-token span charges 80 bytes) at three
    budgets: the same spans evicted, kept and released."""
    def script(pkg):
        Trie = JaxTrie if pkg == "jax" else RadixPrefixCache
        c = Trie(capacity_bytes=capacity)
        mk = _spans(pkg)
        keys = [np.arange(s, s + 10, dtype=np.int32) for s in (0, 50, 80)]
        c.insert(keys[0], mk)
        c.insert(keys[1], mk)
        c.match(keys[0])
        c.insert(keys[2], mk)
        c.insert(np.concatenate([keys[2], keys[1]]), mk)
        return ([c.match(k)[0] for k in keys], c.bytes, c.evictions,
                c.entries)

    assert script("port") == script("jax")


def test_page_payload_split_and_release_match_jax():
    """Eviction releases pages, and a split drops the straddled page,
    as in JAX."""
    def script(pkg):
        P, Trie = (JaxPages, JaxTrie) if pkg == "jax" else \
            (PagePayload, RadixPrefixCache)
        released = []

        def mk(a, b):
            return P(a, b - a, {j: j for j in range(-(-a // 8), b // 8)},
                     8, 100, released.extend)

        c = Trie(capacity_bytes=0)
        c.insert(np.arange(16, dtype=np.int32), mk)
        first = (c.entries, list(released))
        pp = P(0, 20, {0: 7, 1: 9}, 8, 100, released.extend)
        left, right = pp.split(12)
        return (first, left.pages, right.pages, list(released),
                pp.usable_pages(15), pp.usable_pages(16))

    assert script("port") == script("jax")


def test_host_tier_is_refused():
    """A negative host budget is refused, as in JAX; the host tier itself
    is ported (``tests/test_torch_tiered_cache.py``): 0 is one tier,
    None and a positive budget turn it on."""
    for Trie in (JaxTrie, RadixPrefixCache):
        with pytest.raises(ValueError, match="host_capacity_bytes"):
            Trie(host_capacity_bytes=-1)
        assert not Trie(host_capacity_bytes=0).host_tier_enabled
        assert Trie(host_capacity_bytes=None).host_tier_enabled
        assert Trie(host_capacity_bytes=1 << 20).host_tier_enabled


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _shared_prompts(n, shared_len=24, tail=4, seed=0):
    """The JAX test's shared-prefix load: n prompts of a common prefix
    plus a random tail, and the pure prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 128, (shared_len,)).astype(np.int32)
    ps = [np.concatenate([shared,
                          rng.integers(1, 128, (tail,)).astype(np.int32)])
          for _ in range(n)]
    ps.append(shared.copy())
    return ps


def _serve(eng, prompts, max_new=6, steps_per_sync=4):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    out = eng.run(steps_per_sync=steps_per_sync)
    for r in rids:
        assert eng.request(r).status == RequestStatus.DONE
    return {"streams": [out[r] for r in rids],
            "hits": [eng.request(r).prefix_hit for r in rids]}


_TRIE_KEYS = ("bytes", "entries", "hits", "misses", "hit_tokens",
              "extended_tokens", "evictions")


def _observe(eng, res):
    """What a case compares: streams, per-request hits, trie stats and,
    paged, the page refcounts and free pages."""
    st = eng.metrics()["prefix_cache"]
    res["trie"] = {k: st[k] for k in _TRIE_KEYS}
    if hasattr(eng, "_page_rc"):
        res["page_rc"] = np.asarray(eng._page_rc).tolist()
        res["free"] = eng.free_blocks
    return res


def _lru_budget(cfg):
    # about one 10-token span of the model's K/V (the JAX test's budget)
    return 10 * 2 * cfg.num_layers * cfg.hidden_size * 4


# (engine family, prompts, budget, max_batch) of each engine case
_CASES = {
    "hit_partial_miss": ("contiguous", lambda: _shared_prompts(3), BIG, 2),
    "lru": ("contiguous", lambda: _shared_prompts(4, 20, 6), "lru", 2),
    "paged_parity": ("paged", lambda: _shared_prompts(3), BIG, 2),
    "paged_lru": ("paged", lambda: _shared_prompts(4, 20, 6), 300, 2),
}


def _engine(pkg, models, family, budget, max_batch, **kw):
    jcfg, jp, tcfg, tp = models["target"]
    if budget == "lru":
        budget = _lru_budget(tcfg)
    paged = family == "paged"
    if pkg == "jax":
        E = JaxPaged if paged else JaxEngine
        return E(jp, jcfg, max_batch=max_batch, max_len=64,
                 prefix_cache_bytes=budget, **(_PAGED if paged else {}),
                 **kw)
    E = PagedContinuousBatchingEngine if paged else ContinuousBatchingEngine
    return E(tp, tcfg, max_batch=max_batch, max_len=64,
             prefix_cache_bytes=budget, device="cpu",
             **(_PAGED if paged else {}), **kw)


def _two_turns(eng, prompt):
    """The same prompt twice (the second a full hit), then the page
    state between and after."""
    a = _serve(eng, [prompt], max_new=4)
    between = _observe(eng, {})
    b = _serve(eng, [prompt], max_new=4)
    return {"first": a, "between": between, "second": _observe(eng, b)}


@pytest.fixture(scope="module")
def jax_runs(models):
    """Every engine case on JAX's warm engines, once for the module."""
    out = {}
    for name, (family, prompts, budget, mb) in _CASES.items():
        eng = _engine("jax", models, family, budget, mb)
        out[name] = _observe(eng, _serve(eng, prompts()))
    p = np.arange(1, 34, dtype=np.int32)
    for family in ("contiguous", "paged"):
        out["resubmit_" + family] = _two_turns(
            _engine("jax", models, family, BIG, 1), p)
    out["paged_below_a_page"] = _two_turns(
        _engine("jax", models, "paged", 1, 1), p)
    return out


@pytest.mark.parametrize("case,attn_kernel", [
    ("hit_partial_miss", "flash"), ("hit_partial_miss", "xla"),
    ("lru", "flash"), ("paged_parity", "flash"), ("paged_parity", "xla"),
    ("paged_lru", "flash")])
def test_engine_prefix_matches_jax_and_the_cold_engine(models, jax_runs,
                                                       case, attn_kernel):
    """Hit, partial-hit and miss streams equal the cold port engine's and
    JAX's warm engine's; hits, trie counters (evictions included) and,
    paged, every page's refcount and the free pages equal JAX's."""
    family, prompts, budget, mb = _CASES[case]
    eng = _engine("port", models, family, budget, mb,
                  attn_kernel=attn_kernel)
    got = _observe(eng, _serve(eng, prompts()))
    assert got == jax_runs[case]
    cold = _engine("port", models, family, 0, mb, attn_kernel=attn_kernel)
    assert _serve(cold, prompts())["streams"] == got["streams"]
    assert "prefix_cache" not in cold.metrics()
    if budget == BIG:
        assert any(got["hits"]) and got["trie"]["hit_tokens"] > 0
    else:
        assert got["trie"]["evictions"] > 0
    m = eng.metrics()
    assert m["prefix_hit_tokens"] == sum(got["hits"])
    assert m["prefix_evictions"] == got["trie"]["evictions"]
    if budget == "lru":
        assert got["trie"]["bytes"] <= _lru_budget(models["target"][2])
    if family == "paged":
        rc = np.asarray(eng._page_rc)
        assert eng.free_blocks + int((rc > 0).sum()) == eng.num_blocks


@pytest.mark.parametrize("family", ["contiguous", "paged"])
def test_full_hit_resubmit_matches_jax(models, jax_runs, family):
    """A resubmitted prompt is a full hit (paged: every page of
    prompt[:32] shared) with the first turn's tokens; the pages the
    cache pins survive the slot's retirement and are shared, never
    copied, by the second turn."""
    got = _two_turns(_engine("port", models, family, BIG, 1),
                     np.arange(1, 34, dtype=np.int32))
    assert got == jax_runs["resubmit_" + family]
    assert got["second"]["streams"] == got["first"]["streams"]
    assert got["second"]["hits"] == [32]
    if family == "paged":
        pinned = sum(rc > 0 for rc in got["between"]["page_rc"])
        assert pinned == 4
        assert got["between"]["free"] == _PAGED["num_blocks"] - pinned
        assert got["second"]["free"] == got["between"]["free"]


def test_paged_budget_below_a_page_returns_every_page(models, jax_runs):
    got = _two_turns(_engine("port", models, "paged", 1, 1),
                     np.arange(1, 34, dtype=np.int32))
    assert got == jax_runs["paged_below_a_page"]
    assert got["second"]["trie"]["evictions"] > 0
    assert got["second"]["free"] == _PAGED["num_blocks"]


def test_paged_reset_flushes_the_cache_before_the_pool(models):
    """A pool rebuild drops every cached span first: their page ids
    would point into the old pool."""
    eng = _engine("port", models, "paged", BIG, 1)
    _serve(eng, [np.arange(1, 34, dtype=np.int32)], max_new=4)
    assert eng.metrics()["prefix_cache"]["entries"] > 0
    assert eng.free_blocks < eng.num_blocks
    eng._reset_cache()
    st = eng.metrics()["prefix_cache"]
    assert st["entries"] == 0 and st["bytes"] == 0
    assert eng.free_blocks == eng.num_blocks
    assert not np.asarray(eng._page_rc).any()


def test_fused_engine_prefix_matches_jax(models):
    """FusedB1Engine with the prefix cache on JAX's fused engine with
    it: a miss, a partial hit and a full hit give JAX's streams and the
    cold engine's, with JAX's hits and trie counters."""
    jcfg, jq, tcfg, tq = models["fused"]
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 128, (12,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 128, (5,))
                               .astype(np.int32)]),
               np.concatenate([shared, rng.integers(1, 128, (3,))
                               .astype(np.int32)]),
               shared.copy()]
    jeng = JaxFused(jq, jcfg, max_len=64, prefix_cache_bytes=BIG)
    want = _observe(jeng, _serve(jeng, prompts, max_new=8))
    eng = FusedB1Engine(tq, tcfg, max_len=64, prefix_cache_bytes=BIG,
                        device="cpu")
    got = _observe(eng, _serve(eng, prompts, max_new=8))
    assert got == want
    assert got["hits"][1] > 0 and got["hits"][2] > 0
    cold = FusedB1Engine(tq, tcfg, max_len=64, device="cpu")
    assert _serve(cold, prompts, max_new=8)["streams"] == got["streams"]
    assert eng.metrics()["launches"]["prefix"] >= 2


# ---------------------------------------------------------------------------
# tests/test_speculative.py::TestPrefixExtension
# ---------------------------------------------------------------------------

_SPEC_REQS = ((5, 9), (16, 4), (9, 12), (3, 5))


def _spec_prompts(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, (n,)).astype(np.int32), m)
            for n, m in _SPEC_REQS]


def _serve_reqs(eng, reqs):
    rids = [eng.submit(p, max_new=m) for p, m in reqs]
    out = eng.run(steps_per_sync=8)
    return [out[r] for r in rids]


def _extension(eng_of, cold_of):
    eng = eng_of()
    p = np.arange(1, 17, dtype=np.int32)
    rid = eng.submit(p, max_new=6)
    toks = eng.run()[rid]
    extended = eng.metrics()["prefix_cache"]["extended_tokens"]
    p2 = np.concatenate([p, np.asarray(toks, np.int32),
                         np.asarray([5, 9], np.int32)])
    rid2 = eng.submit(p2, max_new=4)
    eng.run()
    cold = cold_of()
    crid = cold.submit(p2, max_new=4)
    return {"first": toks, "extended": extended,
            "hit": eng.request(rid2).prefix_hit,
            "second": eng.request(rid2).tokens, "cold": cold.run()[crid]}


def test_accepted_output_extends_trie(models):
    """DONE retirement inserts the emitted output; a follow-up request
    continuing the conversation skips past the generated span
    (prefix_hit > the first turn's prompt length), as in JAX."""
    jcfg, jp, tcfg, tp = models["target"]
    want = _extension(
        lambda: JaxEngine(jp, jcfg, max_batch=1, max_len=64,
                          speculative=True, prefix_cache_bytes=BIG),
        lambda: JaxEngine(jp, jcfg, max_batch=1, max_len=64))
    got = _extension(
        lambda: ContinuousBatchingEngine(tp, tcfg, max_batch=1, max_len=64,
                                         speculative=True,
                                         prefix_cache_bytes=BIG,
                                         device="cpu"),
        lambda: ContinuousBatchingEngine(tp, tcfg, max_batch=1, max_len=64,
                                         device="cpu"))
    assert got == want
    assert got["extended"] > 0
    assert got["hit"] >= 16 + len(got["first"]) - 1
    assert got["second"] == got["cold"]


def test_rejected_tokens_never_enter_trie(models):
    """A GPT draft (head dim 8, on the default "flash" engine) whose
    rounds reject suffixes: every stream, and every stream of the
    resubmission served off the extended trie, equals the cold engine's
    and JAX's."""
    jcfg, jp, tcfg, tp = models["target"]
    jdcfg, jdp, tdcfg, tdp = models["draft"]
    reqs = _spec_prompts(9)
    cold = _serve_reqs(JaxEngine(jp, jcfg, max_batch=2, max_len=64), reqs)
    jeng = JaxEngine(jp, jcfg, max_batch=2, max_len=64,
                     speculative=JaxSpec(k=3, draft_params=jdp,
                                         draft_cfg=jdcfg),
                     prefix_cache_bytes=BIG)
    jax_warm = (_serve_reqs(jeng, reqs), _serve_reqs(jeng, reqs))
    eng = ContinuousBatchingEngine(
        tp, tcfg, max_batch=2, max_len=64, device="cpu",
        speculative=SpeculativeConfig(k=3, draft_params=tdp,
                                      draft_cfg=tdcfg),
        prefix_cache_bytes=BIG)
    assert eng.attn_kernel == "flash"
    got = _serve_reqs(eng, reqs)
    assert got == cold
    assert eng.metrics()["speculative"]["rollbacks"] > 0
    got2 = _serve_reqs(eng, reqs)
    assert got2 == cold
    assert (got, got2) == jax_warm
    st = eng.metrics()["prefix_cache"]
    jst = jeng.metrics()["prefix_cache"]
    assert {k: st[k] for k in _TRIE_KEYS} == {k: jst[k] for k in _TRIE_KEYS}
