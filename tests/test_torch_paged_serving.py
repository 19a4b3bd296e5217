"""Port parity: paged and quantized KV serving in paddle_tpu_torch against
paddle_tpu.

Model steps: ``decode_step_paged`` against JAX's and against the port's
own ``decode_step_multi`` on the same sequence state, and
``prefill_paged_batched`` pools against JAX's, under both attention
knobs and the three ``kv_dtype`` values, at rtol = atol = 2e-5 (float32,
another reduction order; the tolerance of
``tests/test_paged_serving.py``).  A write whose page is -1 must drop.

Engines: greedy token streams of ``PagedContinuousBatchingEngine``
(block sizes 16 and 8) and ``ContinuousBatchingEngine`` must be
IDENTICAL to the JAX engines' for every knob pair, under the staggered
mixed-length drive of ``tests/test_paged_serving.py``.  The model is the
tiny serving-test GPT (vocab 128, H 32, 2 layers, 2 heads, float32)
with weights drawn at ``initializer_range`` 0.3 instead of 0.02, so the
streams vary token to token and the fp8 cache changes them — a stream
that repeats one token would hide a broken cache.  Then the engine
cases of ``tests/test_paged_serving.py`` and the livelock guard.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.serving import (
    ContinuousBatchingEngine as JaxEngine,
    PagedContinuousBatchingEngine as JaxPagedEngine)
from paddle_tpu.incubate.nn import kv_quant as jkvq
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.incubate.nn import kv_quant as tkvq
from paddle_tpu_torch.incubate.nn.kernels import flash_decode as tfd
from paddle_tpu_torch.inference.serving import (
    ContinuousBatchingEngine, PagedContinuousBatchingEngine, RequestStatus)
from paddle_tpu_torch.models import gpt as tgpt

TOL = dict(rtol=2e-5, atol=2e-5)
KV_DTYPES = ("bf16", "int8", "fp8")


@pytest.fixture(scope="module")
def models():
    common = dict(vocab_size=128, hidden_size=32, num_layers=2,
                  num_heads=2, max_position_embeddings=128,
                  initializer_range=0.3, use_flash=False)
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, unroll_layers=False, **common)
    tcfg = tgpt.GPTConfig(dtype=torch.float32, **common)
    jp = jgpt.init_params(jcfg, seed=0)
    tp = tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return jcfg, jp, tcfg, tp


def _np_pool(c):
    """A JAX cache component as numpy float32 (dequantized when
    quantized) — the comparison basis for pools."""
    return np.asarray(jkvq.dequantize_kv(c))


def _t_pool(c):
    return tkvq.dequantize_kv(c).numpy()


def _pools(cache):
    if "ks" in cache:
        return {"k": (cache["k"], cache["ks"]), "v": (cache["v"], cache["vs"])}
    return {"k": cache["k"], "v": cache["v"]}


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------

def _paged_state(models, kd, B=3, S=24, bs=8, nb=16, max_len=64):
    """The same sequences prefilled into a contiguous cache and, page by
    page, into pools, in both packages.  Slots 0 and 1 hold S tokens;
    slot 2 is inactive (an all -1 table, fed at max_len - 1)."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 128, (B, S)).astype(np.int32)
    tables = np.full((B, max_len // bs), -1, np.int32)
    order = rng.permutation(nb)
    nblk = S // bs
    st = {"ids": ids, "tables": tables}
    jcache = jgpt.init_decode_cache(jcfg, B, max_len, kv_dtype=kd)
    _, st["jcache"], _ = jgpt.prefill(jp, jnp.asarray(ids), jcfg, jcache)
    st["tcache"] = tgpt.init_decode_cache(tcfg, B, max_len, kd,
                                          device="cpu")
    tgpt.prefill(tp, torch.from_numpy(ids), tcfg, st["tcache"])
    jpools = jgpt.init_decode_cache(jcfg, nb, bs, kv_dtype=kd)
    st["tpools"] = tgpt.init_decode_cache(tcfg, nb, bs, kd, device="cpu")
    for b in range(B - 1):
        pages = order[b * nblk:(b + 1) * nblk].astype(np.int32)
        tables[b, :nblk] = pages
        _, jpools = jgpt.prefill_paged(jp, jnp.asarray(ids[b]), jcfg,
                                       jpools, jnp.asarray(pages))
        _, st["tpools"] = tgpt.prefill_paged(
            tp, torch.from_numpy(ids[b]), tcfg, st["tpools"],
            torch.from_numpy(pages))
    st["jpools"] = jpools
    st["tok"] = ids[:, -1].copy()
    st["pos"] = np.array([S - 1, S - 1, max_len - 1], np.int32)
    return st


@pytest.fixture(scope="module")
def paged_states(models):
    """_paged_state per kv_dtype, built once; tests clone the port's
    tensors (its steps write in place; JAX's return new arrays)."""
    cache = {}

    def get(kd):
        if kd not in cache:
            cache[kd] = _paged_state(models, kd)
        st = dict(cache[kd])
        for key in ("tcache", "tpools"):
            st[key] = {n: a.clone() for n, a in st[key].items()}
        return st

    return get


@pytest.mark.parametrize("attn_kernel", ["xla", "flash"])
@pytest.mark.parametrize("kd", KV_DTYPES)
def test_decode_step_paged_matches_jax_and_contiguous(models, paged_states,
                                                      kd, attn_kernel):
    jcfg, jp, tcfg, tp = models
    st = paged_states(kd)
    for name in st["jpools"]:
        np.testing.assert_allclose(_t_pool(st["tpools"][name]),
                                   _np_pool(st["jpools"][name]), **TOL)
    tok, pos, tables = st["tok"], st["pos"], st["tables"]
    before = {n: tkvq.byte_view(a).clone() for n, a in st["tpools"].items()}
    jl, jpools = jgpt.decode_step_paged(
        jp, st["jpools"], jnp.asarray(tables), jnp.asarray(tok),
        jnp.asarray(pos), jcfg, attn_kernel=attn_kernel)
    tl, tpools = tgpt.decode_step_paged(
        tp, st["tpools"], torch.from_numpy(tables), torch.from_numpy(tok),
        torch.from_numpy(pos), tcfg, attn_kernel=attn_kernel)
    assert tpools is st["tpools"]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in jpools:
        np.testing.assert_allclose(_t_pool(tpools[name]),
                                   _np_pool(jpools[name]), **TOL)
    # only the two valid slots' rows changed: the inactive slot's write
    # (table all -1) dropped instead of landing in page 0
    bs = tpools["k"].shape[2]
    for name, a in tpools.items():
        diff = (tkvq.byte_view(a) != before[name]).flatten(3).any(-1)
        want = torch.zeros_like(diff)
        for b in range(2):
            want[:, tables[b, pos[b] // bs], pos[b] % bs] = True
        assert not (diff & ~want).any(), name
    # the contiguous step on the same state gives the same logits
    cl, _ = tgpt.decode_step_multi(
        tp, st["tcache"], torch.from_numpy(tok), torch.from_numpy(pos),
        tcfg, attn_kernel=attn_kernel)
    np.testing.assert_allclose(tl[:2].numpy(), cl[:2].numpy(), **TOL)


@pytest.mark.parametrize("page", [-1, 4, 9])
def test_paged_write_drops_with_no_valid_slot(models, page):
    """No slot's page is in the pool (-1, or an id past the 4 pages):
    every write drops, as JAX's ``mode="drop"`` scatter does, and the
    reads clamp into the pool as JAX's gather does."""
    jcfg, jp, tcfg, tp = models
    jpools = jgpt.init_decode_cache(jcfg, 4, 8, kv_dtype="int8")
    rng = np.random.default_rng(7)
    jpools = {n: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
              if n.endswith("s")
              else jnp.asarray(rng.integers(-5, 5, a.shape), a.dtype)
              for n, a in jpools.items()}
    pools = {n: torch.from_numpy(np.array(a)) for n, a in jpools.items()}
    before = {n: a.clone() for n, a in pools.items()}
    tables = np.full((2, 4), page, np.int32)
    tok = np.array([3, 4], np.int32)
    pos = np.array([5, 31], np.int32)
    jl, _ = jgpt.decode_step_paged(jp, jpools, jnp.asarray(tables),
                                   jnp.asarray(tok), jnp.asarray(pos), jcfg)
    tl, _ = tgpt.decode_step_paged(tp, pools, torch.from_numpy(tables),
                                   torch.from_numpy(tok),
                                   torch.from_numpy(pos), tcfg)
    for name in pools:
        assert torch.equal(pools[name], before[name])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("attn_kernel", ["xla", "flash"])
@pytest.mark.parametrize("kd", KV_DTYPES)
def test_prefill_paged_batched_matches_jax(models, kd, attn_kernel):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(3)
    N, S, bs, nb = 2, 32, 8, 12
    ids = rng.integers(1, 128, (N, S)).astype(np.int32)
    pages = rng.permutation(nb)[:N * S // bs].reshape(N, S // bs) \
        .astype(np.int32)
    jpools = jgpt.prefill_paged_batched(
        jp, jnp.asarray(ids), jcfg,
        jgpt.init_decode_cache(jcfg, nb, bs, kv_dtype=kd),
        jnp.asarray(pages), attn_kernel=attn_kernel)
    tpools = tgpt.init_decode_cache(tcfg, nb, bs, kd, device="cpu")
    out = tgpt.prefill_paged_batched(
        tp, torch.from_numpy(ids), tcfg, tpools, torch.from_numpy(pages),
        attn_kernel=attn_kernel)
    assert out is tpools
    assert sorted(tpools) == sorted(jpools)
    for name, c in _pools(tpools).items():
        np.testing.assert_allclose(_t_pool(c), _np_pool(_pools(jpools)[name]),
                                   **TOL)
    with pytest.raises(ValueError, match="multiple"):
        tgpt.prefill_paged_batched(tp, torch.from_numpy(ids[:, :30]), tcfg,
                                   tpools, torch.from_numpy(pages))


# ---------------------------------------------------------------------------
# engines: identical greedy streams
# ---------------------------------------------------------------------------

_LENS = (5, 23, 40, 9, 17, 31)
_BUDGETS = (12, 7, 20, 9, 15, 5)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 128, (n,)).astype(np.int32) for n in _LENS]


def _drive(eng, prompts=None, budgets=_BUDGETS, k_tokens=4, stagger_from=3):
    """Submit a few requests up front, the rest one per scheduler step
    (the drive of tests/test_paged_serving.py)."""
    prompts = _prompts() if prompts is None else prompts
    for p, b in zip(prompts[:stagger_from], budgets[:stagger_from]):
        eng.submit(p, max_new=b)
    out = {}
    k = stagger_from
    while eng._queue or eng.active_slots:
        for r in eng.step(k_tokens):
            out[r.rid] = list(r.tokens)
        if k < len(prompts):
            eng.submit(prompts[k], max_new=budgets[k])
            k += 1
    return out


def _engines(models, layout, attn_kernel, kd, **kw):
    jcfg, jp, tcfg, tp = models
    if layout == "contiguous":
        J, T = JaxEngine, ContinuousBatchingEngine
    else:
        J, T = JaxPagedEngine, PagedContinuousBatchingEngine
        kw["block_size"] = int(layout.split("_")[1])
    common = dict(max_batch=2, max_len=64, attn_kernel=attn_kernel,
                  kv_dtype=kd, **kw)
    return J(jp, jcfg, **common), T(tp, tcfg, device="cpu", **common)


@pytest.mark.parametrize("kd", KV_DTYPES)
@pytest.mark.parametrize("attn_kernel", ["xla", "flash"])
@pytest.mark.parametrize("layout", ["paged_16", "paged_8", "contiguous"])
def test_streams_identical_to_jax_engines(models, layout, attn_kernel, kd):
    jeng, teng = _engines(models, layout, attn_kernel, kd)
    want = _drive(jeng)
    got = _drive(teng)
    assert got == want
    assert all(teng.status(r) == RequestStatus.DONE for r in got)
    assert [len(got[r]) for r in sorted(got)] == list(_BUDGETS)
    if layout != "contiguous":
        assert teng.free_blocks == teng.num_blocks
        assert not teng._page_rc.any()
    # the greedy streams differ from token to token
    assert len({t for toks in got.values() for t in toks}) > 20


def test_paged_streams_identical_to_contiguous(models):
    _, _, tcfg, tp = models
    for kd in KV_DTYPES:
        want = _drive(ContinuousBatchingEngine(
            tp, tcfg, max_batch=2, max_len=64, kv_dtype=kd, device="cpu"))
        eng = PagedContinuousBatchingEngine(tp, tcfg, max_batch=2,
                                            max_len=64, block_size=16,
                                            kv_dtype=kd, device="cpu")
        assert _drive(eng) == want
        assert eng.free_blocks == eng.num_blocks


def test_fp8_cache_changes_the_stream(models):
    """The drive is sharp enough to see the storage format."""
    _, _, tcfg, tp = models
    out = {kd: _drive(ContinuousBatchingEngine(
        tp, tcfg, max_batch=2, max_len=64, kv_dtype=kd, attn_kernel="xla",
        device="cpu")) for kd in ("bf16", "fp8")}
    assert out["bf16"] != out["fp8"]


# ---------------------------------------------------------------------------
# engine cases of tests/test_paged_serving.py
# ---------------------------------------------------------------------------

def test_hbm_per_request_bound(models):
    """The default pool is half the contiguous allocation, and a
    9-token prompt with budget 5 claims exactly one 16-row page."""
    _, _, tcfg, tp = models
    for kd in KV_DTYPES:
        e1 = ContinuousBatchingEngine(tp, tcfg, max_batch=4, max_len=128,
                                      kv_dtype=kd, device="cpu")
        e2 = PagedContinuousBatchingEngine(tp, tcfg, max_batch=4,
                                           max_len=128, block_size=16,
                                           kv_dtype=kd, device="cpu")
        assert e2.cache_bytes() == e1.cache_bytes() // 2
    e2.submit(np.arange(1, 10, dtype=np.int32), max_new=5)
    e2._admit()
    assert e2.num_blocks - e2.free_blocks == 1


def test_page_exhaustion_defers_admission(models):
    """When the pool cannot back a new request, admission waits instead
    of corrupting live sequences; the streams equal the JAX engine's."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 128, (20,)).astype(np.int32)
               for _ in range(3)]
    outs = []
    for eng in (JaxPagedEngine(jp, jcfg, max_batch=4, max_len=64,
                               block_size=16, num_blocks=3),
                PagedContinuousBatchingEngine(tp, tcfg, max_batch=4,
                                              max_len=64, block_size=16,
                                              num_blocks=3, device="cpu")):
        rids = [eng.submit(p, max_new=8) for p in prompts]
        eng._admit()
        # each needs 2 pages for its bucket of 32: only one fits
        assert eng.active_slots == 1 and len(eng._queue) == 2
        out = eng.run(steps_per_sync=4)
        assert sorted(out) == sorted(rids)
        assert all(len(v) == 8 for v in out.values())
        assert eng.free_blocks == eng.num_blocks
        outs.append({r: list(out[r]) for r in rids})
    assert eng.metrics()["deferred_admissions"] >= 2
    assert outs[0] == outs[1]


def test_eviction_resumes_identically(models):
    """A slot stalled for pages is EVICTED (pages released, request
    re-queued with its sequence so far) and later resumed: the streams
    equal the contiguous engine's and the JAX paged engine's."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, (9,)).astype(np.int32)
               for _ in range(2)]
    budgets = (20, 20)
    ref = _drive(ContinuousBatchingEngine(tp, tcfg, max_batch=2, max_len=64,
                                          device="cpu"),
                 prompts, budgets, stagger_from=2)
    jax_out = _drive(JaxPagedEngine(jp, jcfg, max_batch=2, max_len=64,
                                    block_size=16, num_blocks=3),
                     prompts, budgets, stagger_from=2)
    e = PagedContinuousBatchingEngine(tp, tcfg, max_batch=2, max_len=64,
                                      block_size=16, num_blocks=3,
                                      device="cpu")
    evicted = []
    evict = e._evict
    e._evict = lambda slot: evicted.append(slot) or evict(slot)
    out = _drive(e, prompts, budgets, stagger_from=2)
    assert evicted, "the pool of 3 pages must force an eviction"
    assert e.metrics()["evictions"] == len(evicted)
    assert out == ref == jax_out
    assert e.free_blocks == e.num_blocks


def test_oversized_request_rejected_up_front(models):
    _, _, tcfg, tp = models
    e = PagedContinuousBatchingEngine(tp, tcfg, max_batch=2, max_len=64,
                                      block_size=16, num_blocks=2,
                                      device="cpu")
    with pytest.raises(ValueError, match="pages"):
        e.submit(np.arange(1, 30, dtype=np.int32), max_new=30)
    with pytest.raises(ValueError, match="block_size"):
        PagedContinuousBatchingEngine(tp, tcfg, max_batch=2, max_len=60,
                                      block_size=16, device="cpu")


def test_livelock_guard_retires_failed(models):
    """Pages held outside the slot (as a prefix cache pins them) leave
    the pool too small for the request's next token: it is evicted,
    cannot be re-admitted, and after max_stall_rounds fruitless rounds
    retires FAILED with the page diagnostic — run() terminates."""
    _, _, tcfg, tp = models
    e = PagedContinuousBatchingEngine(tp, tcfg, max_batch=2, max_len=64,
                                      block_size=16, num_blocks=4,
                                      max_stall_rounds=3, device="cpu")
    pinned = e._claim(3)
    rid = e.submit(np.arange(1, 10, dtype=np.int32), max_new=20)
    out = e.run(steps_per_sync=4)
    req = e.request(rid)
    assert req.status == RequestStatus.FAILED and rid in out
    assert "pages" in req.error and "pool" in req.error
    # it ran to the end of its page (positions 8..15) before stalling
    assert len(req.tokens) == 7
    assert e.metrics()["stalls"] == 3
    e._unref_pages(pinned)
    assert e.free_blocks == e.num_blocks


def test_cpu_engine_runs_plain_kernels(models):
    """On the CPU the flash engine's kernels run their plain versions:
    no launch is counted."""
    _, _, tcfg, tp = models
    tfd.reset_launches()
    _drive(PagedContinuousBatchingEngine(tp, tcfg, max_batch=2, max_len=64,
                                         block_size=16, kv_dtype="int8",
                                         device="cpu"))
    assert tfd.LAUNCHES == tfd.PAGED_LAUNCHES == 0
    assert not any(tfd.MODE_LAUNCHES.values())
