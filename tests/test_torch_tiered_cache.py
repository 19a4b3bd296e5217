"""Port parity: the prefix cache's host tier and the INSTALLING state.

Mirrors ``tests/test_tiered_cache.py`` case for case: ``TestTrieTiers``
(6), ``TestEngineParity`` (4) and ``TestInstallingLifecycle`` (10).  The
trie cases run the JAX test's operations through JAX's
``RadixPrefixCache`` and the port's side by side (the same values, numpy
payloads there and CPU tensors here) and compare ``stats()`` after every
operation.  The engine cases run the port's engines on the CPU, on JAX's
``init_params`` weights bridged by ``params_from_numpy``, and hold every
stream to JAX's greedy ``gpt.generate`` (the oracle, computed once per
prompt for the module), with the JAX test's own assertions on the tier
counters, the page refcounts and the request states.  The config is the
JAX test's (vocab 128, H 32, 2 layers, float32) at
``initializer_range=0.3``: the default 0.02 gives near-constant greedy
streams that would hide a wrong cache row.

Differences by design, asserted as such: JAX's registry histograms are
the port's summed ``prefix_tiers`` seconds; JAX's ``_cache_lost`` case
re-prefills after its donated cache died, where the port writes its
caches in place and runs the failed call again — the case holds the
same outcome (the streams, the host spans still in the trie, a reinstall
on the re-admission, no page leaked).  A paged demotion releases its
pages before the trie lets the payload go; the port subtracts the bytes
it charged at attach, JAX the payload's bytes after the release (0), so
JAX's device byte count keeps every demoted paged span
(``test_paged_demotion_returns_its_device_bytes``).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.prefix_cache import (
    HostPagePayload as JaxHostPages, KVSpanPayload as JaxSpan,
    PagePayload as JaxPages, RadixPrefixCache as JaxTrie)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference.prefix_cache import (HostPagePayload,
                                                     KVSpanPayload,
                                                     PagePayload,
                                                     RadixPrefixCache)
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                FusedB1Engine,
                                                PagedContinuousBatchingEngine,
                                                RequestStatus)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.testing.faults import inject_engine_faults

# below one 40-token shared span at this config's 512 B a token: every
# insert demotes the shared prefix to the host tier
TINY_DEVICE_BUDGET = 8_000
HOST_BUDGET = 1 << 26


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny products: one intra-op thread keeps the port's engines from
    contending with the other test workers; restored after."""
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


@functools.lru_cache(maxsize=None)
def _models():
    jcfg, tcfg = _cfgs()
    jp = jgpt.init_params(jcfg, seed=0)
    tp = tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return jcfg, jp, tcfg, tp


@functools.lru_cache(maxsize=None)
def _prompts():
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 128, (40,)).astype(np.int32)
    return tuple(np.concatenate([
        shared, rng.integers(1, 128, (8,)).astype(np.int32)])
        for _ in range(6))


@functools.lru_cache(maxsize=None)
def _oracle(i: int, max_new: int):
    """JAX's greedy ``generate`` of prompt i: the streams' oracle."""
    jcfg, jp, _, _ = _models()
    out = jgpt.generate(jp, np.asarray(_prompts()[i], "i4")[None], jcfg,
                        max_new_tokens=max_new, temperature=0.0)
    return [int(t) for t in np.asarray(out)[0]]


@pytest.fixture(scope="module")
def setup():
    _, _, tcfg, tp = _models()
    return tcfg, tp


@pytest.fixture(scope="module")
def prompts():
    return list(_prompts())


# ---------------------------------------------------------------------------
# TestTrieTiers: the JAX trie and the port's on the same operations
# ---------------------------------------------------------------------------

def _mk(pkg):
    """The JAX test's ``_mk_span`` (a span's values are its positions) in
    either package's arrays."""
    def mk(a, b):
        arr = np.arange(a, b, dtype=np.float32)[None]
        if pkg == "jax":
            return JaxSpan(arr, arr.copy())
        t = torch.from_numpy(arr)
        return KVSpanPayload(t, t.clone())
    return mk


def _run_both(script):
    """Run ``script(pkg, Trie, mk, seen)`` for both packages; the
    observations (stats after every operation, matches, tiers) must be
    equal."""
    out = {}
    for pkg, Trie in (("jax", JaxTrie), ("port", RadixPrefixCache)):
        seen = []
        script(pkg, Trie, _mk(pkg), seen)
        out[pkg] = seen
    assert out["port"] == out["jax"]
    return out["port"]


def _observe(c, seen, *extra):
    seen.append((c.stats(), *extra))


class TestTrieTiers:
    def test_device_host_gone_cascade(self):
        def script(pkg, Trie, mk, seen):
            # each 10-token span charges 80 bytes; the device holds one,
            # the host two: the third demotion evicts the host's LRU
            c = Trie(capacity_bytes=100, host_capacity_bytes=170)
            keys = [np.arange(b, b + 10, dtype=np.int32)
                    for b in (0, 100, 200, 300)]
            c.insert(keys[0], mk)
            _observe(c, seen)
            c.insert(keys[1], mk)          # k0 demotes
            _observe(c, seen)
            assert c.demotions == 1 and c.host_entries == 1
            assert c.bytes <= 100 and c.host_bytes == 80
            length, spans = c.match(keys[0])
            _observe(c, seen, length, [p.tier for p, _ in spans])
            assert length == 10 and spans[0][0].tier == "host"
            assert c.host_hits == 1 and c.host_hit_tokens == 10
            c.insert(keys[2], mk)          # k1 demotes
            _observe(c, seen)
            c.insert(keys[3], mk)          # k2 demotes; the host is over
            _observe(c, seen)
            assert c.demotions == 3
            assert c.host_evictions == 1 and c.host_bytes <= 170
            assert c.match(keys[1])[0] == 0
            assert c.match(keys[0])[0] == 10
            _observe(c, seen, c.probe(keys[0]))

        _run_both(script)

    def test_single_tier_budget_still_drops(self):
        def script(pkg, Trie, mk, seen):
            c = Trie(capacity_bytes=100)
            c.insert(np.arange(10, dtype=np.int32), mk)
            c.insert(np.arange(50, 60, dtype=np.int32), mk)
            _observe(c, seen)
            assert c.demotions == 0 and c.host_entries == 0
            assert c.evictions == 1

        _run_both(script)

    def test_failed_demotion_degrades_to_drop(self):
        def bad_demoter(payload):
            raise OSError("injected demote failure")

        def script(pkg, Trie, mk, seen):
            c = Trie(capacity_bytes=100, host_capacity_bytes=None,
                     demoter=bad_demoter)
            c.insert(np.arange(10, dtype=np.int32), mk)
            c.insert(np.arange(50, 60, dtype=np.int32), mk)
            _observe(c, seen)
            assert c.bytes <= 100
            assert c.demotions == 0 and c.evictions == 1

        _run_both(script)

    def test_promote_swaps_tier_in_place(self):
        def script(pkg, Trie, mk, seen):
            c = Trie(capacity_bytes=100, host_capacity_bytes=None)
            key = np.arange(10, dtype=np.int32)
            c.insert(key, mk)
            c.insert(np.arange(50, 60, dtype=np.int32), mk)
            _observe(c, seen)
            host = [p for p, _ in c.match(key)[1] if p.tier == "host"][0]
            if pkg == "jax":
                dev = JaxSpan(host.k.copy(), host.v.copy())
            else:
                dev = KVSpanPayload(host.k.clone(), host.v.clone())
            assert c.promote(host, dev)
            _observe(c, seen)
            assert c.promotions == 1
            assert [p.tier for p, _ in c.match(key)[1]] == ["device"]
            # a payload whose node was dropped since fails soft
            c.clear()
            assert not c.promote(host, dev)
            _observe(c, seen)

        _run_both(script)

    def test_drop_device_entries_keeps_host_tier(self):
        def script(pkg, Trie, mk, seen):
            c = Trie(capacity_bytes=100, host_capacity_bytes=None)
            k_host = np.arange(10, dtype=np.int32)
            k_dev = np.arange(50, 60, dtype=np.int32)
            c.insert(k_host, mk)
            c.insert(k_dev, mk)            # k_host demoted
            c.drop_device_entries()        # the dead-pool path
            _observe(c, seen)
            assert c.match(k_dev)[0] == 0
            assert c.match(k_host)[0] == 10
            assert c.host_entries == c.entries == 1
            _observe(c, seen)

        _run_both(script)

    def test_host_page_payload_split_drops_straddled(self):
        got = {}
        for pkg, P in (("jax", JaxHostPages), ("port", HostPagePayload)):
            k = np.arange(3 * 8 * 2 * 4, dtype=np.float32).reshape(
                1, 3, 8, 2, 4)
            if pkg == "port":
                k = torch.from_numpy(k)
            p = P(0, 24, {0: 0, 1: 1, 2: 2}, 8, k, k.clone()
                  if pkg == "port" else k.copy())
            left, right = p.split(12)      # cuts inside page 1
            assert set(left.pages) == {0} and set(right.pages) == {2}
            assert left.usable_pages(12) == {0: 0}
            got[pkg] = (left.pages, right.pages, left.nbytes, right.nbytes,
                        np.asarray(right.k).tolist())
        assert got["port"] == got["jax"]


def test_export_spans_matches_jax():
    """``export_spans`` lists the same (key, a, b) records, parents
    first, over a split and two tiers."""
    def script(pkg, Trie, mk, seen):
        c = Trie(capacity_bytes=200, host_capacity_bytes=None)
        a = np.arange(100, 120, dtype=np.int32)
        c.insert(a, mk)
        c.insert(np.concatenate([a[:8], np.arange(7, 12, dtype=np.int32)]),
                 mk)
        c.insert(np.arange(300, 310, dtype=np.int32), mk)
        seen.append([(k.tolist(), x, y, p.tier, p.nbytes)
                     for k, x, y, p in c.export_spans()])
        _observe(c, seen)

    assert _run_both(script)[0]


def test_paged_demotion_returns_its_device_bytes():
    """A demoted paged span gives its device bytes back (the port counts
    the bytes charged at attach): one demotion brings two 2-page spans
    under a 2.5-page budget.  JAX subtracts the released payload's 0, so
    its device count keeps the span, stays over the budget and demotes
    the second span too (the one difference)."""
    def script(P, Trie, zeros):
        released = []

        def mk(a, b):
            return P(a, b - a, {j: j for j in range(-(-a // 8), b // 8)}, 8,
                     100, released.extend, gather_cb=lambda pids: (
                         zeros((1, len(pids), 8)), zeros((1, len(pids), 8))))
        c = Trie(capacity_bytes=250, host_capacity_bytes=None)
        c.insert(np.arange(16, dtype=np.int32), mk)        # 2 pages
        c.insert(np.arange(50, 66, dtype=np.int32), mk)    # over: demote
        return c.bytes, c.demotions, c.host_entries, released

    assert script(PagePayload, RadixPrefixCache, torch.zeros) == \
        (200, 1, 1, [0, 1])
    assert script(JaxPages, JaxTrie, np.zeros) == (400, 2, 2, [0, 1, 0, 1])


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _warm_engine(kind, cfg, params, **kw):
    if kind == "paged":
        return PagedContinuousBatchingEngine(
            params, cfg, max_batch=2, max_len=80, block_size=8,
            num_blocks=24, prefix_cache_bytes=TINY_DEVICE_BUDGET,
            prefix_host_bytes=HOST_BUDGET, device="cpu", **kw)
    return ContinuousBatchingEngine(
        params, cfg, max_batch=2, max_len=80,
        prefix_cache_bytes=TINY_DEVICE_BUDGET,
        prefix_host_bytes=HOST_BUDGET, device="cpu", **kw)


class TestEngineParity:
    @pytest.mark.parametrize("kind", ["contiguous", "paged"])
    def test_host_hit_parity_with_cold_engine(self, setup, prompts, kind):
        cfg, params = setup
        eng = _warm_engine(kind, cfg, params)
        rids = [eng.submit(p, max_new=8) for p in prompts]
        results = eng.run(steps_per_sync=4)
        for i, rid in enumerate(rids):
            assert results[rid] == _oracle(i, 8)
        tiers = eng.metrics()["prefix_tiers"]
        assert tiers["demotions"] > 0, "undersized budget never demoted"
        assert tiers["reinstalls"] > 0, "host tier never reinstalled"
        assert tiers["host_hit_tokens"] > 0
        assert eng._installing == []

    def test_fused_host_hit_parity(self, prompts):
        jcfg, tcfg = _cfgs(num_layers=1, max_position_embeddings=64,
                           dtype="bfloat16")
        jq = jgpt.quantize_decode_params(jgpt.init_params(jcfg, seed=0),
                                         jcfg)
        qp = tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jq),
                                    device="cpu")
        eng = FusedB1Engine(qp, tcfg, max_len=64, prefix_cache_bytes=4_000,
                            prefix_host_bytes=HOST_BUDGET, device="cpu")
        cold = FusedB1Engine(qp, tcfg, max_len=64, prefix_cache_bytes=0,
                             device="cpu")
        for p in [pr[:34] for pr in prompts[:3]]:
            rid = eng.submit(p, max_new=6)
            got = eng.run(steps_per_sync=2)[rid]
            crid = cold.submit(p, max_new=6)
            assert got == cold.run(steps_per_sync=2)[crid]
        assert eng._tier_stats["reinstalls"] > 0

    def test_paged_refcounts_across_demote_promote(self, setup, prompts):
        cfg, params = setup
        eng = _warm_engine("paged", cfg, params)
        rids = [eng.submit(p, max_new=8) for p in prompts]
        eng.run(steps_per_sync=4)
        assert all(eng.status(r) == RequestStatus.DONE for r in rids)
        # every slot retired: pages are held only by trie pins
        rc = eng._page_rc
        assert eng.free_blocks + int((rc > 0).sum()) == eng.num_blocks
        tiers = eng.metrics()["prefix_tiers"]
        assert tiers["demotions"] > 0 and tiers["reinstalls"] > 0
        # demoted spans released their pins, promotions pinned fresh
        # pages: dropping the trie frees ALL
        eng._prefix.clear()
        assert int((eng._page_rc > 0).sum()) == 0
        assert eng.free_blocks == eng.num_blocks

    def test_prefill_budget_bounds_admissions(self, setup, prompts):
        cfg, params = setup
        eng = ContinuousBatchingEngine(params, cfg, max_batch=4, max_len=80,
                                       prefix_cache_bytes=0,
                                       prefill_budget=60, device="cpu")
        rids = [eng.submit(p, max_new=4) for p in prompts[:4]]
        eng.step(1)
        # one 48-token prompt fits the 60-token budget of a round; the
        # second would exceed it
        assert eng.active_slots <= 2
        results = eng.run(steps_per_sync=4)
        for i, rid in enumerate(rids):
            assert results[rid] == _oracle(i, 4)


class TestInstallingLifecycle:
    def _warmed(self, setup, prompts, **kw):
        cfg, params = setup
        eng = ContinuousBatchingEngine(
            params, cfg, max_batch=2, max_len=80,
            prefix_cache_bytes=TINY_DEVICE_BUDGET,
            prefix_host_bytes=HOST_BUDGET, device="cpu", **kw)
        eng.submit(prompts[0], max_new=4)
        eng.run(steps_per_sync=4)        # the host tier holds the span
        assert eng._prefix.host_entries > 0
        return cfg, params, eng

    def test_decode_progresses_while_install_in_flight(self, setup,
                                                       prompts):
        cfg, params, eng = self._warmed(setup, prompts)
        ra = eng.submit(prompts[1], max_new=24)
        for _ in range(8):
            if eng.status(ra) == RequestStatus.RUNNING:
                break
            eng.step(4)
        with inject_engine_faults(eng, defer_ready=3) as inj:
            rb = eng.submit(prompts[2], max_new=8)
            before = len(eng.request(ra).tokens)
            eng.step(1)
            assert eng.status(rb) == RequestStatus.INSTALLING
            eng.step(1)
            # the decode rounds advanced A while B's copy was deferred
            assert len(eng.request(ra).tokens) > before
            results = eng.run(steps_per_sync=4)
        assert inj.deferred == 3
        assert results[ra] == _oracle(1, 24)
        assert results[rb] == _oracle(2, 8)
        tiers = eng.metrics()["prefix_tiers"]
        # JAX's reinstall_seconds / reinstall_decode_overlap_seconds
        # histograms: the port's sums
        assert tiers["reinstalls"] >= 1 and tiers["reinstall_seconds"] > 0
        assert tiers["reinstall_decode_overlap_seconds"] > 0

    def test_transient_reinstall_failure_falls_back_to_prefill(
            self, setup, prompts):
        cfg, params, eng = self._warmed(setup, prompts)
        with inject_engine_faults(eng, fail_always=True,
                                  kinds=("reinstall",)) as inj:
            rid = eng.submit(prompts[1], max_new=8)
            results = eng.run(steps_per_sync=4)
        assert inj.injected["reinstall"] >= 1
        # a tier fault never fails the request: it re-prefills
        assert eng.status(rid) == RequestStatus.DONE
        assert results[rid] == _oracle(1, 8)
        assert eng._tier_stats["reinstall_failures"] >= 1
        assert eng._tier_stats["reinstalls"] == 0

    def test_reinstall_failure_below_retry_budget_absorbed(
            self, setup, prompts):
        cfg, params, eng = self._warmed(setup, prompts)
        with inject_engine_faults(eng, fail_times=1,
                                  kinds=("reinstall",)) as inj:
            rid = eng.submit(prompts[1], max_new=8)
            results = eng.run(steps_per_sync=4)
        assert inj.injected["reinstall"] == 1
        assert results[rid] == _oracle(1, 8)
        assert eng._tier_stats["reinstall_failures"] == 0
        assert eng._tier_stats["reinstalls"] >= 1

    def test_demote_failure_degrades_to_plain_eviction(self, setup,
                                                       prompts):
        cfg, params = setup
        eng = ContinuousBatchingEngine(
            params, cfg, max_batch=2, max_len=80,
            prefix_cache_bytes=TINY_DEVICE_BUDGET,
            prefix_host_bytes=HOST_BUDGET, device="cpu")
        with inject_engine_faults(eng, fail_always=True, kinds=("demote",)):
            rid = eng.submit(prompts[0], max_new=8)
            results = eng.run(steps_per_sync=4)
        assert results[rid] == _oracle(0, 8)
        assert eng._prefix.demotions == 0
        assert eng._prefix.evictions > 0

    def test_cancel_mid_install_releases_everything(self, setup, prompts):
        cfg, params = setup
        eng = PagedContinuousBatchingEngine(
            params, cfg, max_batch=2, max_len=80, block_size=8,
            num_blocks=24, prefix_cache_bytes=TINY_DEVICE_BUDGET,
            prefix_host_bytes=HOST_BUDGET, device="cpu")
        eng.submit(prompts[0], max_new=4)
        eng.run(steps_per_sync=4)
        free_before = eng.free_blocks
        with inject_engine_faults(eng, defer_ready=100):
            rid = eng.submit(prompts[1], max_new=8)
            eng.step(1)
            assert eng.status(rid) == RequestStatus.INSTALLING
            assert eng.cancel(rid)
        assert eng.status(rid) == RequestStatus.CANCELLED
        assert eng._installing == []
        assert eng.free_blocks == free_before   # no page leaked
        rc = eng._page_rc
        assert eng.free_blocks + int((rc > 0).sum()) == eng.num_blocks

    def test_ttl_expiry_mid_install(self, setup, prompts):
        cfg, params, eng = self._warmed(setup, prompts)
        with inject_engine_faults(eng, defer_ready=100):
            rid = eng.submit(prompts[1], max_new=8, ttl=0.0)
            eng.step(1)
            eng.step(1)
        assert eng.request(rid).status == RequestStatus.TIMEOUT
        assert eng._installing == []

    def test_install_timeout_falls_back_to_prefill(self, setup, prompts):
        cfg, params, eng = self._warmed(setup, prompts)
        eng.install_timeout = 0.0        # every pending poll times out
        with inject_engine_faults(eng, defer_ready=1):
            rid = eng.submit(prompts[1], max_new=8)
            results = eng.run(steps_per_sync=4)
        assert results[rid] == _oracle(1, 8)
        assert eng._tier_stats["reinstall_failures"] >= 1

    def test_cache_lost_falls_back_to_host_tier(self, setup, prompts):
        """JAX: a donated decode dies, the engine re-prefills and the
        host tier serves the replay.  The port runs the failed decode
        again on its in-place caches: the same streams, the host spans
        still in the trie, the re-admission reinstalled, no leak."""
        cfg, params = setup
        eng = PagedContinuousBatchingEngine(
            params, cfg, max_batch=2, max_len=80, block_size=8,
            num_blocks=24, prefix_cache_bytes=TINY_DEVICE_BUDGET,
            prefix_host_bytes=HOST_BUDGET, device="cpu")
        eng.submit(prompts[0], max_new=4)
        eng.run(steps_per_sync=4)
        assert eng._prefix.host_entries > 0
        reinstalls_before = eng._tier_stats["reinstalls"]
        with inject_engine_faults(eng, fail_after_times=1,
                                  kinds=("decode",)) as inj:
            rid = eng.submit(prompts[1], max_new=8)
            results = eng.run(steps_per_sync=4)
        assert inj.injected == {"decode": 1}
        assert eng.status(rid) == RequestStatus.DONE
        assert results[rid] == _oracle(1, 8)
        assert eng._prefix.host_entries > 0
        assert eng._tier_stats["reinstalls"] > reinstalls_before
        assert eng.metrics()["retries"] == {"decode": 1}
        rc = eng._page_rc
        assert eng.free_blocks + int((rc > 0).sum()) == eng.num_blocks

    def test_drain_finishes_installing_requests(self, setup, prompts):
        cfg, params, eng = self._warmed(setup, prompts)
        with inject_engine_faults(eng, defer_ready=2):
            rid = eng.submit(prompts[1], max_new=8)
            eng.step(1)
            assert eng.status(rid) == RequestStatus.INSTALLING
            done = eng.drain(timeout=30.0)
        assert done[rid].status == RequestStatus.DONE
        assert done[rid].tokens == _oracle(1, 8)

    def test_tier_metrics_block(self, setup, prompts):
        cfg, params, eng = self._warmed(setup, prompts)
        rid = eng.submit(prompts[1], max_new=4)
        eng.run(steps_per_sync=4)
        tiers = eng.metrics()["prefix_tiers"]
        for key in ("device_bytes", "host_bytes", "host_entries",
                    "demotions", "promotions", "host_evictions",
                    "host_hits", "host_hit_tokens", "installing",
                    "reinstalls", "reinstall_failures", "reinstall_seconds",
                    "reinstall_decode_overlap_seconds"):
            assert key in tiers, key
        assert tiers["installing"] == 0
        assert eng.request(rid).prefix_host_hit > 0
        # JAX's prefix_host_hits counter: the trie's always-live count
        assert tiers["host_hits"] > 0
        assert tiers["reinstall_bytes"] > 0 and tiers["demote_bytes"] > 0
