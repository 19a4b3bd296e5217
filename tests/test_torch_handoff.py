"""Port parity: the live engine handoff (drain, snapshot, restore).

Mirrors ``tests/test_handoff.py`` case for case: ``TestDrainHandoff``
(4), ``TestSnapshotRestore`` (9) and ``TestFaultSeams`` (9), with the
port's ``inference.handoff``, ``distributed.checkpoint`` and
``testing.faults``.  The engines run on the CPU on JAX's ``init_params``
weights (bridged by ``params_from_numpy``) and every carried stream is
held to JAX's greedy ``gpt.generate`` of its prompt (the oracle,
computed once per module), where the JAX test holds it to an
uninterrupted JAX engine.  The config is the JAX test's (vocab 128,
H 32, 2 layers, float32) at ``initializer_range=0.3``.  Then the span
digests: a port span record's SHA-256 equals JAX's ``_span_record``
digest for the same K/V in bf16, int8 and fp8 (the port writes bf16 as
its 16-bit words, fp8 as its bytes).  ``TestRollingRestart`` and
``TestTelemetry`` wait for the serving fleet's port (``testing/
cluster.py``, ``observability/``; ROADMAP Queue 1 item 9).
"""
import functools
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn import kv_quant as jkvq
from paddle_tpu.inference import handoff as jhandoff
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.distributed.checkpoint._io import get_io
from paddle_tpu_torch.distributed.checkpoint.manifest import (digest_bytes,
                                                              read_manifest,
                                                              write_manifest)
from paddle_tpu_torch.incubate.nn import kv_quant as tkvq
from paddle_tpu_torch.inference import handoff
from paddle_tpu_torch.inference.lifecycle import (EngineClosedError,
                                                  EngineState)
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                FusedB1Engine,
                                                PagedContinuousBatchingEngine,
                                                RequestStatus,
                                                _canonical_array)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.testing.faults import (FaultInjected,
                                             inject_engine_faults, inject_io)

MAX_LEN = 64


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


def _bridge(tree):
    return tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


@functools.lru_cache(maxsize=None)
def _models():
    jcfg, tcfg = _cfgs()
    jp = jgpt.init_params(jcfg, seed=0)
    return jcfg, jp, tcfg, _bridge(jp)


@functools.lru_cache(maxsize=None)
def _prompts():
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 128, (24,)).astype(np.int32)
    return tuple(np.concatenate([
        shared, rng.integers(1, 128, (6,)).astype(np.int32)])
        for _ in range(4))


@functools.lru_cache(maxsize=None)
def _oracle(i: int, max_new: int):
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


def _mk_contiguous(setup, **kw):
    cfg, params = setup
    base = dict(max_batch=2, max_len=MAX_LEN, prefix_cache_bytes=1 << 22,
                prefix_host_bytes=1 << 22, device="cpu")
    base.update(kw)
    return ContinuousBatchingEngine(params, cfg, **base)


def _mk_paged(setup, **kw):
    cfg, params = setup
    # a full pool and a BOUNDED device prefix budget (2 pages), so cached
    # spans demote instead of pinning the pool dry
    base = dict(max_batch=2, max_len=MAX_LEN, block_size=8, num_blocks=16,
                prefix_cache_bytes=1 << 14, prefix_host_bytes=1 << 22,
                device="cpu")
    base.update(kw)
    return PagedContinuousBatchingEngine(params, cfg, **base)


def _reference(max_new=8):
    """The uninterrupted streams: JAX's oracle of every prompt."""
    return {i: _oracle(i, max_new) for i in range(len(_prompts()))}


def _no_leaks(eng):
    """After a drain: no slot, install, page or refcount left over."""
    assert all(r is None for r in eng._slot_req)
    assert not eng._installing
    if hasattr(eng, "_page_rc"):
        if eng._prefix is not None:
            eng._prefix.clear()
        assert eng.free_blocks == eng.num_blocks
        assert int(eng._page_rc.sum()) == 0


def _mid_run(setup, prompts, make_old, max_new=8):
    """Submit everything on a fresh engine and stop mid-decode."""
    old = make_old(setup)
    rids = [old.submit(p, max_new=max_new, seed=i)
            for i, p in enumerate(prompts)]
    old.step(2)
    old.step(2)
    pre = {i: list(old.request(r).tokens) for i, r in enumerate(rids)}
    return old, rids, pre


def _finish(old, new, rep, rids):
    """Run the successor to the end; the final stream of each index."""
    new.run(4)
    out = {}
    for i, r in enumerate(rids):
        if old.request(r).status == RequestStatus.DONE:
            out[i] = list(old.request(r).tokens)
        else:
            out[i] = list(new.request(rep.rid_map.get(r, r)).tokens)
    return out


class TestDrainHandoff:
    def test_parks_requests_without_retiring(self, setup, prompts):
        old, rids, _ = _mid_run(setup, prompts, _mk_contiguous)
        live = [r for r in rids
                if old.request(r).status != RequestStatus.DONE]
        reqs = old.drain(mode="handoff")
        assert old.state == EngineState.STOPPED
        for r in live:
            assert reqs[r].status == RequestStatus.QUEUED
        assert all(s is None for s in old._slot_req)
        assert not old._installing
        with pytest.raises(EngineClosedError):
            old.submit(prompts[0], max_new=2)
        # idempotent: a second handoff drain changes nothing
        again = old.drain(mode="handoff")
        assert {r: q.status for r, q in again.items()} == \
            {r: q.status for r, q in reqs.items()}

    def test_bad_mode_rejected(self, setup, prompts):
        eng = _mk_contiguous(setup)
        with pytest.raises(ValueError):
            eng.drain(mode="hand-off")

    def test_retire_drain_resolves_installing(self, setup, prompts):
        """No install job outlives DRAINING: a stuck copy falls back to
        re-prefill inside the drain loop, and the request still reaches
        a terminal status."""
        eng = _mk_contiguous(setup, install_timeout=0.1)
        warm = eng.submit(prompts[0], max_new=2)
        eng.run(4)
        assert eng.status(warm) == RequestStatus.DONE
        # demote the cached prefix so that the next hit reinstalls
        eng._prefix.capacity_bytes = 0
        eng._prefix._evict_to_budget()
        assert eng._prefix.host_entries > 0
        with inject_engine_faults(eng, kinds=(), defer_ready=10 ** 6):
            rid = eng.submit(prompts[0], max_new=2)
            eng.step(2)      # begins the never-ready reinstall
            assert eng._installing
            eng.drain(timeout=5.0)
        assert not eng._installing
        assert eng.request(rid).terminal
        _no_leaks(eng)

    def test_handoff_drain_aborts_installing(self, setup, prompts):
        eng = _mk_contiguous(setup)
        warm = eng.submit(prompts[0], max_new=2)
        eng.run(4)
        assert eng.status(warm) == RequestStatus.DONE
        eng._prefix.capacity_bytes = 0
        eng._prefix._evict_to_budget()
        with inject_engine_faults(eng, kinds=(), defer_ready=10 ** 6):
            rid = eng.submit(prompts[0], max_new=2)
            eng.step(2)
            assert eng._installing
            eng.drain(mode="handoff")
        assert not eng._installing
        assert eng.request(rid).status == RequestStatus.QUEUED
        assert all(s is None for s in eng._slot_req)


class TestSnapshotRestore:
    @pytest.mark.parametrize("make_old,make_new", [
        (_mk_contiguous, _mk_contiguous),
        (_mk_contiguous, _mk_paged),
        (_mk_paged, _mk_contiguous),
        (_mk_paged, _mk_paged),
    ], ids=["contig-contig", "contig-paged", "paged-contig",
            "paged-paged"])
    def test_mid_run_parity(self, setup, prompts, tmp_path, make_old,
                            make_new):
        ref = _reference()
        old, rids, pre = _mid_run(setup, prompts, make_old)
        bundle = handoff.snapshot(old, str(tmp_path))
        new = make_new(setup)
        rep = handoff.restore(new, bundle)
        assert rep.ok and not rep.fallback
        assert rep.spans_installed > 0
        out = _finish(old, new, rep, rids)
        assert out == ref
        for i, r in enumerate(rids):
            fr = rep.rid_map.get(r, r)
            if fr in rep.stream_offsets:
                off = rep.stream_offsets[fr]
                # the carried tokens are the stream the client has
                assert off == len(pre[i])
                assert out[i][:off] == pre[i]
        # the carried prompts were served from the restored spans
        assert new.metrics()["prefix_tiers"]["reinstalls"] > 0
        _no_leaks(old)
        _no_leaks(new)

    def test_warm_restore_skips_prefill(self, setup, prompts, tmp_path):
        """Fresh traffic on the carried prefix is served from the
        restored host spans."""
        old = _mk_contiguous(setup)
        for p in prompts:
            old.submit(p, max_new=4)
        old.run(4)
        bundle = handoff.snapshot(old, str(tmp_path))
        new = _mk_contiguous(setup)
        rep = handoff.restore(new, bundle)
        assert rep.spans_installed > 0
        rid = new.submit(prompts[0], max_new=4)
        new.run(4)
        req = new.request(rid)
        assert req.status == RequestStatus.DONE
        assert req.prefix_hit > 0 and req.prefix_host_hit > 0
        assert req.tokens == _oracle(0, 4)

    def test_xla_to_flash_restore(self, setup, prompts, tmp_path):
        old, rids, _ = _mid_run(
            setup, prompts, lambda s: _mk_contiguous(s, attn_kernel="xla"))
        bundle = handoff.snapshot(old, str(tmp_path))
        new = _mk_contiguous(setup, attn_kernel="flash")
        rep = handoff.restore(new, bundle)
        assert rep.ok
        assert _finish(old, new, rep, rids) == _reference()

    def test_fused_roundtrip(self, prompts, tmp_path):
        jcfg, tcfg = _cfgs(num_layers=1, max_position_embeddings=64,
                           dtype="bfloat16")
        qp = _bridge(jgpt.quantize_decode_params(
            jgpt.init_params(jcfg, seed=0), jcfg))

        def mk(_setup=None):
            return FusedB1Engine(qp, tcfg, max_len=64,
                                 prefix_cache_bytes=1 << 22,
                                 prefix_host_bytes=1 << 22, device="cpu")

        ref_eng = mk()
        rr = [ref_eng.submit(p, max_new=4) for p in prompts[:2]]
        ref_eng.run(4)
        ref = {i: list(ref_eng.request(r).tokens) for i, r in enumerate(rr)}
        old = mk()
        rids = [old.submit(p, max_new=4) for p in prompts[:2]]
        old.step(2)
        bundle = handoff.snapshot(old, str(tmp_path))
        new = mk()
        rep = handoff.restore(new, bundle)
        assert rep.ok and rep.spans_installed > 0
        assert _finish(old, new, rep, rids) == ref

    def test_matches_generate_oracle(self, setup, prompts, tmp_path):
        """The handed-off stream equals ``gpt.generate`` on the prompt
        (JAX's, the independent oracle)."""
        old, rids, _ = _mid_run(setup, prompts, _mk_contiguous, max_new=6)
        bundle = handoff.snapshot(old, str(tmp_path))
        new = _mk_contiguous(setup)
        rep = handoff.restore(new, bundle)
        out = _finish(old, new, rep, rids)
        assert out[0] == _oracle(0, 6)

    def test_ttl_rebase(self, setup, prompts, tmp_path):
        from paddle_tpu_torch.inference.lifecycle import now as _now
        old = _mk_contiguous(setup)
        rid = old.submit(prompts[0], max_new=8, ttl=30.0)
        old.step(1)
        bundle = handoff.snapshot(old, str(tmp_path))
        recs = pickle.loads(get_io().read_file(
            os.path.join(bundle, handoff.REQUESTS_FILE)))
        rec = [r for r in recs if r["rid"] == rid][0]
        assert 0 < rec["remaining_ttl"] <= 30.0
        assert rec["trace"] is None
        new = _mk_contiguous(setup)
        rep = handoff.restore(new, bundle)
        fr = rep.rid_map[rid]
        remaining = new.request(fr).deadline - _now()
        assert 0 < remaining <= rec["remaining_ttl"] + 1e-3
        new.run(4)
        assert new.request(fr).status == RequestStatus.DONE

    def test_cancel_around_snapshot(self, setup, prompts, tmp_path):
        """A cancel between the drain and the snapshot excludes the
        request (the bundle does not tear); a carried rid can still be
        cancelled on the successor."""
        old, rids, _ = _mid_run(setup, prompts, _mk_contiguous)
        old.drain(mode="handoff")
        live = [r for r in rids
                if old.request(r).status == RequestStatus.QUEUED]
        assert len(live) >= 2
        assert old.cancel(live[0])
        bundle = handoff.snapshot(old, str(tmp_path))
        new = _mk_contiguous(setup)
        rep = handoff.restore(new, bundle)
        assert rep.ok
        carried = set(rep.carried)
        assert rep.rid_map.get(live[0]) is None
        fr = rep.rid_map[live[1]]
        assert fr in carried
        assert new.cancel(fr)
        new.run(4)
        assert new.request(fr).status == RequestStatus.CANCELLED
        _no_leaks(new)

    def test_carried_too_long_rejected_loudly(self, setup, prompts,
                                              tmp_path):
        old, rids, _ = _mid_run(setup, prompts, _mk_contiguous)
        bundle = handoff.snapshot(old, str(tmp_path))
        tiny = _mk_contiguous(setup, max_len=16)
        rep = handoff.restore(tiny, bundle)
        assert rep.ok
        assert rep.rejected and not rep.carried
        for r in rep.rejected:
            assert tiny.request(r).status == RequestStatus.REJECTED

    def test_restore_requires_serving_engine(self, setup, prompts,
                                             tmp_path):
        old, _, _ = _mid_run(setup, prompts, _mk_contiguous)
        bundle = handoff.snapshot(old, str(tmp_path))
        with pytest.raises(handoff.HandoffError):
            handoff.restore(old, bundle)   # a STOPPED donor


def _tamper_span(bundle):
    """Corrupt ONE span's bytes and refresh the file manifest, so only
    the span's own SHA-256 catches it (the re-prefill rung)."""
    io = get_io()
    p = os.path.join(bundle, handoff.CACHE_FILE)
    doc = pickle.loads(io.read_file(p))
    assert doc["spans"]
    doc["spans"][0]["k"] = doc["spans"][0]["k"] + 1
    blob = pickle.dumps(doc, protocol=4)
    io.write_file(p, blob)
    man = read_manifest(bundle)
    files = man["files"]
    files[handoff.CACHE_FILE] = digest_bytes(blob)
    write_manifest(bundle, files, extra={"bundle": man.get("bundle")})


def _truncate_file(bundle):
    p = os.path.join(bundle, handoff.CACHE_FILE)
    with open(p, "rb") as f:
        data = f.read()
    with open(p, "wb") as f:
        f.write(data[:len(data) // 2])


class TestFaultSeams:
    def test_crash_mid_snapshot_leaves_no_bundle(self, setup, prompts,
                                                 tmp_path):
        old, rids, _ = _mid_run(setup, prompts, _mk_contiguous)
        with inject_io(crash_at_write=2):
            with pytest.raises(FaultInjected):
                handoff.snapshot(old, str(tmp_path))
        # the crash leaves a hidden staging directory, never a bundle
        assert handoff.latest_bundle(str(tmp_path)) is None
        names = os.listdir(str(tmp_path))
        assert all(n.startswith(handoff.STAGING_PREFIX) for n in names)
        assert old.state == EngineState.STOPPED
        _no_leaks(old)

    def test_snapshot_write_retry_is_not_absorbed_silently(
            self, setup, prompts, tmp_path):
        """The IO layer's write has no retry: the snapshot raises and
        commits no bundle."""
        old, _, _ = _mid_run(setup, prompts, _mk_contiguous)
        with inject_io(fail_times=1):
            with pytest.raises(OSError):
                handoff.snapshot(old, str(tmp_path))
        assert handoff.latest_bundle(str(tmp_path)) is None

    def test_truncated_bundle_quarantined_cold_fallback(
            self, setup, prompts, tmp_path):
        old, rids, _ = _mid_run(setup, prompts, _mk_contiguous)
        bundle = handoff.snapshot(old, str(tmp_path))
        _truncate_file(bundle)
        new = _mk_contiguous(setup)
        rep = handoff.restore(new, bundle)
        assert not rep.ok and rep.fallback == "cold"
        assert rep.problems
        assert not os.path.isdir(bundle)
        assert any(n.startswith(handoff.QUARANTINE_PREFIX)
                   for n in os.listdir(str(tmp_path)))
        assert new.metrics()["handoff"]["fallbacks"] == 1
        # the successor is untouched: cold traffic still serves
        rid = new.submit(prompts[0], max_new=2)
        new.run(4)
        assert new.request(rid).status == RequestStatus.DONE
        _no_leaks(new)

    def test_corrupt_span_sha_degrades_to_reprefill(
            self, setup, prompts, tmp_path):
        old, rids, _ = _mid_run(setup, prompts, _mk_contiguous)
        bundle = handoff.snapshot(old, str(tmp_path))
        _tamper_span(bundle)
        new = _mk_contiguous(setup)
        rep = handoff.restore(new, bundle)
        assert rep.ok and rep.spans_bad >= 1
        assert _finish(old, new, rep, rids) == _reference()
        _no_leaks(new)

    def test_restore_transient_fault_absorbed_by_retry(
            self, setup, prompts, tmp_path):
        old, rids, _ = _mid_run(setup, prompts, _mk_contiguous)
        bundle = handoff.snapshot(old, str(tmp_path))
        new = _mk_contiguous(setup)
        with inject_engine_faults(new, kinds=("restore",),
                                  fail_times=1) as inj:
            rep = handoff.restore(new, bundle)
        assert inj.injected.get("restore") == 1
        assert rep.ok and rep.spans_bad == 0
        assert _finish(old, new, rep, rids) == _reference()

    def test_restore_persistent_fault_drops_to_reprefill(
            self, setup, prompts, tmp_path):
        old, rids, _ = _mid_run(setup, prompts, _mk_contiguous)
        bundle = handoff.snapshot(old, str(tmp_path))
        new = _mk_contiguous(setup)
        with inject_engine_faults(new, kinds=("restore",),
                                  fail_always=True):
            rep = handoff.restore(new, bundle)
        assert rep.ok and rep.spans_installed == 0 and rep.spans_bad > 0
        assert rep.carried
        assert _finish(old, new, rep, rids) == _reference()
        _no_leaks(new)

    def test_snapshot_export_fault_fails_loudly(self, setup, prompts,
                                                tmp_path):
        old, _, _ = _mid_run(setup, prompts, _mk_contiguous)
        with inject_engine_faults(old, kinds=("snapshot",),
                                  fail_always=True):
            with pytest.raises(OSError):
                handoff.snapshot(old, str(tmp_path))
        assert handoff.latest_bundle(str(tmp_path)) is None

    def test_slow_h2d_install_on_successor(self, setup, prompts, tmp_path):
        old, rids, _ = _mid_run(setup, prompts, _mk_contiguous)
        bundle = handoff.snapshot(old, str(tmp_path))
        new = _mk_contiguous(setup)
        rep = handoff.restore(new, bundle)
        with inject_engine_faults(new, kinds=(), defer_ready=3) as inj:
            out = _finish(old, new, rep, rids)
        assert inj.deferred > 0                 # INSTALLING exercised
        assert out == _reference()
        _no_leaks(new)

    def test_latest_bundle_walks_past_corruption(self, setup, prompts,
                                                 tmp_path):
        old, _, _ = _mid_run(setup, prompts, _mk_contiguous)
        b1 = handoff.snapshot(old, str(tmp_path))
        old2, _, _ = _mid_run(setup, prompts, _mk_contiguous)
        b2 = handoff.snapshot(old2, str(tmp_path))
        assert b2 != b1
        _truncate_file(b2)
        # the newest VERIFIED bundle wins; the torn one is quarantined
        assert handoff.latest_bundle(str(tmp_path)) == b1
        assert not os.path.isdir(b2)


# ---------------------------------------------------------------------------
# span digests against JAX's records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_span_digest_equals_jax(kv_dtype):
    """The same K/V (float32 values, stored as each package's engine
    stores them at ``kv_dtype`` under a bf16 model) gives a port span
    record whose SHA-256 is JAX's ``_span_record`` digest: bf16 as its
    16-bit words, fp8 as its bytes, int8 data and scales."""
    rng = np.random.default_rng(3)
    # canonical [L, tokens, nH, hD]; fp8 values inside its range
    kf, vf = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32) * 3
              for _ in range(2))

    def jax_side(x):
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        if kv_dtype == "bf16":
            return np.asarray(xb)
        data, scale = jkvq.quantize_kv(xb, kv_dtype)
        # fp8 is stored bare (no scale plane), as in the JAX cache
        return np.asarray(data) if scale is None else \
            (np.asarray(data), np.asarray(scale))

    def port_side(x):
        xb = torch.from_numpy(x).to(torch.bfloat16)
        if kv_dtype == "bf16":
            return _canonical_array(xb)
        stored = tkvq.quantize_kv(xb, kv_dtype)
        stored = stored[0] if stored[1] is None else stored
        return tkvq.kv_map(_canonical_array, stored)

    key = np.arange(12, dtype=np.int32)
    want = jhandoff._span_record(key, 0, 12, jax_side(kf), jax_side(vf))
    kp, vp = port_side(kf), port_side(vf)
    got = handoff._span_record(key, 0, 12, kp, vp,
                               {"bf16": "bfloat16", "int8": "int8",
                                "fp8": "float8_e4m3fn"}[kv_dtype])
    assert got["sha256"] == want["sha256"]
    if kv_dtype == "bf16":
        assert kp.dtype == np.uint16     # 16-bit words, no ml_dtypes
    if kv_dtype == "fp8":
        assert kp.dtype == np.uint8
