"""Port parity: serving robustness and lifecycle against the JAX engines.

Every case of ``tests/test_serving_robust.py`` (22), the speculative
fault and cancel/TTL cases of ``tests/test_speculative.py``
(``TestVerifyFaults``, ``TestCancelAndTTLMidSpeculation``) and the device
tier's fault cases of ``tests/test_prefix_cache.py``
(``TestDonationSafety``) run as ONE scenario function written against an
``api`` namespace, once through the JAX package and once through the
port (``device="cpu"``), on the same weights and the same fault schedule
(``paddle_tpu.testing.faults`` on the JAX side,
``paddle_tpu_torch.testing.faults`` on the port's).  Each scenario keeps
the JAX test's own assertions, on both sides, and returns an outcome —
statuses, token lists, ``inj.injected``, the error substrings the JAX
test checks, page accounting — that must be equal on both sides.

The one difference by design: JAX donates its caches, so a device call
that fails after it ran (``fail_after_times``) deletes them and the JAX
engine re-prefills every slot; the port writes its caches in place and
runs the call again on unchanged host state.  Those scenarios return the
streams (equal) and hold the port's prefill count at its fault-free
count, where JAX's rises.

Then the new modules against the JAX ones on the same schedules:
``RetryPolicy`` with an injected sleep and rng, ``CircuitBreaker``'s
half-open probe and flaps, ``watch`` raising on a late return; and the
port's own repairs: a prefill that raises strands nothing, a capture
that raises leaves its program able to capture again.
"""
import functools
import random
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import watchdog as jwatchdog
from paddle_tpu.inference import lifecycle as jlifecycle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.testing import faults as jfaults
from paddle_tpu.utils import retry as jretry
from paddle_tpu_torch.distributed import watchdog as twatchdog
from paddle_tpu_torch.inference import lifecycle as tlifecycle
from paddle_tpu_torch.inference import programs
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch.utils import retry as tretry

_GPT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_position_embeddings=128, use_flash=False)
_DRAFT = dict(vocab_size=128, hidden_size=16, num_layers=1, num_heads=2,
              max_position_embeddings=128, use_flash=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny products: one intra-op thread keeps the port's engines from
    contending with the other test workers; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


@functools.lru_cache(maxsize=None)
def _apis():
    """The two packages behind one surface: engine classes, the fault
    injector, the retry policy, the lifecycle vocabulary, the target's
    weights and the speculative draft, the same in both (the JAX tests'
    shapes: the tiny target and a one-layer GPT draft; the weights are the
    port's ``init_params`` of seeds 0 and 7 handed to JAX, whose own
    ``init_params`` takes seconds to compile)."""
    tcfg = tgpt.GPTConfig(dtype=torch.float32, **_GPT)
    tdcfg = tgpt.GPTConfig(dtype=torch.float32, **_DRAFT)
    tp = tgpt.init_params(tcfg, 0, device="cpu")
    tdp = tgpt.init_params(tdcfg, 7, device="cpu")
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, unroll_layers=False, **_GPT)
    jdcfg = jgpt.GPTConfig(dtype=jnp.float32, unroll_layers=False, **_DRAFT)
    jax_api = types.SimpleNamespace(
        name="jax", Engine=jserving.ContinuousBatchingEngine,
        Paged=jserving.PagedContinuousBatchingEngine,
        inject=jfaults.inject_engine_faults, RetryPolicy=jretry.RetryPolicy,
        Status=jlifecycle.RequestStatus, State=jlifecycle.EngineState,
        QueueFullError=jlifecycle.QueueFullError,
        CircuitOpenError=jlifecycle.CircuitOpenError,
        EngineClosedError=jlifecycle.EngineClosedError,
        params=_to_jax(tp), cfg=jcfg, kw={},
        draft=jserving.SpeculativeConfig(k=3, draft_params=_to_jax(tdp),
                                         draft_cfg=jdcfg))
    port_api = types.SimpleNamespace(
        name="port", Engine=tserving.ContinuousBatchingEngine,
        Paged=tserving.PagedContinuousBatchingEngine,
        inject=tfaults.inject_engine_faults, RetryPolicy=tretry.RetryPolicy,
        Status=tlifecycle.RequestStatus, State=tlifecycle.EngineState,
        QueueFullError=tlifecycle.QueueFullError,
        CircuitOpenError=tlifecycle.CircuitOpenError,
        EngineClosedError=tlifecycle.EngineClosedError,
        params=tp, cfg=tcfg, kw={"device": "cpu"},
        draft=tserving.SpeculativeConfig(k=3, draft_params=tdp,
                                         draft_cfg=tdcfg))
    return jax_api, port_api


def _engine(api, paged=False, **kw):
    cls = api.Paged if paged else api.Engine
    return cls(api.params, api.cfg, **kw, **api.kw)


@functools.lru_cache(maxsize=None)
def _reference(prompt: tuple, max_new: int):
    """The greedy ``generate`` of a prompt, the JAX tests' reference.
    The references here are the port's (its ``generate`` is held to
    JAX's by ``tests/test_torch_speculative.py::
    test_generate_streams_identical``): they compile nothing, where JAX
    compiles a program for each prompt length and engine shape, and the
    JAX scenario's own assertions then hold JAX to them as well."""
    _, port_api = _apis()
    with torch.inference_mode():
        out = tgpt.generate(port_api.params,
                            torch.tensor([prompt], dtype=torch.int32),
                            port_api.cfg, max_new_tokens=max_new)
    return [int(t) for t in out[0]]


def _ref(prompt, max_new):
    return _reference(tuple(int(t) for t in prompt), max_new)


def _prompts(n, rng=None, lo=4, hi=17):
    rng = rng or np.random.default_rng(0)
    return [rng.integers(1, 128, (int(s),)).astype(np.int32)
            for s in rng.integers(lo, hi, (n,))]


_OUTCOMES = {}


def _both(scenario):
    """The scenario's outcome through JAX (once a module) and through the
    port, which must be equal."""
    jax_api, port_api = _apis()
    if scenario not in _OUTCOMES:
        _OUTCOMES[scenario] = scenario(jax_api)
    want = _OUTCOMES[scenario]
    got = scenario(port_api)
    assert got == want, (scenario.__name__, got, want)
    return got


# -- tests/test_serving_robust.py ---------------------------------------------

def submit_max_new_zero_rejected(api):
    eng = _engine(api, max_batch=1, max_len=64)
    msgs = []
    for m in (0, -3):
        with pytest.raises(ValueError, match="max_new") as e:
            eng.submit(np.arange(1, 6, dtype=np.int32), max_new=m)
        msgs.append(str(e.value))
    assert not eng._queue
    return msgs


def overlong_prompt(api, paged):
    kw = dict(block_size=16) if paged else {}
    eng = _engine(api, paged, max_batch=1, max_len=64, **kw)
    with pytest.raises(ValueError, match=r"prompt length 70.*64"):
        eng.submit(np.arange(70, dtype=np.int32) % 128, max_new=1)
    return True


def overlong_contiguous(api):
    return overlong_prompt(api, False)


def overlong_paged(api):
    return overlong_prompt(api, True)


def queue_full_rejects(api):
    eng = _engine(api, max_batch=1, max_len=64, max_queue=3)
    ps = _prompts(4)
    for p in ps[:3]:
        eng.submit(p, max_new=2)
    with pytest.raises(api.QueueFullError, match="admission queue full"):
        eng.submit(ps[3], max_new=2)
    assert eng.queued == 3
    return eng.queued


def sustained_overload(api):
    eng = _engine(api, max_batch=2, max_len=64, max_queue=4)
    accepted, rejected = [], 0
    for p in _prompts(25):
        try:
            accepted.append(eng.submit(p, max_new=2))
        except api.QueueFullError:
            rejected += 1
        assert eng.queued <= 4
    assert rejected == 25 - len(accepted) > 0
    results = eng.run()
    assert sorted(results) == sorted(accepted)
    assert all(eng.status(r) == api.Status.DONE for r in accepted)
    return accepted, rejected, {r: results[r] for r in accepted}


def shed_oldest(api):
    eng = _engine(api, max_batch=1, max_len=64, max_queue=2,
                  overload="shed-oldest")
    ps = _prompts(3)
    a, b, c = (eng.submit(p, max_new=2) for p in ps)
    assert eng.status(a) == api.Status.REJECTED
    assert "shed" in eng.request(a).error
    results = eng.run()
    assert a in results and results[a] == []
    return [eng.status(r) for r in (a, b, c)], results


def block_policy(api):
    eng = _engine(api, max_batch=1, max_len=64, max_queue=1,
                  overload="block", overload_timeout=30.0)
    ps = _prompts(3)
    rids = [eng.submit(p, max_new=2) for p in ps]
    results = eng.run()
    for r in rids:
        assert eng.status(r) == api.Status.DONE
        assert r in results or eng.request(r).tokens
    return [eng.request(r).tokens for r in rids]


def expires_while_queued(api):
    eng = _engine(api, max_batch=1, max_len=64)
    live = eng.submit(_prompts(1)[0], max_new=2)
    dead = eng.submit(_prompts(2)[1], max_new=2, ttl=-0.001)
    results = eng.run()
    assert eng.status(dead) == api.Status.TIMEOUT
    assert "queue" in eng.request(dead).error
    assert results[dead] == []
    return eng.status(live), results[live]


def expires_mid_decode(api):
    """Timed: how many tokens land before the deadline is the host's
    speed, so the outcome is the status, the error and whether the
    partial stream is a prefix of the reference."""
    eng = _engine(api, max_batch=1, max_len=64)
    prompt = np.arange(1, 7, dtype=np.int32)
    rid = eng.submit(prompt, max_new=40, ttl=0.25)
    while eng._has_work():
        eng.step(1)
        time.sleep(0.06)
    req = eng.request(rid)
    assert req.status == api.Status.TIMEOUT
    assert 0 < len(req.tokens) < 40
    assert "mid-decode" in req.error
    return req.status, req.tokens == _ref(prompt, 40)[:len(req.tokens)]


def cancel_queued(api):
    eng = _engine(api, max_batch=1, max_len=64)
    a, b = (eng.submit(p, max_new=2) for p in _prompts(2))
    assert eng.cancel(b) is True
    assert eng.status(b) == api.Status.CANCELLED
    results = eng.run()
    assert eng.status(a) == api.Status.DONE
    assert results[b] == []
    assert eng.cancel(b) is False
    return results


def cancel_running_frees_pages(api):
    eng = _engine(api, True, max_batch=2, max_len=64, block_size=16)
    hog = eng.submit(_prompts(1)[0], max_new=30)
    short = eng.submit(_prompts(2)[1], max_new=3)
    eng.step(2)
    assert eng.status(hog) == api.Status.RUNNING
    claimed = eng.num_blocks - eng.free_blocks
    assert eng.cancel(hog) is True
    assert eng.status(hog) == api.Status.CANCELLED
    after = eng.num_blocks - eng.free_blocks
    assert after < claimed
    eng.run()
    assert eng.status(short) == api.Status.DONE
    assert eng.free_blocks == eng.num_blocks
    return claimed, after, eng.request(short).tokens


def fail_twice_decode(api):
    ps, budgets = _prompts(4), [6, 4, 8, 3]
    clean = _engine(api, max_batch=2, max_len=64)
    want = {clean.submit(p, max_new=m): None for p, m in zip(ps, budgets)}
    want = clean.run()
    eng = _engine(api, max_batch=2, max_len=64)
    rids = [eng.submit(p, max_new=m) for p, m in zip(ps, budgets)]
    with api.inject(eng, fail_times=2, kinds=("decode",)) as inj:
        got = eng.run()
    assert inj.injected == {"decode": 2}
    assert got == {r2: want[r1] for r1, r2 in zip(sorted(want), rids)}
    assert all(eng.status(r) == api.Status.DONE for r in rids)
    if api.name == "port":
        assert eng.metrics()["retries"] == {"decode": 2}
    return inj.injected, [got[r] for r in rids]


def fail_twice_prefill(api):
    p = _prompts(1)[0]
    eng = _engine(api, max_batch=1, max_len=64)
    rid = eng.submit(p, max_new=5)
    with api.inject(eng, fail_times=2, kinds=("prefill",)) as inj:
        got = eng.run()
    assert inj.injected == {"prefill": 2}
    assert got[rid] == _ref(p, 5)
    return inj.injected, got


def poison_pill(api):
    ps = _prompts(3)
    eng = _engine(api, max_batch=1, max_len=64, breaker_threshold=50,
                  retry=api.RetryPolicy(retries=1, backoff=0.0))
    poison = eng.submit(ps[0], max_new=2)
    healthy = eng.submit(ps[1], max_new=3)
    seen = {"prefill": 0}
    orig = eng._device_invoke

    def fail_first_request(kind, fn, *args, **kw):
        if kind == "prefill" and args[1].rid == poison:
            seen["prefill"] += 1
            raise OSError("injected: this request's prefill dies")
        return orig(kind, fn, *args, **kw)

    eng._device_invoke = fail_first_request
    try:
        results = eng.run()
    finally:
        eng.__dict__.pop("_device_invoke", None)
    assert eng.status(poison) == api.Status.FAILED
    assert "prefill failed" in eng.request(poison).error
    assert seen["prefill"] == 2
    assert eng.status(healthy) == api.Status.DONE
    assert results[healthy] == _ref(ps[1], 3)
    return seen, results


def breaker_opens(api):
    ps = _prompts(4)
    eng = _engine(api, max_batch=1, max_len=64, breaker_threshold=2,
                  retry=api.RetryPolicy(retries=0, backoff=0.0))
    rids = [eng.submit(p, max_new=2) for p in ps]
    with api.inject(eng, fail_always=True, kinds=("prefill",)) as inj:
        results = eng.run()
    assert eng.circuit_open
    statuses = [eng.status(r) for r in rids]
    assert all(s == api.Status.FAILED for s in statuses)
    errors = [eng.request(r).error for r in rids]
    assert "circuit breaker open" in errors[-1]
    with pytest.raises(api.CircuitOpenError):
        eng.submit(ps[0], max_new=2)
    assert sorted(results) == sorted(rids)
    eng.reset_circuit()
    rid = eng.submit(ps[0], max_new=2)
    again = eng.run()[rid]
    assert again == _ref(ps[0], 2)
    return (inj.injected, statuses,
            ["prefill failed" in e for e in errors],
            ["circuit breaker open" in e for e in errors], again)


def stalled_step_watchdog(api):
    """Stall 0.4 s against a 0.1 s deadline (4x, as the JAX test)."""
    ps = _prompts(2)
    eng = _engine(api, max_batch=2, max_len=64, breaker_threshold=2,
                  retry=api.RetryPolicy(retries=0, backoff=0.0))
    warm = eng.submit(ps[0], max_new=2)
    eng.run(steps_per_sync=2)
    assert eng.status(warm) == api.Status.DONE
    eng.step_timeout = 0.1
    rids = [eng.submit(p, max_new=6) for p in ps]
    with api.inject(eng, stall=0.4, kinds=("decode",)):
        out = eng.drain(timeout=60, steps_per_sync=2)
    assert eng.state == api.State.STOPPED
    for r in rids:
        assert out[r].status == api.Status.FAILED
        assert "circuit breaker" in out[r].error
    assert "TimeoutError" in eng._breaker.last_error
    return [out[r].status for r in rids], [out[r].tokens for r in rids]


def drain_finishes(api):
    ps = _prompts(3)
    eng = _engine(api, max_batch=1, max_len=64)
    rids = [eng.submit(p, max_new=3) for p in ps]
    eng.step(1)
    out = eng.drain()
    assert eng.state == api.State.STOPPED
    for r in rids:
        assert out[r].status == api.Status.DONE
        assert out[r].tokens == _ref(ps[rids.index(r)], 3)
    with pytest.raises(api.EngineClosedError):
        eng.submit(ps[0], max_new=2)
    return sorted(out), [out[r].tokens for r in rids]


def drain_timeout(api):
    eng = _engine(api, max_batch=1, max_len=64)
    rid = eng.submit(_prompts(1)[0], max_new=8)
    t0 = time.monotonic()
    with api.inject(eng, stall=0.2):
        out = eng.drain(timeout=0.0)
    assert time.monotonic() - t0 < 5.0
    assert out[rid].status == api.Status.TIMEOUT
    assert "drain" in out[rid].error
    return out[rid].status, out[rid].tokens


def livelock_guard(api):
    eng = _engine(api, True, max_batch=2, max_len=64, block_size=16,
                  num_blocks=4, max_stall_rounds=4)
    rid = eng.submit(_prompts(1)[0], max_new=20)
    eng._scan_clamp = lambda active, max_tokens=1: 0
    results = eng.run(steps_per_sync=4)
    assert eng.status(rid) == api.Status.FAILED
    err = eng.request(rid).error
    assert "pages" in err and "pool" in err
    assert rid in results
    return err


def eviction_cycle(api):
    p = np.arange(1, 10, dtype=np.int32)
    eng = _engine(api, True, max_batch=2, max_len=64, block_size=16,
                  num_blocks=3, max_stall_rounds=3)
    a = eng.submit(p, max_new=20)
    b = eng.submit(p + 1, max_new=20)
    results = eng.run(steps_per_sync=4)
    assert eng.status(a) == eng.status(b) == api.Status.DONE
    assert results[a] == _ref(p, 20)
    assert eng.free_blocks == eng.num_blocks
    return results


def step_terminal_statuses(api):
    eng = _engine(api, max_batch=2, max_len=64)
    ok = eng.submit(_prompts(1)[0], max_new=2)
    dead = eng.submit(_prompts(2)[1], max_new=2, ttl=-0.001)
    gone = eng.submit(_prompts(3)[2], max_new=2)
    eng.cancel(gone)
    seen = {}
    while eng._has_work():
        for req in eng.step(2):
            seen[req.rid] = req.status
    for req in eng.step(1):
        seen[req.rid] = req.status
    assert seen[ok] == api.Status.DONE
    assert seen[dead] == api.Status.TIMEOUT
    assert seen[gone] == api.Status.CANCELLED
    return seen


def forget_terminal(api):
    eng = _engine(api, max_batch=1, max_len=64)
    rid = eng.submit(_prompts(1)[0], max_new=2)
    assert eng.forget(rid) is None
    eng.run()
    assert eng.forget(rid).rid == rid
    with pytest.raises(KeyError):
        eng.status(rid)
    return rid


ROBUST = (submit_max_new_zero_rejected, overlong_contiguous, overlong_paged,
          queue_full_rejects, sustained_overload, shed_oldest, block_policy,
          expires_while_queued, expires_mid_decode, cancel_queued,
          cancel_running_frees_pages, fail_twice_decode, fail_twice_prefill,
          poison_pill, breaker_opens, stalled_step_watchdog, drain_finishes,
          drain_timeout, livelock_guard, eviction_cycle,
          step_terminal_statuses, forget_terminal)


@pytest.mark.parametrize("scenario", ROBUST, ids=lambda f: f.__name__)
def test_serving_robust_matches_jax(scenario):
    _both(scenario)


# -- tests/test_speculative.py: TestVerifyFaults, TestCancelAndTTL... ---------

_SPEC_REQS = ((5, 9, 11), (16, 4, 22), (9, 12, 33), (3, 5, 44))


def _spec_prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, (n,)).astype("i4"), m, s)
            for n, m, s in _SPEC_REQS]


def _spec_run(eng, reqs):
    rids = [eng.submit(p, max_new=m, seed=s) for p, m, s in reqs]
    out = eng.run(steps_per_sync=8)
    return [out[r] for r in rids]


@functools.lru_cache(maxsize=None)
def _spec_base():
    """A plain engine's streams of the speculative requests (the port's,
    as the references here: see :func:`_reference`)."""
    _, port_api = _apis()
    return _spec_run(_engine(port_api, max_batch=2, max_len=64),
                     _spec_prompts())


def transient_verify_draft_faults(api):
    reqs, out = _spec_prompts(), {}
    for kind in ("verify", "draft"):
        eng = _engine(api, max_batch=2, max_len=64, speculative=api.draft)
        rids = [eng.submit(p, max_new=m, seed=s) for p, m, s in reqs]
        with api.inject(eng, fail_times=2, kinds=(kind,)) as inj:
            got = eng.run(steps_per_sync=8)
        assert inj.injected == {kind: 2}
        assert [got[r] for r in rids] == _spec_base(), kind
        assert all(eng.status(r) == api.Status.DONE for r in rids)
        out[kind] = inj.injected
    return out


def loss_mid_verify(api):
    """JAX: the donated verify program's failure deletes both caches and
    the engine re-prefills; the port runs the verify again in place, so
    its prefill and draft-prefill counts stay at the fault-free run's."""
    reqs = _spec_prompts()
    eng = _engine(api, max_batch=2, max_len=64, speculative=api.draft)
    rids = [eng.submit(p, max_new=m, seed=s) for p, m, s in reqs]
    with api.inject(eng, fail_after_times=1, kinds=("verify",)) as inj:
        out = eng.run(steps_per_sync=8)
    assert inj.injected["verify"] >= 1
    assert [out[r] for r in rids] == _spec_base()
    assert all(eng.status(r) == api.Status.DONE for r in rids)
    if api.name == "port":
        clean = _engine(api, max_batch=2, max_len=64, speculative=api.draft)
        _spec_run(clean, reqs)
        m, c = eng.metrics()["launches"], clean.metrics()["launches"]
        for kind in ("prefill", "draft_prefill"):
            assert m[kind] == c[kind], (kind, m, c)
    return [out[r] for r in rids]


def verify_fail_always(api):
    eng = _engine(api, True, max_batch=2, max_len=64, block_size=8,
                  num_blocks=24, breaker_threshold=2, speculative=api.draft)
    rids = [eng.submit(p, max_new=m, seed=s) for p, m, s in _spec_prompts()]
    with api.inject(eng, fail_always=True, kinds=("verify",)) as inj:
        eng.run(steps_per_sync=8)
    assert all(eng.request(r).terminal for r in rids)
    assert eng.circuit_open
    rc = eng._page_rc
    assert eng.free_blocks + int((rc > 0).sum()) == eng.num_blocks
    return (inj.injected, [eng.status(r) for r in rids], eng.free_blocks,
            int((rc > 0).sum()))


def cancel_mid_speculation(api):
    eng = _engine(api, True, max_batch=1, max_len=64, block_size=8,
                  num_blocks=16, speculative=api.draft)
    rng = np.random.default_rng(5)
    p1 = rng.integers(1, 128, (9,)).astype(np.int32)
    rid = eng.submit(p1, max_new=20)
    eng.step(8)
    first = list(eng.request(rid).tokens)
    assert first
    assert eng.cancel(rid)
    assert eng.status(rid) == api.Status.CANCELLED
    assert int((eng._page_rc > 0).sum()) == 0
    assert eng.free_blocks == eng.num_blocks
    p2 = rng.integers(1, 128, (7,)).astype(np.int32)
    rid2 = eng.submit(p2, max_new=5)
    out = eng.run()
    assert out[rid2] == _ref(p2, 5)
    return first, out


def ttl_mid_verification(api):
    eng = _engine(api, True, max_batch=1, max_len=64, block_size=8,
                  num_blocks=16, speculative=api.draft)
    rid = eng.submit(np.arange(1, 10, dtype=np.int32), max_new=30, ttl=0.0)
    with api.inject(eng, fail_times=1, kinds=("verify",)):
        eng.run(steps_per_sync=8)
    assert eng.status(rid) == api.Status.TIMEOUT
    assert int((eng._page_rc > 0).sum()) == 0
    assert eng.free_blocks == eng.num_blocks
    return eng.status(rid), eng.request(rid).tokens


SPECULATIVE = (transient_verify_draft_faults, loss_mid_verify,
               verify_fail_always, cancel_mid_speculation,
               ttl_mid_verification)


@pytest.mark.parametrize("scenario", SPECULATIVE, ids=lambda f: f.__name__)
def test_speculative_faults_match_jax(scenario):
    _both(scenario)


# -- tests/test_prefix_cache.py: TestDonationSafety ---------------------------

def _shared_prompts(n, shared_len=24, tail=4, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 128, (shared_len,)).astype(np.int32)
    ps = [np.concatenate([shared,
                          rng.integers(1, 128, (tail,)).astype(np.int32)])
          for _ in range(n)]
    ps.append(shared.copy())
    return ps


def _run_all(eng, prompts, max_new=6, steps_per_sync=4):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    out = eng.run(steps_per_sync=steps_per_sync)
    return {i: out[r] for i, r in enumerate(rids)}


@functools.lru_cache(maxsize=None)
def _cold(n, paged):
    """A cold engine's streams of ``_shared_prompts(n)`` (the port's, as
    the references here)."""
    _, port_api = _apis()
    kw = dict(block_size=8, num_blocks=24) if paged else {}
    return _run_all(_engine(port_api, paged, max_batch=2, max_len=64, **kw),
                    _shared_prompts(n))


def transient_decode_with_prefix(api):
    prompts = _shared_prompts(3)
    eng = _engine(api, max_batch=2, max_len=64, prefix_cache_bytes=1 << 30)
    rids = [eng.submit(p, max_new=6) for p in prompts]
    with api.inject(eng, fail_times=2, kinds=("decode",)) as inj:
        out = eng.run(steps_per_sync=4)
    assert inj.injected == {"decode": 2}
    assert {i: out[r] for i, r in enumerate(rids)} == _cold(3, False)
    assert all(eng.status(r) == api.Status.DONE for r in rids)
    return inj.injected


def _prefills(api, eng):
    """The JAX engine counts launches in its metrics registry, which is
    off by default; the port's metrics count them always."""
    if api.name != "port":
        return None
    return eng.metrics()["launches"]["prefill"]


def loss_mid_decode(api):
    """JAX re-prefills after the donated decode program's loss; the port
    runs the decode again in place: its prefill count equals a
    fault-free run's."""
    prompts = _shared_prompts(2)
    eng = _engine(api, max_batch=2, max_len=64, prefix_cache_bytes=1 << 30)
    rids = [eng.submit(p, max_new=6) for p in prompts]
    with api.inject(eng, fail_after_times=1, kinds=("decode",)) as inj:
        out = eng.run(steps_per_sync=4)
    assert inj.injected["decode"] >= 1
    assert {i: out[r] for i, r in enumerate(rids)} == _cold(2, False)
    assert all(eng.status(r) == api.Status.DONE for r in rids)
    if api.name == "port":
        clean = _engine(api, max_batch=2, max_len=64,
                        prefix_cache_bytes=1 << 30)
        _run_all(clean, prompts)
        assert _prefills(api, eng) == _prefills(api, clean)
    again = eng.submit(prompts[0], max_new=6)
    assert eng.run()[again] == _cold(2, False)[0]
    assert eng.request(again).prefix_hit > 0
    return [out[r] for r in rids]


def paged_loss_mid_decode(api):
    """JAX flushes the prefix cache with the dead pool; the port's pool
    and pinned pages survive the retried decode, and the accounting
    stays exact."""
    prompts = _shared_prompts(2)
    eng = _engine(api, True, max_batch=2, max_len=64, block_size=8,
                  num_blocks=24, prefix_cache_bytes=1 << 30)
    rids = [eng.submit(p, max_new=6) for p in prompts]
    with api.inject(eng, fail_after_times=1, kinds=("decode",)) as inj:
        out = eng.run(steps_per_sync=4)
    assert inj.injected["decode"] >= 1
    assert {i: out[r] for i, r in enumerate(rids)} == _cold(2, True)
    rc = eng._page_rc
    assert eng.free_blocks + int((rc > 0).sum()) == eng.num_blocks
    return [out[r] for r in rids]


def prefill_fault_with_prefix(api):
    p = _shared_prompts(1)[0]
    eng = _engine(api, max_batch=1, max_len=64, prefix_cache_bytes=1 << 30)
    rid = eng.submit(p, max_new=5)
    with api.inject(eng, fail_times=2, kinds=("prefill",)) as inj:
        out = eng.run()
    assert inj.injected == {"prefill": 2}
    assert out[rid] == _ref(p, 5)
    rid2 = eng.submit(p, max_new=5)
    with api.inject(eng, fail_times=1, kinds=("prefix",)) as inj2:
        out2 = eng.run()
    assert inj2.injected == {"prefix": 1}
    return inj.injected, inj2.injected, out[rid], out2[rid2]


DONATION = (transient_decode_with_prefix, loss_mid_decode,
            paged_loss_mid_decode, prefill_fault_with_prefix)


@pytest.mark.parametrize("scenario", DONATION, ids=lambda f: f.__name__)
def test_prefix_fault_cases_match_jax(scenario):
    _both(scenario)


# -- the new modules against JAX's on the same schedules ----------------------

def test_retry_policy_matches_jax():
    """The same failures, injected sleep and seeded rng: the same calls,
    delays, on_retry attempts and final give-up in both packages; a
    no-retry subclass is raised at once."""
    class NoRetry(OSError):
        pass

    def drive(mod, fails, exc=OSError, **kw):
        calls, sleeps, retried = [], [], []

        def flaky(x):
            calls.append(x)
            if len(calls) <= fails:
                raise exc(f"fault {len(calls)}")
            return x * 2

        pol = mod.RetryPolicy(sleep=sleeps.append, rng=random.Random(3),
                              on_retry=lambda a, e: retried.append(a), **kw)
        try:
            out = pol.call(flaky, 21)
        except Exception as e:  # noqa: BLE001 — the outcome under test
            out = type(e).__name__
        return out, len(calls), sleeps, retried

    for kw, fails, exc in ((dict(retries=3, backoff=0.1), 2, OSError),
                           (dict(retries=2, backoff=0.5, max_backoff=0.7),
                            5, TimeoutError),
                           (dict(retries=3, no_retry_excs=(NoRetry,)), 2,
                            NoRetry),
                           (dict(retries=3), 1, ValueError)):
        want = drive(jretry, fails, exc, **kw)
        assert drive(tretry, fails, exc, **kw) == want
    assert tretry.TRANSIENT_EXCS == jretry.TRANSIENT_EXCS
    assert tretry.retry_call(lambda: 5, retries=0) == 5


def test_circuit_breaker_matches_jax():
    """Threshold, half-open probe with a zero cooldown, a failed probe
    re-arming, a probe success closing, a flap on re-opening, trip and
    the reason text: the same trace in both packages."""
    def drive(mod):
        br = mod.CircuitBreaker(threshold=2, cooldown_seconds=0.0,
                                label="e0")
        edges = []
        br.on_transition = edges.append
        trace = []
        for op in ("fail", "fail", "probe", "fail", "probe", "probe",
                   "ok", "fail", "fail", "reset", "trip", "ok"):
            if op == "fail":
                trace.append(br.record_failure(OSError("x")))
            elif op == "probe":
                trace.append(br.should_probe())
            elif op == "ok":
                br.record_success()
            elif op == "reset":
                br.reset()
            else:
                trace.append(br.trip(TimeoutError("t")))
            trace.append((br.open, br.half_open, br.failures,
                          br.total_failures, br.probes, br.open_count,
                          br.flaps_total, br.flap_count()))
        return trace, edges, br.reason

    assert drive(tlifecycle) == drive(jlifecycle)
    with pytest.raises(ValueError):
        tlifecycle.CircuitBreaker(threshold=0)


def test_watch_raises_on_late_return_like_jax():
    """A watched block that returns after its deadline raises
    TimeoutError in both packages; one inside it does not, and an
    exception of the block passes through unchanged."""
    for mod in (jwatchdog, twatchdog):
        with pytest.raises(TimeoutError, match="exceeded"):
            with mod.watch("late", timeout=0.02):
                time.sleep(0.08)
        with mod.watch("fast", timeout=5.0):
            pass
        with pytest.raises(KeyError):
            with mod.watch("raising", timeout=0.0):
                time.sleep(0.01)
                raise KeyError("own")
        assert not [t for t in mod.comm_task_manager.pending()
                    if t.name in ("late", "fast", "raising")]


def test_admission_queue_policies_match_jax():
    """The overload policies, the context text, the deque surface."""
    def drive(mod):
        out = []
        for policy in mod.OVERLOAD_POLICIES:
            q = mod.AdmissionQueue(2, policy, label="e1")
            out += [q.offer(1), q.offer(2)]
            try:
                out.append(q.offer(3))
            except mod.QueueFullError as e:
                out.append(str(e))
            q.extendleft([9, 8])
            q.remove(9)
            out.append((list(q), q[0], len(q), q.high_water, q.context()))
        return out

    assert drive(tlifecycle) == drive(jlifecycle)
    assert tlifecycle.RequestStatus.TERMINAL == jlifecycle.RequestStatus.TERMINAL
    assert tlifecycle.DRAIN_MODES == jlifecycle.DRAIN_MODES


def half_open_probe(api):
    """``breaker_cooldown=0``: the breaker opens on the first failed
    prefill, the next submit rides through as the half-open probe, and
    its success closes the breaker."""
    ps = _prompts(3)
    eng = _engine(api, max_batch=1, max_len=64, breaker_threshold=1,
                  breaker_cooldown=0.0,
                  retry=api.RetryPolicy(retries=0, backoff=0.0))
    a = eng.submit(ps[0], max_new=2)
    with api.inject(eng, fail_times=1, kinds=("prefill",)):
        eng.run()
    opened = eng.circuit_open
    b = eng.submit(ps[1], max_new=3)
    probing = eng._breaker.half_open
    out = eng.run()
    assert out[b] == _ref(ps[1], 3)
    return (eng.status(a), opened, probing, eng.circuit_open,
            eng._breaker.probes, eng.status(b))


def prefill_budget_rounds(api):
    """``prefill_budget=12``: a round admits requests while their prompt
    tokens fit the budget (the first always), so admissions spread over
    rounds the same way in both engines, and the streams hold (the
    engine shape of ``fail_twice_decode``, whose programs JAX has
    compiled)."""
    ps = _prompts(6)
    eng = _engine(api, max_batch=2, max_len=64, prefill_budget=12)
    rids = [eng.submit(p, max_new=4) for p in ps]
    admitted = []
    while eng._has_work():
        eng.step(2)
        admitted.append(sum(eng.request(r).admitted_at is not None
                            for r in rids))
    for r, p in zip(rids, ps):
        assert eng.request(r).tokens == _ref(p, 4)
    return admitted


def test_prefill_budget_matches_jax():
    admitted = _both(prefill_budget_rounds)
    assert admitted[0] < 2           # the budget held the first round back


def test_half_open_probe_matches_jax():
    assert _both(half_open_probe) == ("FAILED", True, True, False, 1,
                                      "DONE")


# -- the port's own repairs ---------------------------------------------------

def test_raising_prefill_strands_nothing():
    """A prefill that raises a non-transient error (no retry) fails its
    admission's requests one by one (the poison-pill guard) instead of
    leaving them QUEUED in no queue and no slot; the next requests are
    served, and run() reports every request."""
    _, api = _apis()
    ps = _prompts(4)
    eng = _engine(api, max_batch=2, max_len=64, breaker_threshold=50)
    rids = [eng.submit(p, max_new=3) for p in ps]
    bad = set(rids[:2])
    orig = eng._prefill_batch

    def broken(slots, reqs):
        if any(r.rid in bad for r in reqs):
            raise RuntimeError("kernel launch failed")
        return orig(slots, reqs)

    eng._prefill_batch = broken
    out = eng.run()
    assert sorted(out) == rids
    for r in rids[:2]:
        assert eng.status(r) == api.Status.FAILED
        assert "prefill failed after retries" in eng.request(r).error
    for r, p in zip(rids[2:], ps[2:]):
        assert eng.status(r) == api.Status.DONE
        assert out[r] == _ref(p, 3)
    m = eng.metrics()
    assert m["quarantined"] == 2 and m["retries"] == {}
    assert m["retired"] == {"FAILED": 2, "DONE": 2}
    assert not eng._has_work() and eng.active_slots == 0


def test_retries_counted_by_kind_and_drain_modes():
    """``metrics()["retries"]`` counts attempts beyond the first by funnel
    kind; ``drain(mode="handoff")`` parks the engine (STOPPED, nothing
    retired; ``tests/test_torch_handoff.py`` drives it); an unknown mode
    is a ValueError."""
    _, api = _apis()
    eng = _engine(api, max_batch=2, max_len=64, prefix_cache_bytes=1 << 30)
    p = _shared_prompts(1)[0]
    with api.inject(eng, fail_times=1) as inj:
        eng.submit(p, max_new=3)
        eng.run()
        eng.submit(p, max_new=3)
        eng.run()
    assert inj.injected == {"prefill": 1, "decode": 1, "prefix": 1}
    assert eng.metrics()["retries"] == inj.injected
    with pytest.raises(ValueError, match="drain mode"):
        eng.drain(mode="later")
    assert eng.state == tlifecycle.EngineState.SERVING
    parked = eng.drain(mode="handoff")
    assert eng.state == tlifecycle.EngineState.STOPPED
    assert {r.status for r in parked.values()} == {api.Status.DONE}


class _FailingCapture:
    """A graph stand-in whose capture raises at its first attempt (as a
    capture that dies midway), then records like the decode-program
    tests' stand-in."""
    attempts = 0

    def __init__(self, body, pool=None):
        type(self).attempts += 1
        if type(self).attempts == 1:
            body()          # the capture ran the wrappers' Python...
            raise RuntimeError("capture failed")   # ...then died
        self.body = body
        self.pool = pool if pool is not None else object()
        body()

    def replay(self):
        held = programs.snapshot()
        self.body()
        programs.restore(held)


def test_capture_that_raises_can_capture_again():
    """A capture that raises leaves its program uncaptured with its run
    count and the launch counters as they were; the engine's decode
    failure path retries the round, the next run captures, and the
    streams equal an eager engine's."""
    _, api = _apis()
    ps, budgets = _prompts(3), [9, 5, 7]
    eager = _engine(api, max_batch=2, max_len=64)
    first = [eager.submit(p, max_new=m) for p, m in zip(ps, budgets)]
    done = eager.run(steps_per_sync=2)
    want = [done[r] for r in first]
    eng = _engine(api, max_batch=2, max_len=64,
                  retry=api.RetryPolicy(retries=1, backoff=0.0,
                                        retry_excs=(RuntimeError,)))
    eng._programs.capture = True
    eng._programs.graph_type = _FailingCapture
    _FailingCapture.attempts = 0
    rids = [eng.submit(p, max_new=m) for p, m in zip(ps, budgets)]
    eng.step(2)                                   # eager first run
    prog = eng._programs.programs[("decode", 2)]
    assert prog.runs == 1 and not prog.captured
    before = programs.snapshot()
    with pytest.raises(RuntimeError, match="capture failed"):
        prog.run()
    assert prog.runs == 1 and not prog.captured and prog.graph is None
    assert programs.snapshot() == before
    # the next capture fails inside the engine's round: the funnel
    # retries it, and the retry captures
    _FailingCapture.attempts = 0
    out = eng.run(steps_per_sync=2)
    assert prog.captured and prog.replays >= 1
    assert eng.metrics()["retries"] == {"decode": 1}
    assert [out[r] for r in rids] == want


class _Recorded:
    """The CUDA graph's stand-in of ``tests/test_torch_decode_program.py``:
    its capture runs the body, a replay runs it with the launch counters
    held."""

    def __init__(self, body, pool=None):
        self.body = body
        self.pool = pool if pool is not None else object()
        body()

    def replay(self):
        held = programs.snapshot()
        self.body()
        programs.restore(held)


@functools.lru_cache(maxsize=None)
def _fused_params():
    """A one-layer bf16 GPT's int8 serving weights (port-only test)."""
    cfg = tgpt.GPTConfig(dtype=torch.bfloat16, **{
        **_GPT, "num_layers": 1, "max_position_embeddings": 64})
    return cfg, tgpt.quantize_decode_params(
        tgpt.init_params(cfg, 0, device="cpu"), cfg)


@pytest.mark.parametrize("kind,sampled", [
    ("contiguous", False), ("paged", True), ("ngram", False),
    ("fused", True)])
def test_faults_keep_streams_under_captured_programs(kind, sampled):
    """On each engine (n-gram k 3 on the contiguous one), greedy or
    sampled, with the decode, verify and draft programs captured (the
    stand-in): ``fail_times=2`` and ``fail_after_times=1`` on every call
    kind leave every stream equal to the engine's fault-free one, with
    the fault-free prefill count (nothing re-prefills in place)."""
    _, api = _apis()
    samp = dict(temperature=0.8, top_k=20, top_p=0.95) if sampled else {}
    if kind == "fused":
        cfg, params = _fused_params()
        reqs = [(p[:12], m) for p, m in zip(_prompts(3), (9, 6, 11))]

        def make():
            return tserving.FusedB1Engine(params, cfg, max_len=64,
                                          kv_dtype="int8", device="cpu",
                                          **samp)
    else:
        reqs = list(zip(_prompts(5), (9, 6, 11, 4, 8)))

        def make():
            kw = dict(block_size=8, num_blocks=24) if kind == "paged" else {}
            return _engine(api, kind == "paged", max_batch=2, max_len=64,
                           speculative=(kind == "ngram") or None,
                           **kw, **samp)

    def serve(eng, **faults):
        eng._programs.capture = True
        eng._programs.graph_type = _Recorded
        rids = [eng.submit(p, max_new=m, seed=i + 1)
                for i, (p, m) in enumerate(reqs)]
        with tfaults.inject_engine_faults(eng, **faults) as inj:
            out = eng.run(steps_per_sync=4)
        assert all(eng.status(r) == api.Status.DONE for r in rids)
        return [out[r] for r in rids], inj.injected, eng.metrics()

    want, _, clean = serve(make())
    prefill = "prefill_fused" if kind == "fused" else "prefill"
    decode = "verify" if kind == "ngram" else "decode"
    for faults, injected in (
            (dict(fail_times=2), {prefill[:7]: 2, decode: 2}),
            (dict(fail_after_times=1, kinds=(decode,)), {decode: 1})):
        got, inj, m = serve(make(), **faults)
        assert got == want and inj == injected, (faults, inj)
        assert m["retries"] == injected
        assert m["launches"][prefill] == clean["launches"][prefill]
        assert m["graph_replays"] > 0
