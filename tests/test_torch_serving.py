"""Port parity: the port's ContinuousBatchingEngine against the JAX one.

Five greedy requests through ``max_batch=2`` engines (so slots refill
mid-run) must give IDENTICAL token streams in both packages, under
both attention knobs, on the tiny serving-test GPT with shared
weights.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.serving import (
    ContinuousBatchingEngine as JaxEngine)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference.serving import (
    ContinuousBatchingEngine, EngineClosedError, QueueFullError,
    RequestStatus, _derive_buckets)
from paddle_tpu_torch.models import decoding, gpt as tgpt

# (prompt length, max_new): lengths 3-20 span two prefill buckets
_REQS = ((3, 5), (20, 12), (7, 9), (16, 4), (11, 12))


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


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt.GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                          num_heads=2, max_position_embeddings=128,
                          dtype=jnp.float32, use_flash=False,
                          unroll_layers=False)
    tcfg = tgpt.GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                          num_heads=2, max_position_embeddings=128,
                          dtype=torch.float32, use_flash=False)
    jp = jgpt.init_params(jcfg, seed=0)
    tp = tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 128, (n,)).astype(np.int32), m)
            for n, m in _REQS]


def _serve(eng):
    rids = [eng.submit(p, max_new=m) for p, m in _prompts()]
    out = eng.run(steps_per_sync=8)
    return rids, [out[r] for r in rids]


@pytest.mark.parametrize("attn_kernel", ["xla", "flash"])
def test_streams_identical_to_jax_engine(models, attn_kernel):
    jcfg, jp, tcfg, tp = models
    _, want = _serve(JaxEngine(jp, jcfg, max_batch=2, max_len=64,
                               attn_kernel=attn_kernel))
    eng = ContinuousBatchingEngine(tp, tcfg, max_batch=2, max_len=64,
                                   attn_kernel=attn_kernel, device="cpu")
    rids, got = _serve(eng)
    assert got == want
    for rid, (_, m) in zip(rids, _REQS):
        assert eng.status(rid) == RequestStatus.DONE
        assert len(eng.request(rid).tokens) == m
    m = eng.metrics()
    assert m["attn_kernel"] == attn_kernel
    # 5 prompts, two buckets, slots refill one or two at a time
    assert 2 <= m["launches"]["prefill"] <= 5
    assert m["launches"]["decode"] >= 1
    assert m["decode_steps"] >= max(n for _, n in _REQS)
    assert m["active_slots"] == 0 and m["queued"] == 0


def test_eos_retires_early(models):
    jcfg, jp, tcfg, tp = models
    _, free = _serve(ContinuousBatchingEngine(tp, tcfg, max_batch=2,
                                              max_len=64, device="cpu"))
    eos = free[1][-1]
    _, want = _serve(JaxEngine(jp, jcfg, max_batch=2, max_len=64,
                               eos_token_id=eos))
    _, got = _serve(ContinuousBatchingEngine(
        tp, tcfg, max_batch=2, max_len=64, eos_token_id=eos, device="cpu"))
    assert got == want
    assert got[1] == free[1][:free[1].index(eos) + 1]


def test_attn_kernel_outside_knob_raises(models):
    _, _, tcfg, tp = models
    with pytest.raises(ValueError, match="attn_kernel"):
        ContinuousBatchingEngine(tp, tcfg, max_batch=1, max_len=32,
                                 attn_kernel="triton", device="cpu")


def test_default_device_without_cuda_raises(models):
    _, _, tcfg, tp = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(tp, tcfg, max_batch=1, max_len=32)


def test_temperature_raises_not_implemented():
    """Sampling is ported (it raised before the threefry port): the
    position-keyed draw gives JAX's tokens; greedy ignores seeds and
    positions."""
    import jax.numpy as jnp
    from paddle_tpu.models import decoding as jdec
    logits = np.random.default_rng(3).standard_normal((2, 8)).astype(
        np.float32)
    seeds, pos = np.asarray([5, -9], np.int32), np.asarray([0, 40], np.int32)
    got = decoding.sample_token_pos(torch.from_numpy(logits), seeds, pos,
                                    temperature=0.7)
    want = jdec.sample_token_pos(jnp.asarray(logits), jnp.asarray(seeds),
                                 jnp.asarray(pos), temperature=0.7)
    assert got.tolist() == np.asarray(want).tolist()
    assert decoding.sample_token_pos(
        torch.tensor([[0., 2., 2.]]), None, None, 0.0).tolist() == [1]


def test_queue_bound_and_drain(models):
    _, _, tcfg, tp = models
    eng = ContinuousBatchingEngine(tp, tcfg, max_batch=1, max_len=32,
                                   max_queue=2, device="cpu")
    eng.submit([1, 2, 3], max_new=2)
    eng.submit([4, 5], max_new=2)
    with pytest.raises(QueueFullError):
        eng.submit([6], max_new=2)
    out = eng.drain()
    # JAX's drain() contract: {rid: Request}, each in a terminal status
    assert sorted(out) == [0, 1]
    assert all(r.status == RequestStatus.DONE and len(r.tokens) == 2
               for r in out.values())
    with pytest.raises(EngineClosedError):
        eng.submit([1], max_new=1)


def test_submit_validates(models):
    _, _, tcfg, tp = models
    eng = ContinuousBatchingEngine(tp, tcfg, max_batch=1, max_len=32,
                                   device="cpu")
    for prompt, max_new in (([], 1), ([1], 0), (list(range(30)), 5)):
        with pytest.raises(ValueError):
            eng.submit(prompt, max_new=max_new)
    assert _derive_buckets(32) == (16, 32)
    assert _derive_buckets(100) == (16, 32, 64, 100)


def test_rejected_submit_uses_up_its_rid_as_in_jax(models):
    """``max_queue=1``: the second submit is rejected (QueueFullError) and
    still takes a rid, in both engines; after the queue is served the
    next submit gets the same rid in both, and the streams agree."""
    jcfg, jp, tcfg, tp = models
    from paddle_tpu.inference.lifecycle import QueueFullError as JaxFull
    seen = []
    for eng, full in ((JaxEngine(jp, jcfg, max_batch=1, max_len=32,
                                 max_queue=1), JaxFull),
                      (ContinuousBatchingEngine(tp, tcfg, max_batch=1,
                                                max_len=32, max_queue=1,
                                                device="cpu"),
                       QueueFullError)):
        first = eng.submit([1, 2, 3], max_new=2)
        with pytest.raises(full):
            eng.submit([4, 5], max_new=2)
        out = eng.run()
        again = eng.submit([6, 7], max_new=2)
        out.update(eng.run())
        seen.append((first, again, eng._next_rid, out))
    assert seen[1][:3] == seen[0][:3] == (0, 2, 3)
    assert seen[1][3] == seen[0][3]
