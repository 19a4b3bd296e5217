"""Port parity: paddle_tpu_torch.models.llama against
paddle_tpu.models.llama.

Both packages compute with the same weights: the JAX ``init_params``
tree goes through numpy and ``params_from_numpy``.  The config is
``llama_tiny`` (vocab 1024, H 128, 4 layers, 4 heads of 32) in float32
at ``initializer_range=0.3`` (0.02 gives near-constant greedy streams
that would hide a broken cache), with grouped-query attention (2 KV
heads) and as MHA.  Float32 is the parity bar: logits and cache rows
within 1e-5 of their largest value (activations grow to tens at this
initializer scale), greedy streams identical.  In
bfloat16 the two frameworks round ``silu`` differently on the CPU
(``jax.nn.silu`` equals neither ``F.silu`` nor bf16 ``x * sigmoid(x)``
on a third of the elements), so a bf16 forward is held to a stated
tolerance only.

The slot loop is ``chip_smoke.llama_slot_loop``, the same loop the card
run drives; its JAX mirror here runs the JAX entry points under ``jit``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu_torch.incubate.nn.kernels import fused_norm_rope as fnr
from paddle_tpu_torch.models import llama as tl

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

REL = 1e-5


def _configs(kv_heads, dtype="float32"):
    kw = dict(initializer_range=0.3, num_kv_heads=kv_heads)
    return (jl.llama_tiny(dtype=getattr(jnp, dtype), **kw),
            tl.llama_tiny(dtype=getattr(torch, dtype), **kw))


@pytest.fixture(scope="module", params=[2, None], ids=["gqa", "mha"])
def models(request):
    jcfg, tcfg = _configs(request.param)
    jp = jl.init_params(jcfg, seed=0)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def gqa():
    jcfg, tcfg = _configs(2)
    jp = jl.init_params(jcfg, seed=0)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tcfg, tp


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 1024, shape).astype(
        np.int32)


def _close_of_max(got, want, rel=REL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def test_params_bridge_and_count(gqa):
    jcfg, jp, tcfg, tp = gqa
    assert set(tp) == {"wte", "layers", "final_norm", "lm_head"}
    assert tp["layers"]["k_w"].shape == (4, 128, 64)
    assert tl.param_count(tp) == jl.param_count(jp)
    own = tl.init_params(tcfg, seed=0, device="cpu")
    assert {k: v.shape for k, v in own["layers"].items()} == \
        {k: v.shape for k, v in tp["layers"].items()}
    assert tl.llama_7b().ffn_size == 11008 and tl.llama_7b().kv_heads == 32
    assert tl.LlamaConfig(hidden_size=768).ffn_size == \
        jl.LlamaConfig(hidden_size=768).ffn_size


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rope_matches_jax(dt):
    """rope_cos_sin at 1e-6 in float32; the interleaved-pair rotation on
    the same inputs and tables bit for bit (each product and the sum
    round in the input dtype in both)."""
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    jc, js = jl.rope_cos_sin(12, 32, 10000.0, jnp.float32)
    tc, ts = tl.rope_cos_sin(12, 32, 10000.0, torch.float32, "cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    x = np.random.default_rng(1).standard_normal((2, 12, 3, 32))
    jx, jc, js = (jnp.asarray(a, jdt) for a in (x, jc, js))

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)

    got = tl.apply_rope(t(jx), t(jc), t(js))
    want = jl.apply_rope(jx, jc, js)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_forward_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    ids = _ids(0, (2, 12))
    want = np.asarray(jl.forward(jp, jnp.asarray(ids), jcfg))
    got = tl.forward(tp, torch.from_numpy(ids), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 12, 1024)
    _close_of_max(got.numpy(), want)


def test_forward_bf16_within_stated_tolerance():
    """bf16 weights: logits within 5e-2 of their largest value.  silu and
    the matmul accumulations round differently in the two frameworks on
    the CPU (see the module docstring), so bf16 is not a parity bar."""
    jcfg, tcfg = _configs(2, "bfloat16")
    jp = jl.init_params(jcfg, seed=0)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    assert tp["wte"].dtype == torch.bfloat16
    ids = _ids(1, (2, 10))
    want = np.asarray(jl.forward(jp, jnp.asarray(ids), jcfg))
    got = tl.forward(tp, torch.from_numpy(ids), tcfg)
    _close_of_max(got.numpy(), want, rel=5e-2)


def test_prefill_and_decode_step_match_jax(gqa):
    jcfg, jp, tcfg, tp = gqa
    ids = _ids(2, (2, 9))
    jcache = jl.init_decode_cache(jcfg, 2, 16)
    jlog, jcache, jpos = jl.prefill(jp, jnp.asarray(ids), jcfg, jcache)
    tcache = tl.init_decode_cache(tcfg, 2, 16, device="cpu")
    tlog, tcache, tpos = tl.prefill(tp, torch.from_numpy(ids), tcfg, tcache)
    assert tpos == int(jpos) == 9
    _close_of_max(tlog.numpy(), np.asarray(jlog))
    for name in ("k", "v"):
        _close_of_max(tcache[name].numpy(), np.asarray(jcache[name]))
    tok = np.array([5, 700], np.int32)
    for pos in (9, 10):
        jlog, jcache = jl.decode_step(jp, jcache, jnp.asarray(tok), pos, jcfg)
        tlog, tcache = tl.decode_step(tp, tcache, torch.from_numpy(tok), pos,
                                      tcfg)
        _close_of_max(tlog.numpy(), np.asarray(jlog))
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for name in ("k", "v"):
        _close_of_max(tcache[name].numpy(), np.asarray(jcache[name]))


@pytest.mark.parametrize("attn_kernel", ["xla", "flash"])
def test_prefill_into_slots_and_decode_step_multi_match_jax(gqa, attn_kernel):
    """Both knobs on both sides (the port's "flash" runs flash_decode's
    plain version on the CPU, JAX's its Pallas kernel in interpret
    mode): the slot cache rows and per-slot decode logits."""
    jcfg, jp, tcfg, tp = gqa
    ids = _ids(3, (2, 7))
    slots = np.array([2, 0], np.int32)
    jcache = jl.init_decode_cache(jcfg, 3, 16, "int8")
    jcache = jl.prefill_into_slots(jp, jnp.asarray(ids), jcfg, jcache,
                                   jnp.asarray(slots),
                                   attn_kernel=attn_kernel)
    tcache = tl.init_decode_cache(tcfg, 3, 16, "int8", device="cpu")
    tl.prefill_into_slots(tp, torch.from_numpy(ids), tcfg, tcache,
                          torch.from_numpy(slots), attn_kernel=attn_kernel)
    np.testing.assert_allclose(tcache["ks"].numpy(), np.asarray(jcache["ks"]),
                               rtol=REL, atol=0)
    assert np.abs(tcache["k"].numpy().astype(int)
                  - np.asarray(jcache["k"]).astype(int)).max() <= 1
    tok = np.array([3, 9, 1000], np.int32)
    pos = np.array([7, 0, 7], np.int32)
    jlog, _ = jl.decode_step_multi(jp, jcache, jnp.asarray(tok),
                                   jnp.asarray(pos), jcfg,
                                   attn_kernel=attn_kernel)
    tlog, _ = tl.decode_step_multi(tp, tcache, torch.from_numpy(tok),
                                   torch.from_numpy(pos), tcfg,
                                   attn_kernel=attn_kernel)
    _close_of_max(tlog.numpy(), np.asarray(jlog))


def test_generate_streams_identical(models):
    jcfg, jp, tcfg, tp = models
    ids = _ids(4, (2, 16))
    want = np.asarray(jl.generate(jp, jnp.asarray(ids), jcfg,
                                  max_new_tokens=10))
    got = tl.generate(tp, ids, tcfg, max_new_tokens=10)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    # EOS: a row keeps emitting it after it appears
    eos = int(want[0, 3])
    want = np.asarray(jl.generate(jp, jnp.asarray(ids), jcfg,
                                  max_new_tokens=10, eos_token_id=eos))
    got = tl.generate(tp, ids, tcfg, max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 3:] == eos).all()


def test_generate_checks(gqa):
    _, _, tcfg, tp = gqa
    ids = _ids(5, (1, 8))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tl.generate(tp, ids, tcfg, max_new_tokens=250)
    with pytest.raises(ValueError, match="max_len"):
        tl.generate(tp, ids, tcfg, max_new_tokens=8, max_len=12)
    with pytest.raises(NotImplementedError, match="threefry"):
        tl.generate(tp, ids, tcfg, max_new_tokens=4, temperature=0.7)
    assert tl.generate(tp, ids, tcfg, max_new_tokens=1).shape == (1, 1)


def _jax_slot_loop(jcfg, jp, prompts, new_tokens, max_len, kv_dtype,
                   attn_kernel):
    """chip_smoke.llama_slot_loop's procedure on the JAX entry points."""
    cache = jl.init_decode_cache(jcfg, len(prompts), max_len, kv_dtype)
    pre = jax.jit(lambda p, ids, c, s: jl.prefill_into_slots(
        p, ids, jcfg, c, s, attn_kernel=attn_kernel))
    step = jax.jit(lambda p, c, t, pos: jl.decode_step_multi(
        p, c, t, pos, jcfg, attn_kernel=attn_kernel))
    for b, p in enumerate(prompts):
        cache = pre(jp, jnp.asarray(p[:-1])[None], cache, jnp.asarray([b]))
    tok = jnp.asarray([p[-1] for p in prompts], jnp.int32)
    pos = jnp.asarray([len(p) - 1 for p in prompts], jnp.int32)
    out = []
    for i in range(new_tokens):
        if i:
            pos = pos + 1
        logits, cache = step(jp, cache, tok, pos)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(out, 1).tolist()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_slot_loop_streams_identical(gqa, kv_dtype):
    """attn_kernel "xla" on both sides; "flash" is held per call by
    test_prefill_into_slots_and_decode_step_multi_match_jax."""
    jcfg, jp, tcfg, tp = gqa
    rng = np.random.default_rng(6)
    # two prompt lengths over four slots: each length is one JAX compile
    prompts = [rng.integers(0, 1024, (n,)) for n in (5, 23, 23, 5)]
    want = _jax_slot_loop(jcfg, jp, prompts, 8, 64, kv_dtype, "xla")
    got = chip_smoke.llama_slot_loop(tl, tp, tcfg, prompts, 8, 64, kv_dtype,
                                     "xla", "cpu")
    assert got["streams"] == want
    assert got["first_logits"].shape == (4, 1024)


def test_use_flash_routes_the_rms_norm(gqa, monkeypatch):
    """use_flash None/True go through the kernel wrapper (its plain
    version on the CPU, no launch), False calls the plain version
    directly; all three give the same logits."""
    _, _, tcfg, tp = gqa
    ids = torch.from_numpy(_ids(7, (1, 6)))
    calls = []
    real = fnr.rms_norm

    def spy(*a):
        calls.append(a[3])
        return real(*a)

    monkeypatch.setattr(tl, "rms_norm", spy)
    before = dict(fnr.LAUNCHES)
    outs = {}
    for flag in (None, True, False):
        calls.clear()
        cfg = tl.llama_tiny(initializer_range=0.3, num_kv_heads=2,
                            use_flash=flag)
        outs[flag] = tl.forward(tp, ids, cfg)
        assert calls == ([] if flag is False else ["llama"] * 9), (flag,
                                                                  calls)
    assert fnr.LAUNCHES == before
    torch.testing.assert_close(outs[True], outs[False], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[None], outs[False], rtol=0, atol=0)
