"""Port parity: paddle_tpu_torch.models.gpt against paddle_tpu.models.gpt.

Both packages compute with the same weights: the JAX ``init_params``
tree goes through numpy and ``params_from_numpy``.  The config is the
tiny serving-test GPT (vocab 128, H 32, 2 layers, 2 heads, float32,
XLA attention), the one the JAX serving tests use.  Logits and cache
rows are held to rtol = atol = 1e-5 (float32, different reduction
order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import gpt as tgpt

TOL = dict(rtol=1e-5, atol=1e-5)


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
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, tcfg, tgpt.params_from_numpy(tree, device="cpu")


def test_params_from_numpy_round_trips(models):
    _, jp, _, tp = models
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tgpt.param_count(tp) == sum(x.size for x in
                                       jax.tree_util.tree_leaves(jp))


def test_params_from_numpy_bfloat16():
    a = np.asarray(jnp.asarray([[1.5, -2.25], [3e-3, 7.0]], jnp.bfloat16))
    t = tgpt.params_from_numpy({"w": a}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_forward_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    ids = np.random.default_rng(0).integers(0, 128, (2, 12)).astype(np.int32)
    ref = np.asarray(jgpt.forward(jp, jnp.asarray(ids), jcfg))
    out = tgpt.forward(tp, torch.from_numpy(ids), tcfg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_causal_attention_flash_is_not_silently_plain():
    """use_flash=True goes through the flash_attention op (its plain
    versions on the CPU), not the plain composition."""
    q = torch.randn(1, 4, 2, 16, requires_grad=True)
    out = tgpt._causal_attention(q, q, q, 16, use_flash=True)
    assert "flash_attention_fwd" in type(out.grad_fn).__name__
    plain = tgpt._causal_attention(q, q, q, 16, use_flash=False)
    assert "flash_attention_fwd" not in type(plain.grad_fn).__name__
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-6)


def test_prefill_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    ids = np.random.default_rng(4).integers(0, 128, (2, 9)).astype(np.int32)
    jl, jc, jpos = jgpt.prefill(jp, jnp.asarray(ids), jcfg,
                                jgpt.init_decode_cache(jcfg, 2, 32))
    cache = tgpt.init_decode_cache(tcfg, 2, 32, device="cpu")
    tl, tc, tpos = tgpt.prefill(tp, torch.from_numpy(ids), tcfg, cache,
                                attn_kernel="flash")
    assert tc is cache and tpos == int(jpos) == 9
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


@pytest.mark.parametrize("attn_kernel", ["xla", "flash"])
def test_prefill_then_decode_matches_jax(models, attn_kernel):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(1)
    B, T, S = 3, 48, 16
    ids = rng.integers(0, 128, (2, S)).astype(np.int32)
    slots = np.array([2, 0], np.int32)
    jcache = jgpt.prefill_into_slots(
        jp, jnp.asarray(ids), jcfg, jgpt.init_decode_cache(jcfg, B, T),
        jnp.asarray(slots), attn_kernel=attn_kernel)
    tcache = tgpt.init_decode_cache(tcfg, B, T, device="cpu")
    out = tgpt.prefill_into_slots(tp, torch.from_numpy(ids), tcfg, tcache,
                                  torch.from_numpy(slots),
                                  attn_kernel=attn_kernel)
    assert out is tcache
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, :, :S].numpy(),
                                   np.asarray(jcache[key])[:, :, :S], **TOL)
    # slot 1 was never admitted: it decodes at the junk row T-1
    tok = np.array([5, 9, 3], np.int32)
    pos = np.array([S - 1, T - 1, 7], np.int32)
    for step in range(3):
        jl, jcache = jgpt.decode_step_multi(
            jp, jcache, jnp.asarray(tok), jnp.asarray(pos), jcfg,
            attn_kernel=attn_kernel)
        tl, _ = tgpt.decode_step_multi(
            tp, tcache, torch.from_numpy(tok), torch.from_numpy(pos), tcfg,
            attn_kernel=attn_kernel)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for key in ("k", "v"):
            for b in range(B):
                np.testing.assert_allclose(
                    tcache[key][:, b, :pos[b] + 1].numpy(),
                    np.asarray(jcache[key])[:, b, :pos[b] + 1], **TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = np.minimum(pos + 1, T - 1).astype(np.int32)


def test_attn_kernel_knob_validated(models):
    _, _, tcfg, tp = models
    with pytest.raises(ValueError, match="attn_kernel"):
        tgpt.decode_step_multi(tp, {}, torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32), tcfg,
                               attn_kernel="cuda")


def test_init_params_layout_and_seed():
    cfg = tgpt.gpt_tiny(num_layers=2, hidden_size=32, num_heads=2,
                        vocab_size=64, max_position_embeddings=16)
    a = tgpt.init_params(cfg, seed=3, device="cpu")
    b = tgpt.init_params(cfg, seed=3, device="cpu")
    assert a["layers"]["qkv_w"].shape == (2, 32, 3, 32)
    assert a["layers"]["fc1_w"].shape == (2, 32, 128)
    assert torch.equal(a["wte"], b["wte"])
    assert not torch.equal(
        a["wte"], tgpt.init_params(cfg, seed=4, device="cpu")["wte"])


def test_entry_points_default_to_cuda():
    cfg = tgpt.gpt_tiny()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.init_decode_cache(cfg, 1, 8)
