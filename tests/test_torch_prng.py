"""Port parity: ``paddle_tpu_torch.models.prng`` against ``jax.random``.

The installed JAX runs threefry2x32 keys with 32-bit integers and
``jax_threefry_partitionable=True``; the port must give that mode's
words.  Keys, fold_in, split, the random bits and the float32 uniforms
are integer operations and one float32 subtraction: equal bit for bit.
The Gumbel noise takes two logs, and XLA:CPU's ``log`` is not correctly
rounded (nor is torch's), so it is held within 5e-7 absolute, or one
float32 ulp of JAX's value where that ulp is larger (|g| >= 8, where the
grid itself is 9.5e-7 apart); a Gumbel-max draw then gives
``jax.random.categorical``'s token except at a near-tie, two
candidates' perturbed scores within 2e-6 of each other, which the test
reports and never re-seeds away.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng as jprng

from paddle_tpu_torch.incubate.nn.kernels import sampling
from paddle_tpu_torch.models import prng

SEEDS = (0, 1, 2 ** 31 - 1, -7)
V = 50304
TIE = 2e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module's [B, V] integer passes (the
    tier-1 run has six processes); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(a):
    """A JAX uint32 array as the port's int64 words."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_threefry2x32_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(4):
        k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
        count = rng.integers(0, 2 ** 32, 2 * 1000,
                             dtype=np.uint64).astype(np.uint32)
        want = np.asarray(jprng.threefry_2x32(
            (jnp.uint32(k[0]), jnp.uint32(k[1])), jnp.asarray(count)))
        c = torch.from_numpy(count.astype(np.int64))
        o0, o1 = prng.threefry2x32(int(k[0]), int(k[1]), c[:1000], c[1000:])
        np.testing.assert_array_equal(torch.cat([o0, o1]).numpy(),
                                      want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_match_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    assert key.dtype == torch.int64 and key.shape == (2,)
    assert torch.equal(key, _words(jkey))
    # a tensor of seeds keys each element
    seeds = torch.tensor([seed, 5], dtype=torch.int32)
    assert torch.equal(prng.PRNGKey(seeds),
                       torch.stack([_words(jkey),
                                    _words(jax.random.PRNGKey(5))]))
    pos = np.arange(4096)
    want = jax.vmap(jax.random.fold_in, (None, 0))(jkey, pos)
    assert torch.equal(prng.fold_in(key, torch.from_numpy(pos)),
                       _words(want))
    assert torch.equal(prng.fold_in(key, 123),
                       _words(jax.random.fold_in(jkey, 123)))
    for n in (2, 3, 7, 64):
        assert torch.equal(prng.split(key, n),
                           _words(jax.random.split(jkey, n)))


@pytest.mark.parametrize("shape", [(V,), (4, V), (3, 1000)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_match_jax(seed, shape):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 77)
    key = prng.fold_in(prng.PRNGKey(seed), 77)
    assert torch.equal(prng.random_bits(key, shape),
                       _words(jax.random.bits(jkey, shape, jnp.uint32)))
    tiny = np.finfo(np.float32).tiny
    for lo, hi in ((0.0, 1.0), (tiny, 1.0)):
        want = np.asarray(jax.random.uniform(jkey, shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(key, shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_an_ulp_of_jax(seed):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    key = prng.fold_in(prng.PRNGKey(seed), 5)
    for shape in ((V,), (4, V)):
        want = np.asarray(jax.random.gumbel(jkey, shape))
        got = prng.gumbel(key, shape).numpy()
        limit = np.maximum(5e-7, np.spacing(np.abs(want)))
        over = np.abs(got - want) > limit
        assert not over.any(), (got[over], want[over])


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_argmax_gives_jax_categorical_tokens(seed):
    """The plain Gumbel-max draw (``sampling.gumbel_argmax_plain`` with
    one key for the whole [8, V] array) gives ``jax.random.categorical``'s
    tokens; a difference must be a reported near-tie."""
    rng = np.random.default_rng(seed & 0xFFFF)
    logits = (rng.standard_normal((8, V)) * 3).astype(np.float32)
    jkey = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(jkey, jnp.asarray(logits)))
    key = prng.PRNGKey(seed)
    got = sampling.gumbel_argmax_plain(torch.from_numpy(logits),
                                       key=key).numpy()
    scores = torch.from_numpy(logits) + prng.gumbel(key, logits.shape)
    for b in np.nonzero(got != want)[0]:
        margin = abs(float(scores[b, got[b]] - scores[b, want[b]]))
        assert margin < TIE, (b, got[b], want[b], margin)
        warnings.warn(f"near-tie: row {b}, tokens {got[b]} / {want[b]}, "
                      f"perturbed scores {margin} apart")
