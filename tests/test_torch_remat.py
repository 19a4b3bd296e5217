"""Port parity for the remat plans of ``models.common.
scan_layers_with_remat``: ``'partial:K'``, ``dots_saveable_attn`` and every
argument-free name of ``jax.checkpoint_policies``, on GPT and LLaMA
(gpt_tiny, llama_tiny, float32, on the CPU), against the JAX package's
plan of the same name on the same numpy-made weights and batch.

Tolerance: every gradient within 1e-5 of its leaf's largest value (at
least 1e-5), float32 with another summation order; a plan against the
port's own ``remat=False`` at 1e-5 absolute (the recompute re-runs the
same ops on the same values).  The flash op's forward runs are counted
on the CPU (its plain version): L a step without remat, 2L under
``True`` and ``dots_saveable``, L under ``dots_saveable_attn`` and
``partial:K``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
from paddle_tpu_torch.models import common
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

NAMED = ("everything_saveable", "nothing_saveable", "dots_saveable",
         "checkpoint_dots", "dots_with_no_batch_dims_saveable",
         "checkpoint_dots_with_no_batch_dims", "dots_saveable_attn")
FAMILIES = {"gpt": (jgpt, tgpt, jgpt.gpt_tiny, tgpt.gpt_tiny),
            "llama": (jllama, tllama, jllama.llama_tiny, tllama.llama_tiny)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _flat_tree(tree):
    """A tree of CPU tensors as the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _flat_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the tiny products run in microseconds, and more
    threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """The weights are the port's ``init_params`` (seed 0) as numpy
    arrays, handed to both packages (JAX's own init compiles for ~4 s)."""
    jmod, tmod, jtiny, ttiny = FAMILIES[request.param]
    jcfg = jtiny(unroll_layers=False)
    tree = _flat_tree(tmod.init_params(ttiny(), seed=0, device="cpu"))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    # one jitted JAX gradient per policy object: checkpoint_dots IS
    # dots_saveable in jax.checkpoint_policies (the no-batch-dims pair
    # likewise)
    cache = {}

    def jax_grads(plan):
        pol = getattr(jax.checkpoint_policies, plan, plan) \
            if isinstance(plan, str) else plan
        key = ("policy", id(pol)) if pol is not plan else ("plan", plan)
        if key not in cache:
            g = jax.jit(jax.grad(lambda p, i, l: jmod.loss_fn(
                p, i, l, jcfg, remat=plan)))(jp, jnp.asarray(ids),
                                             jnp.asarray(labels))
            cache[key] = _flat(jax.tree_util.tree_map(np.asarray, g))
        return cache[key]

    return request.param, tmod, ttiny, tree, ids, labels, jax_grads


def _port_grads(tmod, cfg, tree, ids, labels, remat):
    tp = tmod.params_from_numpy(tree, device="cpu")
    leaves = {name: t.requires_grad_(True)
              for name, t in _flat_tensors(tp).items()}
    loss = tmod.loss_fn(tp, torch.from_numpy(ids), torch.from_numpy(labels),
                        cfg, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {name: g.numpy() for name, g in zip(leaves, grads)}


@pytest.mark.parametrize("plan", (True,) + NAMED + ("partial:2",))
def test_named_plans_match_jax(family, plan):
    """Each plan's gradients against JAX's plan of the same name."""
    _, tmod, ttiny, tree, ids, labels, jax_grads = family
    got = _port_grads(tmod, ttiny(), tree, ids, labels, plan)
    want = jax_grads(plan)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(
            g, want[name], rtol=0,
            atol=1e-5 * max(1.0, np.abs(want[name]).max()),
            err_msg=f"{plan}: {name}")


def test_partial_remat_grads_match_and_edges(family):
    """After tests/test_models.py::TestPartialRemat: partial:2 is a pure
    memory/compute trade (remat=False's gradients), K >= L is the
    uniform policy, K <= 0 raises."""
    _, tmod, ttiny, tree, ids, labels, _ = family
    cfg = ttiny()
    g0 = _port_grads(tmod, cfg, tree, ids, labels, False)
    g1 = _port_grads(tmod, cfg, tree, ids, labels, "partial:2")
    for name in g0:
        np.testing.assert_allclose(g1[name], g0[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    tp = tmod.params_from_numpy(tree, device="cpu")
    tids, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    tmod.loss_fn(tp, tids, tlab, cfg, remat=f"partial:{cfg.num_layers + 3}")
    with pytest.raises(ValueError):
        tmod.loss_fn(tp, tids, tlab, cfg, remat="partial:0")


def test_unknown_plan_raises(family):
    """An unknown name raises AttributeError, as JAX's getattr on
    jax.checkpoint_policies does (JAX's own loss raises the same)."""
    _, tmod, ttiny, tree, ids, labels, jax_grads = family
    with pytest.raises(AttributeError):
        jax_grads("no_such_policy")
    with pytest.raises(AttributeError, match="no_such_policy"):
        _port_grads(tmod, ttiny(), tree, ids, labels, "no_such_policy")


PIN_WANT = {False: 1, True: 2, "dots_saveable": 2, "dots_saveable_attn": 1,
            "partial:2": 1, "everything_saveable": 1, "nothing_saveable": 2}


@pytest.mark.parametrize("plan", list(PIN_WANT))
def test_flash_forward_runs_per_plan(family, plan, monkeypatch):
    """The pin: the flash op's forward (its plain version on the CPU)
    runs L times a step under False, dots_saveable_attn and partial:K,
    2L under True and dots_saveable (the op is not a product, so that
    policy re-runs it in the backward).  The backward runs L + L."""
    _, tmod, ttiny, tree, ids, labels, _ = family
    cfg = ttiny(use_flash=True)
    runs = {"fwd": 0, "dkv": 0, "dq": 0}
    for key, name in (("fwd", "flash_attention_with_lse_plain"),
                      ("dkv", "flash_attention_bwd_dkv_plain"),
                      ("dq", "flash_attention_bwd_dq_plain")):
        orig = getattr(fa, name)

        def counted(*a, _orig=orig, _key=key, **k):
            runs[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(fa, name, counted)
    got = _port_grads(tmod, cfg, tree, ids, labels, plan)
    L = cfg.num_layers
    assert runs == {"fwd": PIN_WANT[plan] * L, "dkv": L, "dq": L}, plan
    assert all(np.isfinite(g).all() for g in got.values())


def test_policy_saves_the_products_and_the_flash_op():
    """The named policies' op sets: products with and without batch
    dimensions, and the flash op only under dots_saveable_attn."""
    from torch.utils.checkpoint import CheckpointPolicy
    flash = torch.ops.paddle_tpu_torch.flash_attention_fwd.default
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    add = torch.ops.aten.add.Tensor
    save = CheckpointPolicy.MUST_SAVE

    def saved(name):
        pol = common.remat_policy(name)
        return {op for op in (flash, mm, bmm, add) if pol(None, op) == save}
    assert saved("dots_saveable") == saved("checkpoint_dots") == {mm, bmm}
    assert saved("dots_with_no_batch_dims_saveable") == {mm}
    assert saved("dots_saveable_attn") == {mm, bmm, flash}
    assert saved("everything_saveable") == {flash, mm, bmm, add}
    assert saved("nothing_saveable") == set()
