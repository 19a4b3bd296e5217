"""Port parity for LLaMA training: ``llama.loss_fn``, its gradients and
``hybrid.build_train_step(model=llama_stage_model(...))`` against the
JAX package on the same numpy-made weights and batches (llama_tiny,
float32, on the CPU, grouped-query attention with 2 KV heads and MHA).

Tolerances, float32 with another summation order: the loss at rel 1e-5
and every gradient within 1e-5 of its leaf's largest value; three AdamW
steps at rel 1e-4 on the losses, and the updates (params after minus
params before) at 0.01 x lr where the gradient is clear of zero at every
step (AdamW's m / (sqrt(v) + eps) turns tiny gradient differences into
steps of up to lr where a gradient is near zero, so there every param
is held at 3 x lr), as ``test_torch_train.py`` holds the GPT step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import hybrid as jhybrid
from paddle_tpu.distributed.process_mesh import ProcessMesh
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.distributed import hybrid as thybrid
from paddle_tpu_torch.models import llama as tl


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module", params=[2, None], ids=["gqa", "mha"])
def tiny(request):
    jcfg = jl.llama_tiny(num_kv_heads=request.param)
    tcfg = tl.llama_tiny(num_kv_heads=request.param)
    tree = jax.tree_util.tree_map(np.asarray, jl.init_params(jcfg, seed=0))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    return jcfg, tcfg, tree, ids, labels


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(tiny, remat):
    jcfg, tcfg, tree, ids, labels = tiny
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss, jg = jax.value_and_grad(jl.loss_fn)(
        jp, jnp.asarray(ids), jnp.asarray(labels), jcfg, remat=remat)
    tp = tl.params_from_numpy(tree, device="cpu")
    leaves = {name: t.requires_grad_(True) for name, t in
              _flat_tensors(tp).items()}
    loss = tl.loss_fn(tp, torch.from_numpy(ids), torch.from_numpy(labels),
                      tcfg, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, jg))
    assert set(want) == set(leaves)
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=0,
            atol=1e-5 * max(1.0, np.abs(want[name]).max()), err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_match_jax(tiny, remat):
    jcfg, tcfg, tree, ids, labels = tiny
    mesh = ProcessMesh(np.arange(1).reshape(1, 1, 1), ["dp", "pp", "mp"])
    jstep, jshard, jinit = jhybrid.build_train_step(
        jcfg, mesh, num_micro=1, remat=remat, zero=0,
        model=jhybrid.llama_stage_model(jcfg, {"dp": 1, "pp": 1, "mp": 1},
                                        remat=remat))
    jp = jshard(jax.tree_util.tree_map(jnp.asarray, tree))
    jo = jinit(jp)
    tstep, tshard, tinit = thybrid.build_train_step(
        tcfg, device="cpu", model=thybrid.llama_stage_model(tcfg, remat))
    tp = tshard(tl.params_from_numpy(tree, device="cpu"))
    to = tinit(tp)
    tids, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    lr = thybrid.AdamWConfig().lr
    before = _flat(tree)
    clear = {name: np.ones(p.shape, bool) for name, p in before.items()}
    jlosses, tlosses = [], []
    for i in range(3):
        _, grads = tstep.loss_and_grads(tp, tids, tlab)
        for name, g in _flat(grads).items():
            clear[name] &= np.abs(g) > 1e-5
        loss, jp, jo = jstep(jp, jo, jnp.asarray(ids), jnp.asarray(labels))
        jlosses.append(float(loss))
        loss, tp, to = tstep(tp, to, tids, tlab)
        assert loss.dim() == 0 and loss.dtype == torch.float32
        tlosses.append(loss.item())
        if i in (0, 2):
            # np.array copies: the next JAX step donates these buffers
            want = _flat(jax.tree_util.tree_map(np.array, jp))
            got = _flat(tp)
            share = (sum(int(c.sum()) for c in clear.values())
                     / sum(c.size for c in clear.values()))
            assert share >= 0.85, share
            for name, p0 in before.items():
                c = clear[name]
                np.testing.assert_allclose(
                    (got[name] - p0)[c], (want[name] - p0)[c], rtol=0,
                    atol=0.01 * lr, err_msg=f"step {i + 1} update of {name}")
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[2] < tlosses[0]
    for name, p in got.items():
        np.testing.assert_allclose(p, want[name], rtol=0, atol=3 * lr,
                                   err_msg=name)


def test_gpt_is_the_default_family():
    """No ``model``: the GPT stage, as before; a LLaMA tree through the
    GPT stage fails on its missing position table."""
    from paddle_tpu_torch.models import gpt as tgpt
    cfg = tgpt.gpt_tiny()
    step, shard, init_opt = thybrid.build_train_step(cfg, device="cpu")
    p = shard(tgpt.init_params(cfg, seed=0, device="cpu"))
    ids = torch.zeros((2, 8), dtype=torch.long)
    loss, _, _ = step(p, init_opt(p), ids, ids)
    assert torch.isfinite(loss)
    lcfg = tl.llama_tiny()
    lstep, lshard, _ = thybrid.build_train_step(lcfg, device="cpu")
    lp = lshard(tl.init_params(lcfg, seed=0, device="cpu"))
    with pytest.raises(KeyError, match="wpe"):
        lstep.loss_and_grads(lp, ids, ids)


@pytest.mark.parametrize("remat", [False, True])
def test_remat_beside_a_model_raises(remat):
    """A stage model carries its own remat; the builder's would be
    ignored, so passing both is refused."""
    cfg = tl.llama_tiny()
    with pytest.raises(ValueError, match="remat"):
        thybrid.build_train_step(cfg, device="cpu", remat=remat,
                                 model=thybrid.llama_stage_model(cfg, remat))
