"""Port parity for the one-device training path: the GPT loss and its
gradients, AdamW, ``hybrid.build_train_step`` and the async
``TrainLoop``, each against the JAX package on the same numpy-made
weights and batches (gpt_tiny, float32, on the CPU).

Tolerances, float32 with another summation order: the loss at rel 1e-5
and every gradient at atol 1e-5; three train steps at rel 1e-4 on the
losses, and the updates at 0.01 x lr where the gradient is clear of
zero (AdamW's m / (sqrt(v) + eps) turns tiny gradient differences into
steps of up to lr where a gradient is near zero, so there every param
is held at 3 x lr).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import hybrid as jhybrid
from paddle_tpu.distributed.process_mesh import ProcessMesh
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.distributed import hybrid as thybrid
from paddle_tpu_torch.jit import loop as tl
from paddle_tpu_torch.jit.loop import DeferredScalar, TrainLoop, \
    TrainStepError
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.common import matmul_f32out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jgpt.gpt_tiny(unroll_layers=False)
    jp = jgpt.init_params(jcfg, seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    return jcfg, tree, ids, labels


def test_bf16_tied_head_is_a_float32_output_product():
    """The repaired head: bf16 LN output and bf16 table give the JAX
    ``preferred_element_type=float32`` logits, where rounding the
    product to bf16 first (the old head) is off by ~1e-3."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 16, 128)), jnp.bfloat16)
    wte = jnp.asarray(rng.standard_normal((1024, 128)) * 0.02, jnp.bfloat16)
    want = np.asarray(jnp.einsum("bsh,vh->bsv", x, wte,
                                 preferred_element_type=jnp.float32))
    tx = tgpt.params_from_numpy({"x": np.asarray(x)}, device="cpu")["x"]
    tw = tgpt.params_from_numpy({"w": np.asarray(wte)}, device="cpu")["w"]
    got = tgpt._tied_logits(tx, tw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    rounded = (tx @ tw.t()).float().numpy()
    assert np.abs(rounded - want).max() > 1e-4
    np.testing.assert_allclose(matmul_f32out(tx[0], tw.t()).numpy(),
                               want[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_flash", [False, True])
def test_loss_and_grads_match_jax(tiny, use_flash):
    """use_flash=True runs the flash Function's plain forward and
    backward; the JAX side runs its Pallas kernel in interpret mode."""
    jcfg, tree, ids, labels = tiny
    jcfg = jgpt.gpt_tiny(unroll_layers=False, use_flash=use_flash)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jl, jg = jax.value_and_grad(jgpt.loss_fn)(jp, jnp.asarray(ids),
                                              jnp.asarray(labels), jcfg)
    tcfg = tgpt.gpt_tiny(use_flash=use_flash)
    tp = tgpt.params_from_numpy(tree, device="cpu")
    leaves = list(_flat(tp).keys())
    flat_t = {}

    def req(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                req(v, f"{prefix}{k}/")
            else:
                v.requires_grad_(True)
                flat_t[f"{prefix}{k}"] = v
    req(tp)
    loss = tgpt.loss_fn(tp, torch.from_numpy(ids), torch.from_numpy(labels),
                        tcfg)
    grads = torch.autograd.grad(loss, [flat_t[k] for k in leaves])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, jg))
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_forward_remat_matches_plain(tiny):
    _, tree, ids, _ = tiny
    cfg = tgpt.gpt_tiny()
    tp = tgpt.params_from_numpy(tree, device="cpu")
    a = tgpt.forward(tp, torch.from_numpy(ids), cfg, remat=False)
    b = tgpt.forward(tp, torch.from_numpy(ids), cfg, remat=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="partial"):
        tgpt.forward(tp, torch.from_numpy(ids), cfg, remat="partial:2")


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    rng = np.random.default_rng(4)
    shapes = {"a": (8, 5), "b": {"c": (7,), "d": (3, 2, 4)}}

    def make(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    params, g1, g2 = make(1.0), make(3.0), make(0.01)
    cfg = jhybrid.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jdt = getattr(jnp, moment_dtype)
    tdt = getattr(torch, moment_dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jhybrid.adamw_init(jp, moment_dtype=jdt)
    tp = tgpt.params_from_numpy(params, device="cpu")
    ts = thybrid.adamw_init(tp, moment_dtype=tdt)
    tcfg = thybrid.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    for g in (g1, g2):           # the first clips, the second does not
        jp, js = jhybrid.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js, cfg)
        out = thybrid.adamw_update(
            tp, tgpt.params_from_numpy(g, device="cpu"), ts, tcfg)
        assert out[0] is tp and out[1] is ts       # in place
    assert int(ts["step"]) == int(js["step"]) == 2
    want = _flat(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in _flat(tp).items():
        np.testing.assert_allclose(p, want[name], rtol=0, atol=1e-6,
                                   err_msg=name)
    for key in ("m", "v"):
        assert all(t.dtype == tdt for t in _flat_tensors(ts[key]))
        wm = _flat(js[key])
        for name, m in _flat(ts[key]).items():
            # bf16 moments: the same f32 update rounded once to bf16
            np.testing.assert_allclose(m, wm[name], rtol=1e-2 if
                                       moment_dtype == "bfloat16" else 1e-6,
                                       atol=1e-7, err_msg=name)


def _flat_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat_tensors(v)]
    return [tree]


@pytest.mark.parametrize("num_micro,remat", [(1, False), (2, True)])
def test_train_steps_match_jax(tiny, num_micro, remat):
    """Losses at rel 1e-4; the update itself, params after minus params
    before, at 0.01 x lr after one step and after three, on the elements
    whose gradient stays clear of zero (|g| > 1e-5 at every step; over
    85 % of them).  Every param is also within 3 x lr."""
    jcfg, tree, ids, labels = tiny
    mesh = ProcessMesh(np.arange(1).reshape(1, 1, 1), ["dp", "pp", "mp"])
    jstep, jshard, jinit = jhybrid.build_train_step(
        jcfg, mesh, num_micro=num_micro, remat=remat, zero=0)
    jp = jshard(jax.tree_util.tree_map(jnp.asarray, tree))
    jo = jinit(jp)
    tcfg = tgpt.gpt_tiny()
    tstep, tshard, tinit = thybrid.build_train_step(
        tcfg, num_micro=num_micro, remat=remat, device="cpu")
    tp = tshard(tgpt.params_from_numpy(tree, device="cpu"))
    to = tinit(tp)
    tids, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    lr = thybrid.AdamWConfig().lr
    before = _flat(tree)
    clear = {name: np.ones(p.shape, bool) for name, p in before.items()}
    jl, tl_ = [], []
    for i in range(3):
        _, grads = tstep.loss_and_grads(tp, tids, tlab)
        for name, g in _flat(grads).items():
            clear[name] &= np.abs(g) > 1e-5
        loss, jp, jo = jstep(jp, jo, jnp.asarray(ids), jnp.asarray(labels))
        jl.append(float(loss))
        loss, tp, to = tstep(tp, to, tids, tlab)
        assert loss.dim() == 0 and loss.dtype == torch.float32
        tl_.append(loss.item())
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
    np.testing.assert_allclose(tl_, jl, rtol=1e-4)
    assert tl_[2] < tl_[0]
    for name, p in got.items():
        np.testing.assert_allclose(p, want[name], rtol=0, atol=3 * lr,
                                   err_msg=name)


def test_step_rejects_indivisible_batch(tiny):
    _, tree, ids, labels = tiny
    step, shard, init_opt = thybrid.build_train_step(
        tgpt.gpt_tiny(), num_micro=3, device="cpu")
    p = shard(tgpt.params_from_numpy(tree, device="cpu"))
    with pytest.raises(ValueError, match="num_micro"):
        step(p, init_opt(p), torch.from_numpy(ids), torch.from_numpy(labels))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thybrid.build_train_step(tgpt.gpt_tiny())


# ---------------------------------------------------------------------------
# TrainLoop / DeferredScalar (after tests/test_train_loop.py)
# ---------------------------------------------------------------------------

def test_deferred_scalar_is_lazy_and_counted():
    base = tl.host_sync_count()
    d = DeferredScalar(torch.tensor(2.5))
    assert not d.materialized and tl.host_sync_count() == base
    assert float(d) == 2.5 and d.materialized
    assert tl.host_sync_count() == base + 1
    assert d.item() == 2.5 and int(d) == 2 and f"{d:.2f}" == "2.50"
    assert d == 2.5 and d < 3 and d >= 2.5
    assert tl.host_sync_count() == base + 1
    import numbers
    assert isinstance(d, numbers.Number)
    prev = tl.reset_host_syncs()
    assert prev >= 1 and tl.host_sync_count() == 0


def test_loop_bounds_inflight_without_host_syncs():
    loop = TrainLoop(max_inflight=2)
    base = tl.host_sync_count()
    handles = []
    for i in range(6):
        handles.append(loop.admit(torch.tensor(float(i))))
        assert loop.inflight <= 2
    assert tl.host_sync_count() == base      # completion waits only
    loop.drain()
    assert loop.inflight == 0 and loop.stats()["steps"] == 6
    assert [float(h) for h in handles] == [0, 1, 2, 3, 4, 5]
    with pytest.raises(ValueError):
        TrainLoop(max_inflight=0)


def test_loop_step_fn_async_matches_sync():
    def step(w, x):
        loss = ((x @ w) ** 2).mean()
        return loss, w - 0.1 * x.t() @ (x @ w) / x.shape[0]

    xs = [torch.from_numpy(np.random.default_rng(i).random((8, 4),
                                                           np.float32))
          for i in range(5)]

    def run(sync):
        w = torch.ones(4, 1)
        loop, out = TrainLoop(step, max_inflight=2), []
        for x in xs:
            d, w = loop.step(w, x)
            if sync:
                float(d)
            out.append(d)
        loop.drain()
        return [float(d) for d in out]
    assert run(True) == run(False)


def test_loop_step_error_names_the_step_and_drains():
    calls = []

    def step(x):
        calls.append(x)
        if len(calls) == 3:
            raise OSError("injected")
        return x * 2

    with TrainLoop(step, max_inflight=2) as loop:
        outs = [loop.step(torch.tensor(float(i))) for i in range(2)]
        with pytest.raises(TrainStepError) as ei:
            loop.step(torch.tensor(2.0))
        assert ei.value.step_index == 2 and loop.inflight == 0
        assert [float(o) for o in outs] == [0.0, 2.0]
        assert float(loop.step(torch.tensor(5.0))) == 10.0
    assert loop.inflight == 0
