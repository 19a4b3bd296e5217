"""Port parity for BERT pretraining (``paddle_tpu_torch.models.bert`` and
``distributed.hybrid.bert_stage_model``) against the JAX package on the
same numpy-made weights and batches, float32, on the CPU.  The cases
follow ``tests/test_models.py::TestBert`` and
``tests/test_stage_models.py::TestBertPipeline``.

Tolerances, float32 with another summation order: logits at atol 1e-5;
the loss at rel 1e-5 and every gradient within 1e-5 of max(1, its
leaf's largest value); the stage model's micro-batched loss at rel 1e-5
and its gradients as above; three AdamW steps at rel 1e-4 on the losses
and the params within 3 x lr (AdamW's m / (sqrt(v) + eps) turns tiny
gradient differences into steps of up to lr where a gradient is near
zero), the update at 0.01 x lr where the gradient stays clear of zero.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.distributed import hybrid as jhybrid
from paddle_tpu.distributed.process_mesh import ProcessMesh
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.distributed import hybrid as thybrid
from paddle_tpu_torch.incubate.nn.functional.chunked_ce import (
    chunked_vocab_nll, pick_num_chunks)
from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
from paddle_tpu_torch.jit.loop import TrainLoop
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models.common import params_from_numpy

REMATS = (False, True, "dots_saveable_attn", "partial:2")
LR = thybrid.AdamWConfig().lr


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _assert_grads(got, want):
    """Every leaf within 1e-5 of max(1, max |want|)."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for name, w in want.items():
        tol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the tiny products only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """TestBertPipeline's config and batch: vocab 512, H 64, 4 layers of
    4 heads, FFN 128, 8 sequences of 32, MLM labels on ~30 % of the
    positions."""
    jcfg = jbert.BertConfig(
        vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
        intermediate_size=128, max_position_embeddings=64,
        dtype=jnp.float32, use_flash=False, unroll_layers=False)
    tree = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda: jbert.init_params(jcfg, 0))())
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jcfg.vocab_size, (8, 32)).astype(np.int32)
    mlm = rng.integers(0, jcfg.vocab_size, (8, 32)).astype(np.int32)
    mlm[rng.random((8, 32)) > 0.3] = -100
    nsp = rng.integers(0, 2, (8,)).astype(np.int32)
    return jcfg, tree, ids, mlm, nsp


def _tcfg(jcfg, **over):
    return tbert.BertConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
        num_layers=jcfg.num_layers, num_heads=jcfg.num_heads,
        intermediate_size=jcfg.intermediate_size,
        max_position_embeddings=jcfg.max_position_embeddings,
        **{"use_flash": False, **over})


def _trainable(tree):
    return thybrid._tree_map(lambda a: a.requires_grad_(True),
                             params_from_numpy(tree, device="cpu"))


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_init_params_has_the_jax_layout(tiny):
    """Same keys, shapes and dtypes as JAX's tree; the numpy bridge maps
    that tree with no code of its own (f32 and bf16)."""
    jcfg, tree, *_ = tiny
    mine = tbert.init_params(_tcfg(jcfg), seed=0, device="cpu")
    want = _flat(tree)
    assert {k: v.shape for k, v in _flat(mine).items()} == \
        {k: v.shape for k, v in want.items()}
    bridged = params_from_numpy(tree, device="cpu")
    for name, w in _flat(bridged).items():
        np.testing.assert_array_equal(w, want[name], err_msg=name)
    bf = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    got = params_from_numpy(bf, device="cpu")
    assert all(t.dtype == torch.bfloat16
               for t in thybrid._leaves(got))
    for name, w in _flat(got).items():
        np.testing.assert_array_equal(w, _flat(bf)[name], err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(tiny, masked):
    """MLM and NSP logits with token types, without and with a padding
    mask (the float32 bias composition)."""
    jcfg, tree, ids, *_ = tiny
    rng = np.random.default_rng(2)
    tt = rng.integers(0, 2, ids.shape).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones(ids.shape, np.int32)
        mask[1, 20:] = 0
        mask[5, 3:] = 0
    jm, jn = jax.jit(lambda p, i, t, m: jbert.forward(p, i, jcfg, t, m))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids),
        jnp.asarray(tt), None if mask is None else jnp.asarray(mask))
    tm, tn = tbert.forward(params_from_numpy(tree, device="cpu"), _t(ids),
                           _tcfg(jcfg), _t(tt),
                           None if mask is None else _t(mask))
    assert tm.dtype == torch.float32 and tm.shape == (8, 32, 512)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tn.detach().numpy(), np.asarray(jn), rtol=0,
                               atol=1e-5)


def test_padding_mask_invariance(tiny):
    """Tokens under the padding mask do not move the other positions."""
    jcfg, tree, *_ = tiny
    cfg = _tcfg(jcfg)
    params = params_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(1)
    ids1 = rng.integers(0, cfg.vocab_size, (1, 10))
    ids2 = ids1.copy()
    ids2[0, 6:] = rng.integers(0, cfg.vocab_size, 4)
    mask = np.ones((1, 10), np.int64)
    mask[0, 6:] = 0
    m1, _ = tbert.forward(params, _t(ids1), cfg, attention_mask=_t(mask))
    m2, _ = tbert.forward(params, _t(ids2), cfg, attention_mask=_t(mask))
    np.testing.assert_allclose(m1[0, :6].numpy(), m2[0, :6].numpy(),
                               rtol=0, atol=1e-5)


def test_ignore_index(tiny):
    """All MLM labels ignored: the loss is NSP's alone (the masked mean of
    nothing is 0); one kept label moves it; both equal JAX's."""
    jcfg, tree, ids, _, nsp = tiny
    cfg = _tcfg(jcfg)
    params = params_from_numpy(tree, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    none = np.full(ids.shape, -100, np.int32)
    some = none.copy()
    some[0, 0] = 5
    jloss = jax.jit(lambda lbl: jbert.loss_fn(
        jp, jnp.asarray(ids), lbl, jnp.asarray(nsp), jcfg))
    losses = []
    for lbl in (none, some):
        got = tbert.loss_fn(params, _t(ids), _t(lbl), _t(nsp), cfg).item()
        want = float(jloss(jnp.asarray(lbl)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        losses.append(got)
    h = tbert.encode(params, _t(ids), cfg)
    assert losses[0] == pytest.approx(
        tbert.nsp_loss_fn(params, h, _t(nsp)).item(), rel=1e-6)
    assert losses[1] != losses[0]
    custom = tbert.loss_fn(params, _t(ids), _t(np.where(some == -100, 7, 5)),
                           _t(nsp), cfg, ignore_index=7).item()
    assert custom == pytest.approx(losses[1], rel=1e-6)


@pytest.fixture(scope="module")
def jax_truth(tiny):
    """JAX's loss and gradients (every remat plan of JAX gives these)."""
    jcfg, tree, ids, mlm, nsp = tiny
    return jax.jit(jax.value_and_grad(
        lambda p: jbert.loss_fn(p, jnp.asarray(ids), jnp.asarray(mlm),
                                jnp.asarray(nsp), jcfg)))(
        jax.tree_util.tree_map(jnp.asarray, tree))


@pytest.mark.parametrize("remat", REMATS)
def test_loss_and_grads_match_jax(tiny, jax_truth, remat):
    jcfg, tree, ids, mlm, nsp = tiny
    params = _trainable(tree)
    loss = tbert.loss_fn(params, _t(ids), _t(mlm), _t(nsp), _tcfg(jcfg),
                         remat=remat)
    grads = torch.autograd.grad(loss, thybrid._leaves(params))
    jl, jg = jax_truth
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _assert_grads(thybrid._unflatten(params, grads), jg)


def test_flash_route_matches_jax_xla(tiny, jax_truth, monkeypatch):
    """use_flash=True runs the flash op (its plain forward and backward
    on the CPU, once a layer, non-causal) and gives JAX's XLA branch."""
    jcfg, tree, ids, mlm, nsp = tiny
    calls = []
    plain = fa.flash_attention_with_lse_plain

    def counted(q, k, v, offset=0, scale=None, causal=True):
        calls.append(causal)
        return plain(q, k, v, offset, scale, causal)
    monkeypatch.setattr(fa, "flash_attention_with_lse_plain", counted)
    params = _trainable(tree)
    loss = tbert.loss_fn(params, _t(ids), _t(mlm), _t(nsp),
                         _tcfg(jcfg, use_flash=True))
    grads = torch.autograd.grad(loss, thybrid._leaves(params))
    assert calls == [False] * jcfg.num_layers
    jl, jg = jax_truth
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _assert_grads(thybrid._unflatten(params, grads), jg)


def test_mlm_feature_pad_keeps_values_and_grads(tiny):
    """``mlm_masked_loss`` (the bias fold zero-padded from H + 1 = 65 to
    a multiple of 8) against the unpadded fold through the same NLL: the
    same loss and gradients, the params' shapes."""
    jcfg, tree, ids, mlm, nsp = tiny
    cfg = _tcfg(jcfg)
    assert (cfg.hidden_size + 1) % tbert.MLM_FEATURE_ALIGN
    params = _trainable(tree)
    h = torch.tensor(np.random.default_rng(2).normal(
        size=(*ids.shape, cfg.hidden_size)).astype("f4"), requires_grad=True)
    lbl = _t(mlm)
    leaves = [params["wte"], params["mlm_bias"], h]

    def unpadded():
        x = tbert._mlm_transform(params, h, cfg)
        N = x.shape[0] * x.shape[1]
        xf, W = tbert._bias_folded(x.reshape(N, -1), params, align=1)
        assert xf.shape[1] == cfg.hidden_size + 1
        mask = (lbl != -100).reshape(N)
        nll = chunked_vocab_nll(xf, W, torch.where(mask, lbl.reshape(N), 0),
                                0, pick_num_chunks(N, cfg.vocab_size))
        return (nll * mask.float()).sum() / mask.float().sum()
    out = []
    for loss in (unpadded(), tbert.mlm_masked_loss(params, h, lbl, cfg)):
        out.append((loss.item(), torch.autograd.grad(loss, leaves)))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        assert a.shape == b.shape
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)


def test_mesh_arguments_raise(tiny):
    jcfg, tree, ids, mlm, nsp = tiny
    params = params_from_numpy(tree, device="cpu")
    with pytest.raises(NotImplementedError, match="mp_axis"):
        tbert.forward(params, _t(ids), _tcfg(jcfg), mp_axis="mp")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbert.init_params(tbert.bert_tiny())


# ---------------------------------------------------------------------------
# The stage model, build_train_step and TrainLoop
# ---------------------------------------------------------------------------

def test_stage_model_dict_labels_num_micro_2(tiny):
    """``bert_stage_model`` through ``build_train_step`` at num_micro 2
    with the labels tree {"mlm", "nsp"}: the mean over the two
    micro-batches of JAX's per-micro-batch loss, and its gradients."""
    jcfg, tree, ids, mlm, nsp = tiny
    cfg = _tcfg(jcfg)
    step, shard, _ = thybrid.build_train_step(
        cfg, num_micro=2, model=thybrid.bert_stage_model(cfg),
        device="cpu")
    p = shard(params_from_numpy(tree, device="cpu"))
    loss, grads = step.loss_and_grads(p, _t(ids),
                                      {"mlm": _t(mlm), "nsp": _t(nsp)})

    def truth(q):
        return sum(jbert.loss_fn(q, jnp.asarray(ids[i:i + 4]),
                                 jnp.asarray(mlm[i:i + 4]),
                                 jnp.asarray(nsp[i:i + 4]), jcfg)
                   for i in (0, 4)) / 2
    jl, jg = jax.jit(jax.value_and_grad(truth))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _assert_grads(grads, jg)
    with pytest.raises(ValueError, match="batch 8"):
        step.loss_and_grads(p, _t(ids), {"mlm": _t(mlm), "nsp": _t(nsp[:4])})


@pytest.fixture(scope="module")
def jax_steps(tiny):
    """Three AdamW steps of JAX's ``build_train_step`` on a 1x1x1 mesh
    with ``bert_stage_model`` and dict labels: (losses, the params and
    state after each step as numpy trees)."""
    jcfg, tree, ids, mlm, nsp = tiny
    mesh = ProcessMesh(np.arange(1).reshape(1, 1, 1), ["dp", "pp", "mp"])
    step, shard, init = jhybrid.build_train_step(
        jcfg, mesh, num_micro=1, remat=False, zero=0,
        model=jhybrid.bert_stage_model(jcfg, {"dp": 1, "pp": 1, "mp": 1}),
        labels_spec={"mlm": P("dp", None), "nsp": P("dp")})
    jp = shard(jax.tree_util.tree_map(jnp.asarray, tree))
    jo = init(jp)
    labels = {"mlm": jnp.asarray(mlm), "nsp": jnp.asarray(nsp)}
    losses, states = [], []
    for _ in range(3):
        loss, jp, jo = step(jp, jo, jnp.asarray(ids), labels)
        losses.append(float(loss))
        # np.array copies: the next step donates these buffers
        states.append(jax.tree_util.tree_map(np.array, (jp, jo)))
    return losses, states


def test_adamw_steps_match_jax(tiny, jax_steps):
    jcfg, tree, ids, mlm, nsp = tiny
    cfg = _tcfg(jcfg)
    step, shard, init_opt = thybrid.build_train_step(
        cfg, model=thybrid.bert_stage_model(cfg), device="cpu")
    p = shard(params_from_numpy(tree, device="cpu"))
    o = init_opt(p)
    labels = {"mlm": _t(mlm), "nsp": _t(nsp)}
    before = _flat(tree)
    clear = {name: np.ones(v.shape, bool) for name, v in before.items()}
    losses = []
    for i in range(3):
        _, grads = step.loss_and_grads(p, _t(ids), labels)
        for name, g in _flat(grads).items():
            clear[name] &= np.abs(g) > 1e-5
        loss, p, o = step(p, o, _t(ids), labels)
        assert loss.dim() == 0 and loss.dtype == torch.float32
        losses.append(loss.item())
    want, got = _flat(jax_steps[1][2][0]), _flat(p)
    # the q and k columns of qkv see near-uniform attention at this init
    # (gradients mostly under 1e-5); wpe past position 32 and wtt's row 1
    # get none
    share = (sum(int(c.sum()) for c in clear.values())
             / sum(c.size for c in clear.values()))
    assert share >= 0.65, share
    for name, p0 in before.items():
        c = clear[name]
        np.testing.assert_allclose((got[name] - p0)[c], (want[name] - p0)[c],
                                   rtol=0, atol=0.01 * LR, err_msg=name)
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=3 * LR, err_msg=name)
    np.testing.assert_allclose(losses, jax_steps[0], rtol=1e-4)
    assert losses[2] < losses[0]


def test_resumes_a_jax_written_train_state(tiny, jax_steps):
    """JAX's params and AdamW state after step 1, through
    ``params_from_numpy`` and ``opt_state_from_numpy``: the port's steps
    2 and 3 give JAX's losses."""
    jcfg, _, ids, mlm, nsp = tiny
    cfg = _tcfg(jcfg)
    step, shard, _ = thybrid.build_train_step(
        cfg, model=thybrid.bert_stage_model(cfg), device="cpu")
    jp, jo = jax_steps[1][0]
    p = shard(params_from_numpy(jp, device="cpu"))
    o = thybrid.opt_state_from_numpy(jo, device="cpu")
    assert int(o["step"]) == 1
    labels = {"mlm": _t(mlm), "nsp": _t(nsp)}
    losses = [step(p, o, _t(ids), labels)[0].item() for _ in range(2)]
    np.testing.assert_allclose(losses, jax_steps[0][1:], rtol=1e-4)
    assert int(o["step"]) == 3


def test_train_loop_prefetches_dict_batches(tiny):
    """``TrainLoop`` over ``prefetch_to_device`` on (ids, {"mlm", "nsp"})
    batches: the losses of the same steps called directly, bit for
    bit."""
    jcfg, tree, ids, mlm, nsp = tiny
    cfg = _tcfg(jcfg)
    step, shard, init_opt = thybrid.build_train_step(
        cfg, model=thybrid.bert_stage_model(cfg, remat="partial:1"),
        device="cpu")
    batches = [(ids[i:i + 4], {"mlm": mlm[i:i + 4], "nsp": nsp[i:i + 4]})
               for i in (0, 4, 0)]
    runs = []
    for looped in (False, True):
        p = shard(params_from_numpy(tree, device="cpu"))
        o = init_opt(p)
        if looped:
            loop = TrainLoop(step, max_inflight=2)
            handles = [loop.step(p, o, *b)[0] for b in tio.prefetch_to_device(
                iter(batches), device=step.data_device)]
            loop.drain()
            runs.append([float(h) for h in handles])
        else:
            runs.append([step(p, o, _t(b[0]), {k: _t(v) for k, v in
                                               b[1].items()})[0].item()
                         for b in batches])
    assert runs[0] == runs[1]
