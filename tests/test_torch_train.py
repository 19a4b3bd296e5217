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
import os
import subprocess
import sys

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
from paddle_tpu_torch.jit.loop import DeferredScalar, ElasticInterrupt, \
    TrainLoop, TrainStepError
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: gpt_tiny's products are small, and more threads
    only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    c = tgpt.forward(tp, torch.from_numpy(ids), cfg, remat="partial:2")
    torch.testing.assert_close(a, c, rtol=0, atol=0)


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


# ---------------------------------------------------------------------------
# The rest of TrainLoop (after tests/test_train_loop.py)
# ---------------------------------------------------------------------------

def test_sync_mode_materializes_immediately():
    with tl.synchronous():
        d = DeferredScalar(torch.tensor(3.0))
        assert d.materialized
    d2 = DeferredScalar(torch.tensor(3.0))
    assert not d2.materialized


def test_sync_hook_fires():
    fired = []

    def hook():
        fired.append(1)

    tl.add_host_sync_hook(hook)
    try:
        float(DeferredScalar(torch.tensor(1.0)))
    finally:
        tl.remove_host_sync_hook(hook)
    float(DeferredScalar(torch.tensor(1.0)))
    assert fired == [1]


def test_fail_times_schedule():
    from paddle_tpu_torch.testing.faults import TrainStepFaultInjector
    inj = TrainStepFaultInjector(fail_times=2)
    wrapped = inj.wrap(lambda x: x)
    for _ in range(2):
        with pytest.raises(OSError):
            wrapped(1)
    assert wrapped(7) == 7
    assert inj.calls == 3 and inj.injected == 2


def test_wrapped_step_fault_names_the_step():
    from paddle_tpu_torch.testing.faults import wrap_train_step
    faulty, inj = wrap_train_step(lambda x: x * 2.0, fail_at=3)
    loop = TrainLoop(faulty, max_inflight=2)
    outs = [loop.step(torch.tensor(float(i))) for i in range(2)]
    with pytest.raises(TrainStepError) as ei:
        loop.step(torch.tensor(2.0))
    assert ei.value.step_index == 2 and inj.injected == 1
    assert loop.inflight == 0 and loop.stats()["inflight"] == 0
    assert [float(o) for o in outs] == [0.0, 2.0]


def test_interrupt_check_drains_at_a_step_boundary():
    """JAX's ElasticInterrupt: the check is polled once per admitted
    step; when it fires the loop drains and reports the completed steps
    (the exact checkpoint step)."""
    polls = []

    def check():
        polls.append(1)
        return "preempted" if len(polls) == 4 else None

    loop = TrainLoop(lambda x: x + 1.0, max_inflight=2,
                     interrupt_check=check)
    for i in range(3):
        loop.step(torch.tensor(float(i)))
    with pytest.raises(ElasticInterrupt) as ei:
        loop.step(torch.tensor(3.0))
    assert ei.value.completed_steps == 4 and ei.value.reason == "preempted"
    assert loop.inflight == 0 and len(polls) == 4


def test_stats_report_the_stall_histogram_and_gauge():
    loop = TrainLoop(max_inflight=2)
    for i in range(5):
        loop.admit(torch.tensor(float(i)))
        assert loop.stats()["inflight"] == loop.inflight <= 2
    loop.drain()
    st = loop.stats()
    assert st["inflight"] == 0 and st["steps"] == 5
    # CPU losses are complete when admitted: no wait is observed
    assert st["stall_histogram"]["count"] == 0
    h = tl.Histogram()
    for x in (0.002, 0.2, 3.0):
        h.observe(x)
    s = h.summary()
    assert s["count"] == 3 and s["max"] == 3.0
    assert s["buckets"][0.005] == 1 and s["buckets"][5.0] == 3


# ---------------------------------------------------------------------------
# The train-step program cache (after TestTrainStepProgramCache)
# ---------------------------------------------------------------------------

def _cached_build(**over):
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=32, num_heads=2,
                         num_layers=2, max_position_embeddings=32)
    kw = dict(num_micro=1, remat=False, device="cpu")
    kw.update(over)
    return thybrid.build_train_step(cfg, **kw)


def test_identical_recipe_hits():
    thybrid.clear_train_step_cache()
    s1 = _cached_build()
    s2 = _cached_build()       # a fresh, equal config
    assert s1[0] is s2[0] and s1[2] is s2[2]
    assert s1[0].cache_key is not None
    assert s1[0].data_device == torch.device("cpu")
    assert thybrid.clear_train_step_cache() == 1


def test_different_recipe_misses():
    thybrid.clear_train_step_cache()
    steps = [_cached_build(), _cached_build(remat=True),
             _cached_build(remat="partial:1"), _cached_build(num_micro=2),
             _cached_build(moment_dtype=torch.bfloat16)]
    assert len({id(s[0]) for s in steps}) == 5
    assert thybrid.clear_train_step_cache() == 5


def test_cache_opt_out():
    thybrid.clear_train_step_cache()
    s1 = _cached_build(cache=False)
    s2 = _cached_build(cache=False)
    assert s1[0] is not s2[0] and s1[0].cache_key is None
    assert thybrid.clear_train_step_cache() == 0


# ---------------------------------------------------------------------------
# The kernel build cache across processes (TestPersistentCompileCache)
# ---------------------------------------------------------------------------

def _stand_in_library():
    """A real shared library for ctypes to load on a machine without
    nvcc: the C math library."""
    import ctypes.util
    name = ctypes.util.find_library("m")
    for d in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/lib64",
              "/usr/lib64", "/lib", "/usr/lib"):
        if name and os.path.exists(os.path.join(d, name)):
            return os.path.join(d, name)
    pytest.skip("no libm to stand in for a kernel library")


def test_compile_cache_loads_without_the_compiler(tmp_path, monkeypatch):
    """PT_COMPILE_CACHE_DIR points the kernel build cache at a directory;
    a library staged there under its hash key loads without nvcc."""
    from paddle_tpu_torch.incubate.nn.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(tl, "_compile_cache_dir", None)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setenv("PT_COMPILE_CACHE_DIR", str(tmp_path / "cache"))

    def no_compiler():
        raise AssertionError("nvcc was called")
    monkeypatch.setattr(_build, "_nvcc", no_compiler)
    assert tl.maybe_enable_compile_cache() == str(tmp_path / "cache")
    assert _build.BUILD_DIR == tmp_path / "cache"
    lib = _build._target("flash_attention")
    assert lib.parent == tmp_path / "cache"
    lib.parent.mkdir(parents=True)
    lib.write_bytes(open(_stand_in_library(), "rb").read())
    builds = dict(_build.BUILD_STATS)
    assert _build.load("flash_attention") is not None
    assert _build.BUILD_STATS == builds
    # idempotent, and build_train_step enables it before every build
    assert tl.maybe_enable_compile_cache() == str(tmp_path / "cache")
    _cached_build(cache=False)
    assert _build.BUILD_DIR == tmp_path / "cache"


_CACHE_CHILD = r"""
import os, sys
from paddle_tpu_torch.incubate.nn.kernels import _build
from paddle_tpu_torch.jit.loop import maybe_enable_compile_cache
d = maybe_enable_compile_cache()
assert d == os.environ["PT_COMPILE_CACHE_DIR"], d
def no_compiler():
    raise AssertionError("nvcc was called")
_build._nvcc = no_compiler
_build.load("flash_attention")
print("BUILDS", _build.BUILD_STATS["builds"], _build._target(
    "flash_attention").parent)
"""


def test_compile_cache_round_trips_through_env_dir(tmp_path):
    """A second process given the same PT_COMPILE_CACHE_DIR loads the
    library the first left there and compiles nothing."""
    from paddle_tpu_torch.incubate.nn.kernels import _build
    cache = tmp_path / "cache"
    cache.mkdir()
    name = _build._target("flash_attention").name
    (cache / name).write_bytes(open(_stand_in_library(), "rb").read())
    env = dict(os.environ, PT_COMPILE_CACHE_DIR=str(cache),
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "-c", _CACHE_CHILD],
                       capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr
    assert f"BUILDS 0 {cache}" in r.stdout
