"""Compiled decode programs on the CPU (``inference/programs.py``).

The serving engines run their K-step decode loop, verify pass and draft
proposal as programs over static buffers.  On a CUDA engine a program's
second run captures it as a CUDA graph and later runs replay it; the
CPU runs the same programs eagerly.  Here a recorded stand-in takes the
graph's place (``_Recorded``: its capture runs the body as a capture
runs the wrappers' Python, its replay runs the body with the launch
counters held, as a replay runs no Python), so the capture-and-replay
path of the engines runs on the CPU: its streams against the JAX
engines' on the same weights, greedy and sampled, at steps_per_sync 1,
4 and 16 on the three engines and with a LLaMA draft; the program
cache across runs and its static buffers; the paged tables buffer;
invalidation; the launch-count bookkeeping; the ``cuda_graphs`` switch.

Sampled streams are held as in ``tests/test_torch_sampling.py``: the
same tokens, except at a near-tie of perturbed scores (within 2e-6),
which is reported.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.serving import (
    ContinuousBatchingEngine as JaxEngine, FusedB1Engine as JaxFused,
    PagedContinuousBatchingEngine as JaxPaged)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.incubate.nn.kernels import fused_decode as fdl
from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
from paddle_tpu_torch.inference import programs
from paddle_tpu_torch.inference.serving import (
    ContinuousBatchingEngine, FusedB1Engine, PagedContinuousBatchingEngine,
    SpeculativeConfig)
from paddle_tpu_torch.models import decoding, prng
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

TIE = 2e-6
SAMP = dict(temperature=0.8, top_k=20, top_p=0.95)
# (prompt length, max_new, seed): two prefill buckets, slots that refill
_REQS = ((5, 9, 11), (20, 14, 22), (9, 12, 33), (3, 17, 44), (14, 6, 55))
_FUSED_REQS = ((5, 10, 1), (9, 7, 2))
_PAGED = dict(block_size=8, num_blocks=24)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module's tiny engines (the tier-1 run
    has six processes); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorded:
    """The CUDA graph's stand-in: built like ``programs.CudaGraph(body,
    pool)``.  Its capture runs the body (the wrappers' Python runs, as
    under a capture; the bodies are idempotent, so running them once more
    than a real capture does changes no state), and a replay runs the
    recorded body with every launch counter held where it was, as a
    replay runs no Python."""

    def __init__(self, body, pool=None):
        self.body = body
        self.pool = pool if pool is not None else object()
        body()

    def replay(self):
        held = programs.snapshot()
        self.body()
        programs.restore(held)


def _captured(eng):
    """``eng`` with its programs captured by the stand-in."""
    eng._programs.capture = True
    eng._programs.graph_type = _Recorded
    return eng


def _gpt_cfgs(**kw):
    common = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                  max_position_embeddings=128, use_flash=False)
    common.update(kw)
    dt = common.pop("dtype", "float32")
    return (jgpt.GPTConfig(dtype=getattr(jnp, dt), unroll_layers=False,
                           **common),
            tgpt.GPTConfig(dtype=getattr(torch, dt), **common))


def _bridge(tree):
    return tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


def _jit_init(family, cfg, seed):
    return jax.jit(lambda: family.init_params(cfg, seed=seed))()


@pytest.fixture(scope="module")
def models():
    """The target, a LLaMA draft (GQA 2/1) and the fused int8 model, in
    both packages on the same weights."""
    jcfg, tcfg = _gpt_cfgs()
    jp = _jit_init(jgpt, jcfg, 0)
    lkw = dict(vocab_size=128, hidden_size=16, num_layers=1, num_heads=2,
               num_kv_heads=1, max_position_embeddings=128, use_flash=False)
    jlcfg = jllama.LlamaConfig(dtype=jnp.float32, **lkw)
    tlcfg = tllama.LlamaConfig(dtype=torch.float32, **lkw)
    jlp = _jit_init(jllama, jlcfg, 3)
    jfcfg, tfcfg = _gpt_cfgs(num_layers=1, max_position_embeddings=64,
                             dtype="bfloat16")
    jq = jax.jit(lambda p: jgpt.quantize_decode_params(p, jfcfg))(
        _jit_init(jgpt, jfcfg, 0))
    return {"target": (jcfg, jp, tcfg, _bridge(jp)),
            "llama": (jlcfg, jlp, tlcfg, _bridge(jlp)),
            "fused": (jfcfg, jq, tfcfg, _bridge(jq))}


def _requests(kind):
    reqs = _FUSED_REQS if kind == "fused" else _REQS
    rng = np.random.default_rng(2 if kind == "fused" else 0)
    return [(rng.integers(1, 128, (n,)).astype(np.int32), m, s)
            for n, m, s in reqs]


def _engine(pkg, models, kind, mode, spec=None, **kw):
    jax_side = pkg == "jax"
    jcfg, jp, tcfg, tp = models["fused" if kind == "fused" else "target"]
    args = (jp, jcfg) if jax_side else (tp, tcfg)
    if kind == "fused":
        E, kw = (JaxFused if jax_side else FusedB1Engine), dict(max_len=64,
                                                                **kw)
    elif kind == "paged":
        E = JaxPaged if jax_side else PagedContinuousBatchingEngine
        kw = dict(max_batch=2, max_len=64, **{**_PAGED, **kw})
    else:
        E = JaxEngine if jax_side else ContinuousBatchingEngine
        kw = dict(max_batch=2, max_len=64, **kw)
    if not jax_side:
        kw["device"] = "cpu"
    if mode == "sampled":
        kw.update(SAMP)
    return E(*args, speculative=spec, **kw)


def _serve(eng, reqs, steps=8):
    rids = [eng.submit(p, max_new=m, seed=s) for p, m, s in reqs]
    out = eng.run(steps_per_sync=steps)
    return [list(map(int, out[r])) for r in rids]


@pytest.fixture(scope="module")
def jax_streams(models):
    """Each JAX engine's plain stream, greedy and sampled, run once."""
    return {(kind, mode): _serve(_engine("jax", models, kind, mode),
                                 _requests(kind))
            for kind in ("contiguous", "paged", "fused")
            for mode in ("greedy", "sampled")}


def _assert_streams(models, kind, mode, got, want):
    """Greedy: equal.  Sampled: equal up to the first difference of each
    stream, which must be a near-tie of the port's perturbed scores."""
    if mode == "greedy":
        assert got == want
        return
    _, _, tcfg, tp = models["fused" if kind == "fused" else "target"]
    for (prompt, _, seed), g, w in zip(_requests(kind), got, want):
        if g == w:
            continue
        t = next(i for i, (x, y) in enumerate(zip(g, w)) if x != y)
        seq = np.concatenate([prompt, np.asarray(w[:t], np.int32)])
        cache = tgpt.init_decode_cache(tcfg, 1, seq.size, device="cpu")
        logits, _, _ = tgpt.prefill(tp, torch.from_numpy(seq[None]).long(),
                                    tcfg, cache)
        filt = decoding._filter_logits(logits.float(), **SAMP)[0]
        scores = filt + prng.gumbel(prng.fold_in(prng.PRNGKey(seed),
                                                 seq.size - 1), filt.shape)
        margin = abs(float(scores[g[t]] - scores[w[t]]))
        assert margin < TIE, (kind, seed, t, margin)
        warnings.warn(f"near-tie in {kind} seed {seed} token {t}: "
                      f"perturbed scores {margin} apart")


def _check_programs(eng):
    """Every program ran eagerly once, was captured at its second run
    and replayed from then on."""
    m = eng.metrics()
    for key, g in m["graphs"].items():
        assert g["captured"] == (g["runs"] > 1), key
        assert g["replays"] == g["runs"] - 1, key
    assert m["graph_replays"] == sum(g["replays"]
                                     for g in m["graphs"].values())
    return m


@pytest.mark.parametrize("steps", [1, 4, 16])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("kind", ["contiguous", "paged", "fused"])
def test_program_streams_match_jax(models, jax_streams, kind, mode, steps):
    """The captured-and-replayed decode programs give the JAX engine's
    stream at every steps_per_sync (JAX's stream does not depend on it)."""
    eng = _captured(_engine("port", models, kind, mode))
    got = _serve(eng, _requests(kind), steps)
    _assert_streams(models, kind, mode, got, jax_streams[(kind, mode)])
    m = _check_programs(eng)
    assert m["graph_replays"] > 0
    assert {k.split(":")[0] for k in m["graphs"]} == {"decode"}
    assert max(int(k.split(":")[1]) for k in m["graphs"]) <= steps


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_llama_draft_programs_match_jax(models, jax_streams, kind, mode):
    """A LLaMA draft (k 2, its rotary tables a constant of the engine):
    the draft and verify programs replay, and the speculative stream is
    the JAX engine's plain stream."""
    jlcfg, jlp, tlcfg, tlp = models["llama"]
    spec = SpeculativeConfig(k=2, family="llama", draft_params=tlp,
                             draft_cfg=tlcfg)
    eng = _captured(_engine("port", models, kind, mode, spec))
    got = _serve(eng, _requests(kind))
    _assert_streams(models, kind, mode, got, jax_streams[(kind, mode)])
    m = _check_programs(eng)
    kinds = {k.split(":")[0] for k in m["graphs"]}
    assert {"draft", "verify"} <= kinds
    assert m["graphs"]["draft:2"]["replays"] > 0
    assert m["graphs"]["verify:2"]["replays"] > 0


def _buffers(eng):
    """{name: data_ptr} of the engine's static buffers and every
    program's outputs."""
    out = {"io": eng._io.data_ptr(), "seeds": eng._seeds.data_ptr()}
    if eng._drafts is not None:
        out["drafts"] = eng._drafts.data_ptr()
    if hasattr(eng, "_tables_dev"):
        out["tables"] = eng._tables_dev.data_ptr()
    for (kind, steps), prog in eng._programs.programs.items():
        for name, t in prog.outputs.items():
            out[f"{kind}:{steps}:{name}"] = t.data_ptr()
    return out


@pytest.mark.parametrize("spec", [None, "ngram", "self"])
@pytest.mark.parametrize("kind", ["contiguous", "paged", "fused"])
def test_second_run_reuses_programs_and_buffers(models, kind, spec):
    """A second run of the same requests adds no program key, replays
    the first run's programs, keeps every static buffer's address (also
    from round to round) and gives the same streams."""
    _, _, tcfg, tp = models["fused" if kind == "fused" else "target"]
    s = {None: None, "ngram": True,
         "self": SpeculativeConfig(k=3, draft_params=tp, draft_cfg=tcfg)}
    eng = _captured(_engine("port", models, kind, "greedy", s[spec]))
    seen = []
    real = eng._load_round

    def load(state):
        seen.append(_buffers(eng))
        real(state)

    eng._load_round = load
    first = _serve(eng, _requests(kind))
    keys = set(eng.metrics()["graphs"])
    ptrs = _buffers(eng)
    replays = eng.metrics()["graph_replays"]
    assert _serve(eng, _requests(kind)) == first
    assert set(eng.metrics()["graphs"]) == keys
    assert eng.metrics()["graph_replays"] > replays
    assert _buffers(eng) == ptrs
    for round_ptrs in seen:
        assert all(ptrs[k] == v for k, v in round_ptrs.items())


def test_paged_tables_buffer_follows_tables_in_place(models):
    """The paged engine's tables buffer is refilled in place before each
    round and then equals ``_tables``, through the deferrals and
    evictions of a 26-page pool; the streams equal an eager contiguous
    engine's."""
    _, _, tcfg, tp = models["target"]
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, 128, (n,)).astype(np.int32), m, 0)
            for n, m in ((20, 40), (40, 40), (17, 40), (50, 40), (3, 40),
                         (60, 30))]
    kw = dict(max_batch=4, max_len=128, device="cpu")
    eng = _captured(PagedContinuousBatchingEngine(
        tp, tcfg, block_size=8, num_blocks=26, **kw))
    ptr = eng._tables_dev.data_ptr()
    rounds = []
    real = eng._load_round

    def load(state):
        real(state)
        assert eng._tables_dev.data_ptr() == ptr
        assert np.array_equal(eng._tables_dev.numpy(), eng._tables)
        rounds.append(eng._tables.copy())

    eng._load_round = load
    got = _serve(eng, reqs)
    assert got == _serve(ContinuousBatchingEngine(tp, tcfg, **kw), reqs)
    m = _check_programs(eng)
    assert m["evictions"] >= 1 and m["deferred_admissions"] >= 1
    assert m["free_blocks"] == m["num_blocks"]
    assert len({r.tobytes() for r in rounds}) > 1


@pytest.mark.parametrize("kind", ["contiguous", "paged", "fused"])
def test_reset_cache_and_draft_cache_drop_the_programs(models, kind):
    """``_reset_cache`` and ``_init_draft_cache`` replace storage the
    programs bind: both drop them and the pool; the next run builds and
    captures anew, with the same streams."""
    _, _, tcfg, tp = models["fused" if kind == "fused" else "target"]
    spec = SpeculativeConfig(k=2, draft_params=tp, draft_cfg=tcfg)
    eng = _captured(_engine("port", models, kind, "greedy", spec))
    first = _serve(eng, _requests(kind))
    assert eng.metrics()["graphs"] and eng._programs.pool is not None
    eng._reset_cache()
    assert eng.metrics()["graphs"] == {} and eng._programs.pool is None
    assert _serve(eng, _requests(kind)) == first
    assert any(g["captured"] for g in eng.metrics()["graphs"].values())
    eng._init_draft_cache()
    assert eng.metrics()["graphs"] == {} and eng._programs.pool is None


@pytest.fixture
def counting(monkeypatch):
    """Count the CPU's plain launches as the card's wrappers count
    kernel launches: row_gemm, the sampler and the fused layer stack
    bump their module counters once a call."""
    real_gemm, real_rows = tgpt.row_gemm, decoding.sample_rows
    real_fused = tgpt.fused_decode_layers

    def gemm(*a, **kw):
        rg.LAUNCHES += 1
        return real_gemm(*a, **kw)

    def rows(*a, **kw):
        sm.LAUNCHES += 1
        return real_rows(*a, **kw)

    def fused(*a, **kw):
        fdl.LAUNCHES += 1
        fdl.MODE_LAUNCHES["int8"] += 1
        return real_fused(*a, **kw)

    monkeypatch.setattr(tgpt, "row_gemm", gemm)
    monkeypatch.setattr(decoding, "sample_rows", rows)
    monkeypatch.setattr(tgpt, "fused_decode_layers", fused)


@pytest.mark.parametrize("spec", [None, "ngram", "self"])
@pytest.mark.parametrize("kind", ["contiguous", "paged", "fused"])
def test_launch_counts_of_replays_equal_eager(models, counting, kind, spec):
    """The counters' changes recorded over a capture, put back after it
    and added once a replay, give the eager engine's counts, kernel by
    kernel (the stand-in replay counts nothing itself)."""
    _, _, tcfg, tp = models["fused" if kind == "fused" else "target"]
    s = {None: None, "ngram": True,
         "self": SpeculativeConfig(k=3, draft_params=tp, draft_cfg=tcfg)}
    counts, streams = [], []
    for capture in (False, True):
        eng = _engine("port", models, kind, "sampled", s[spec])
        if capture:
            _captured(eng)
        before = programs.snapshot()
        streams.append(_serve(eng, _requests(kind), steps=4))
        counts.append(programs.difference(programs.snapshot(), before))
    assert streams[0] == streams[1]
    assert counts[0] == counts[1]
    assert eng.metrics()["graph_replays"] > 0
    delta = dict(zip(((m.__name__.rsplit(".", 1)[1], a)
                      for m, a in programs.COUNTERS), counts[1]))
    assert delta[("sampling", "LAUNCHES")] > 0
    assert delta[("row_gemm", "LAUNCHES")] > 0
    assert delta[("fused_decode", "LAUNCHES")] > 0 or kind != "fused"


def test_counter_bookkeeping_functions():
    """snapshot / difference / add / restore over ints and dicts, the
    dicts updated in place."""
    before = programs.snapshot()
    held = fdl.MODE_LAUNCHES
    try:
        rg.LAUNCHES += 3
        fdl.MODE_LAUNCHES["fp8"] += 2
        after = programs.snapshot()
        delta = programs.difference(after, before)
        programs.restore(before)
        assert programs.snapshot() == before
        programs.add(delta)
        programs.add(delta)
        assert rg.LAUNCHES == before[programs.COUNTERS.index(
            (rg, "LAUNCHES"))] + 6
        assert fdl.MODE_LAUNCHES is held
        assert fdl.MODE_LAUNCHES["fp8"] == before[programs.COUNTERS.index(
            (fdl, "MODE_LAUNCHES"))]["fp8"] + 4
    finally:
        programs.restore(before)


@pytest.mark.parametrize("kind", ["contiguous", "paged", "fused"])
def test_cuda_graphs_switch(models, kind):
    """``cuda_graphs``: True on a CPU engine raises; None and False run
    the programs eagerly there (nothing captured)."""
    with pytest.raises(ValueError, match="cuda_graphs"):
        _engine("port", models, kind, "greedy", cuda_graphs=True)
    for flag in (None, False):
        eng = _engine("port", models, kind, "greedy", cuda_graphs=flag)
        assert eng._programs.capture is False
        _serve(eng, _requests(kind)[:1])
        m = eng.metrics()
        assert m["graphs"] and m["graph_replays"] == 0
        assert not any(g["captured"] for g in m["graphs"].values())
        assert m["graph_pool_bytes"] == 0 and m["capture_seconds"] == 0.0
