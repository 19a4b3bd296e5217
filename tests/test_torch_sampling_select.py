"""The sampler kernel's selection rule against the JAX package, on the CPU.

``paddle_tpu_torch.incubate.nn.kernels.sampling.cut_values_plain`` is the
rule the CUDA kernel applies: the k-th largest value from integer
counts, the top-p cut from fixed-point masses summed exactly.  It is
held here to JAX's ``paddle_tpu/models/decoding.py`` ``_filter_logits``
through the kept sets, at V 128 and 50304 under the settings of
``tests/test_torch_sampling.py`` and at the ends of the ranges (top-k at
or above V, top-p 1e-6, top-p one float32 step below 1), and on edge
rows (NaN, +-inf, -0 against +0, an all -inf row, ties at the k-th
value).  Kept sets are equal, except where JAX's float cumulative mass
at the cut lies within n 2^-24 of top_p (n: the values summed up to
it), a top-p near-tie, which the test reports (``warnings``) and never
re-seeds away.

The plan: a mirror of the kernel's radix select (four 8-bit digit
passes over per-rank histograms of each rank's slice, summed, the digit
found from suffix sums) gives the same thresholds at every cluster size
and whether a row is drawn alone or among others.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import decoding as jdec
from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
from paddle_tpu_torch.models import decoding, prng

SETTINGS = [dict(temperature=0.8, top_k=20, top_p=0.95),
            dict(temperature=1.0), dict(temperature=0.7, top_p=0.9),
            dict(temperature=1.3, top_k=50)]
ONE_BELOW_1 = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
ENDS = [dict(temperature=0.9, top_k=50304, top_p=0.95),
        dict(temperature=0.8, top_k=20, top_p=1e-6),
        dict(temperature=1.1, top_p=ONE_BELOW_1)]
CASES = [(V, kw) for V in (128, 50304) for kw in SETTINGS + ENDS]


def _kw(kw):
    return kw["temperature"], kw.get("top_k", 0), kw.get("top_p", 1.0)


@functools.lru_cache(maxsize=None)
def _jax_filter_fn(k, p):
    """JAX's ``_filter_logits`` at one (top_k, top_p), compiled once.
    The temperature is an argument: a constant divisor would let XLA
    multiply by its reciprocal instead, which eager JAX does not."""
    return jax.jit(lambda x, t: jdec._filter_logits(x, t, k, p))


def _jax_filter(logits, kw):
    t, k, p = _kw(kw)
    return np.asarray(_jax_filter_fn(k, p)(jnp.asarray(logits),
                                           jnp.float32(t)))


def _logits(B, V, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, V)) * 3).astype(np.float32)


def _exact(logits, kw):
    t, k, p = _kw(kw)
    x = torch.from_numpy(logits)
    kth, cut = sm.cut_values_plain(x, t, k, p)
    return sm.apply_cuts(x, t, kth, cut).numpy(), kth, cut


def _topp_gap(jrow, p):
    """(gap, n): JAX's cumulative float64 mass over the descending
    finite values of a top-k filtered row closest to float32 ``p``
    between the two cuts' indices, and the values summed there."""
    desc = np.sort(jrow[np.isfinite(jrow)])[::-1].astype(np.float64)
    e = np.exp(desc - desc[0])
    return np.abs(np.cumsum(e) / e.sum() - float(np.float32(p))), \
        np.arange(1, desc.size + 1)


def _assert_kept(what, logits, kw, jf, ef):
    """JAX's filtered logits ``jf`` against the exact rule's ``ef``: the
    same values kept, or a reported top-p near-tie."""
    same = (jf == ef) | (np.isnan(jf) & np.isnan(ef))
    for r in np.nonzero(~same.all(-1))[0]:
        t, k, p = _kw(kw)
        assert p < 1.0, (what, r, "kept sets differ without top-p")
        # the top-k cut is exact in both: the rows agree there
        x = torch.from_numpy(logits[r:r + 1])
        kth, _ = sm.cut_values_plain(x, t, k, 1.0)
        topk = sm.apply_cuts(x, t, kth, torch.tensor([float("-inf")]))[0]
        gap, n = _topp_gap(topk.numpy(), p)
        nj, ne = int(np.isfinite(jf[r]).sum()), int(np.isfinite(ef[r]).sum())
        lo, hi = min(nj, ne) - 1, max(nj, ne)
        ok = gap[lo:hi] <= n[lo:hi] * 2.0 ** -24
        assert ok.any(), (what, r, nj, ne, gap[lo:hi].min())
        warnings.warn(f"top-p near-tie in {what} row {r}: kept {nj} (JAX) "
                      f"/ {ne} (exact), mass {gap[lo:hi].min()} from top_p")


@pytest.mark.parametrize("V,kw", CASES, ids=lambda a: "-".join(
    f"{k}{v:g}" for k, v in a.items()) if isinstance(a, dict) else str(a))
def test_cut_values_keep_jax_sets(V, kw):
    """The exact rule keeps the values JAX's ``_filter_logits`` keeps."""
    logits = _logits(8, V, V + len(str(kw)))
    jf = _jax_filter(logits, kw)
    ef, kth, cut = _exact(logits, kw)
    _assert_kept(f"V {V} {kw}", logits, kw, jf, ef)
    assert kth.dtype == cut.dtype == torch.float32
    if not 0 < kw.get("top_k", 0) < V:
        assert torch.isneginf(kth).all()
    if kw.get("top_p", 1.0) >= 1.0:
        assert torch.isneginf(cut).all()


def _edge_rows():
    """[rows, 16] float32: NaN (twice), +inf (twice), ties of -0 and +0
    at the cut, an all -inf row, ties at the k-th value, -inf among
    finite values, a NaN row of NaNs and -inf, and +inf with NaN."""
    rng = np.random.default_rng(5)
    rows = (rng.standard_normal((9, 16)) * 2).astype(np.float32)
    nan, inf = np.float32("nan"), np.float32("inf")
    rows[0, [3, 11]] = nan
    rows[1, [2, 9]] = inf
    rows[2] = [3, 2, -0.0, 0.0, -1, -0.0, 0.0, -2, -3, -4, -5, -6, -7, -8,
               -9, -10]
    rows[3] = -inf
    rows[4] = [5, 2, 2, 2, 2, 1, 1, 0, -1, -1, 2, -2, -3, -4, 2, -5]
    rows[5, ::2] = -inf
    rows[6] = -inf
    rows[6, 7] = nan
    rows[7, 4] = inf
    rows[7, 12] = nan
    rows[8] = 0.25          # all equal: every mass the same
    return rows


EDGE_SETTINGS = [dict(temperature=1.0, top_k=2), dict(temperature=1.0,
                                                      top_k=3),
                 dict(temperature=0.5, top_k=4, top_p=0.6),
                 dict(temperature=1.0, top_p=0.5),
                 dict(temperature=2.0, top_k=6, top_p=0.99),
                 dict(temperature=1.0, top_p=1e-6)]


@pytest.mark.parametrize("kw", EDGE_SETTINGS, ids=str)
def test_cut_values_on_edge_rows(kw):
    """NaN, +-inf, -0 / +0, all -inf and tied rows keep JAX's sets; a
    row whose maximum is NaN, +inf or -inf cuts at that maximum."""
    rows = _edge_rows()
    t, k, p = _kw(kw)
    jf = _jax_filter(rows, kw)
    ef, kth, cut = _exact(rows, kw)
    _assert_kept(f"edge rows {kw}", rows, kw, jf, ef)
    if p < 1.0:
        assert torch.isnan(cut[[0, 6, 7]]).all()
        assert cut[1] == float("inf") and torch.isneginf(cut[3])
    if k:
        assert kth[3] == float("-inf") and bool(torch.isnan(kth[0])) == (
            k <= 2)
    if k in (2, 3) and p >= 1.0:
        # ties at the k-th value are all kept; -0 and +0 are one value
        assert np.isfinite(ef[4]).sum() == 7
        assert np.isfinite(ef[2]).sum() == (2 if k == 2 else 6)


def test_cut_values_zero_signs_are_one_value():
    """-0 and +0 have one key: a cut at zero keeps both signs."""
    x = torch.tensor([[1.0, -0.0, 0.0, -1.0]])
    keys = sm.order_keys(x)
    assert keys[0, 1] == keys[0, 2]
    kth, _ = sm.cut_values_plain(x, 1.0, 3, 1.0)
    assert kth[0] == 0.0 and not torch.signbit(kth[0])
    kept = sm.apply_cuts(x, 1.0, kth, torch.tensor([float("-inf")]))
    assert torch.isfinite(kept[0, :3]).all() and torch.isneginf(kept[0, 3])


def test_order_keys_round_trip():
    """Keys order values as floats do (NaN on top) and map back."""
    rng = np.random.default_rng(2)
    v = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.integers(
        -40, 39, 500), [np.inf, -np.inf, 0.0, 1e-45, -1e-45]])
    x = torch.from_numpy(v.astype(np.float32))
    keys = sm.order_keys(x)
    order = torch.argsort(keys, stable=True)
    assert (torch.diff(x[order]) >= 0).all()
    assert torch.equal(sm.key_values(keys), x)
    nan = torch.tensor([float("nan"), -float("nan")])
    assert (sm.order_keys(nan) == 0xFFFFFFFF).all()
    assert torch.isnan(sm.key_values(sm.order_keys(nan))).all()


@pytest.mark.parametrize("p", [0.95, 0.9, 1e-6, 0.5, ONE_BELOW_1, 0.0,
                               -1.0, 2.0 ** -140])
def test_mass_threshold_is_the_exact_ceiling(p):
    """ceil(float32(p) total) by int64 arithmetic equals the rational
    ceiling, at least 1, up to totals of 2^53."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    tot = np.concatenate([rng.integers(1, 2 ** 53, 200), [1, 2 ** 53, 2 ** 37
                                                          * 50304]])
    got = sm.mass_threshold(torch.from_numpy(tot), p).tolist()
    p32 = Fraction(float(np.float32(p)))
    want = [max(1, -(-p32 * int(t) // 1)) for t in tot]
    assert got == want


# -- the plan: the kernel's radix select over cluster slices ---------------

def _radix(slices, weights, need_of, passes=4):
    """The kernel's select: 8-bit digits, each from the sum of the
    ranks' histograms of the keys that match the digits found so far;
    the largest key v whose weight at or above it reaches need (after
    four passes; after fewer, the lower bound of v's bucket)."""
    prefix, above, need = 0, 0, None
    for p in range(passes):
        shift = 24 - 8 * p
        hi = 0 if p == 0 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        g = np.zeros(256, np.int64)
        for keys, w in zip(slices, weights):
            m = ((keys ^ prefix) & hi) == 0
            bins = (keys[m] >> shift) & 255
            g += np.bincount(bins, minlength=256) if w is None \
                else _wsum(bins, w[m])
        if need is None:
            need = need_of(int(g.sum()))
        s = np.cumsum(g[::-1])[::-1]
        d = max(i for i in range(256) if above + s[i] >= need)
        above += int(s[d] - g[d])
        prefix |= d << shift
    return prefix


def _wsum(bins, w):
    """Exact int64 histogram of int64 weights."""
    out = np.zeros(256, np.int64)
    np.add.at(out, bins, w)
    return out


def _kernel_rule(x, k, p, C):
    """kth and cut of one row [V] (already divided by T) as the kernel
    computes them with clusters of C blocks."""
    V = x.numel()
    L = sm.sampling_plan(1, V, {C: 1})["slice"]
    keys = sm.order_keys(x).numpy()
    slices = [keys[c * L:(c + 1) * L] for c in range(C)]
    kth_key = 0
    kth = cut = float("-inf")
    if 0 < k < V:
        kth_key = _radix(slices, [None] * C, lambda total: k)
        kth = float(sm.key_values(torch.tensor(kth_key)))
    if p < 1.0:
        mx = float(sm.key_values(torch.tensor(int(keys.max()))))
        if not np.isfinite(mx):
            return kth, mx
        m = (torch.exp(x - mx).double() * 2.0 ** sm.mass_bits(V)).long()
        m = torch.where(torch.from_numpy(keys) >= kth_key, m, 0).numpy()
        v = _radix(slices, [m[c * L:(c + 1) * L] for c in range(C)],
                   lambda total: int(sm.mass_threshold(
                       torch.tensor([total]), p)[0]))
        cut = float(sm.key_values(torch.tensor(v)))
    return kth, cut


def _gather_rule(x, k, p, C):
    """kth and cut of one row [V] (divided by T) as the kernel's gather
    path computes them under top-k: each rank keeps its values in and
    above the 16-bit bucket of its own k-th largest (two local passes),
    rank 0 finds the exact k-th largest among them all and the top-p
    cut among those at or above it.  None: more candidates than rank 0
    takes (the cluster's select runs instead)."""
    V = x.numel()
    L = sm.sampling_plan(1, V, {C: 1})["slice"]
    keys = sm.order_keys(x).numpy()
    idx = []
    for c in range(C):
        ks = keys[c * L:(c + 1) * L]
        tk = _radix([ks], [None], lambda total: k, passes=2) \
            if ks.size > k else 0
        idx.append(np.nonzero(ks >= tk)[0] + c * L)
    idx = np.concatenate(idx)
    if idx.size > sm.MAX_CAND:
        return None
    kth_key = _radix([keys[idx]], [None], lambda total: k)
    kth = float(sm.key_values(torch.tensor(kth_key)))
    kept = idx[keys[idx] >= kth_key]
    if not p < 1.0:
        return kth, float("-inf")
    ck = keys[kept]
    mx = float(sm.key_values(torch.tensor(int(ck.max()))))
    if not np.isfinite(mx):
        return kth, mx
    m = (torch.exp(x[kept] - mx).double()
         * 2.0 ** sm.mass_bits(V)).long().numpy()
    need = int(sm.mass_threshold(torch.tensor([int(m.sum())]), p)[0])
    w = np.array([m[ck >= key].sum() for key in ck])
    return kth, float(sm.key_values(torch.tensor(int(ck[w >= need].max()))))


def _same(a, b):
    return a == b or (np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("V,kw", [(50304, SETTINGS[0]), (50304, SETTINGS[2]),
                                  (32000, SETTINGS[3]), (128, ENDS[1]),
                                  (16, EDGE_SETTINGS[2])], ids=str)
def test_thresholds_do_not_depend_on_the_plan(V, kw):
    """The radix select over 4, 8 or 16 slices, a row drawn alone or
    among others: the same kth and cut, equal to ``cut_values_plain``'s
    (one sort, cumulative int64 sums)."""
    t, k, p = _kw(kw)
    logits = _edge_rows() if V == 16 else _logits(4, V, 17)
    x = sm._scaled(torch.from_numpy(logits), t)
    kth, cut = sm.cut_values_plain(torch.from_numpy(logits), t, k, p)
    for r in range(0, x.shape[0], 3):
        alone = sm.cut_values_plain(torch.from_numpy(logits[r:r + 1]), t, k,
                                    p)
        assert _same(float(alone[0][0]), float(kth[r]))
        assert _same(float(alone[1][0]), float(cut[r]))
        for C in sm.CLUSTER_SIZES:
            got = _kernel_rule(x[r], k, p, C)
            assert _same(got[0], float(kth[r])), (r, C, got, float(kth[r]))
            assert _same(got[1], float(cut[r])), (r, C, got, float(cut[r]))


@pytest.mark.parametrize("V,kw", [(50304, SETTINGS[0]), (50304, SETTINGS[3]),
                                  (32000, ENDS[1]), (128, SETTINGS[0]),
                                  (16, EDGE_SETTINGS[2]),
                                  (16, EDGE_SETTINGS[1])], ids=str)
def test_gathered_candidates_give_the_rule(V, kw):
    """Under top-k the kernel gathers each rank's values at or above the
    16-bit bucket of its own k-th largest: at every cluster size that
    union holds every value at or above the row's k-th largest, and the
    thresholds found in it are ``cut_values_plain``'s; rows of ties too
    many to gather (all values equal) take the cluster's select."""
    t, k, p = _kw(kw)
    logits = _edge_rows() if V == 16 else _logits(4, V, 29)
    x = sm._scaled(torch.from_numpy(logits), t)
    kth, cut = sm.cut_values_plain(torch.from_numpy(logits), t, k, p)
    for r in range(x.shape[0]):
        for C in sm.CLUSTER_SIZES:
            got = _gather_rule(x[r], k, p, C)
            assert got is not None, (r, C)
            assert _same(got[0], float(kth[r])), (r, C, got, float(kth[r]))
            assert _same(got[1], float(cut[r])), (r, C, got, float(cut[r]))
    flat = torch.full((50304,), 0.25)
    assert _gather_rule(flat, 20, 0.95, 16) is None


def test_sampling_plan_takes_the_fewest_waves():
    """Every size fits: 16; else the size that runs R rows in the fewest
    waves of the clusters that fit, then under top-k one that gathers
    at most ``GATHER_TARGET`` candidates, then the larger; slices are
    multiples of 4 that cover V."""
    fits = {16: 7, 8: 15, 4: 30}
    assert sm.sampling_plan(8, 50304)["clusters"] == 16
    assert sm.sampling_plan(4, 50304, fits)["clusters"] == 16
    assert sm.sampling_plan(8, 50304, fits)["clusters"] == 8
    assert sm.sampling_plan(32, 50304, fits)["clusters"] == 4
    assert sm.sampling_plan(32, 50304, {**fits, 8: 16})["clusters"] == 8
    plan = sm.sampling_plan(64, 50304, {16: 20, 8: 60, 4: 30})
    assert plan["clusters"] == 8 and plan["waves"] == 2
    # under top-k, clusters whose blocks gather at most GATHER_TARGET
    assert sm.sampling_plan(1, 50304, fits, top_k=20)["clusters"] == 16
    assert sm.sampling_plan(1, 50304, fits, top_k=50)["clusters"] == 8
    assert sm.sampling_plan(1, 50304, fits, top_k=50000)["clusters"] == 16
    assert sm.sampling_plan(8, 50304, fits, top_k=50)["clusters"] == 8
    for R, V in ((1, 1), (3, 7), (8, 50304), (32, 32000)):
        plan = sm.sampling_plan(R, V, fits)
        assert plan["slice"] % 4 == 0 and plan["slice"] * plan[
            "clusters"] >= V
        assert plan["smem"] == sm.SMEM_FIXED + 4 * plan["slice"]
    with pytest.raises(ValueError, match="shared memory"):
        sm.sampling_plan(1, 16 * 60000)


def test_launch_args_follow_the_plan_once_a_setting(monkeypatch):
    """A launch's plan and scalars are the plan's and the float32
    setting's, computed once a (device, R, V, setting): the occupancy
    lookup runs on the first draw of a setting only."""
    fits = {16: 7, 8: 15, 4: 30, 2: 66}
    calls = []

    def fake_fits(device, V):
        calls.append((device, V))
        return fits

    monkeypatch.setattr(sm, "device_fits", fake_fits)
    monkeypatch.setattr(sm, "_ARGS", {})
    dev = torch.device("cuda", 0)
    for _ in range(3):
        got = sm._launch_args(dev, 8, 50304, 0.8, 20, 0.95)
    plan = sm.sampling_plan(8, 50304, fits, 20)
    assert got == (plan["slice"], plan["clusters"],
                   float(np.float32(0.8)), 20, 1, float(np.float32(0.95)),
                   sm.mass_bits(50304))
    assert calls == [(dev, 50304)]
    # no top-k at or above V, no top-p at 1, another R another plan
    got = sm._launch_args(dev, 32, 50304, 1.0, 1 << 20, 1.0)
    plan = sm.sampling_plan(32, 50304, fits, 1 << 20)
    assert got[:2] == (plan["slice"], plan["clusters"])
    assert got[3:6] == (0, 0, 1.0) and len(calls) == 2
    monkeypatch.setattr(sm, "_ARGS_MAX", 2)
    sm._launch_args(dev, 4, 32000, 1.0, 0, 1.0)
    assert len(sm._ARGS) == 1


# -- the wrapper on the CPU ------------------------------------------------

def test_sample_rows_on_the_cpu_is_the_plain_composition():
    """A CPU tensor runs the float filter and the plain draw, what the
    CPU path computed before the kernel (both keyings); ``decoding``'s
    filter is the module's; the draw alone is ``gumbel_argmax``."""
    assert decoding._filter_logits is sm.filter_logits_plain
    logits = torch.from_numpy(_logits(6, 1000, 9))
    seeds = torch.tensor([1, -2, 3], dtype=torch.int32)
    pos = torch.tensor([0, 5, 1023], dtype=torch.int32)
    key = prng.split(prng.PRNGKey(4))[1]
    for t, k, p in ((0.8, 20, 0.95), (1.0, 0, 1.0), (0.7, 0, 0.9)):
        filt = sm.filter_logits_plain(logits, t, k, p)
        got = sm.sample_rows(logits, t, k, p, seeds=seeds, pos=pos, window=2)
        want = sm.gumbel_argmax_plain(filt, seeds=seeds, pos=pos, window=2)
        assert torch.equal(got, want)
        assert torch.equal(sm.sample_rows(logits, t, k, p, key=key),
                           sm.gumbel_argmax_plain(filt, key=key))
    assert torch.equal(sm.gumbel_argmax(logits, key=key),
                       sm.sample_rows(logits, 1.0, key=key))


def test_sample_rows_rejects():
    """Greedy temperatures, other dtypes and keyings raise."""
    x = torch.zeros(4, 10)
    seeds = pos = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="temperature"):
        sm.sample_rows(x, 0.0, seeds=seeds, pos=pos)
    with pytest.raises(TypeError, match="float32"):
        sm.sample_rows(x.double(), 1.0, seeds=seeds, pos=pos)
    with pytest.raises(ValueError, match="either key"):
        sm.sample_rows(x, 1.0)
    with pytest.raises(ValueError, match="whole windows"):
        sm.sample_rows(x, 1.0, seeds=seeds[:1], pos=pos[:1], window=3)
