"""The sampler: temperature, top-k, top-p and a keyed Gumbel-max draw of
one token a row on JAX's threefry stream, in one launch (a module of
the port only).

The JAX package filters and draws in XLA (``paddle_tpu/models/
decoding.py`` ``_filter_logits`` and ``jax.random.categorical`` inside
``sample_token`` and ``_sample_one``), with no Pallas kernel.
:func:`sample_rows` is the hand-written kernel of ``csrc/sampling.cu``,
which reads the raw logits once and returns the tokens; its source note
says what bounds it and how it is built.

:func:`sample_rows` takes raw float32 logits [R, V], ``temperature`` >
0, ``top_k`` and ``top_p`` and returns int32 tokens [R]: row r is
``argmax_j(f[r, j] + g[r, j])`` (the first index among equal maxima)
over the filtered logits f = :func:`filter_logits_plain` (JAX's
``_filter_logits``) and the Gumbel noise g of one of two keyings:

* the engines' rule (``seeds``, ``pos``, ``window``): row r = b *
  window + w draws with ``fold_in(PRNGKey(seeds[b]), pos[b] + w)`` over
  counters 0..V-1 — ``sample_token_pos`` (window 1) and
  ``sample_window``;
* the generate rule (``key``): one key draws the whole [R, V] array,
  row r over counters r V .. r V + V - 1 —
  ``jax.random.categorical(key, logits)``.

:func:`gumbel_argmax` is the draw alone (temperature 1, no top-k, no
top-p: the same launch).

The kernel keeps the filter's thresholds exact.  The k-th largest value
comes from integer counts.  The top-p cut comes from each kept value's
softmax mass ``exp(x - max)`` rounded to a 64-bit fixed-point integer
(:func:`mass_bits`), summed exactly and compared exactly with ``top_p``
times the total (:func:`mass_threshold`).  :func:`cut_values_plain` is
that rule in plain PyTorch.  It may differ from the float softmax and
cumsum of :func:`filter_logits_plain` only where the cumulative mass at
the cut lies within rounding of ``top_p`` (a top-p near-tie).  No float
sum decides a token, so a row's token does not depend on how many rows
are drawn with it or on the launch plan.

Dispatch: a CPU tensor runs :func:`sample_rows_plain`
(``gumbel_argmax_plain(filter_logits_plain(...))``, what the CPU path
computed before the kernel existed); a CUDA tensor launches the kernel
or raises.  There is no fallback and no move to the CPU.  ``LAUNCHES``
counts one a kernel launch.  A launch allocates only its output and
uses no scratch, so draws on several streams never meet and a CUDA
graph can capture one.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ....models import prng
from . import _build

__all__ = ["sample_rows", "sample_rows_plain", "gumbel_argmax",
           "gumbel_argmax_plain", "filter_logits_plain", "cut_values_plain",
           "apply_cuts", "perturbed_scores", "order_keys", "key_values",
           "mass_bits", "mass_threshold", "sampling_plan", "device_fits",
           "reset_launches", "LAUNCHES"]

#: kernel launches so far (CUDA tensors only; the plain version and
#: rejected calls do not count)
LAUNCHES = 0

#: threads a block; radix digits (bits, so bins = 2^DIGIT_BITS) of the
#: 32-bit order keys; the cluster sizes a plan may take; the candidates
#: rank 0 of a cluster gathers under top-k
THREADS, DIGIT_BITS = 1024, 8
CLUSTER_SIZES = (16, 8, 4, 2)
MAX_CAND = 2048
#: candidates a plan aims to gather under top-k (rank 0 counts them
#: pairwise: its time grows with their square)
GATHER_TARGET = 512
#: dynamic shared memory a block may use on the card (bytes: 227 KB less
#: 1 KB for the static scalars), and what a block holds besides its
#: slice of the row: the histograms (a published pair and one a warp,
#: 64-bit bins), the candidates and the mbarrier's 16-byte slot
SMEM_LIMIT = 231424
SMEM_FIXED = ((2 + THREADS // 32) * (1 << DIGIT_BITS) * 8 + MAX_CAND * 8
              + 16)

_fn = None
_FITS = {}
#: a launch's plan and scalar arguments by (device, R, V, top_k,
#: temperature, top_p): the plan, the occupancy lookup and the float32
#: conversions run once a setting, not once a draw
_ARGS = {}
_ARGS_MAX = 256


def reset_launches():
    """Set the launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _scaled(logits, temperature: float):
    """float32 logits / temperature, an IEEE division (JAX's).  The
    divisor is a 0-d tensor on the logits' device: divided by a Python
    float, a CUDA tensor is multiplied by the float32 reciprocal
    instead, which can round one step away."""
    x = logits.to(torch.float32)
    return x / torch.full((), temperature, dtype=torch.float32,
                          device=x.device)


def filter_logits_plain(logits, temperature: float, top_k: int,
                        top_p: float):
    """Temperature / top-k / top-p transform of the last axis, in
    float32 (JAX ``decoding._filter_logits``): top-k keeps the values at
    or above the k-th largest; top-p keeps the smallest prefix of the
    descending values whose softmax mass reaches ``top_p`` (always one
    token), cut at the value there.  Dropped logits become -inf."""
    logits = _scaled(logits, temperature)
    V = logits.shape[-1]
    if top_k and 0 < top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        e = torch.exp(desc - desc[..., :1])
        cum = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
        # a cutoff past the end (the whole mass below top_p by rounding)
        # cuts nothing, as JAX's out-of-range take does
        idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=V - 1)
        cutoff = torch.gather(desc, -1, idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _row_keys(seeds, pos, window):
    """[R, 2] keys of the engines' rule: fold_in(PRNGKey(seeds[b]),
    pos[b] + w) for row b * window + w."""
    w = torch.arange(window, dtype=torch.int32, device=pos.device)
    p = (pos.to(torch.int32)[:, None] + w).reshape(-1)
    s = seeds.repeat_interleave(window)
    return prng.fold_in(prng.PRNGKey(s), p)


def perturbed_scores(logits, seeds=None, pos=None, key=None,
                     window: int = 1):
    """logits + g [R, V] in float32, the scores whose argmax each row
    draws (see the module note), in plain PyTorch."""
    R, V = logits.shape
    if key is not None:
        g = prng.gumbel(key, (R, V))
    else:
        g = prng.gumbel(_row_keys(seeds, pos, window), (V,))
    return logits.to(torch.float32) + g


def gumbel_argmax_plain(logits, seeds=None, pos=None, key=None,
                        window: int = 1):
    """The draw in plain PyTorch (:mod:`~paddle_tpu_torch.models.prng`)
    from filtered float32 logits: int32 tokens [R]."""
    return torch.argmax(perturbed_scores(logits, seeds, pos, key, window),
                        dim=-1).to(torch.int32)


def sample_rows_plain(logits, temperature: float, top_k: int = 0,
                      top_p: float = 1.0, seeds=None, pos=None, key=None,
                      window: int = 1):
    """The kernel's function in plain PyTorch: the float filter of JAX's
    ``_filter_logits``, then the draw."""
    return gumbel_argmax_plain(
        filter_logits_plain(logits, temperature, top_k, top_p), seeds, pos,
        key, window)


def order_keys(x):
    """The kernel's order-preserving 32-bit keys of float32 ``x``, as
    int64: a larger value has a larger key, NaN (any sign or payload)
    is above +inf, -0 has +0's key."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, 0, b)
    k = torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)
    return torch.where(torch.isnan(x), 0xFFFFFFFF, k)


def key_values(k):
    """float32 values of order keys (int64): NaN for the NaN key, +0 for
    the key of -0 and +0."""
    b = torch.where(k >= 0x80000000, k & 0x7FFFFFFF, k ^ 0xFFFFFFFF)
    v = (b - ((b >> 31) << 32)).to(torch.int32).view(torch.float32)
    return torch.where(k == 0xFFFFFFFF, float("nan"), v)


def mass_bits(V: int) -> int:
    """Fixed-point bits of a mass: a value's mass is ``exp(x - max)``
    (float32, at most 1) times 2^bits, truncated, so a row of V masses
    sums below 2^53 + 1."""
    return 53 - max(V - 1, 1).bit_length()


def _p_parts(top_p: float):
    """(mantissa, s) with float32(top_p) = mantissa 2^-s, for 0 <
    float32(top_p) < 1."""
    b = int(np.float32(top_p).view(np.uint32))
    e = b >> 23
    mant = (b & 0x7FFFFF) | (0x800000 if e else 0)
    return mant, (150 - e if e else 149)


def mass_threshold(total, top_p: float):
    """The least mass that reaches ``top_p``: ceil(float32(top_p) x
    total) exactly, at least 1 (a ``top_p`` at or below 0 cuts at the
    maximum, as JAX's ``cum < top_p`` does), the total when
    float32(top_p) rounds to 1.  ``total`` is an int64 tensor of masses
    below 2^53 + 1 (int64 arithmetic, no float product)."""
    p = float(np.float32(top_p))
    if not p > 0.0:
        return torch.ones_like(total)
    if p >= 1.0:
        return total
    mant, s = _p_parts(top_p)
    t = s - 24
    hi, lo = total >> 24, total & 0xFFFFFF
    a2 = mant * hi + ((mant * lo) >> 24)
    lo2 = (mant * lo) & 0xFFFFFF
    if t >= 63:
        q, rem = torch.zeros_like(total), (a2 | lo2) != 0
    else:
        q = a2 >> t
        rem = ((a2 & ((1 << t) - 1)) != 0) | (lo2 != 0)
    return torch.clamp(q + rem.to(torch.int64), min=1)


def cut_values_plain(logits, temperature: float, top_k: int = 0,
                     top_p: float = 1.0):
    """The kernel's selection rule in plain PyTorch: each row's k-th
    value and top-p cut, float32 [R] each, of x = logits / temperature.
    A value x is kept when neither ``x < kth`` nor ``x < cut`` holds
    (:func:`apply_cuts`); "no cut" is -inf.

    kth: the k-th largest x, duplicates counted, NaN above +inf (when 0
    < top_k < V).  cut (when top_p < 1): among the values not below kth,
    the largest v whose mass at or above it, sum of
    ``floor(exp(x - max) 2^mass_bits(V))``, reaches
    :func:`mass_threshold` of their total.  A row whose maximum is NaN,
    +inf or -inf (all -inf) takes the cut at that maximum, as JAX's
    softmax and cumsum do there."""
    x = _scaled(logits, temperature)
    R, V = x.shape
    keys = order_keys(x)
    ninf = torch.full((R,), float("-inf"), dtype=torch.float32,
                      device=x.device)
    if top_k and 0 < top_k < V:
        kth_key = torch.topk(keys, top_k, dim=-1).values[:, -1]
        kth = key_values(kth_key)
    else:
        kth_key = torch.zeros(R, dtype=torch.int64, device=x.device)
        kth = ninf
    if not top_p < 1.0:
        return kth, ninf
    mx_key = keys.max(dim=-1).values
    mx = key_values(mx_key)
    e = torch.exp(x - mx[:, None])
    m = (e.to(torch.float64) * float(2 ** mass_bits(V))).to(torch.int64)
    m = torch.where(keys >= kth_key[:, None], m, 0)
    sk, order = torch.sort(keys, dim=-1, descending=True)
    cs = torch.cumsum(torch.gather(m, -1, order), dim=-1)
    thr = mass_threshold(cs[:, -1], top_p)
    first = (cs < thr[:, None]).sum(dim=-1).clamp(max=V - 1)
    cut = key_values(torch.gather(sk, -1, first[:, None])[:, 0])
    finite = torch.isfinite(mx)
    return kth, torch.where(finite, cut, mx)


def apply_cuts(logits, temperature: float, kth, cut):
    """logits / temperature with the values below ``kth`` or ``cut``
    (float32 [R]) set to -inf: the filtered logits of the kernel's
    rule."""
    x = _scaled(logits, temperature)
    drop = (x < kth[:, None]) | (x < cut[:, None])
    return x.masked_fill(drop, float("-inf"))


# ---------------------------------------------------------------------------
# the plan and the launch
# ---------------------------------------------------------------------------

def sampling_plan(R: int, V: int, fits=None, top_k: int = 0) -> dict:
    """How the kernel cuts an [R, V] draw: one thread-block cluster of
    ``clusters`` blocks a row, rank c holding logits [c slice, (c + 1)
    slice) of it (``slice`` a multiple of 4, so every slice starts 16
    bytes apart; the last may be short or empty) in shared memory.
    ``fits`` is {cluster size: clusters that fit on the card at once}
    for this V (:func:`device_fits`; none given: every size fits).  The
    plan takes the size that runs the R rows in the fewest waves; then,
    under top-k, one whose blocks gather at most ``GATHER_TARGET``
    candidates (about k a block) to rank 0, which counts them pairwise;
    then the largest.  Nothing that decides a token depends on it:
    counts and masses are exact integer sums."""
    gathers = 0 < top_k < V
    cands = []
    for C in CLUSTER_SIZES:
        L = -(-V // (4 * C)) * 4
        smem = SMEM_FIXED + 4 * L
        fit = R if fits is None else fits.get(C, 0)
        if smem > SMEM_LIMIT or fit < 1:
            continue
        crowded = gathers and C * top_k > GATHER_TARGET
        cands.append((-(-R // fit), crowded, -C, L, smem))
    if not cands:
        raise ValueError(f"sampling: a row of {V} logits does not fit the "
                         f"shared memory of {CLUSTER_SIZES[0]} blocks")
    waves, _, neg_c, L, smem = min(cands)
    return {"clusters": -neg_c, "slice": L, "smem": smem,
            "blocks": -R * neg_c, "waves": waves}


def _check(logits, seeds, pos, key, window, temperature):
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise TypeError(f"sample_rows: float32 logits [R, V] expected, "
                        f"got {logits.dtype} {tuple(logits.shape)}")
    if temperature is None or not temperature > 0.0:
        raise ValueError(f"sample_rows: temperature must be > 0, got "
                         f"{temperature} (greedy is argmax)")
    R = logits.shape[0]
    if (key is None) == (seeds is None):
        raise ValueError("sample_rows: give either key or seeds and pos")
    dev = logits.device
    if key is not None:
        if key.shape != (2,) or key.dtype != torch.int64 \
                or key.device != dev:
            raise ValueError(f"sample_rows: key must be int64 [2] on "
                             f"{dev}, got {key.dtype} {tuple(key.shape)} "
                             f"on {key.device}")
        return
    if window < 1 or R % window:
        raise ValueError(f"sample_rows: {R} rows are not whole windows "
                         f"of {window}")
    for name, t in (("seeds", seeds), ("pos", pos)):
        if t is None or t.shape != (R // window,) or t.device != dev \
                or t.dtype != torch.int32:
            raise ValueError(
                f"sample_rows: {name} must be int32 [{R // window}] on "
                f"{dev}, got " + ("None" if t is None else
                                  f"{t.dtype} {tuple(t.shape)} on "
                                  f"{t.device}"))


def _lib():
    return _build.load("sampling")


def _kernel():
    global _fn
    if _fn is None:
        fn = _lib().pt_sample_rows
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def device_fits(device, V: int) -> dict:
    """{cluster size: clusters of the kernel that fit at once} on a CUDA
    device for rows of V logits (the card's occupancy query, once a
    (device, V))."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    fits = _FITS.get((idx, V))
    if fits is None:
        query = _lib().pt_sample_rows_max_clusters
        query.argtypes = [ctypes.c_int, ctypes.c_int]
        query.restype = ctypes.c_int
        fits = {}
        with torch.cuda.device(idx):
            for C in CLUSTER_SIZES:
                smem = SMEM_FIXED + 4 * (-(-V // (4 * C)) * 4)
                if smem <= SMEM_LIMIT:
                    n = query(C, smem)
                    if n < 0:
                        raise RuntimeError(f"sampling: cluster occupancy "
                                           f"query failed: CUDA error {-n}")
                    fits[C] = n
        _FITS[(idx, V)] = fits
    return fits


def _launch_args(device, R, V, temperature, top_k, top_p):
    """(slice, clusters, temperature, top_k, has_p, top_p, mass bits):
    the arguments of a launch that follow from the shape, the card and
    the setting (cached)."""
    key = (device.index, R, V, top_k, temperature, top_p)
    args = _ARGS.get(key)
    if args is None:
        plan = sampling_plan(R, V, device_fits(device, V), top_k)
        has_p = int(top_p < 1.0)
        args = (plan["slice"], plan["clusters"],
                float(np.float32(temperature)),
                int(top_k) if top_k and 0 < top_k < V else 0, has_p,
                float(np.float32(top_p)) if has_p else 1.0, mass_bits(V))
        if len(_ARGS) >= _ARGS_MAX:
            _ARGS.clear()
        _ARGS[key] = args
    return args


def _launch(logits, temperature, top_k, top_p, seeds, pos, key, window):
    global LAUNCHES
    R, V = logits.shape
    out = torch.empty(R, dtype=torch.int32, device=logits.device)
    if R == 0:
        return out
    if V < 1:
        raise ValueError("sample_rows: rows of 0 logits")
    logits = logits.contiguous()
    ptr = logits.data_ptr()
    L, C, *scalars = _launch_args(logits.device, R, V, temperature, top_k,
                                  top_p)
    tma = int(V % 4 == 0 and ptr % 16 == 0)
    rc = _kernel()(ptr, R, V, L, C, tma, *scalars,
                   None if seeds is None else seeds.data_ptr(),
                   None if pos is None else pos.data_ptr(), window,
                   None if key is None else key.data_ptr(), out.data_ptr(),
                   torch._C._cuda_getCurrentRawStream(logits.device.index))
    if rc != 0:
        raise RuntimeError(f"sampling kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def sample_rows(logits, temperature: float, top_k: int = 0,
                top_p: float = 1.0, seeds=None, pos=None, key=None,
                window: int = 1):
    """Tokens [R] int32 drawn from raw float32 logits [R, V] at
    ``temperature`` (> 0), ``top_k`` and ``top_p`` by the engines' rule
    (``seeds``, ``pos`` int32 [R / window] on the logits' device) or the
    generate rule (``key`` int64 [2]); see the module note.  CPU tensors
    run :func:`sample_rows_plain`; CUDA tensors launch the kernel on the
    current stream (one launch, no host sync) or raise."""
    _check(logits, seeds, pos, key, window, temperature)
    dev = logits.device.type
    if dev == "cpu":
        return sample_rows_plain(logits, temperature, top_k, top_p, seeds,
                                 pos, key, window)
    if dev != "cuda":
        raise ValueError(f"sample_rows runs on cuda or cpu tensors, got "
                         f"{logits.device}")
    return _launch(logits, temperature, top_k, top_p, seeds, pos, key,
                   window)


def gumbel_argmax(logits, seeds=None, pos=None, key=None, window: int = 1):
    """Tokens [R] int32 drawn from float32 logits [R, V] with no filter:
    :func:`sample_rows` at temperature 1 (an exact division), no top-k,
    no top-p."""
    return sample_rows(logits, 1.0, 0, 1.0, seeds, pos, key, window)
