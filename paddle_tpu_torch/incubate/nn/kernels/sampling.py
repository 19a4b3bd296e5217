"""The sampler: a keyed Gumbel-max draw of one token a row on JAX's
threefry stream (a module of the port only).

The JAX package draws in XLA (``jax.random.categorical`` inside
``paddle_tpu/models/decoding.py`` ``sample_token`` and ``_sample_one``),
with no Pallas kernel.  On the card the plain composition of
:mod:`~paddle_tpu_torch.models.prng` is ~150 elementwise launches over
[rows, V] int64 tensors a draw; :func:`gumbel_argmax` is the
hand-written kernel of ``csrc/sampling.cu``, one launch a draw, whose
source note says what bounds it and how it is built.

:func:`gumbel_argmax` takes filtered float32 logits [R, V] and returns
int32 tokens [R], row r being ``argmax_j(logits[r, j] + g[r, j])`` (the
first index among equal maxima) with the Gumbel noise g of one of two
keyings:

* the engines' rule (``seeds``, ``pos``, ``window``): row r = b *
  window + w draws with ``fold_in(PRNGKey(seeds[b]), pos[b] + w)`` over
  counters 0..V-1 — ``sample_token_pos`` (window 1) and
  ``sample_window``;
* the generate rule (``key``): one key draws the whole [R, V] array,
  row r over counters r V .. r V + V - 1 —
  ``jax.random.categorical(key, logits)``.

Dispatch: a CPU tensor runs :func:`gumbel_argmax_plain`; a CUDA tensor
launches the kernel or raises.  There is no fallback and no move to
the CPU.  ``LAUNCHES`` counts one a kernel launch.
"""
from __future__ import annotations

import ctypes

import torch

from ....models import prng
from . import _build

__all__ = ["gumbel_argmax", "gumbel_argmax_plain", "perturbed_scores",
           "sampling_plan", "reset_launches", "LAUNCHES"]

#: kernel launches so far (CUDA tensors only; the plain version and
#: rejected calls do not count)
LAUNCHES = 0

#: threads a block (one pass of a chunk); blocks the plan aims for over
#: a draw (4 an SM of an H100)
THREADS, TARGET_BLOCKS = 256, 528

_fn = None
_SCRATCH = {}


def reset_launches():
    """Set the launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0


def sampling_plan(R: int, V: int) -> dict:
    """How the kernel cuts an [R, V] draw: ``chunk`` logits a block (a
    multiple of :data:`THREADS`) so that the R rows spread over about
    :data:`TARGET_BLOCKS` blocks, ``blocks_per_row`` = ceil(V / chunk).
    The plan moves no token: every block's winner meets the row's in
    an exact, order-free max."""
    per_block = -(-R * V // TARGET_BLOCKS)
    chunk = max(THREADS, -(-per_block // THREADS) * THREADS)
    return {"chunk": chunk, "blocks_per_row": -(-V // chunk),
            "blocks": R * -(-V // chunk)}


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
    """The kernel's function in plain PyTorch (:mod:`~paddle_tpu_torch.
    models.prng`): int32 tokens [R]."""
    return torch.argmax(perturbed_scores(logits, seeds, pos, key, window),
                        dim=-1).to(torch.int32)


def _check(logits, seeds, pos, key, window):
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise TypeError(f"gumbel_argmax: float32 logits [R, V] expected, "
                        f"got {logits.dtype} {tuple(logits.shape)}")
    R = logits.shape[0]
    if (key is None) == (seeds is None):
        raise ValueError("gumbel_argmax: give either key or seeds and pos")
    dev = logits.device
    if key is not None:
        if key.shape != (2,) or key.dtype != torch.int64 \
                or key.device != dev:
            raise ValueError(f"gumbel_argmax: key must be int64 [2] on "
                             f"{dev}, got {key.dtype} {tuple(key.shape)} "
                             f"on {key.device}")
        return
    if window < 1 or R % window:
        raise ValueError(f"gumbel_argmax: {R} rows are not whole windows "
                         f"of {window}")
    for name, t in (("seeds", seeds), ("pos", pos)):
        if t is None or t.shape != (R // window,) or t.device != dev \
                or t.dtype != torch.int32:
            raise ValueError(
                f"gumbel_argmax: {name} must be int32 [{R // window}] on "
                f"{dev}, got " + ("None" if t is None else
                                  f"{t.dtype} {tuple(t.shape)} on "
                                  f"{t.device}"))


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("sampling").pt_gumbel_argmax
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int] + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _scratch(device, stream, R):
    """The row slots and tickets of one stream of ``device``: zero
    between launches (each launch's last block of a row zeroes its
    own), grown as R needs.  Launches on one stream run in order, so
    they can share them; another stream gets its own."""
    got = _SCRATCH.get((device.index, stream))
    if got is None or got[0].numel() < R:
        n = max(R, 64 if got is None else 2 * got[0].numel())
        got = (torch.zeros(n, dtype=torch.int64, device=device),
               torch.zeros(n, dtype=torch.int32, device=device))
        _SCRATCH[(device.index, stream)] = got
    return got


def _launch(logits, seeds, pos, key, window):
    global LAUNCHES
    R, V = logits.shape
    if R > 65535:
        raise ValueError(f"gumbel_argmax: {R} rows exceed the grid's 65535")
    out = torch.empty(R, dtype=torch.int32, device=logits.device)
    if R == 0:
        return out
    logits = logits.contiguous()
    stream = torch._C._cuda_getCurrentRawStream(logits.device.index)
    best, ticket = _scratch(logits.device, stream, R)
    plan = sampling_plan(R, V)
    rc = _kernel()(logits.data_ptr(), R, V, plan["chunk"],
                   None if seeds is None else seeds.data_ptr(),
                   None if pos is None else pos.data_ptr(), window,
                   None if key is None else key.data_ptr(), out.data_ptr(),
                   best.data_ptr(), ticket.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sampling kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def gumbel_argmax(logits, seeds=None, pos=None, key=None, window: int = 1):
    """Tokens [R] int32 drawn from filtered float32 logits [R, V] by the
    engines' rule (``seeds``, ``pos`` int32 [R / window] on the logits'
    device) or the generate rule (``key`` int64 [2]); see the module
    note.  CPU tensors run :func:`gumbel_argmax_plain`, CUDA tensors
    launch the kernel on the current stream or raise.  Each stream of a
    device keeps its own zeroed row slots, so draws on two streams
    never meet; a launch that dies midway leaves its slots set, but it
    also leaves the CUDA context unusable."""
    _check(logits, seeds, pos, key, window)
    dev = logits.device.type
    if dev == "cpu":
        return gumbel_argmax_plain(logits, seeds, pos, key, window)
    if dev != "cuda":
        raise ValueError(f"gumbel_argmax runs on cuda or cpu tensors, got "
                         f"{logits.device}")
    return _launch(logits, seeds, pos, key, window)
