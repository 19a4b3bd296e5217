"""GPT — the flagship decoder-only LM (port of
``paddle_tpu/models/gpt.py``: config, init, forward, the training loss
and the KV-cache entry points of the serving path; dense weights, one
device).

The parameter tree keeps the JAX layout exactly — per-layer weights
stacked on a leading L axis, qkv packed as ``[L, H, 3, H]`` — so
:func:`params_from_numpy` maps the JAX pytree one to one and both
packages compute with the same weights.  Layout: activations
``[B, S, H]``; attention ``[B, S, nH, hD]``; KV cache
``{"k", "v"}: [L, B, max_len, nH, hD]`` in the storage dtype of
``kv_dtype`` (int8 adds ``{"ks", "vs"}`` scale planes with a trailing
axis of 1); paged pools the same with ``[L, num_blocks, block_size,
...]``.  Every cache write quantizes this step's rows on the way in.

Weight-only int8 (:func:`quantize_decode_params`): the four matmul
weights become ``(int8 [L, K, N], float32 scale [L, N])`` tuples and the
tied table ``(int8 [V, H], float32 row scale [V])``; every entry point of
the serving path takes such a tree (:func:`_wmm`, :func:`_embed_rows`,
the int8 tied head).  :func:`decode_step_fused` runs the whole layer
stack of a b1 step in the ``fused_decode`` kernel over the flat
``[L, T, H]`` cache of :func:`flatten_decode_cache`.

Differences from the JAX functions, by design:

* The depth ``lax.scan`` is a Python loop over layers, and the cache
  is updated IN PLACE (the JAX programs donate the cache buffer; here
  the same tensors are written).  The cache-writing entry points
  return the dict they were given.
* :func:`_layer_norm` is ``F.layer_norm``, which computes mean and
  variance in float32 for bfloat16 input; the JAX version computes
  them in the input dtype.  At float32 the two agree to rounding.
* The tied head and the loss head take float32 output from bfloat16
  operands through :func:`~.common.matmul_f32out`, as the JAX einsums
  with ``preferred_element_type=float32`` do; no logit is rounded to
  bfloat16.
* Training attention (``use_flash``) is the hand-written flash kernel
  pair on the card and its plain forward/backward on the CPU; remat is
  ``torch.utils.checkpoint`` per layer (False and True only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..incubate.nn.functional import _decode_attention
from ..incubate.nn.functional.chunked_ce import (chunked_vocab_nll,
                                                 pick_num_chunks)
from ..incubate.nn.kernels.flash_decode import (flash_decode_attention,
                                                flash_decode_paged)
from ..incubate.nn.kernels.fused_decode import fused_decode_layers
from ..incubate.nn.kv_quant import byte_view, kv_map, kv_zeros
from .common import (_causal_attention, _check_attn_kernel, _kv_layer,
                     _kv_write, _slot_rows_writer, _zero_cache, layer_slices,
                     matmul_f32out, param_count, params_from_numpy,
                     scan_layers_with_remat)

__all__ = ["GPTConfig", "gpt3_1p3b", "gpt_tiny", "init_params",
           "params_from_numpy", "param_count", "embed",
           "logits_from_hidden", "forward_layers", "forward", "loss_fn",
           "init_decode_cache", "prefill", "prefill_into_slots",
           "decode_step_multi", "decode_step_paged",
           "prefill_paged_batched", "prefill_paged",
           "quantize_decode_params", "decode_step_fused",
           "flatten_decode_cache"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32
    # training attention in forward()/loss_fn(): None -> the
    # flash_attention kernels on CUDA, the plain composition on the CPU;
    # True -> flash_attention on either (its plain versions on the CPU);
    # False -> the plain composition
    use_flash: Optional[bool] = None

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# GPT-3 1.3B: 24 layers, 2048 hidden, 16 heads of 128.
def gpt3_1p3b(**over) -> GPTConfig:
    cfg = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
               num_heads=16, max_position_embeddings=2048)
    cfg.update(over)
    return GPTConfig(**cfg)


def gpt_tiny(**over) -> GPTConfig:
    cfg = dict(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
               max_position_embeddings=256)
    cfg.update(over)
    return GPTConfig(**cfg)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: GPTConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Parameter tree in the JAX layout, drawn on ``device`` (CUDA by
    default) from a ``torch.Generator`` seeded with ``seed``.  The
    draws differ from ``jax.random``'s for the same seed; tests that
    compare the packages share weights through
    :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    H, F_, L = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    std = cfg.initializer_range
    dt = cfg.dtype

    def norm(shape, scale=std):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    return {
        "wte": norm((cfg.vocab_size, H)),
        "wpe": norm((cfg.max_position_embeddings, H)),
        "layers": {
            "ln1_g": ones(L, H),
            "ln1_b": zeros(L, H),
            "qkv_w": norm((L, H, 3, H)),
            "qkv_b": zeros(L, 3, H),
            "proj_w": norm((L, H, H), std / math.sqrt(2 * L)),
            "proj_b": zeros(L, H),
            "ln2_g": ones(L, H),
            "ln2_b": zeros(L, H),
            "fc1_w": norm((L, H, F_)),
            "fc1_b": zeros(L, F_),
            "fc2_w": norm((L, F_, H), std / math.sqrt(2 * L)),
            "fc2_b": zeros(L, H),
        },
        "lnf_g": ones(H),
        "lnf_b": zeros(H),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_norm(x, g, b, eps):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _wmm(x, w):
    """``x @ w`` for a dense ``w`` [K, N] or an int8 pair (qw int8
    [K, N], scale float32 [N]): then the product is taken in x's dtype
    and scaled in it, ``(x @ qw) * s``, as the JAX function does."""
    if isinstance(w, tuple):
        qw, s = w
        return (x @ qw.to(x.dtype)) * s.to(x.dtype)
    return x @ w


def _qkv_weight(lp, H):
    """The packed qkv weight as a [H, 3H] operand of :func:`_wmm`: the
    dense ``[H, 3, H]`` reshaped, or the int8 pair (quantized as
    ``[H, 3H]`` with a ``[3H]`` scale) as it is."""
    w = lp["qkv_w"]
    return w if isinstance(w, tuple) else w.reshape(H, 3 * H)


def _embed_rows(wte, idx, dtype):
    """Embedding lookup for a dense [V, H] table or a per-ROW int8 pair
    (qw [V, H], scale [V]), dequantized in ``dtype``."""
    if isinstance(wte, tuple):
        qw, s = wte
        return qw[idx].to(dtype) * s[idx][..., None].to(dtype)
    return wte[idx]


def _decoder_layer(h, lp, cfg: GPTConfig, return_kv: bool = False,
                   attn_kernel: Optional[str] = None):
    """One pre-LN decoder layer, dense or weight-only int8 (``lp``
    holds this layer's params); ``return_kv`` also returns its K/V
    (prefill)."""
    nH, hD = cfg.num_heads, cfg.head_dim
    x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_epsilon)
    B, S, H = x.shape
    qkv = _wmm(x, _qkv_weight(lp, H)).view(B, S, 3, H) + lp["qkv_b"]
    q = qkv[:, :, 0].view(B, S, nH, hD)
    k = qkv[:, :, 1].view(B, S, nH, hD)
    v = qkv[:, :, 2].view(B, S, nH, hD)
    if attn_kernel == "flash":
        # causal self-attention is the window mask with a zero base
        # offset (query j attends rows <= j): the decode kernel serves
        # prefill too
        attn = flash_decode_attention(
            q, k, v, torch.zeros((B,), dtype=torch.int32, device=h.device))
    else:
        attn = _causal_attention(q, k, v, hD, use_flash=cfg.use_flash)
    attn = _wmm(attn.reshape(B, S, H), lp["proj_w"])
    h = h + attn + lp["proj_b"]
    x = _layer_norm(h, lp["ln2_g"], lp["ln2_b"], cfg.layer_norm_epsilon)
    x = F.gelu(_wmm(x, lp["fc1_w"]) + lp["fc1_b"], approximate="tanh")
    out = h + _wmm(x, lp["fc2_w"]) + lp["fc2_b"]
    return (out, (k, v)) if return_kv else out


def embed(params, input_ids, cfg: GPTConfig):
    S = input_ids.shape[-1]
    pos = torch.arange(S, device=input_ids.device)
    return _embed_rows(params["wte"], input_ids, params["wpe"].dtype) \
        + params["wpe"][pos]


def _tied_logits(x, wte):
    """The weight-tied head on normalised hidden states x [..., H]:
    float32 logits [..., V] from operands in the model dtype.  An int8
    table (qw, row scale) is dequantized to x's dtype for the product
    and its float32 logits are scaled per vocabulary row, as JAX's
    einsum with ``preferred_element_type=float32`` then ``* s``."""
    if isinstance(wte, tuple):
        qw, s = wte
        logits = matmul_f32out(x.reshape(-1, x.shape[-1]),
                               qw.to(x.dtype).t()) * s
    else:
        logits = matmul_f32out(x.reshape(-1, x.shape[-1]), wte.t())
    return logits.view(*x.shape[:-1], logits.shape[-1])


def logits_from_hidden(params, h, cfg: GPTConfig):
    """Final LN + weight-tied head -> float32 logits [..., V]."""
    h = _layer_norm(h, params["lnf_g"], params["lnf_b"],
                    cfg.layer_norm_epsilon)
    return _tied_logits(h, params["wte"])


def forward_layers(h, layer_params, cfg: GPTConfig, remat=False):
    """The stacked decoder layers over h [B, S, H]; ``remat`` False or
    True (full per-layer recompute), see ``scan_layers_with_remat``."""
    return scan_layers_with_remat(lambda c, lp: _decoder_layer(c, lp, cfg),
                                  h, layer_params, remat)


def forward(params, input_ids, cfg: GPTConfig, remat=False):
    h = embed(params, input_ids, cfg)
    h = forward_layers(h, params["layers"], cfg, remat=remat)
    return logits_from_hidden(params, h, cfg)


def _head_loss(params, h, labels, cfg: GPTConfig):
    """Final LN + tied head + cross entropy over h [B, S, H], the mean
    over tokens.  The head goes through ``chunked_vocab_nll``: no
    [tokens, V] log-softmax is saved under autograd, and a no-grad call
    on the card of a supported shape runs the fused_ce kernel."""
    h = _layer_norm(h, params["lnf_g"], params["lnf_b"],
                    cfg.layer_norm_epsilon)
    N = h.shape[0] * h.shape[1]
    nll = chunked_vocab_nll(h.reshape(N, h.shape[-1]), params["wte"],
                            labels.reshape(N), 0,
                            pick_num_chunks(N, params["wte"].shape[0]))
    return nll.mean()


def loss_fn(params, input_ids, labels, cfg: GPTConfig, remat=False):
    """Next-token cross entropy, the mean over tokens."""
    h = embed(params, input_ids, cfg)
    h = forward_layers(h, params["layers"], cfg, remat=remat)
    return _head_loss(params, h, labels, cfg)


# ---------------------------------------------------------------------------
# KV-cache decoding (serving path)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: GPTConfig, batch: int, max_len: int,
                      kv_dtype: str = "bf16", device=None):
    """Zeroed {"k", "v"}: [L, batch, max_len, nH, hD] in the storage
    dtype of ``kv_dtype`` ("bf16" = the model dtype, "int8", "fp8");
    int8 adds float32 scale planes {"ks", "vs"}: [L, batch, max_len,
    nH, 1].  The paged engine's pools are this layout with batch =
    num_blocks and max_len = block_size."""
    return _zero_cache((cfg.num_layers, batch, max_len, cfg.num_heads,
                        cfg.head_dim), kv_dtype, cfg.dtype, device)


def _prefill_layers(params, input_ids, cfg: GPTConfig, cache, write,
                    attn_kernel: Optional[str]):
    """The stack over prompts [N, S]: each layer's K/V (computed in the
    model dtype; the window attends its own unquantized rows) goes
    through ``write(arr, rows)`` into layer l of ``cache``; returns the
    last hidden state [N, S, H]."""
    _check_attn_kernel(attn_kernel)
    h = embed(params, input_ids, cfg)
    for l, lp in enumerate(layer_slices(params["layers"])):
        h, (k, v) = _decoder_layer(h, lp, cfg, return_kv=True,
                                   attn_kernel=attn_kernel)
        ck, cv = _kv_layer(cache, l)
        _kv_write(ck, k, write)
        _kv_write(cv, v, write)
    return h


def prefill(params, input_ids, cfg: GPTConfig, cache,
            attn_kernel: Optional[str] = None):
    """Run the prompt [B, S] through the stack, writing each layer's K/V
    into cache rows [0, S) in place.  Returns (last-position logits
    [B, V], cache, pos=S)."""
    B, S = input_ids.shape
    slots = torch.arange(B, device=input_ids.device)
    h = _prefill_layers(params, input_ids, cfg, cache,
                        _slot_rows_writer(slots, S), attn_kernel)
    logits = logits_from_hidden(params, h[:, -1:], cfg)[:, 0]
    return logits, cache, S


def prefill_into_slots(params, input_ids, cfg: GPTConfig, cache, slots,
                       attn_kernel: Optional[str] = None):
    """Batched admission prefill writing straight into the engine's
    cache slots: input_ids [N, S] (N prompts padded to one bucket S),
    slots [N] slot indices.  Each layer's K/V rows [0, S) land in
    ``cache[l, slots]`` in place — no scratch cache.  Returns the
    cache (the engine discards logits: priming recomputes the last
    prompt position)."""
    _prefill_layers(params, input_ids, cfg, cache,
                    _slot_rows_writer(slots.long(), input_ids.shape[1]),
                    attn_kernel)
    return cache


def _decode_layer_step(h, lp, ck, cv, cfg: GPTConfig, write_kv, attend):
    """One-token block of the decode paths: this token's K/V go through
    ``write_kv(ck, cv, k, v)`` (the write strategy: per-slot row, or the
    slot's page), then ``attend(q, ck, cv)`` gives the attention output
    [B, nH, hD] — the flash kernel or the plain composition over the
    cache or its page view.  The two are the only variation points, so
    every decode path runs one implementation."""
    B = h.shape[0]
    nH, hD, H = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_epsilon)
    qkv = _wmm(x, _qkv_weight(lp, H)).view(B, 3, H) + lp["qkv_b"]
    q = qkv[:, 0].view(B, nH, hD)
    k = qkv[:, 1].view(B, nH, hD)
    v = qkv[:, 2].view(B, nH, hD)
    write_kv(ck, cv, k, v)
    attn = attend(q, ck, cv)
    hh = h + _wmm(attn.reshape(B, H), lp["proj_w"]) + lp["proj_b"]
    x = _layer_norm(hh, lp["ln2_g"], lp["ln2_b"], cfg.layer_norm_epsilon)
    x = F.gelu(_wmm(x, lp["fc1_w"]) + lp["fc1_b"], approximate="tanh")
    return hh + _wmm(x, lp["fc2_w"]) + lp["fc2_b"]


def decode_step_multi(params, cache, token, pos, cfg: GPTConfig,
                      attn_kernel: Optional[str] = None):
    """One token per slot at PER-SLOT positions: token [B], pos [B]
    int32 -> (logits [B, V] float32, cache updated in place).  Each
    slot's K/V row lands at ``cache[l, b, pos[b]]`` (quantized on write
    for an int8/fp8 cache).  ``attn_kernel="flash"`` serves the
    attention from the flash_decode kernel (W = 1) instead of the plain
    composition."""
    _check_attn_kernel(attn_kernel)
    B = token.shape[0]
    h = _embed_rows(params["wte"], token, params["wpe"].dtype) \
        + params["wpe"][pos]                                     # [B, H]
    write_at = (torch.arange(B, device=token.device), pos.long())

    def write(arr, rows):
        byte_view(arr)[write_at] = byte_view(rows)

    def write_kv(ck, cv, k, v):
        _kv_write(ck, k, write)
        _kv_write(cv, v, write)

    if attn_kernel == "flash":
        def attend(q, ck, cv):
            return flash_decode_attention(q[:, None], ck, cv, pos)[:, 0]
    else:
        def attend(q, ck, cv):
            return _decode_attention(q, ck, cv, pos + 1)

    for l, lp in enumerate(layer_slices(params["layers"])):
        ck, cv = _kv_layer(cache, l)
        h = _decode_layer_step(h, lp, ck, cv, cfg, write_kv, attend)
    logits = logits_from_hidden(params, h[:, None], cfg)[:, 0]
    return logits, cache


def _paged_write_target(block_tables, pos, block_size, num_blocks):
    """Where each slot's decode row goes in a paged pool: (page, offset,
    source slot, any_valid).  A slot whose page is -1 (or past the pool)
    drops its write, as the JAX scatter does with ``mode="drop"``; an
    in-place index_put cannot drop, so such a slot repeats the first
    valid slot's write —
    the same row with the same bytes, whatever order the duplicates land
    in.  With no valid slot at all the writes rewrite page 0's row 0
    with its own content (see :func:`decode_step_paged`)."""
    B = pos.shape[0]
    posl = pos.long()
    page = block_tables.long().gather(1, (posl // block_size)[:, None])[:, 0]
    off = posl % block_size
    valid = (page >= 0) & (page < num_blocks)
    first = torch.argmax(valid.to(torch.int32))   # 0 when none is valid
    src = torch.where(valid, torch.arange(B, device=pos.device), first)
    any_valid = valid.any()
    zero = torch.zeros_like(page)
    return (torch.where(any_valid, page[src], zero),
            torch.where(any_valid, off[src], zero), src, any_valid)


def decode_step_paged(params, pools, block_tables, token, pos,
                      cfg: GPTConfig, attn_kernel: Optional[str] = None):
    """One token per slot against a PAGED KV cache: pools {"k", "v"
    (, "ks", "vs")}: [L, num_blocks, block_size, nH, hD (or 1)] shared
    by all slots; block_tables [B, max_blocks] int32 page ids per slot
    (-1 = unallocated); token/pos [B].  Returns (logits [B, V], pools
    updated in place).  The write puts this token's K/V in row
    ``pos % block_size`` of page ``block_tables[b, pos // block_size]``
    and drops it when that page is -1 (an inactive slot, whose table is
    all -1) or past the pool.  ``attn_kernel="flash"`` reads the pool in
    place through ``flash_decode_paged``; otherwise the slot's pages are
    gathered (ids clamped into the pool) and the plain composition
    attends them, masked to pos + 1."""
    _check_attn_kernel(attn_kernel)
    B = token.shape[0]
    nb, bs = pools["k"].shape[1], pools["k"].shape[2]
    h = _embed_rows(params["wte"], token, params["wpe"].dtype) \
        + params["wpe"][pos]                                     # [B, H]
    page, off, src, any_valid = _paged_write_target(block_tables, pos, bs,
                                                    nb)

    def write(arr, rows):
        raw = byte_view(arr)
        rows = byte_view(rows).index_select(0, src)
        raw[page, off] = torch.where(any_valid, rows, raw[page, off])

    def write_kv(ck, cv, k, v):
        _kv_write(ck, k, write)
        _kv_write(cv, v, write)

    if attn_kernel == "flash":
        def attend(q, ck, cv):
            return flash_decode_paged(q[:, None], ck, cv, block_tables,
                                      pos)[:, 0]
    else:
        # ids clamped into the pool, as the JAX gather clamps
        safe = block_tables.clamp(0, nb - 1).long()

        def view(a):
            return byte_view(a)[safe].view(a.dtype).reshape(
                (B, -1) + tuple(a.shape[2:]))

        def attend(q, ck, cv):
            return _decode_attention(q, kv_map(view, ck), kv_map(view, cv),
                                     pos + 1)

    for l, lp in enumerate(layer_slices(params["layers"])):
        ck, cv = _kv_layer(pools, l)
        h = _decode_layer_step(h, lp, ck, cv, cfg, write_kv, attend)
    logits = logits_from_hidden(params, h[:, None], cfg)[:, 0]
    return logits, pools


def prefill_paged_batched(params, input_ids, cfg: GPTConfig, pools, pages,
                          attn_kernel: Optional[str] = None):
    """Batched admission prefill for the PAGED pools: input_ids [N, S]
    with S a whole number of pages, pages [N, S / block_size] page ids
    (distinct across requests).  Each layer's K/V reshapes to pages and
    lands in those pages of the pools in place.  Returns the pools.
    ``attn_kernel="flash"``: the window's causal self-attention runs
    through the contiguous flash_decode kernel over the window's own
    K/V (paging only decides where the rows land)."""
    N, S = input_ids.shape
    bs = pools["k"].shape[2]
    if S % bs or tuple(pages.shape) != (N, S // bs):
        raise ValueError(f"prefill of [{N}, {S}] ids into pages of "
                         f"{bs} rows needs S a multiple of {bs} and pages "
                         f"[{N}, {S // bs}], got {tuple(pages.shape)}")
    nblk = S // bs
    pages = pages.long()

    def write(arr, rows):
        byte_view(arr)[pages] = byte_view(rows).reshape(
            (N, nblk, bs) + tuple(arr.shape[2:]))

    _prefill_layers(params, input_ids, cfg, pools, write, attn_kernel)
    return pools


def prefill_paged(params, input_ids, cfg: GPTConfig, pools, pages):
    """Prefill one request's prompt [S] into its pages: the contiguous
    prefill into a scratch cache of whole pages (a prompt shorter than
    its pages pads with id 0), then the scratch lands page by page in
    the pools.  ``pages`` [ceil(S / block_size)] page ids.  Returns
    (logits [V] at the last padded position, pools updated in
    place)."""
    S = input_ids.shape[-1]
    L, bs = pools["k"].shape[0], pools["k"].shape[2]
    nblk = -(-S // bs)
    # the scratch mirrors the pools' storage (data and any scales), so
    # the contiguous prefill quantizes on write
    scratch = {name: kv_zeros((L, 1, nblk * bs) + tuple(a.shape[3:]),
                              a.dtype, a.device)
               for name, a in pools.items()}
    ids = F.pad(input_ids, (0, nblk * bs - S))
    logits, scratch, _ = prefill(params, ids[None], cfg, scratch)
    pages = pages.long()
    for name, a in pools.items():
        byte_view(a)[:, pages] = byte_view(scratch[name][:, 0]).reshape(
            (L, nblk, bs) + tuple(a.shape[3:]))
    return logits[0], pools


# ---------------------------------------------------------------------------
# Weight-only int8 and the fused b1 decode step
# ---------------------------------------------------------------------------

def quantize_decode_params(params, cfg: GPTConfig):
    """Weight-only int8 copy of a GPT parameter tree for the decode path.
    The matmul weights become (int8, per-out-channel float32 scale)
    pairs — qkv quantized as ``[L, H, 3H]`` — and the tied table
    quantizes per ROW, so the lookup (row scale) and the head (output
    channel = vocabulary row) dequantize alike.  LN, biases and the
    positional table stay as they are.  Scales are ``max|w| / 127`` and
    the values ``clip(round(w / max(s, 1e-8)), -127, 127)`` with round
    half to even, in float32: bit-identical to the JAX function on the
    same weights."""
    L, H = cfg.num_layers, cfg.hidden_size

    def chan_q(w):
        wf = w.float()
        s = wf.abs().amax(dim=-2) / 127.0
        q = torch.round(wf / s.clamp_min(1e-8)[..., None, :]) \
            .clamp(-127, 127).to(torch.int8)
        return q, s

    lp = params["layers"]
    qlayers = dict(lp)
    qlayers["qkv_w"] = chan_q(lp["qkv_w"].reshape(L, H, 3 * H))
    for name in ("proj_w", "fc1_w", "fc2_w"):
        qlayers[name] = chan_q(lp[name])
    out = dict(params)
    out["layers"] = qlayers
    wte = params["wte"].float()
    s = wte.abs().amax(dim=1) / 127.0                 # per vocab row
    qwte = torch.round(wte / s.clamp_min(1e-8)[:, None]) \
        .clamp(-127, 127).to(torch.int8)
    out["wte"] = (qwte, s)
    return out


def decode_step_fused(qparams, cache, token, pos, cfg: GPTConfig):
    """The b1 decode step through the fused layer-stack kernel
    (``incubate/nn/kernels/fused_decode.py``): ONE launch runs all L
    layers for this token.  ``qparams`` from
    :func:`quantize_decode_params`; cache {"k", "v"}: [L, T, H] in the
    storage dtype (:func:`flatten_decode_cache`), int8 adding {"ks",
    "vs"}: [L, T, nH]; token [1] int32; pos the position fed (an int or
    an int32 tensor of one element; a device tensor is read by the
    kernel, so the step never syncs the host).  Returns (logits [1, V]
    float32, cache updated in place)."""
    H = cfg.hidden_size
    wte_q, wte_s = qparams["wte"]
    dev = wte_q.device
    pos1 = (pos.reshape(1) if torch.is_tensor(pos)
            else torch.tensor([pos], dtype=torch.int32, device=dev))
    tok = token.reshape(1)
    # row 0 of the kernel's [8, H] input is the real one
    row = wte_q[tok].float() * wte_s[tok][:, None] \
        + qparams["wpe"][pos1].float()
    h0 = F.pad(row, (0, 0, 0, 7))
    scales = (cache["ks"], cache["vs"]) if "ks" in cache else None
    hout = fused_decode_layers(h0, qparams["layers"], cache["k"],
                               cache["v"], pos1.to(torch.int32),
                               cfg.num_heads, eps=cfg.layer_norm_epsilon,
                               scales=scales)[0]
    logits = logits_from_hidden(qparams, hout[0:1][None].to(cfg.dtype),
                                cfg)[:, 0]
    return logits, cache


def flatten_decode_cache(cache, cfg: GPTConfig):
    """The standard b1 cache [L, 1, T, nH, hD] (scales [L, 1, T, nH, 1])
    in the fused kernel's layout [L, T, H] (scales [L, T, nH]): views
    of the same storage."""
    L, T = cache["k"].shape[0], cache["k"].shape[2]
    return {k: v[:, 0].reshape(L, T, -1) for k, v in cache.items()}
