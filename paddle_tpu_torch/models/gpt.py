"""GPT — the flagship decoder-only LM (port of
``paddle_tpu/models/gpt.py``: config, init, forward, the training loss,
the KV-cache entry points of the serving path with greedy
:func:`generate`, and the speculative verify over a window; dense
weights, one device).

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

Speculative verify (:func:`verify_into_slots`, :func:`verify_paged`,
:func:`verify_fused`) feeds a window of W = k+1 tokens a slot at
positions pos..pos+W-1 in one teacher-forced pass: query j attends rows
<= pos + j, through the same ``flash_decode`` kernel that serves W = 1,
so the window runs the decode block (:func:`_decode_layer_step`) on
``[B, W, H]``.  Writes past the cache (an inactive slot fed at
``max_len - 1``) or onto an unallocated page are dropped, as JAX's
scatter drops them with ``mode="drop"``.

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
from ..incubate.nn.functional import (_decode_attention,
                                      _window_decode_attention)
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
from .decoding import generate_loop, sample_token

__all__ = ["GPTConfig", "gpt3_1p3b", "gpt_tiny", "init_params",
           "params_from_numpy", "param_count", "embed",
           "logits_from_hidden", "forward_layers", "forward", "loss_fn",
           "init_decode_cache", "prefill", "prefill_into_slots",
           "decode_step", "decode_step_multi", "decode_step_paged",
           "prefill_paged_batched", "prefill_paged",
           "quantize_decode_params", "decode_step_fused",
           "flatten_decode_cache", "verify_into_slots", "verify_paged",
           "verify_fused", "generate"]


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
    """The block of the decode and verify paths over h [B, H] (one token
    a slot) or [B, W, H] (a verify window): this step's K/V go through
    ``write_kv(ck, cv, k, v)`` (the write strategy: per-slot row, the
    slot's page, or the window's rows), then ``attend(q, ck, cv)`` gives
    the attention output [..., nH, hD] — the flash kernel or the plain
    composition over the cache or its page view.  The two are the only
    variation points, so every decode and verify path runs one
    implementation."""
    lead = h.shape[:-1]
    nH, hD, H = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_epsilon)
    qkv = _wmm(x, _qkv_weight(lp, H)).view(*lead, 3, H) + lp["qkv_b"]
    q = qkv[..., 0, :].view(*lead, nH, hD)
    k = qkv[..., 1, :].view(*lead, nH, hD)
    v = qkv[..., 2, :].view(*lead, nH, hD)
    write_kv(ck, cv, k, v)
    attn = attend(q, ck, cv)
    hh = h + _wmm(attn.reshape(*lead, H), lp["proj_w"]) + lp["proj_b"]
    x = _layer_norm(hh, lp["ln2_g"], lp["ln2_b"], cfg.layer_norm_epsilon)
    x = F.gelu(_wmm(x, lp["fc1_w"]) + lp["fc1_b"], approximate="tanh")
    return hh + _wmm(x, lp["fc2_w"]) + lp["fc2_b"]


def _kv_writer(write):
    """``write_kv(ck, cv, k, v)`` of :func:`_decode_layer_step` from one
    row writer ``write(arr, rows)``."""
    def write_kv(ck, cv, k, v):
        _kv_write(ck, k, write)
        _kv_write(cv, v, write)
    return write_kv


def decode_step(params, cache, token, pos: int, cfg: GPTConfig):
    """One token at ONE position: token [B], pos an int -> (logits [B, V]
    float32, cache updated in place).  Every row's K/V lands at
    ``cache[l, :, pos]``; attention is the plain composition over rows
    <= pos, as in JAX."""
    B = token.shape[0]
    h = _embed_rows(params["wte"], token, params["wpe"].dtype) \
        + params["wpe"][pos]                                     # [B, H]
    lens = torch.full((B,), pos + 1, dtype=torch.int32, device=token.device)

    def write(arr, rows):
        byte_view(arr)[:, pos] = byte_view(rows)

    def attend(q, ck, cv):
        return _decode_attention(q, ck, cv, lens)

    write_kv = _kv_writer(write)
    for l, lp in enumerate(layer_slices(params["layers"])):
        ck, cv = _kv_layer(cache, l)
        h = _decode_layer_step(h, lp, ck, cv, cfg, write_kv, attend)
    logits = logits_from_hidden(params, h[:, None], cfg)[:, 0]
    return logits, cache


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

    write_kv = _kv_writer(write)
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


def _dropping_writer(cells, valid):
    """``write(arr, rows)`` for N row writes, each dropped unless valid,
    as the JAX scatter drops them with ``mode="drop"``: ``cells`` a
    tuple of [N] index tensors naming each write's place in ``arr``
    (slot and row, or page and offset), ``valid`` [N] bool, ``rows``
    with N leading rows (flattened).  An in-place index_put cannot drop,
    so an invalid write repeats the first valid one — the same place
    with the same bytes, whatever order the duplicates land in; with no
    valid write at all every write puts the first place (index 0 on each
    axis) back with its own content."""
    N = valid.shape[0]
    first = torch.argmax(valid.to(torch.int32))   # 0 when none is valid
    src = torch.where(valid, torch.arange(N, device=valid.device), first)
    any_valid = valid.any()
    at = tuple(torch.where(any_valid, c[src], torch.zeros_like(c))
               for c in cells)

    def write(arr, rows):
        raw = byte_view(arr)
        rows = byte_view(rows).reshape(
            (N,) + tuple(raw.shape[len(cells):])).index_select(0, src)
        raw[at] = torch.where(any_valid, rows, raw[at])

    return write


def _paged_cells(block_tables, rows, block_size, num_blocks):
    """Where rows [B, W] of each slot land in a paged pool: (page,
    offset) flattened to [B * W], and which of them are valid — a write
    on a -1 page, past the table or past the pool is dropped."""
    mb = block_tables.shape[1]
    blk = (rows // block_size).clamp(max=mb - 1)
    page = block_tables.long().gather(1, blk)
    valid = (page >= 0) & (page < num_blocks) & (rows < mb * block_size)
    return ((page.reshape(-1), (rows % block_size).reshape(-1)),
            valid.reshape(-1))


def _paged_plain_view(block_tables, num_blocks):
    """The plain composition's history of each slot: its pages gathered
    (ids clamped into the pool, as the JAX gather clamps) into
    [B, mb * bs, ...]."""
    B = block_tables.shape[0]
    safe = block_tables.clamp(0, num_blocks - 1).long()

    def view(a):
        return byte_view(a)[safe].view(a.dtype).reshape(
            (B, -1) + tuple(a.shape[2:]))

    return view


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
    nb, bs = pools["k"].shape[1], pools["k"].shape[2]
    h = _embed_rows(params["wte"], token, params["wpe"].dtype) \
        + params["wpe"][pos]                                     # [B, H]
    write_kv = _kv_writer(_dropping_writer(
        *_paged_cells(block_tables, pos.long()[:, None], bs, nb)))
    if attn_kernel == "flash":
        def attend(q, ck, cv):
            return flash_decode_paged(q[:, None], ck, cv, block_tables,
                                      pos)[:, 0]
    else:
        view = _paged_plain_view(block_tables, nb)

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


# ---------------------------------------------------------------------------
# Speculative verify (serving path) and greedy generation
# ---------------------------------------------------------------------------
# One teacher-forced pass over a k+1-token WINDOW a slot — the token to
# feed, then the k draft tokens — gives the target's logits at every
# window position, each position's K/V written into the serving cache
# exactly as decode_step_multi would write it.  Rolling back a rejected
# suffix needs no device work: no query attends rows past its own
# position, and the next fed token overwrites its row.

def _window_rows(params, toks, pos, cfg: GPTConfig):
    """The window's cache rows pos[:, None] + j [B, W] (int64) and its
    input h [B, W, H]; positional rows clamp at the table's end, as the
    JAX gather clamps (an inactive slot's window runs past it)."""
    W = toks.shape[1]
    rows = pos.long()[:, None] + torch.arange(W, device=toks.device)
    prows = rows.clamp(max=cfg.max_position_embeddings - 1)
    h = _embed_rows(params["wte"], toks, params["wpe"].dtype) \
        + params["wpe"][prows]
    return rows, h


def verify_into_slots(params, cache, toks, pos, cfg: GPTConfig,
                      attn_kernel: Optional[str] = None):
    """Speculative verify against the contiguous cache: toks [B, W]
    (the token to feed, then the k draft tokens), pos [B] int32 the
    first position fed a slot.  Returns (logits [B, W, V] float32, cache
    updated in place).  Row pos + j of slot b takes window token j's
    K/V; rows past the cache are dropped (an inactive slot fed at
    ``max_len - 1``).  Query j attends rows <= pos + j, through the
    ``flash_decode`` kernel (``attn_kernel="flash"``, the instance W = 1
    runs while nH * W <= 16) or the plain window composition, so W = 1
    is :func:`decode_step_multi` bit for bit on the CPU."""
    _check_attn_kernel(attn_kernel)
    B, W = toks.shape
    T = cache["k"].shape[2]
    rows, h = _window_rows(params, toks, pos, cfg)
    slot = torch.arange(B, device=toks.device)[:, None].expand(B, W)
    write_kv = _kv_writer(_dropping_writer(
        (slot.reshape(-1), rows.reshape(-1)), (rows < T).reshape(-1)))
    if attn_kernel == "flash":
        def attend(q, ck, cv):
            return flash_decode_attention(q, ck, cv, pos)
    else:
        def attend(q, ck, cv):
            return _window_decode_attention(q, ck, cv, pos)

    for l, lp in enumerate(layer_slices(params["layers"])):
        ck, cv = _kv_layer(cache, l)
        h = _decode_layer_step(h, lp, ck, cv, cfg, write_kv, attend)
    return logits_from_hidden(params, h, cfg), cache


def verify_paged(params, pools, block_tables, toks, pos, cfg: GPTConfig,
                 attn_kernel: Optional[str] = None):
    """Speculative verify against the PAGED pools (layout of
    :func:`decode_step_paged`): toks [B, W], pos [B] int32.  The
    window's K/V land in each slot's pages; a row on a -1 page, past the
    table or past the pool is dropped.  ``attn_kernel="flash"`` attends
    straight off the pool through ``flash_decode_paged``; otherwise the
    slot's gathered pages through the plain window composition.
    Returns (logits [B, W, V] float32, pools updated in place)."""
    _check_attn_kernel(attn_kernel)
    nb, bs = pools["k"].shape[1], pools["k"].shape[2]
    rows, h = _window_rows(params, toks, pos, cfg)
    write_kv = _kv_writer(_dropping_writer(
        *_paged_cells(block_tables, rows, bs, nb)))
    if attn_kernel == "flash":
        def attend(q, ck, cv):
            return flash_decode_paged(q, ck, cv, block_tables, pos)
    else:
        view = _paged_plain_view(block_tables, nb)

        def attend(q, ck, cv):
            return _window_decode_attention(q, kv_map(view, ck),
                                            kv_map(view, cv), pos)

    for l, lp in enumerate(layer_slices(params["layers"])):
        ck, cv = _kv_layer(pools, l)
        h = _decode_layer_step(h, lp, ck, cv, cfg, write_kv, attend)
    return logits_from_hidden(params, h, cfg), pools


def verify_fused(qparams, cache, toks, pos, cfg: GPTConfig):
    """Speculative verify for the fused b1 engine: the window [1, W] as W
    successive :func:`decode_step_fused` calls at pos[0] + j (pos a
    device tensor [1]: no host sync), each one launch of the fused
    layer stack.  The fused kernel rounds differently from the per-op
    stack, so a window through :func:`verify_into_slots` could disagree
    with the fused decode on near-ties; running the decode step itself
    makes the verify tokens bit-identical to it by construction.  JAX
    scans the step inside one program; here it is W launches, each
    reading every weight.  Returns (logits [1, W, V], cache)."""
    out = []
    for j in range(toks.shape[1]):
        logits, cache = decode_step_fused(qparams, cache, toks[:, j],
                                          pos[0] + j, cfg)
        out.append(logits)
    return torch.stack(out, dim=1), cache


@torch.no_grad()
def generate(params, input_ids, cfg: GPTConfig, max_new_tokens: int = 32,
             max_len: Optional[int] = None, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, seed: int = 0,
             eos_token_id: Optional[int] = None):
    """Greedy generation: the prompt [B, S] (a tensor or an array, moved
    to the weights' device) through :func:`prefill` into a model-dtype
    cache of ``max_len`` rows (default: prompt + new tokens, at most
    ``max_position_embeddings``), then ``max_new_tokens - 1``
    :func:`decode_step` calls.  Returns the new tokens [B,
    max_new_tokens] int32; after ``eos_token_id`` a row repeats it.
    ``temperature > 0`` (seeded sampling) raises NotImplementedError;
    ``seed`` is unused until then."""
    del seed
    dev = params["wpe"].device
    ids = torch.as_tensor(input_ids, device=dev).long()
    B, S = ids.shape
    max_len = max_len or min(cfg.max_position_embeddings,
                             S + max_new_tokens)
    if S + max_new_tokens > cfg.max_position_embeddings:
        raise ValueError("prompt + max_new_tokens exceeds "
                         "max_position_embeddings")
    if max_len < S + max_new_tokens:
        raise ValueError(
            f"max_len={max_len} cannot hold the prompt ({S}) plus "
            f"{max_new_tokens} new tokens")
    cache = init_decode_cache(cfg, B, max_len, device=dev)
    logits, cache, pos = prefill(params, ids, cfg, cache)
    first = sample_token(logits, temperature, top_k, top_p)
    tokens, _ = generate_loop(
        lambda c, t, p: decode_step(params, c, t, p, cfg), cache, first,
        pos, max_new_tokens, temperature, top_k, top_p, eos_token_id)
    return tokens
