"""LLaMA — decoder LM with RMSNorm, rotary embeddings, SwiGLU and
grouped-query attention (port of ``paddle_tpu/models/llama.py``: config,
init, forward, ``loss_fn`` with its sequence-parallel form, and the
KV-cache entry points of the serving path, with ``generate``).

The parameter tree keeps the JAX layout — per-layer weights stacked on a
leading L axis, q/k/v/o and gate/up/down as separate ``[L, in, out]``
matrices, an untied ``lm_head [H, V]`` unless ``tie_word_embeddings`` —
so :func:`~.common.params_from_numpy` maps the JAX pytree one to one.
Layout: activations ``[B, S, H]``; attention ``[B, S, nH, hD]``, K/V at
``nKV`` heads (GQA); KV cache ``{"k", "v"}: [L, B, max_len, nKV, hD]``
in the storage dtype of ``kv_dtype`` (int8 adds ``{"ks", "vs"}`` scale
planes with a trailing axis of 1), quantized on write (``common._kv_write``).

Kernels: every RMSNorm is the ``"llama"`` policy of the ``rms_norm``
CUDA kernels (``incubate/nn/kernels/fused_norm_rope.py``), which keep
the two bfloat16 roundings of the JAX ``_rms_norm``, forward and
backward.  The layer stack carries the residual stream as a pair
``(h, delta)`` whose add is still pending: each norm that reads a
residual sum (every norm but layer 0's attention norm) is
``add_rms_norm``, which writes ``h + delta`` and its norm in one launch;
the sum is the one JAX's ``h = h + ...`` rounds, so the values are the
same as an add followed by the norm.  Training attention in
:func:`forward`, :func:`loss_fn` and :func:`prefill` is
``flash_attention``, and under ``sp_group`` ``ring_attention`` over
``flash_attention_with_lse``; the
``attn_kernel="flash"`` knob of :func:`prefill_into_slots` and
:func:`decode_step_multi` routes their attention through
``flash_decode``, whose kernel groups the GQA heads itself.
``cfg.use_flash`` chooses for both kernel families: None -> the kernels
on CUDA, the plain compositions on the CPU; True -> the kernel wrappers
(their plain versions on the CPU); False -> the plain compositions
(``rms_norm_plain``, ``add_rms_norm_plain``, the masked softmax) on any
device.

Differences from the JAX functions, by design:

* The depth ``lax.scan`` is a Python loop over layers, and the cache is
  updated IN PLACE; the cache-writing entry points return the dict they
  were given.
* Sequence parallelism takes a ``torch.distributed`` group,
  ``sp_group``, where JAX takes the mesh axis ``sp_axis``: each rank
  holds its chunk of the sequence, rope reads positions ``rank * S``
  on, attention is ``ring_attention``, and :func:`loss_fn` averages the
  loss over the group with an all-reduce whose backward is an
  all-reduce too (``lax.pmean``'s transpose).  As in JAX, each rank's
  gradients of the replicated weights are partials whose mean over the
  group is the dense gradient.  The ring runs the flash kernels on the
  card whatever ``cfg.use_flash`` says (JAX's ring always runs Pallas).
* ``mp_axis`` (tensor parallelism) and ``unroll_layers`` are not
  ported; ``generate`` is greedy only.
* The LM head takes float32 output from bfloat16 operands through
  :func:`~.common.matmul_f32out`, as JAX's ``preferred_element_type``.
* ``F.silu`` in bfloat16 rounds differently from ``jax.nn.silu`` on the
  CPU; float32 is the parity bar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed.collective import all_reduce_sum
from ..incubate.nn.functional import _decode_attention
from ..incubate.nn.functional.chunked_ce import (chunked_vocab_nll,
                                                 pick_num_chunks)
from ..incubate.nn.kernels.flash_decode import flash_decode_attention
from ..incubate.nn.kernels.fused_norm_rope import (add_rms_norm,
                                                   add_rms_norm_plain,
                                                   rms_norm, rms_norm_plain)
from ..incubate.nn.kernels.ring_attention import ring_attention
from ..incubate.nn.kv_quant import byte_view
from .common import (_causal_attention, _check_attn_kernel, _kv_layer,
                     _kv_write, _slot_rows_writer, _zero_cache, layer_slices,
                     matmul_f32out, param_count, params_from_numpy,
                     scan_layers_with_remat)
from . import prng
from .decoding import generate_loop, sample_token

__all__ = ["LlamaConfig", "llama_7b", "llama_tiny", "init_params",
           "params_from_numpy", "param_count", "rope_cos_sin", "apply_rope",
           "forward_layers", "forward", "loss_fn", "init_decode_cache",
           "prefill",
           "decode_step", "decode_step_multi", "prefill_into_slots",
           "generate"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None   # None -> MHA
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.float32
    # the kernels (flash_attention, the rms_norm kernel): None -> on
    # CUDA, plain on the CPU; True -> the wrappers; False -> plain
    use_flash: Optional[bool] = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        if self.intermediate_size:
            return self.intermediate_size
        # LLaMA convention: 2/3 * 4H rounded up to a multiple of 256
        f = int(2 * 4 * self.hidden_size / 3)
        return 256 * ((f + 255) // 256)


# LLaMA-7B: 32 layers, 4096 hidden, 32 heads of 128 (MHA), FFN 11008.
def llama_7b(**over) -> LlamaConfig:
    cfg = dict(vocab_size=32000, hidden_size=4096, num_layers=32,
               num_heads=32, intermediate_size=11008,
               max_position_embeddings=4096)
    cfg.update(over)
    return LlamaConfig(**cfg)


def llama_tiny(**over) -> LlamaConfig:
    cfg = dict(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
               num_kv_heads=2, max_position_embeddings=256)
    cfg.update(over)
    return LlamaConfig(**cfg)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: LlamaConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Parameter tree in the JAX layout, drawn on ``device`` (CUDA by
    default) from a ``torch.Generator`` seeded with ``seed``.  The draws
    differ from ``jax.random``'s for the same seed; tests that compare
    the packages share weights through :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    H, F_, L = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    nH, nKV, hD = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    std, dt = cfg.initializer_range, cfg.dtype

    def norm(shape, scale=std):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    params = {
        "wte": norm((cfg.vocab_size, H)),
        "layers": {
            "attn_norm": ones(L, H),
            "q_w": norm((L, H, nH * hD)),
            "k_w": norm((L, H, nKV * hD)),
            "v_w": norm((L, H, nKV * hD)),
            "o_w": norm((L, nH * hD, H), std / math.sqrt(2 * L)),
            "ffn_norm": ones(L, H),
            "gate_w": norm((L, H, F_)),
            "up_w": norm((L, H, F_)),
            "down_w": norm((L, F_, H), std / math.sqrt(2 * L)),
        },
        "final_norm": ones(H),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm((H, cfg.vocab_size))
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _rms_norm(x, g, cfg: LlamaConfig):
    """RMSNorm over the last axis in the "llama" rounding policy (the JAX
    ``_rms_norm``): the kernel wrapper unless ``cfg.use_flash`` is
    False."""
    fn = rms_norm_plain if cfg.use_flash is False else rms_norm
    out, _ = fn(x.reshape(-1, x.shape[-1]), g, cfg.rms_norm_eps, "llama")
    return out.view(x.shape)


def _residual_norm(carry, g, cfg: LlamaConfig):
    """The residual stream and its RMSNorm from the pair ``carry`` =
    (h, delta) whose add is pending: (h + delta, its norm), the add fused
    into the norm (``add_rms_norm``; ``add_rms_norm_plain`` when
    ``cfg.use_flash`` is False).  A pair without delta is h itself."""
    h, delta = carry
    if delta is None:
        return h, _rms_norm(h, g, cfg)
    fn = add_rms_norm_plain if cfg.use_flash is False else add_rms_norm
    H = h.shape[-1]
    s, out = fn(h.reshape(-1, H), delta.reshape(-1, H), g, cfg.rms_norm_eps,
                "llama")
    return s.view(h.shape), out.view(h.shape)


def rope_cos_sin(S: int, head_dim: int, theta: float, dtype, device=None):
    """Rotary tables [S, hD/2] in ``dtype`` (angles in float32), on
    ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=dev) / head_dim)
    t = torch.arange(S, dtype=torch.float32, device=dev)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def _rotate_pairs(x, c, s):
    """Rotate the (even, odd) pairs of the last axis of x by angles whose
    cos/sin ``c``/``s`` broadcast against x[..., 0::2]; each product and
    the sum round in x's dtype, as the JAX expression does."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                       dim=-1).reshape(x.shape)


def apply_rope(x, cos, sin):
    """x: [B, S, h, hD] — rotate pairs (even, odd) by cos/sin [S, hD/2]
    (NOT the rotate-half convention of ``fused_norm_rope.apply_rope``)."""
    return _rotate_pairs(x, cos[None, :, None, :], sin[None, :, None, :])


def _attention(q, k, v, cfg: LlamaConfig, sp_group=None):
    """Causal attention [B, S, nH, hD]: the KV heads repeated for GQA,
    then ``ring_attention`` over ``sp_group``, else ``flash_attention``
    or the plain masked softmax (``common._causal_attention``;
    ``cfg.use_flash`` decides)."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if sp_group is not None:
        return ring_attention(q, k, v, sp_group, causal=True)
    return _causal_attention(q, k, v, cfg.head_dim, use_flash=cfg.use_flash)


def _decoder_layer(carry, lp, cfg: LlamaConfig, cos, sin,
                   return_kv: bool = False,
                   attn_kernel: Optional[str] = None, sp_group=None):
    """Pre-RMSNorm decoder layer over the residual pair ``carry`` = (h,
    delta), h [B, S, H] (see :func:`_residual_norm`); returns the next
    pair, (h after attention, the MLP's output).  ``return_kv`` also
    returns this layer's post-rope K and V at nKV heads (prefill).
    ``attn_kernel="flash"`` runs the causal attention in the flash_decode
    kernel (the window mask at a zero base offset; GQA grouped in the
    kernel); ``sp_group`` the ring over a sequence split."""
    h, x = _residual_norm(carry, lp["attn_norm"], cfg)
    B, S, _ = h.shape
    nH, nKV, hD = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    q = apply_rope((x @ lp["q_w"]).view(B, S, nH, hD), cos, sin)
    k = apply_rope((x @ lp["k_w"]).view(B, S, nKV, hD), cos, sin)
    v = (x @ lp["v_w"]).view(B, S, nKV, hD)
    if attn_kernel == "flash":
        attn = flash_decode_attention(
            q, k, v, torch.zeros((B,), dtype=torch.int32, device=h.device))
    else:
        attn = _attention(q, k, v, cfg, sp_group)
    h, x = _residual_norm((h, attn.reshape(B, S, nH * hD) @ lp["o_w"]),
                          lp["ffn_norm"], cfg)
    out = (h, (F.silu(x @ lp["gate_w"]) * (x @ lp["up_w"])) @ lp["down_w"])
    return (out, (k, v)) if return_kv else out


def _logits(params, carry, cfg: LlamaConfig):
    """Final RMSNorm (of the residual pair ``carry``, the add fused in) +
    LM head -> float32 logits [..., V]."""
    _, h = _residual_norm(carry, params["final_norm"], cfg)
    head = (params["wte"].t() if cfg.tie_word_embeddings
            else params["lm_head"])
    logits = matmul_f32out(h.reshape(-1, h.shape[-1]), head)
    return logits.view(*h.shape[:-1], logits.shape[-1])


def forward_layers(h, layer_params, cfg: LlamaConfig, remat=False,
                   sp_group=None):
    """The stacked decoder layers over h [B, S, H] -> the residual pair
    (h, delta) of the last layer, its add pending (the final norm
    fuses it); ``remat`` is any plan of ``scan_layers_with_remat``
    (False, True, a named policy, ``'partial:K'``).  Without remat the
    pair is the carry.  Under remat each layer's
    checkpoint keeps its input, so the carry is the sum h + delta, one
    tensor a layer as the unfused stack keeps: each layer ends in that
    add, and its attention norm is the norm alone (delta None).  Under
    ``sp_group`` h is this rank's chunk of the sequence: rope positions
    start at rank * S."""
    S = h.shape[1]
    if sp_group is None:
        cos, sin = rope_cos_sin(S, cfg.head_dim, cfg.rope_theta, h.dtype,
                                h.device)
    else:
        pos0 = dist.get_rank(sp_group) * S
        cos, sin = rope_cos_sin(S * dist.get_world_size(sp_group),
                                cfg.head_dim, cfg.rope_theta, h.dtype,
                                h.device)
        cos, sin = cos[pos0:pos0 + S], sin[pos0:pos0 + S]
    def layer(carry, lp):
        return _decoder_layer(carry, lp, cfg, cos, sin, sp_group=sp_group)

    if remat:
        def summed(h, lp):
            s, delta = layer((h, None), lp)
            return s + delta

        return scan_layers_with_remat(summed, h, layer_params, remat), None
    return scan_layers_with_remat(layer, (h, None), layer_params, remat)


def forward(params, input_ids, cfg: LlamaConfig, remat=False,
            sp_group=None):
    """Float32 logits [B, S, V] of input_ids [B, S] (this rank's chunk
    under ``sp_group``)."""
    carry = forward_layers(params["wte"][input_ids], params["layers"], cfg,
                           remat=remat, sp_group=sp_group)
    return _logits(params, carry, cfg)


def _head_loss(params, carry, labels, cfg: LlamaConfig):
    """Final RMSNorm (of the residual pair ``carry`` from
    :func:`forward_layers`) + LM head + cross entropy over [B, S, H], the
    mean over tokens, through ``chunked_vocab_nll`` (no [tokens, V]
    log-softmax saved under autograd)."""
    _, h = _residual_norm(carry, params["final_norm"], cfg)
    W = params["wte"] if cfg.tie_word_embeddings else params["lm_head"].t()
    N = h.shape[0] * h.shape[1]
    nll = chunked_vocab_nll(h.reshape(N, h.shape[-1]), W, labels.reshape(N),
                            0, pick_num_chunks(N, cfg.vocab_size))
    return nll.mean()


def loss_fn(params, input_ids, labels, cfg: LlamaConfig, sp_group=None,
            remat=False):
    """Next-token cross entropy, the mean over tokens (ids/labels
    [B, S]).  Under ``sp_group`` they are this rank's chunk of the
    sequence and the loss is the mean over the group (``lax.pmean``)."""
    carry = forward_layers(params["wte"][input_ids], params["layers"], cfg,
                           remat=remat, sp_group=sp_group)
    loss = _head_loss(params, carry, labels, cfg)
    if sp_group is not None:
        loss = all_reduce_sum(loss, sp_group) / dist.get_world_size(sp_group)
    return loss


# ---------------------------------------------------------------------------
# KV-cache decoding (serving path)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: LlamaConfig, batch: int, max_len: int,
                      kv_dtype: str = "bf16", device=None):
    """Zeroed {"k", "v"}: [L, batch, max_len, nKV, hD] in the storage
    dtype of ``kv_dtype`` ("bf16" = the model dtype, "int8", "fp8");
    int8 adds float32 scale planes {"ks", "vs"}: [..., nKV, 1]."""
    return _zero_cache((cfg.num_layers, batch, max_len, cfg.kv_heads,
                        cfg.head_dim), kv_dtype, cfg.dtype, device)


def _prefill_layers(params, input_ids, cfg: LlamaConfig, cache, write,
                    attn_kernel: Optional[str] = None):
    """The stack over prompts [N, S]: each layer's K/V go through
    ``write(arr, rows)`` into layer l of ``cache``; returns the last
    layer's residual pair (h, delta), each [N, S, H]."""
    h = params["wte"][input_ids]
    cos, sin = rope_cos_sin(input_ids.shape[1], cfg.head_dim, cfg.rope_theta,
                            h.dtype, h.device)
    carry = (h, None)
    for l, lp in enumerate(layer_slices(params["layers"])):
        carry, (k, v) = _decoder_layer(carry, lp, cfg, cos, sin,
                                       return_kv=True,
                                       attn_kernel=attn_kernel)
        ck, cv = _kv_layer(cache, l)
        _kv_write(ck, k, write)
        _kv_write(cv, v, write)
    return carry


def prefill(params, input_ids, cfg: LlamaConfig, cache):
    """Run the prompt [B, S] through the stack, writing each layer's K/V
    into cache rows [0, S) in place.  Returns (last-position logits
    [B, V] float32, cache, pos=S)."""
    B, S = input_ids.shape
    slots = torch.arange(B, device=input_ids.device)
    h, delta = _prefill_layers(params, input_ids, cfg, cache,
                               _slot_rows_writer(slots, S))
    return _logits(params, (h[:, -1], delta[:, -1]), cfg), cache, S


def _decode_layer(carry, lp, ck, cv, cfg: LlamaConfig, c, s, write,
                  attend):
    """One-token block of the decode paths over the residual pair
    ``carry`` (h [B, H], delta; see :func:`_residual_norm`) -> the next
    pair: q/k rotated by cos/sin ``c``/``s`` (broadcast against [B,
    heads, hD/2]), this token's K/V through ``write(arr, rows)``,
    ``attend(q, ck, cv)`` -> [B, nH, hD]."""
    h, x = _residual_norm(carry, lp["attn_norm"], cfg)
    B = h.shape[0]
    nH, nKV, hD = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    q = _rotate_pairs((x @ lp["q_w"]).view(B, nH, hD), c, s)
    k = _rotate_pairs((x @ lp["k_w"]).view(B, nKV, hD), c, s)
    v = (x @ lp["v_w"]).view(B, nKV, hD)
    _kv_write(ck, k, write)
    _kv_write(cv, v, write)
    h, x = _residual_norm((h, attend(q, ck, cv).reshape(B, nH * hD)
                           @ lp["o_w"]), lp["ffn_norm"], cfg)
    return h, (F.silu(x @ lp["gate_w"]) * (x @ lp["up_w"])) @ lp["down_w"]


def _tables(params, cfg: LlamaConfig, rope_tables):
    if rope_tables is not None:
        return rope_tables
    return rope_cos_sin(cfg.max_position_embeddings, cfg.head_dim,
                        cfg.rope_theta, params["wte"].dtype,
                        params["wte"].device)


def decode_step(params, cache, token, pos, cfg: LlamaConfig,
                rope_tables=None):
    """One token per row at ONE position: token [B], pos an int ->
    (logits [B, V] float32, cache updated in place).  Attention is the plain composition over rows <= pos, as in
    JAX.  ``rope_tables`` (cos, sin) [max_position_embeddings, hD/2] are
    built when not given."""
    B = token.shape[0]
    cos_t, sin_t = _tables(params, cfg, rope_tables)
    c, s = cos_t[pos], sin_t[pos]                               # [hD/2]
    lens = torch.full((B,), 1, dtype=torch.int32, device=token.device) + pos

    def write(arr, rows):
        byte_view(arr)[:, pos] = byte_view(rows)

    def attend(q, ck, cv):
        return _decode_attention(q, ck, cv, lens)

    carry = (params["wte"][token], None)                        # [B, H]
    for l, lp in enumerate(layer_slices(params["layers"])):
        ck, cv = _kv_layer(cache, l)
        carry = _decode_layer(carry, lp, ck, cv, cfg, c, s, write, attend)
    return _logits(params, carry, cfg), cache


def decode_step_multi(params, cache, token, pos, cfg: LlamaConfig,
                      rope_tables=None, attn_kernel: Optional[str] = None):
    """One token per slot at PER-SLOT positions: token [B], pos [B]
    int32 -> (logits [B, V] float32, cache updated in place).  Each
    slot's K/V row lands at ``cache[l, b, pos[b]]`` (quantized on write);
    ``attn_kernel="flash"`` serves the attention from the flash_decode
    kernel (GQA grouped in the kernel), otherwise the plain
    composition."""
    _check_attn_kernel(attn_kernel)
    B = token.shape[0]
    cos_t, sin_t = _tables(params, cfg, rope_tables)
    posl = pos.long()
    c, s = cos_t[posl][:, None], sin_t[posl][:, None]          # [B, 1, hD/2]
    write_at = (torch.arange(B, device=token.device), posl)

    def write(arr, rows):
        byte_view(arr)[write_at] = byte_view(rows)

    if attn_kernel == "flash":
        def attend(q, ck, cv):
            return flash_decode_attention(q[:, None], ck, cv, pos)[:, 0]
    else:
        def attend(q, ck, cv):
            return _decode_attention(q, ck, cv, pos + 1)

    carry = (params["wte"][token], None)
    for l, lp in enumerate(layer_slices(params["layers"])):
        ck, cv = _kv_layer(cache, l)
        carry = _decode_layer(carry, lp, ck, cv, cfg, c, s, write, attend)
    return _logits(params, carry, cfg), cache


def prefill_into_slots(params, input_ids, cfg: LlamaConfig, cache, slots,
                       attn_kernel: Optional[str] = None):
    """Batched admission prefill writing each prompt's K/V straight into
    its cache slot: input_ids [N, S] (padded to one bucket), slots [N].
    Returns the cache (the final norm and head do not run: the engine's
    priming step recomputes the last position)."""
    _check_attn_kernel(attn_kernel)
    _prefill_layers(params, input_ids, cfg, cache,
                    _slot_rows_writer(slots.long(), input_ids.shape[1]),
                    attn_kernel)
    return cache


@torch.no_grad()
def generate(params, input_ids, cfg: LlamaConfig, max_new_tokens: int = 32,
             max_len: Optional[int] = None, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, seed: int = 0,
             eos_token_id: Optional[int] = None):
    """Generation (greedy when temperature <= 0): the prompt [B, S] (a
    tensor or an array, moved to the weights' device) through
    :func:`prefill` into a model-dtype cache of ``max_len`` rows
    (default: prompt + new tokens, at most ``max_position_embeddings``),
    then ``max_new_tokens - 1`` :func:`decode_step` calls.  Returns the new tokens [B,
    max_new_tokens] int32; after ``eos_token_id`` a row repeats it.
    ``temperature > 0`` samples as JAX's ``generate``: ``PRNGKey(seed)``
    split into (k0, kr), the first token drawn from the prefill logits
    with k0 and step i with ``split(kr, max_new_tokens - 1)[i]``
    (:func:`~paddle_tpu_torch.models.decoding.generate_loop`)."""
    dev = params["wte"].device
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
    k0 = kr = None
    if temperature is not None and temperature > 0.0:
        k0, kr = prng.split(prng.PRNGKey(seed, dev))
    first = sample_token(logits, k0, temperature, top_k, top_p)
    tables = _tables(params, cfg, None)
    tokens, _ = generate_loop(
        lambda c, t, p: decode_step(params, c, t, p, cfg, tables), cache,
        first, pos, max_new_tokens, kr, temperature, top_k, top_p,
        eos_token_id)
    return tokens
