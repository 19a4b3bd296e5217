"""GPT — the flagship decoder-only LM (port of
``paddle_tpu/models/gpt.py``: config, init, forward, the training loss
and the KV-cache entry points of the serving path; dense weights, one
device).

The parameter tree keeps the JAX layout exactly — per-layer weights
stacked on a leading L axis, qkv packed as ``[L, H, 3, H]`` — so
:func:`params_from_numpy` maps the JAX pytree one to one and both
packages compute with the same weights.  Layout: activations
``[B, S, H]``; attention ``[B, S, nH, hD]``; KV cache
``{"k", "v"}: [L, B, max_len, nH, hD]``.

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

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..incubate.nn.functional import _decode_attention
from ..incubate.nn.functional.chunked_ce import (chunked_vocab_nll,
                                                 pick_num_chunks)
from ..incubate.nn.kernels.flash_attention import (default_use_flash,
                                                   flash_attention)
from ..incubate.nn.kernels.flash_decode import flash_decode_attention
from .common import layer_slices, matmul_f32out, scan_layers_with_remat

__all__ = ["GPTConfig", "gpt3_1p3b", "gpt_tiny", "init_params",
           "params_from_numpy", "param_count", "embed",
           "logits_from_hidden", "forward_layers", "forward", "loss_fn",
           "init_decode_cache", "prefill", "prefill_into_slots",
           "decode_step_multi"]


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


def params_from_numpy(tree, device=None,
                      dtype: Optional[torch.dtype] = None):
    """The weights bridge: a parameter tree of numpy arrays (the JAX
    pytree passed through ``np.asarray``) -> the port's tree of tensors
    on ``device`` (CUDA by default), same nesting and shapes.  Floating
    arrays are cast to ``dtype`` when given; bfloat16 numpy arrays
    (``ml_dtypes``) pass through float32, which holds them exactly."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        t = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
             if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return conv(node)

    return walk(tree)


def param_count(params) -> int:
    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        return node.numel()
    return walk(params)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_norm(x, g, b, eps):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _causal_attention(q, k, v, head_dim, use_flash: Optional[bool] = False):
    """[B, S, nH, hD] causal attention.  ``use_flash`` (or ``None`` on a
    CUDA tensor, as ``default_use_flash``) routes to
    :func:`flash_attention`; otherwise the plain softmax composition in
    float32 (the JAX XLA branch)."""
    if use_flash is None:
        use_flash = default_use_flash(q.device)
    if use_flash:
        return flash_attention(q, k, v, causal=True)
    S = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(head_dim))
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check_attn_kernel(attn_kernel: Optional[str]) -> Optional[str]:
    """Validate the serving attention-kernel knob.  None/"xla" is the
    plain composition; "flash" routes decode and prefill attention
    through the flash_decode kernel."""
    if attn_kernel not in (None, "xla", "flash"):
        raise ValueError(
            f"attn_kernel must be 'xla' or 'flash', got {attn_kernel!r}")
    return attn_kernel


def _decoder_layer(h, lp, cfg: GPTConfig, return_kv: bool = False,
                   attn_kernel: Optional[str] = None):
    """One pre-LN decoder layer (dense branch).  ``lp`` holds this
    layer's params; ``return_kv`` also returns its K/V (prefill)."""
    nH, hD = cfg.num_heads, cfg.head_dim
    x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_epsilon)
    B, S, H = x.shape
    qkv = (x @ lp["qkv_w"].reshape(H, 3 * H)).view(B, S, 3, H) \
        + lp["qkv_b"]
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
    attn = attn.reshape(B, S, H) @ lp["proj_w"]
    h = h + attn + lp["proj_b"]
    x = _layer_norm(h, lp["ln2_g"], lp["ln2_b"], cfg.layer_norm_epsilon)
    x = F.gelu(x @ lp["fc1_w"] + lp["fc1_b"], approximate="tanh")
    out = h + x @ lp["fc2_w"] + lp["fc2_b"]
    return (out, (k, v)) if return_kv else out


def embed(params, input_ids, cfg: GPTConfig):
    S = input_ids.shape[-1]
    pos = torch.arange(S, device=input_ids.device)
    return params["wte"][input_ids] + params["wpe"][pos]


def _tied_logits(x, wte):
    """The weight-tied head on normalised hidden states x [..., H]:
    float32 logits [..., V] from operands in the model dtype."""
    logits = matmul_f32out(x.reshape(-1, x.shape[-1]), wte.t())
    return logits.view(*x.shape[:-1], wte.shape[0])


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
                      device=None):
    """Zeroed {"k", "v"}: [L, batch, max_len, nH, hD] in the model
    dtype (the JAX ``kv_dtype="bf16"`` rule; quantized caches are a
    later slice)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _prefill_layers(params, input_ids, cfg: GPTConfig, cache, slots,
                    attn_kernel: Optional[str]):
    """The stack over prompts [N, S], each layer's K/V written in place
    into rows [0, S) of ``cache[l, slots]``; returns the last hidden
    state [N, S, H]."""
    _check_attn_kernel(attn_kernel)
    S = input_ids.shape[1]
    h = embed(params, input_ids, cfg)
    for l, lp in enumerate(layer_slices(params["layers"])):
        h, (k, v) = _decoder_layer(h, lp, cfg, return_kv=True,
                                   attn_kernel=attn_kernel)
        cache["k"][l][slots, :S] = k
        cache["v"][l][slots, :S] = v
    return h


def prefill(params, input_ids, cfg: GPTConfig, cache,
            attn_kernel: Optional[str] = None):
    """Run the prompt [B, S] through the stack, writing each layer's K/V
    into cache rows [0, S) in place.  Returns (last-position logits
    [B, V], cache, pos=S)."""
    B, S = input_ids.shape
    h = _prefill_layers(params, input_ids, cfg, cache,
                        torch.arange(B, device=input_ids.device),
                        attn_kernel)
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
    _prefill_layers(params, input_ids, cfg, cache, slots, attn_kernel)
    return cache


def _decode_layer_step(h, lp, ck, cv, cfg: GPTConfig, write_at, pos,
                       attn_kernel: Optional[str]):
    """One-token block of the decode path: this token's K/V are written
    in place at ``ck/cv[write_at]`` (write_at = (arange(B), pos) as
    int64, built once per step), then each slot attends its rows <= pos
    (pos [B] int32) through the flash kernel or the plain
    composition."""
    B = h.shape[0]
    nH, hD, H = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_epsilon)
    qkv = (x @ lp["qkv_w"].reshape(H, 3 * H)).view(B, 3, H) + lp["qkv_b"]
    q = qkv[:, 0].view(B, nH, hD)
    k = qkv[:, 1].view(B, nH, hD)
    v = qkv[:, 2].view(B, nH, hD)
    ck[write_at] = k
    cv[write_at] = v
    if attn_kernel == "flash":
        attn = flash_decode_attention(q[:, None], ck, cv, pos)[:, 0]
    else:
        attn = _decode_attention(q, ck, cv, pos + 1)
    hh = h + attn.reshape(B, H) @ lp["proj_w"] + lp["proj_b"]
    x = _layer_norm(hh, lp["ln2_g"], lp["ln2_b"], cfg.layer_norm_epsilon)
    x = F.gelu(x @ lp["fc1_w"] + lp["fc1_b"], approximate="tanh")
    return hh + x @ lp["fc2_w"] + lp["fc2_b"]


def decode_step_multi(params, cache, token, pos, cfg: GPTConfig,
                      attn_kernel: Optional[str] = None):
    """One token per slot at PER-SLOT positions: token [B], pos [B]
    int32 -> (logits [B, V] float32, cache updated in place).
    ``attn_kernel="flash"`` serves the attention from the flash_decode
    kernel (W = 1) instead of the plain composition."""
    _check_attn_kernel(attn_kernel)
    B = token.shape[0]
    h = params["wte"][token] + params["wpe"][pos]                # [B, H]
    write_at = (torch.arange(B, device=token.device), pos.long())
    for l, lp in enumerate(layer_slices(params["layers"])):
        h = _decode_layer_step(h, lp, cache["k"][l], cache["v"][l], cfg,
                               write_at, pos, attn_kernel)
    logits = logits_from_hidden(params, h[:, None], cfg)[:, 0]
    return logits, cache
