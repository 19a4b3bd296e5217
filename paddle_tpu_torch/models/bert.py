"""BERT/ERNIE — bidirectional encoder with MLM + NSP pretraining heads
(port of ``paddle_tpu/models/bert.py``: config, init, the encoder,
the pooler, ``forward``, the masked-LM and next-sentence losses and
``loss_fn``; one device).

The parameter tree keeps the JAX layout exactly — per-layer weights
stacked on a leading L axis, qkv packed as ``[L, H, 3, H]`` with a
``[L, 3, H]`` bias, the MLM decoder tied to ``wte`` with its own
``mlm_bias [V]`` — so :func:`~.common.params_from_numpy` maps the JAX
pytree one to one.  Layout: activations ``[B, S, H]``; attention
``[B, S, nH, hD]``; token-type (segment) embeddings and an optional
padding mask distinguish the encoder from the causal decoders.

The layer is post-LN (the original BERT ordering): ``LN(h + attn +
proj_b)``, then ``LN(h + fc2(gelu(fc1(h))) + fc2_b)``, with tanh GELU
and ``layer_norm_epsilon`` 1e-12.  Attention without a padding mask is
the non-causal ``flash_attention`` (the ``torch.library`` op, so the
``dots_saveable_attn`` remat plan can save its output as JAX's
``checkpoint_name(attn, "attn_out")``): the hand-written kernels on the
card, their plain versions on the CPU.  With a mask, the float32 softmax
composition adds the ``finfo(float32).min`` padding bias, as JAX does
(no kernel there either).  ``cfg.use_flash``: None -> the kernels on
CUDA, the plain composition on the CPU; True -> ``flash_attention`` on
either; False -> the plain composition.

The MLM head keeps JAX's bias fold: ``mlm_bias`` becomes a column of
the tied table against a ones feature, so H + 1 features go through
``chunked_vocab_nll`` (whose no-grad ``fused_ce_fwd`` route refuses
H + 1, as JAX's gate does, so the loss always takes the chunked scan).
The feature axis is then zero-padded to a multiple of
:data:`MLM_FEATURE_ALIGN`: a zero column adds exact zeros to every
logit and its gradient is dropped by the slice that made it, so values
and gradients are those of the unpadded expression, while the
float32-output products of the head get 16-byte-aligned rows.

Differences from the JAX functions, by design:

* The depth ``lax.scan`` is a Python loop over layers
  (``common.scan_layers_with_remat``, every remat plan); the JAX
  config's ``unroll_layers`` (XLA scheduling across layers) has no
  meaning here and is not ported.
* ``mp_axis`` (tensor parallelism, ROADMAP Queue 1 item 10) is not
  ported: passing one raises ``NotImplementedError``.
* :func:`_layer_norm` is ``F.layer_norm``, which computes mean and
  variance in float32 for bfloat16 input; the JAX version computes
  them in the input dtype.  At float32 the two agree to rounding, and
  float32 is the parity bar.
* The MLM logits take float32 output from bfloat16 operands through
  :func:`~.common.matmul_f32out`, as JAX's einsum with
  ``preferred_element_type=float32``.
* The ``BertModel`` Layer wrapper belongs with the ``paddle.*`` surface
  (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..incubate.nn.functional.chunked_ce import (chunked_vocab_nll,
                                                 pick_num_chunks)
from ..incubate.nn.kernels.flash_attention import (default_use_flash,
                                                   flash_attention)
from .common import (matmul_f32out, param_count, params_from_numpy,
                     scan_layers_with_remat)

__all__ = ["BertConfig", "bert_base", "bert_large", "bert_tiny",
           "init_params", "params_from_numpy", "param_count",
           "forward_layers", "encode", "pooled_output", "forward",
           "mlm_masked_loss", "nsp_loss_fn", "loss_fn"]

#: the MLM head's feature axis (H + 1 with the folded bias) is
#: zero-padded to a multiple of this many elements (16 bytes of bf16)
MLM_FEATURE_ALIGN = 8


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32
    # attention without a padding mask: None -> the flash_attention
    # kernels on CUDA, the plain composition on the CPU; True ->
    # flash_attention on either (its plain versions on the CPU); False ->
    # the plain composition
    use_flash: Optional[bool] = None

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_base(**over) -> BertConfig:
    return BertConfig(**over)


# BERT-large: 24 layers, 1024 hidden, 16 heads of 64, FFN 4096.
def bert_large(**over) -> BertConfig:
    cfg = dict(hidden_size=1024, num_layers=24, num_heads=16)
    cfg.update(over)
    return BertConfig(**cfg)


def bert_tiny(**over) -> BertConfig:
    cfg = dict(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
               max_position_embeddings=128)
    cfg.update(over)
    return BertConfig(**cfg)


def _no_mp(mp_axis):
    if mp_axis is not None:
        raise NotImplementedError(
            f"mp_axis={mp_axis!r}: tensor parallelism is not ported (one "
            f"device)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: BertConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Parameter tree in the JAX layout, drawn on ``device`` (CUDA by
    default) from a ``torch.Generator`` seeded with ``seed``.  The draws
    differ from ``jax.random``'s for the same seed; tests that compare
    the packages share weights through :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    H, F_, L = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    std, dt = cfg.initializer_range, cfg.dtype

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
        "wtt": norm((cfg.type_vocab_size, H)),
        "emb_ln_g": ones(H),
        "emb_ln_b": zeros(H),
        "layers": {
            "qkv_w": norm((L, H, 3, H)),
            "qkv_b": zeros(L, 3, H),
            "proj_w": norm((L, H, H), std / math.sqrt(2 * L)),
            "proj_b": zeros(L, H),
            "ln1_g": ones(L, H),
            "ln1_b": zeros(L, H),
            "fc1_w": norm((L, H, F_)),
            "fc1_b": zeros(L, F_),
            "fc2_w": norm((L, F_, H), std / math.sqrt(2 * L)),
            "fc2_b": zeros(L, H),
            "ln2_g": ones(L, H),
            "ln2_b": zeros(L, H),
        },
        # pooler + pretraining heads (reference BertPretrainingHeads)
        "pool_w": norm((H, H)),
        "pool_b": zeros(H),
        "mlm_w": norm((H, H)),
        "mlm_b": zeros(H),
        "mlm_ln_g": ones(H),
        "mlm_ln_b": zeros(H),
        "mlm_bias": zeros(cfg.vocab_size),
        "nsp_w": norm((H, 2)),
        "nsp_b": zeros(2),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _layer_norm(x, g, b, eps):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _encoder_layer(h, lp, cfg: BertConfig, attn_bias=None, mp_axis=None):
    """One post-LN encoder layer (``lp`` holds this layer's params);
    ``attn_bias`` is the float32 [B, 1, 1, S] padding bias or None."""
    _no_mp(mp_axis)
    B, S, H = h.shape
    nH, hD = cfg.num_heads, cfg.head_dim
    qkv = (h @ lp["qkv_w"].reshape(H, 3 * H)).view(B, S, 3, H) + lp["qkv_b"]
    q = qkv[:, :, 0].view(B, S, nH, hD)
    k = qkv[:, :, 1].view(B, S, nH, hD)
    v = qkv[:, :, 2].view(B, S, nH, hD)
    use_flash = cfg.use_flash
    if use_flash is None:
        use_flash = default_use_flash(h.device)
    if attn_bias is None and use_flash:
        # no padding mask: the flash kernels (non-causal) never hold the
        # [B, nH, S, S] float32 scores
        attn = flash_attention(q, k, v, causal=False)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * (1.0 / math.sqrt(hD))
        if attn_bias is not None:
            logits = logits + attn_bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    attn = attn.reshape(B, S, H) @ lp["proj_w"]
    h = _layer_norm(h + attn + lp["proj_b"], lp["ln1_g"], lp["ln1_b"],
                    cfg.layer_norm_epsilon)
    x = F.gelu(h @ lp["fc1_w"] + lp["fc1_b"], approximate="tanh")
    x = x @ lp["fc2_w"]
    return _layer_norm(h + x + lp["fc2_b"], lp["ln2_g"], lp["ln2_b"],
                       cfg.layer_norm_epsilon)


def forward_layers(h, layer_params, cfg: BertConfig, attn_bias=None,
                   remat=False):
    """The stacked encoder layers over h [B, S, H]; ``remat`` is any plan
    of ``scan_layers_with_remat`` (False, True, a named policy,
    ``'partial:K'``)."""
    return scan_layers_with_remat(
        lambda c, lp: _encoder_layer(c, lp, cfg, attn_bias), h,
        layer_params, remat)


def encode(params, input_ids, cfg: BertConfig, token_type_ids=None,
           attention_mask=None, mp_axis=None, remat=False):
    """[B, S] ids -> [B, S, H] contextual states.  ``attention_mask``
    [B, S] (> 0 where a token is real) masks padding keys with the
    ``finfo(float32).min`` bias."""
    _no_mp(mp_axis)
    S = input_ids.shape[1]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    pos = torch.arange(S, device=input_ids.device)
    h = (params["wte"][input_ids] + params["wpe"][pos]
         + params["wtt"][token_type_ids])
    h = _layer_norm(h, params["emb_ln_g"], params["emb_ln_b"],
                    cfg.layer_norm_epsilon)
    attn_bias = None
    if attention_mask is not None:
        attn_bias = torch.where(
            attention_mask[:, None, None, :] > 0,
            torch.zeros((), dtype=torch.float32, device=h.device),
            torch.tensor(torch.finfo(torch.float32).min, device=h.device))
    return forward_layers(h, params["layers"], cfg, attn_bias, remat)


def pooled_output(params, h):
    """[CLS] through the tanh pooler (reference BertPooler)."""
    return torch.tanh(h[:, 0] @ params["pool_w"] + params["pool_b"])


def _mlm_transform(params, h, cfg: BertConfig):
    x = F.gelu(h @ params["mlm_w"] + params["mlm_b"], approximate="tanh")
    return _layer_norm(x, params["mlm_ln_g"], params["mlm_ln_b"],
                       cfg.layer_norm_epsilon)


def forward(params, input_ids, cfg: BertConfig, token_type_ids=None,
            attention_mask=None, mp_axis=None, remat=False):
    """-> (mlm_logits [B, S, V] float32, nsp_logits [B, 2])."""
    h = encode(params, input_ids, cfg, token_type_ids, attention_mask,
               mp_axis=mp_axis, remat=remat)
    x = _mlm_transform(params, h, cfg)
    mlm = matmul_f32out(x.reshape(-1, x.shape[-1]), params["wte"].t())
    mlm = mlm.view(*x.shape[:-1], -1) + params["mlm_bias"]
    nsp = pooled_output(params, h) @ params["nsp_w"] + params["nsp_b"]
    return mlm, nsp


# ---------------------------------------------------------------------------
# Pretraining losses
# ---------------------------------------------------------------------------

def _bias_folded(x, params, align: int = MLM_FEATURE_ALIGN):
    """(x | 1 | 0...) [N, Hp] and (wte | mlm_bias | 0...) [V, Hp], Hp the
    multiple of ``align`` at or above H + 1."""
    wte = params["wte"]
    V, H = wte.shape
    pad = -(H + 1) % align
    W = torch.cat([wte, params["mlm_bias"][:, None].to(wte.dtype),
                   wte.new_zeros((V, pad))], dim=1)
    x = torch.cat([x, x.new_ones((x.shape[0], 1)),
                   x.new_zeros((x.shape[0], pad))], dim=1)
    return x, W


def mlm_masked_loss(params, h, mlm_labels, cfg: BertConfig, mp_axis=None,
                    ignore_index: int = -100):
    """Masked-LM loss over encoder states h [B, S, H] through the custom
    backward vocabulary NLL (``chunked_vocab_nll``): the MLM transform
    (GELU + LN), ``mlm_bias`` folded as a feature column against a ones
    feature (zero-padded, see the module note), the masked mean over
    positions with label != ``ignore_index`` (0 when none is kept)."""
    _no_mp(mp_axis)
    x = _mlm_transform(params, h, cfg)
    N = x.shape[0] * x.shape[1]
    x, W = _bias_folded(x.reshape(N, x.shape[-1]), params)
    mask = (mlm_labels != ignore_index).reshape(N)
    safe = torch.where(mask, mlm_labels.reshape(N), 0)
    nll = chunked_vocab_nll(x, W, safe, 0, pick_num_chunks(N, cfg.vocab_size))
    maskf = mask.to(nll.dtype)
    return (nll * maskf).sum() / torch.clamp(maskf.sum(), min=1.0)


def nsp_loss_fn(params, h, nsp_labels):
    """Next-sentence cross entropy over the pooled [CLS] state, float32,
    the mean over sequences."""
    nsp = pooled_output(params, h) @ params["nsp_w"] + params["nsp_b"]
    logp = torch.log_softmax(nsp.float(), dim=-1)
    return -logp.gather(1, nsp_labels.long()[:, None]).mean()


def loss_fn(params, input_ids, mlm_labels, nsp_labels, cfg: BertConfig,
            token_type_ids=None, attention_mask=None, mp_axis=None,
            remat=False, ignore_index: int = -100):
    """Masked-LM + next-sentence loss (reference
    BertPretrainingCriterion): MLM positions with label == ignore_index
    are excluded.  No [tokens, V] log-softmax is saved under autograd
    (see :func:`mlm_masked_loss`)."""
    h = encode(params, input_ids, cfg, token_type_ids, attention_mask,
               mp_axis=mp_axis, remat=remat)
    return (mlm_masked_loss(params, h, mlm_labels, cfg,
                            ignore_index=ignore_index)
            + nsp_loss_fn(params, h, nsp_labels))
