"""Token selection and the generate loop (port of
``paddle_tpu/models/decoding.py``).

Greedy (``temperature <= 0`` or None) is ``torch.argmax``, the first
index among equal maxima as in JAX, and uses no key.  Sampling
transforms the logits with temperature / top-k / top-p (JAX's
``_filter_logits``) and draws with JAX's threefry stream: one key
for a [B, V] draw (:func:`sample_token`, ``jax.random.categorical``) or
the serving engines' rule, ``fold_in(PRNGKey(seed), pos)`` a row, which
makes a stream a function of (seed, absolute position) and so the same
under any partition of the decode into steps, K-step loops or
speculative verify windows.  Filter and draw are one call of the
sampler (``incubate/nn/kernels/sampling.py`` ``sample_rows`` on the raw
logits: its plain version on the CPU, one CUDA kernel launch on the
card, whose thresholds are exact).

Against JAX: keys, bits and uniforms are JAX's bit for bit; the Gumbel
noise is within an ulp of JAX's (XLA:CPU's ``log`` is not correctly
rounded), and torch's softmax and cumsum may round the top-p mass
unlike XLA's, so a token can differ only where two candidates'
perturbed scores, or the top-p mass and ``top_p``, lie within rounding
of each other.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..incubate.nn.kernels.sampling import filter_logits_plain, sample_rows
from . import prng

__all__ = ["sample_token", "sample_token_pos", "sample_window",
           "generate_loop"]


def _greedy(temperature) -> bool:
    return temperature is None or temperature <= 0.0


# the float filter of JAX's ``_filter_logits``: on the CPU the sampled
# paths run it before the draw; on the card the sampler kernel applies
# its exact rule (``sampling.cut_values_plain``) and the two differ only
# at a top-p near-tie
_filter_logits = filter_logits_plain


def _int32(x, device):
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def sample_token(logits, key, temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0):
    """Next tokens [B] int32 from logits [B, V]: temperature <= 0 (or
    None) is greedy argmax; else one ``key`` (int64 [2], a
    :mod:`~paddle_tpu_torch.models.prng` key) draws the whole filtered
    [B, V] array, as ``jax.random.categorical(key, logits)``."""
    if _greedy(temperature):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.to(torch.float32)
    return sample_rows(x, temperature, top_k, top_p, key=key.to(x.device))


def sample_token_pos(logits, seeds, pos, temperature: float = 1.0,
                     top_k: int = 0, top_p: float = 1.0):
    """Per-row token for logits [B, V], the serving engines' rule:
    greedy for temperature <= 0 (seeds and pos unused then); else row b
    draws with ``fold_in(PRNGKey(seeds[b]), pos[b])``, pos being the
    position the row is fed at."""
    if _greedy(temperature):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.to(torch.float32)
    return sample_rows(x, temperature, top_k, top_p,
                       seeds=_int32(seeds, x.device),
                       pos=_int32(pos, x.device))


def sample_window(logits, seeds, pos, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0):
    """Window tokens [B, W] int32 from the speculative verify's logits
    [B, W, V] (fed at positions pos..pos+W-1), by the
    :func:`sample_token_pos` rule at each position (``pos[b] + w``), so
    the target tokens equal what the decode steps would draw."""
    if _greedy(temperature):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    B, W, V = logits.shape
    x = logits.to(torch.float32).reshape(B * W, V)
    toks = sample_rows(x, temperature, top_k, top_p,
                       seeds=_int32(seeds, x.device),
                       pos=_int32(pos, x.device), window=W)
    return toks.view(B, W)


def generate_loop(decode_step: Callable, cache: Any, first_token, start_pos,
                  max_new_tokens: int, key, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  eos_token_id: Optional[int] = None):
    """Run ``decode_step(cache, token, pos) -> (logits, cache)`` and
    return the NEW tokens [B, max_new_tokens], starting with
    ``first_token`` (already chosen from the prefill logits), and the
    cache.  Exactly max_new_tokens - 1 decode steps run, each emitting
    the token it picks; step i samples with ``split(key, max_new_tokens
    - 1)[i]`` (``key`` unused when greedy).  After ``eos_token_id`` a
    row keeps emitting it.

    The JAX loop is one ``lax.scan`` over the split keys; this one is a
    Python loop whose positions are host integers (``start_pos`` + i),
    so no step waits for the device."""
    if max_new_tokens <= 1:
        return first_token[:, None], cache
    keys = None if _greedy(temperature) else prng.split(key,
                                                         max_new_tokens - 1)
    done = None if eos_token_id is None else first_token == eos_token_id
    token, out = first_token, [first_token]
    for i in range(max_new_tokens - 1):
        logits, cache = decode_step(cache, token, start_pos + i)
        token = sample_token(logits, None if keys is None else keys[i],
                             temperature, top_k, top_p)
        if done is not None:
            token = torch.where(done, torch.full_like(token, eos_token_id),
                                token)
            done = done | (token == eos_token_id)
        out.append(token)
    return torch.stack(out, dim=1), cache
