"""Token selection and the generate loop (port of
``paddle_tpu/models/decoding.py``, greedy branch).

Seeded sampling keys each draw on JAX's threefry generator
(``jax.random.categorical`` on ``fold_in(PRNGKey(seed), pos)`` or a split
key), which needs a threefry port to give JAX's streams: until that
lands (ROADMAP Queue 1 item 3), every function here takes
``temperature > 0`` as an error.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

__all__ = ["sample_token", "sample_token_pos", "sample_window",
           "generate_loop"]


def _greedy(logits, temperature):
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    raise NotImplementedError(
        "seeded sampling (temperature > 0) needs the threefry port: "
        "ROADMAP Queue 1 item 3")


def sample_token(logits, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0):
    """Next tokens [B] int32 from logits [B, V]: temperature <= 0 (or
    None) is greedy argmax, the first index among equal maxima as in
    JAX.  The JAX function also takes a PRNG key for sampling; sampling
    raises here."""
    del top_k, top_p
    return _greedy(logits, temperature)


def sample_token_pos(logits, seeds, pos, temperature: float = 1.0,
                     top_k: int = 0, top_p: float = 1.0):
    """Per-row token for logits [B, V], the serving engines' rule:
    greedy for temperature <= 0 (seeds and pos unused then); seeded
    sampling raises."""
    del seeds, pos, top_k, top_p
    return _greedy(logits, temperature)


def sample_window(logits, seeds, pos, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0):
    """Window tokens [B, W] int32 from the speculative verify's logits
    [B, W, V] (fed at positions pos..pos+W-1), by the
    :func:`sample_token_pos` rule at each position: greedy for
    temperature <= 0; seeded sampling raises."""
    del seeds, pos, top_k, top_p
    return _greedy(logits, temperature)


def generate_loop(decode_step: Callable, cache: Any, first_token, start_pos,
                  max_new_tokens: int, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0,
                  eos_token_id: Optional[int] = None):
    """Run ``decode_step(cache, token, pos) -> (logits, cache)`` and
    return the NEW tokens [B, max_new_tokens], starting with
    ``first_token`` (already chosen from the prefill logits), and the
    cache.  Exactly max_new_tokens - 1 decode steps run, each emitting
    the token it picks.  After ``eos_token_id`` a row keeps emitting it.

    The JAX loop is one ``lax.scan`` over split PRNG keys; this one is a
    Python loop whose positions are host integers (``start_pos`` + i), so
    no step waits for the device."""
    if max_new_tokens <= 1:
        return first_token[:, None], cache
    done = None if eos_token_id is None else first_token == eos_token_id
    token, out = first_token, [first_token]
    for i in range(max_new_tokens - 1):
        logits, cache = decode_step(cache, token, start_pos + i)
        token = sample_token(logits, temperature, top_k, top_p)
        if done is not None:
            token = torch.where(done, torch.full_like(token, eos_token_id),
                                token)
            done = done | (token == eos_token_id)
        out.append(token)
    return torch.stack(out, dim=1), cache
