"""Token selection for the serving engine (port of
``paddle_tpu/models/decoding.py``, greedy branch)."""
from __future__ import annotations

import torch

__all__ = ["sample_token_pos"]


def sample_token_pos(logits, seeds, pos, temperature: float = 1.0,
                     top_k: int = 0, top_p: float = 1.0):
    """Per-row token for logits [B, V]: temperature <= 0 (or None) is
    greedy argmax, the first index among equal maxima as in JAX; seeds
    and pos are unused then.  Seeded sampling keys each draw on
    ``fold_in(PRNGKey(seed), pos)``, which needs a threefry port to
    give JAX's streams: it raises until that lands."""
    del seeds, pos, top_k, top_p
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    raise NotImplementedError(
        "seeded sampling (temperature > 0) needs the threefry port: "
        "ROADMAP Queue 1 item 5")
