"""Shared model-family helpers (port of ``paddle_tpu/models/common.py``).

The JAX package runs the decoder stack as ``lax.scan`` over per-layer
weights stacked on a leading L axis.  PyTorch runs eagerly, so the scan
becomes a Python loop over that axis; the stacked layout stays, so the
weights bridge maps the JAX tree one to one.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

import torch

__all__ = ["layer_slices", "scan_layers"]


def layer_slices(layers: Dict[str, torch.Tensor]
                 ) -> Iterator[Dict[str, Any]]:
    """Per-layer views {name: layers[name][l]} for l in 0..L-1."""
    n = next(iter(layers.values())).shape[0]
    for l in range(n):
        yield {name: w[l] for name, w in layers.items()}


def scan_layers(body: Callable, h: torch.Tensor,
                layers: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``h = body(h, lp)`` over the stacked layers — the eager
    counterpart of ``scan_layers_with_remat`` without remat (this port
    has no training path yet)."""
    for lp in layer_slices(layers):
        h = body(h, lp)
    return h
