"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU by name.  There is no silent move to the CPU — without
    a GPU, ``device=None`` or ``"cuda"`` raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
