"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s layout file for file, so every
module names its counterpart: ``paddle_tpu_torch/models/gpt.py`` ports
``paddle_tpu/models/gpt.py``.  It imports ``torch`` only — never
``jax`` and nothing of ``paddle_tpu``.

Every TPU (Pallas) kernel on a ported path is a kernel written by hand
for Hopper under ``incubate/nn/kernels/``.  Each kernel wrapper keeps a
plain PyTorch version of the same function, which it runs only for
tensors on the CPU; a CUDA tensor launches the kernel or raises.

Entry points (``models.gpt.init_params``, the serving engine) run on
the card by default and raise when no GPU is present: the CPU is used
only when the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
