"""Where the port's entry points build their models.

The rule of the port: the CUDA card unless the caller asks for the CPU.
Every factory and constructor takes `device=None`, which means the current
CUDA device and raises when there is none; the CPU is used only when the
caller passes `device="cpu"` (as the CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA device (RuntimeError without one); anything
    else -> torch.device(device)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "vstnet_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to "
            "build on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
