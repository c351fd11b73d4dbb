"""Invertible 1x1 convolution over channels, and its exact inverse.

Counterpart of vstnet_tpu/ops/invconv.py, the reference's InvConv2d: an
orthogonally initialised 1x1 conv with bias whose inverse applies the
matrix inverse. No shipped configuration wires it in, and it has no
kernel: a channels-last einsum is one matmul. Both directions compute in
true float32 (TF32 off for the matmul), as the port's float32 routes do.
"""

from __future__ import annotations

import torch

from vstnet_tpu_torch.device import resolve_device
from vstnet_tpu_torch.models.cwct import true_f32_matmul


def init_invconv(generator: torch.Generator, channel: int, device=None):
    """{"w": the Q of a QR of a standard normal (channel, channel) matrix,
    "b": a standard normal (channel,) bias}, float32, drawn from
    `generator` on the CPU and moved to `device` (the CUDA card when none
    is given; device="cpu" for the CPU)."""
    w = torch.randn(channel, channel, generator=generator)
    q, _ = torch.linalg.qr(w)
    b = torch.randn(channel, generator=generator)
    device = resolve_device(device)
    return {"w": q.to(device), "b": b.to(device)}


def invconv_forward(params, x):
    """x: NHWC (B, H, W, C) -> W x + b over the channel axis (torch's
    (Cout, Cin, 1, 1) conv weight contracts the input channel with W's
    second index)."""
    with true_f32_matmul():
        return torch.einsum("bhwc,oc->bhwo", x, params["w"]) + params["b"]


def invconv_inverse(params, y):
    """The exact algebraic inverse: W^-1 (y - b)."""
    with true_f32_matmul():
        w_inv = torch.linalg.inv(params["w"])
        return torch.einsum("bhwc,oc->bhwo", y - params["b"], w_inv)
