"""Reflection-padded convolution and the 3-conv residual branch, NCHW.

Counterpart of vstnet_tpu/ops/pad_conv.py (reflect_conv_nchw and
residual_branch_nchw). The reference branch is ReflectionPad2d(1) +
Conv2d(3x3) [+ ReLU], three times. This module is the standard path and
the plain twin of both hand-written kernels (ops/coupling_fused.py), so it
rounds where they round:

  * every conv sums in float32 over inputs that hold working-dtype values;
  * h1 and h2 are rounded to the working dtype after bias + ReLU;
  * conv3's sum is returned in float32 (the caller adds it to x1 in float32
    and rounds once).

On a CUDA device a float32 conv here runs through cuDNN, which uses TF32
unless `torch.backends.cudnn.allow_tf32` is False; callers that want true
float32 clear that flag.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_conv(x, w, b=None, stride: int = 1, relu: bool = False):
    """ReflectionPad(1) + Conv(3x3, VALID, stride) [+ ReLU]; OIHW weights."""
    out = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w, b,
                   stride=stride)
    return F.relu(out) if relu else out


def residual_branch_nchw(x, weights, stride: int = 1):
    """F(x) = conv3(ReLU(conv2(ReLU(conv1(x))))), conv1 at `stride`.

    weights: ((w1, b1), (w2, b2), (w3, b3)), OIHW. Returns float32; h1 and
    h2 are rounded to x.dtype (a no-op for float32)."""
    dt = x.dtype
    (w1, b1), (w2, b2), (w3, b3) = weights
    h = reflect_conv(x.float(), w1.float(), b1.float(), stride, relu=True)
    h = h.to(dt).float()
    h = reflect_conv(h, w2.float(), b2.float(), 1, relu=True).to(dt).float()
    return reflect_conv(h, w3.float(), b3.float(), 1)
