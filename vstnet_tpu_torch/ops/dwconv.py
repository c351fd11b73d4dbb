"""Fused 3x3 depthwise conv + bias + exact GELU of the SegFormer MixFFN (K5).

Counterpart of vstnet_tpu/ops/dwconv.py (dwconv3x3_bias_gelu). The kernel
is CUDA C++ for Hopper in `csrc/dwconv.cu`, built at first use by
`ops/_build.py`; beside it is its plain PyTorch version with the same
rounding point: taps and bias in float32, one rounding to the input's
dtype after the GELU.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
launches the kernel or raises. `dwconv3x3_bias_gelu.launches` counts the
kernel launches.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from vstnet_tpu_torch.ops import _build, count_launch


def _taps(w, c: int):
    """(3, 3, C) or HWIO (3, 3, 1, C) -> contiguous float32 (3, 3, C)."""
    if w.dim() == 4:
        w = w.reshape(3, 3, c)
    if tuple(w.shape) != (3, 3, c):
        raise ValueError(f"dwconv3x3_bias_gelu: taps {tuple(w.shape)}, "
                         f"want (3, 3, {c})")
    return w.float().contiguous()


def dwconv3x3_bias_gelu_plain(x, w, b):
    """gelu(dwconv3x3_same(x) + b) for NHWC x, computed in float32 and
    rounded once to x.dtype. w: (3, 3, C) taps, b: (C,)."""
    c = x.shape[-1]
    wt = _taps(w, c).permute(2, 0, 1)[:, None]          # (C, 1, 3, 3)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wt, b.float(), padding=1,
                 groups=c)
    return F.gelu(y).permute(0, 2, 3, 1).to(x.dtype).contiguous()


def dwconv3x3_bias_gelu(x, w, b):
    """x (B, H, W, C) NHWC -> gelu(dwconv3x3_same(x) + b), one fused pass.

    w: (3, 3, C) depthwise taps (HWIO (3, 3, 1, C) also taken), b: (C,);
    both are used at float32 precision. On a CUDA device x must be a
    contiguous bf16 tensor with C a multiple of 8, 16-byte aligned (the
    kernel stages it by TMA)."""
    if x.device.type == "cpu":
        return dwconv3x3_bias_gelu_plain(x, w, b)
    if (not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4
            or not x.is_contiguous() or x.shape[-1] % 8
            or x.data_ptr() % 16):
        raise ValueError(
            "dwconv3x3_bias_gelu: needs a contiguous, 16-byte aligned bf16 "
            f"NHWC tensor on a CUDA device with C % 8 == 0; got "
            f"{tuple(x.shape)} {x.dtype} {x.device} "
            f"contiguous={x.is_contiguous()}")
    bsz, h, wd, c = x.shape
    wt = _taps(w, c)
    bias = b.float().contiguous()
    if wt.device != x.device or bias.device != x.device or bias.numel() != c:
        raise ValueError("dwconv3x3_bias_gelu: taps and a (C,) bias must lie "
                         f"on {x.device}")
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vst_dwconv_gelu(x.data_ptr(), wt.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(), bsz, h,
                                  wd, c, stream)
    _build.check(err, "dwconv3x3_bias_gelu")
    count_launch(dwconv3x3_bias_gelu, "launches", x.device)
    return out


dwconv3x3_bias_gelu.launches = 0
dwconv3x3_bias_gelu.device_launches = collections.Counter()
