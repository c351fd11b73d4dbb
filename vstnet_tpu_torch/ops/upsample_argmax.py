"""The segmenter's logits upsampled and argmaxed in one pass.

`upsample_argmax` takes SegFormer's float32 logits (B, h, w, C) at the
head's resolution to the int32 class mask (B, H, W) of the image: each
pixel's C logits blended from their 4 half-pixel bilinear taps
(align_corners=False, no antialias: the route only grows), then the index
of the largest, the first on a tie. The kernel is CUDA C++ in
`csrc/upsample_argmax.cu`, built at first use by `ops/_build.py`; it never
stores the (B, H, W, C) float32 upsample. It replaces no TPU kernel: its
plain version, `upsample_argmax_plain`, is what models/segformer.py did
before, `resize_bilinear` then `argmax`, and what it still does on the CPU
and under torch.export.

The kernel computes F.interpolate's values on the card bit for bit (its
weights, and the fused multiply-adds that nvcc makes of its blend), so
the masks are equal; under a torch built to contract the blend otherwise,
a pixel could differ only where its two largest upsampled logits lie
within a float32 ulp.

The kernel takes float32 logits that grow at least twofold on both axes
(the head's logits grow fourfold); anything else on a card raises.
`upsample_argmax.launches` counts the kernel's launches
(ops.launch_counts names it "upsample_argmax").
"""

from __future__ import annotations

import collections

import torch

from vstnet_tpu_torch.ops import _build, count_launch
from vstnet_tpu_torch.ops.resize import resize_bilinear


def upsample_argmax_plain(logits, h: int, w: int):
    """resize_bilinear(logits, h, w).argmax(-1) as int32."""
    return resize_bilinear(logits, h, w).argmax(dim=-1).to(torch.int32)


def upsample_argmax(logits, h: int, w: int):
    """logits (B, h_in, w_in, C) float32 on a CUDA device, h >= 2 h_in
    and w >= 2 w_in -> (B, h, w) int32 mask; on the CPU the plain
    version."""
    if logits.device.type == "cpu":
        return upsample_argmax_plain(logits, h, w)
    if not (logits.is_cuda and logits.dtype == torch.float32
            and logits.dim() == 4 and h >= 2 * logits.shape[1]
            and w >= 2 * logits.shape[2]):
        raise ValueError(
            "upsample_argmax: needs float32 logits (B, h, w, C) on a CUDA "
            f"device that grow at least twofold to ({h}, {w}); got "
            f"{tuple(logits.shape)} {logits.dtype} {logits.device}")
    b, hi, wi, c = logits.shape
    x = logits.contiguous()
    out = torch.empty((b, h, w), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.vst_upsample_argmax(
            x.data_ptr(), out.data_ptr(), b, hi, wi, c, h, w,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "upsample_argmax")
    count_launch(upsample_argmax, "launches", x.device)
    return out


upsample_argmax.launches = 0
upsample_argmax.device_launches = collections.Counter()
