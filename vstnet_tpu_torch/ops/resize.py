"""Image resizing on NHWC tensors.

Counterpart of vstnet_tpu/ops/resize.py. The JAX package resizes with
jax.image.resize, which samples at half-pixel centres everywhere. Two of
its habits differ from torch's defaults and are kept here:

  * "linear" antialiases along every axis that shrinks (a triangle filter
    widened by the scale); torch does that only with antialias=True. Where
    an axis grows the two agree without it.
  * "nearest" picks floor((i + 0.5) * in / out), which is torch's
    "nearest-exact", not its "nearest". It is written out as an index
    gather here, so integer label maps resize too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x, h: int, w: int):
    """x (B, H, W, C) -> (B, h, w, C), half-pixel bilinear, antialiased
    where an axis shrinks."""
    if x.shape[1] == h and x.shape[2] == w:
        return x
    shrink = h < x.shape[1] or w < x.shape[2]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1)


def _nearest_index(n_in: int, n_out: int, device):
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).to(torch.long)


def resize_nearest(x, h: int, w: int):
    """x (B, H, W) or (B, H, W, ...) of any dtype -> (B, h, w, ...), each
    output taking the input at floor((i + 0.5) * in / out)."""
    if x.shape[1] != h:
        x = x.index_select(1, _nearest_index(x.shape[1], h, x.device))
    if x.shape[2] != w:
        x = x.index_select(2, _nearest_index(x.shape[2], w, x.device))
    return x


def pad_to_multiple(x, multiple: int = 4):
    """Replicate-pad H and W of an NHWC tensor up to the next multiple, on
    the right and bottom edges."""
    h, w = x.shape[1], x.shape[2]
    bp = (multiple - h % multiple) % multiple
    rp = (multiple - w % multiple) % multiple
    if bp == 0 and rp == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (0, rp, 0, bp), mode="replicate")
    return y.permute(0, 2, 3, 1)
