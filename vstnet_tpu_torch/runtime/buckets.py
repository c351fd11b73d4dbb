"""Shape buckets: a bounded set of shapes under arbitrary input sizes.

Counterpart of vstnet_tpu/runtime/buckets.py. Inputs are replicate-padded
up to the next bucket (the pipeline's own /4 padding is replicate too) and
outputs cropped back. The JAX package needs buckets to bound its compile
count; on the card they give the service's batches one shape, so requests
of nearby sizes coalesce into one batch and one set of kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F


def bucket_hw(h: int, w: int, grid: int = 64,
              max_hw: Tuple[int, int] = (2048, 2048)) -> Tuple[int, int]:
    """(H, W) rounded up to multiples of grid, capped at max_hw."""
    bh = min(-(-h // grid) * grid, max_hw[0])
    bw = min(-(-w // grid) * grid, max_hw[1])
    return bh, bw


def pad_to_bucket(x, grid: int = 64):
    """NHWC tensor -> (padded NHWC, (orig_h, orig_w)), replicate-padded on
    the bottom and right edges."""
    h, w = x.shape[1], x.shape[2]
    bh, bw = bucket_hw(h, w, grid)
    if (bh, bw) == (h, w):
        return x, (h, w)
    y = F.pad(x.permute(0, 3, 1, 2), (0, bw - w, 0, bh - h), mode="replicate")
    return y.permute(0, 2, 3, 1), (h, w)


def crop_from_bucket(y, hw: Tuple[int, int]):
    h, w = hw
    return y[:, :h, :w]


class BucketedStylizer:
    """model.stylize on bucket-padded content and style, cropped back to
    the content's size."""

    def __init__(self, model, grid: int = 64):
        self.model = model
        self.grid = grid

    def __call__(self, content, style):
        c, hw = pad_to_bucket(content, self.grid)
        s, _ = pad_to_bucket(style, self.grid)
        out = self.model.stylize(c, s)
        return crop_from_bucket(out, hw)
