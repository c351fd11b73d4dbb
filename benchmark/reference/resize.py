"""Resizes of NHWC tensors as the configurations state them: bilinear at
half-pixel centres, antialiased (a widened triangle filter) along an axis
that shrinks; nearest taking the input at floor((i + 0.5) * in / out)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x, h: int, w: int):
    if x.shape[1] == h and x.shape[2] == w:
        return x
    shrink = h < x.shape[1] or w < x.shape[2]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1)


def resize_nearest(x, h: int, w: int):
    """x (B, H, W, ...) of any dtype -> (B, h, w, ...)."""
    def idx(n_in, n_out):
        i = torch.arange(n_out, dtype=torch.float64, device=x.device)
        return torch.floor((i + 0.5) * n_in / n_out).long()

    if x.shape[1] != h:
        x = x.index_select(1, idx(x.shape[1], h))
    if x.shape[2] != w:
        x = x.index_select(2, idx(x.shape[2], w))
    return x
