"""Reversible-coupling primitives on NCHW tensors.

Counterpart of vstnet_tpu/ops/coupling.py (its NCHW twins): channel
split/merge, injective zero-channel padding and the space-to-depth pixel
(un)shuffle. The unshuffled channel index is (p * 2 + q) * C + ci, where
p/q are the row/column sub-pixel offsets — the reference checkpoint's
channel grouping, so converted weights stay bit-faithful.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def channel_split(x: torch.Tensor):
    n = x.shape[1] // 2
    return x[:, :n], x[:, n:]


def channel_merge(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return torch.cat([x1, x2], dim=1)


def injective_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Append `pad` zero channels."""
    if pad == 0:
        return x
    return F.pad(x, (0, 0, 0, 0, 0, pad))


def injective_unpad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Drop the last `pad` channels (inverse of injective_pad)."""
    if pad == 0:
        return x
    return x[:, : x.shape[1] - pad]


def pixel_unshuffle(x: torch.Tensor, size: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, s*s*C, H/s, W/s), [p][q][ci] channel order."""
    b, c, h, w = x.shape
    nh, nw = h // size, w // size
    x = x.reshape(b, c, nh, size, nw, size)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, size * size * c, nh, nw)


def pixel_shuffle(x: torch.Tensor, size: int = 2) -> torch.Tensor:
    """(B, s*s*C, H, W) -> (B, C, H*s, W*s); exact inverse of unshuffle."""
    b, c, h, w = x.shape
    nc = c // (size * size)
    x = x.reshape(b, size, size, nc, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, nc, h * size, w * size)
