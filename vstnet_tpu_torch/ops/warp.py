"""Optical-flow warping (nearest, border padding) for the temporal loss.

Counterpart of vstnet_tpu/ops/warp.py. The sample position is
pixel_grid - flow, taken through the reference's exact float sequence:
normalise to [-1, 1] by /(S-1), unnormalise as grid_sample does with
align_corners=False (((g + 1) * S - 1) / 2), round half to even, clamp to
the border. A fused p = v * S/(S-1) - 0.5 is the same real number but not
the same float32, and would round the other way at x.5 ties.

generate_fake_flow and its numpy helpers are a copy of the JAX module's
(numpy only), so that one seed gives both packages the same flow.
"""

from __future__ import annotations

import numpy as np
import torch


def flow_warp_nearest(x, flow):
    """x (B, H, W, C); flow (B, H, W, 2) float32, channel 0 the x
    displacement. Differentiable in x (a gather)."""
    b, h, w, _ = x.shape
    xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    vx = xx - flow[..., 0]
    vy = yy - flow[..., 1]
    gx = 2.0 * vx / max(w - 1, 1) - 1.0
    gy = 2.0 * vy / max(h - 1, 1) - 1.0
    px = ((gx + 1.0) * w - 1.0) * 0.5
    py = ((gy + 1.0) * h - 1.0) * 0.5
    ix = torch.round(px).long().clamp(0, w - 1)
    iy = torch.round(py).long().clamp(0, h - 1)
    bidx = torch.arange(b, device=x.device)[:, None, None]
    return x[bidx, iy, ix]


def generate_fake_flow(rng, h: int, w: int, motion_level: float = 8.0,
                       shift_level: float = 10.0):
    """Smooth random flow field (h, w, 2) float32 from a numpy Generator:
    coarse normal noise upsampled, a global integer shift, a heavy box
    blur."""
    coarse = rng.normal(0.0, motion_level, size=(max(h // 100, 1),
                                                 max(w // 100, 1), 2))
    flow = _resize_bilinear_np(coarse, h, w)
    flow[:, :, 0] += rng.integers(-int(shift_level), int(shift_level) + 1)
    flow[:, :, 1] += rng.integers(-int(shift_level), int(shift_level) + 1)
    flow = _box_blur_np(flow, min(100, h, w))
    return flow.astype(np.float32)


def _resize_bilinear_np(a, h, w):
    sh, sw = a.shape[:2]
    ys = (np.arange(h) + 0.5) * sh / h - 0.5
    xs = (np.arange(w) + 0.5) * sw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, sh - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, sw - 1)
    y1 = np.clip(y0 + 1, 0, sh - 1)
    x1 = np.clip(x0 + 1, 0, sw - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a00 = a[y0][:, x0]
    a01 = a[y0][:, x1]
    a10 = a[y1][:, x0]
    a11 = a[y1][:, x1]
    return (a00 * (1 - fy) * (1 - fx) + a01 * (1 - fy) * fx
            + a10 * fy * (1 - fx) + a11 * fy * fx)


def _box_blur_np(a, k: int):
    if k <= 1:
        return a
    pad = k // 2
    out = np.empty_like(a)
    for c in range(a.shape[2]):
        p = np.pad(a[:, :, c], pad, mode="edge")
        cs = np.cumsum(np.cumsum(p, axis=0), axis=1)
        cs = np.pad(cs, ((1, 0), (1, 0)))
        h, w = a.shape[:2]
        out[:, :, c] = (
            cs[k:k + h, k:k + w] - cs[0:h, k:k + w]
            - cs[k:k + h, 0:w] + cs[0:h, 0:w]
        ) / (k * k)
    return out
