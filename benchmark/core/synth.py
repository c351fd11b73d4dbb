"""Inputs and weights made from a run's seed, on the device, in a few large
calls.

Every stream of random numbers is its own generator, seeded from the run's
seed and the stream's name, so that a seed gives the same weights and the
same images whatever else a cell makes.
"""

from __future__ import annotations

import hashlib
import math

import torch


def generator(seed: int, stream: str, device) -> torch.Generator:
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def weights(shapes: dict, seed: int, stream: str, device) -> dict:
    """{key: float32 tensor} for a state dict given as {key: shape}.

    Convolution and linear weights (two or more dimensions) and their
    biases: uniform in +-1/sqrt(fan_in), PyTorch's default for both.
    One-dimensional weights (norms) 1, their biases 0; a BatchNorm's
    running mean 0 and running variance 1. All uniform draws are one
    call."""
    bound = {}
    for key, shape in shapes.items():
        if key.endswith(".weight") and len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            bound[key] = fan_in ** -0.5
            bias = key[:-len("weight")] + "bias"
            if bias in shapes:
                bound[bias] = fan_in ** -0.5
    total = sum(math.prod(shapes[k]) for k in bound)
    draw = torch.rand(total, generator=generator(seed, stream, device),
                      device=device)
    out, off = {}, 0
    for key, shape in shapes.items():
        if key in bound:
            n = math.prod(shape)
            out[key] = (draw[off:off + n].view(shape) * 2 - 1) * bound[key]
            off += n
        elif key.endswith("running_var") or key.endswith(".weight"):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    return out


WAVES, OBJECTS = 5, 6


def clip(seed: int, stream: str, n: int, h: int, w: int, device):
    """n frames (n, h, w, 3) uint8 of one moving scene: a colour field of
    WAVES drifting plane waves a channel, OBJECTS flat-coloured ellipses
    moving across it (wrapping at the edges), and noise of a few levels.
    Frame t is the scene t steps on."""
    g = generator(seed, stream, device)
    p = torch.rand((3, WAVES, 5), generator=g, device=device)
    o = torch.rand((OBJECTS, 8), generator=g, device=device)
    noise = torch.randn((n, h, w, 3), generator=g, device=device)
    yy = torch.linspace(0, 1, h, device=device)[:, None]
    xx = torch.linspace(0, 1, w, device=device)[None, :]
    frames = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for t in range(n):
        img = torch.empty((h, w, 3), device=device)
        for ch in range(3):
            acc = torch.zeros((h, w), device=device)
            for k in range(WAVES):
                fy, fx, ph, sp, amp = p[ch, k]
                acc += (0.3 + amp) * torch.sin(
                    2 * math.pi * ((1 + 3 * fy) * yy + (1 + 3 * fx) * xx)
                    + 2 * math.pi * ph + 0.15 * (sp - 0.5) * t)
            img[..., ch] = 0.5 + 0.12 * acc
        for cy, cx, ry, rx, vy, vx, hue, shade in o:
            y0 = (cy + 0.01 * (vy - 0.5) * t) % 1.0
            x0 = (cx + 0.01 * (vx - 0.5) * t) % 1.0
            inside = (((yy - y0) / (0.05 + 0.2 * ry)) ** 2
                      + ((xx - x0) / (0.05 + 0.2 * rx)) ** 2) <= 1.0
            colour = torch.stack([
                0.5 + 0.45 * torch.cos(2 * math.pi * (hue + d))
                for d in (0.0, 1 / 3, 2 / 3)]) * (0.4 + 0.6 * shade)
            img = torch.where(inside[..., None], colour, img)
        img = img * 255 + 1.5 * noise[t]
        frames[t] = img.round().clamp(0, 255).to(torch.uint8)
    return frames
