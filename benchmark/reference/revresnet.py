"""Plain RevResNet (CAP-VSTNet's reversible encoder and decoder), float32.

Follows the upstream models/RevResNet.py as the configuration file states
it: an injective zero pad of the RGB input to 2 * channels[0] channels,
split into two streams; additive coupling blocks x -> (x2, F(x2) + x1),
F = reflect-pad 3x3 conv, ReLU, conv, ReLU, conv; a stride-2 block
space-to-depths both streams (channel order [p][q][c]); a channel
reduction of 2 more blocks; sp_steps pixel shuffles to the latent. The
decoder is the exact inverse, block by block. NHWC images at the
boundary, NCHW inside.

Weights are a dict of tensors under the upstream checkpoint's keys
(`weight_shapes`), as `benchmark/core/synth.py` makes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.lowp import Exact


def block_plan(cfg):
    """[(key prefix, channel, stride)] of every coupling block in order."""
    plan = []
    i = 0
    for ch, depth, stride in zip(cfg["nChannels"], cfg["nBlocks"],
                                 cfg["nStrides"]):
        for j in range(depth):
            plan.append((f"stack.{i}", ch, stride if j == 0 else 1))
            i += 1
    red = cfg["hidden_dim"] * 4 ** cfg["sp_steps"]
    for j in range(cfg["reduction_blocks"]):
        plan.append((f"channel_reduction.block_list.{j}", red, 1))
    return plan


def weight_shapes(cfg):
    """{key: shape} of every weight and bias (OIHW convs)."""
    shapes = {}
    for prefix, ch, stride in block_plan(cfg):
        cin = ch if stride == 1 else ch // 4
        mid = ch // cfg["mult"]
        for idx, (ci, co) in zip((1, 4, 7), ((cin, mid), (mid, mid),
                                             (mid, ch))):
            shapes[f"{prefix}.conv.{idx}.weight"] = (co, ci, 3, 3)
            shapes[f"{prefix}.conv.{idx}.bias"] = (co,)
    return shapes


def unshuffle(x):
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel (p * 2 + q) * C + c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def shuffle(x):
    """The inverse of unshuffle."""
    b, c, h, w = x.shape
    x = x.reshape(b, 2, 2, c // 4, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // 4, 2 * h, 2 * w)


def _conv(x, w, b, stride, lp):
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.conv2d(lp(x), lp(w), b, stride=stride)


def branch(x, weights, prefix, stride, lp):
    """F(x) of the block under `prefix`."""
    def wb(i):
        return (weights[f"{prefix}.conv.{i}.weight"].float(),
                weights[f"{prefix}.conv.{i}.bias"].float())

    h = F.relu(_conv(x, *wb(1), stride, lp))
    h = F.relu(_conv(h, *wb(4), 1, lp))
    return _conv(h, *wb(7), 1, lp)


@torch.no_grad()
def encode(weights, cfg, x, lp=Exact()):
    """Image (B, H, W, 3) in [0, 1] -> latent (B, H/ls, W/ls, 2 hidden)."""
    x = x.float().permute(0, 3, 1, 2)
    pad = 2 * cfg["nChannels"][0] - x.shape[1]
    x = lp.store(F.pad(x, (0, 0, 0, 0, 0, pad)))
    half = x.shape[1] // 2
    x1, x2 = x[:, :half], x[:, half:]
    for prefix, _, stride in block_plan(cfg):
        fx2 = branch(x2, weights, prefix, stride, lp)
        if stride == 2:
            x1, x2 = unshuffle(x1), unshuffle(x2)
        x1, x2 = x2, lp.store(fx2 + x1)
    x = torch.cat([x1, x2], dim=1)
    for _ in range(cfg["sp_steps"]):
        x = shuffle(x)
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def decode(weights, cfg, z, lp=Exact()):
    """Latent -> image (B, H, W, 3): the exact inverse of encode."""
    x = lp.store(z.float().permute(0, 3, 1, 2))
    for _ in range(cfg["sp_steps"]):
        x = unshuffle(x)
    half = x.shape[1] // 2
    y1, y2 = x[:, :half], x[:, half:]
    for prefix, _, stride in reversed(block_plan(cfg)):
        x2 = shuffle(y1) if stride == 2 else y1
        x1 = lp.store(y2 - branch(x2, weights, prefix, stride, lp))
        if stride == 2:
            x1 = shuffle(x1)
        y1, y2 = x1, x2
    x = torch.cat([y1, y2], dim=1)[:, :3]
    return x.permute(0, 2, 3, 1)
