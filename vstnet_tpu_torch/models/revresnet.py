"""Reversible residual stylization network, standard path.

Counterpart of vstnet_tpu/models/revresnet.py. One weight set runs both
directions:

  encode:  image (B,H,W,3) --inj_pad--> 32ch --split--> additive-coupling
           blocks (stride-2 blocks space-to-depth both streams) --merge-->
           512ch @ H/4 --channel reduction--> latent (B, H/ls, W/ls, C)
  decode:  the exact algebraic inverse, block by block, in reverse order.

Images and latents are NHWC at the public boundary; streams are NCHW
inside. The modules are laid out so that the reference checkpoint keys
(`stack.{i}.conv.{1,4,7}` and
`channel_reduction.block_list.{i}.conv.{1,4,7}`) load with a plain
`load_state_dict`. The channel-reduction head follows the research
semantics (forward = split, blocks, merge, pixel shuffles; inverse = its
exact algebraic inverse), not the reference package's forward/inverse mixup.

Two entry pairs share one implementation. `encode`/`decode` are the
inference path: they build no autograd graph and round as the fast path's
kernels do (ops/pad_conv.residual_branch_nchw). `forward` (also `net(x)`)
and `inverse` are the training path: differentiable, every conv in the
input's dtype (residual_branch_native), and with cfg.remat each coupling
block recomputed in the backward pass (torch.utils.checkpoint), the
counterpart of the JAX package's _maybe_remat. In float32 both pairs
compute the same values.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.device import resolve_device
from vstnet_tpu_torch.ops import at_least_f32
from vstnet_tpu_torch.ops.coupling import (
    channel_merge,
    channel_split,
    injective_pad,
    injective_unpad,
    pixel_shuffle,
    pixel_unshuffle,
)
from vstnet_tpu_torch.ops.pad_conv import (
    residual_branch_native,
    residual_branch_nchw,
)


class ResidualBlock(nn.Module):
    """The 3-conv bottleneck F of one coupling block; `conv` indices 1, 4
    and 7 hold the convs, as in the reference's nn.Sequential (reflect pad,
    conv, ReLU, reflect pad, conv, ReLU, reflect pad, conv)."""

    def __init__(self, channel: int, stride: int, mult: int = 4,
                 kernel: int = 3, device=None):
        super().__init__()
        device = resolve_device(device)
        self.stride = stride
        in_ch = channel if stride == 1 else channel // 4
        mid = channel // mult

        def conv(ci, co, st):
            return nn.utils.skip_init(nn.Conv2d, ci, co, kernel, stride=st,
                                      device=device)

        self.conv = nn.Sequential(
            nn.ReflectionPad2d(1), conv(in_ch, mid, stride), nn.ReLU(),
            nn.ReflectionPad2d(1), conv(mid, mid, 1), nn.ReLU(),
            nn.ReflectionPad2d(1), conv(mid, channel, 1))

    def convs(self):
        return self.conv[1], self.conv[4], self.conv[7]

    def weights(self):
        """((w1, b1), (w2, b2), (w3, b3)), OIHW."""
        return tuple((c.weight, c.bias) for c in self.convs())


class ChannelReduction(nn.Module):
    def __init__(self, cfg: RevResNetConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.block_list = nn.ModuleList(
            ResidualBlock(cfg.reduction_channels, 1, cfg.mult, cfg.kernel,
                          device=device)
            for _ in range(cfg.reduction_blocks))


def _block_forward(x1, x2, block: ResidualBlock, branch):
    """(x1, x2) -> (x2, F(x2) + x1); stride 2 space-to-depths both streams
    before the add. `branch` computes F from (x, weights, stride)."""
    fx2 = branch(x2, block.weights(), block.stride)
    if block.stride == 2:
        x1, x2 = pixel_unshuffle(x1), pixel_unshuffle(x2)
    return x2, (fx2 + at_least_f32(x1)).to(x1.dtype)


def _block_inverse(y1, y2, block: ResidualBlock, branch):
    x2 = pixel_shuffle(y1) if block.stride == 2 else y1
    x1 = (at_least_f32(y2) - branch(x2, block.weights(), block.stride)).to(
        y2.dtype)
    if block.stride == 2:
        x1 = pixel_shuffle(x1)
    return x1, x2


class RevResNet(nn.Module):
    """Reversible encoder/decoder. Parameters start uninitialized: call
    `init_weights(generator)` or `load_state_dict`. device=None builds on
    the CUDA card (device.resolve_device); pass "cpu" for the CPU."""

    def __init__(self, cfg: RevResNetConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.stack = nn.ModuleList(
            ResidualBlock(ch, st, cfg.mult, cfg.kernel, device=device)
            for ch, st in cfg.block_plan())
        self.channel_reduction = ChannelReduction(cfg, device=device)

    def blocks(self):
        return list(self.stack) + list(self.channel_reduction.block_list)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """U(+-1/sqrt(fan_in)) weights (torch Conv2d's default bound) and
        zero biases, drawn from `generator` on the CPU."""
        for block in self.blocks():
            for conv in block.convs():
                fan_in = conv.weight[0].numel()
                bound = fan_in ** -0.5
                w = torch.rand(conv.weight.shape, generator=generator)
                conv.weight.copy_(w * (2 * bound) - bound)
                conv.bias.zero_()
        return self

    def _step(self, fn, x1, x2, block, branch):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, x1, x2, block, branch, use_reentrant=False)
        return fn(x1, x2, block, branch)

    def _encode(self, x, branch):
        cfg = self.cfg
        ds = cfg.down_scale
        if x.shape[1] % ds or x.shape[2] % ds:
            raise ValueError(
                f"encode: spatial dims {x.shape[1]}x{x.shape[2]} must be "
                f"multiples of {ds}; pad the input first")
        x = injective_pad(x.permute(0, 3, 1, 2), cfg.inj_pad)
        x1, x2 = channel_split(x)
        # channel reduction: merge + split of equal halves is the identity
        for block in self.blocks():
            x1, x2 = self._step(_block_forward, x1, x2, block, branch)
        x = channel_merge(x1, x2)
        for _ in range(cfg.sp_steps):
            x = pixel_shuffle(x)
        return x.permute(0, 2, 3, 1)

    def _decode(self, z, branch):
        cfg = self.cfg
        x = z.permute(0, 3, 1, 2)
        for _ in range(cfg.sp_steps):
            x = pixel_unshuffle(x)
        x1, x2 = channel_split(x)
        for block in reversed(self.blocks()):
            x1, x2 = self._step(_block_inverse, x1, x2, block, branch)
        x = injective_unpad(channel_merge(x1, x2), cfg.inj_pad)
        return x.permute(0, 2, 3, 1)

    @torch.no_grad()
    def encode(self, x):
        """Image (B, H, W, 3) in [0,1] -> latent (B, H/ls, W/ls, 2*hidden).

        H and W must be multiples of cfg.down_scale (= 4). Builds no
        autograd graph."""
        return self._encode(x, residual_branch_nchw)

    @torch.no_grad()
    def decode(self, z):
        """Latent -> image; the exact inverse of `encode`."""
        return self._decode(z, residual_branch_nchw)

    def forward(self, x):
        """Differentiable encode for training, every conv in x's dtype."""
        return self._encode(x, residual_branch_native)

    def inverse(self, z):
        """Differentiable decode for training; the inverse of `forward`."""
        return self._decode(z, residual_branch_native)
