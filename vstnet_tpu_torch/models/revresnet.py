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

Two entry pairs share one implementation, a walk over a list of row
shards (one shard: the whole image; parallel/halo.py walks an image split
over the rows of several devices). `encode`/`decode` are the
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


def _each(fn, xs):
    return [fn(x) for x in xs]


def _whole_image(branch):
    """`branch` (x, weights, stride) -> F(x) as a branch of the walk: a
    list of one shard, the whole image, and its one weight set."""
    def run(xs, weights, stride):
        return [branch(xs[0], weights[0], stride)]
    return run


def _block_forward(x1, x2, blocks, branch):
    """(x1, x2) -> (x2, F(x2) + x1); stride 2 space-to-depths both streams
    before the add. Streams are lists of row shards, `blocks` the block's
    copy beside each shard; `branch` computes F of every shard from (x2's
    shards, each copy's weights, stride)."""
    stride = blocks[0].stride
    fx2 = branch(x2, [b.weights() for b in blocks], stride)
    if stride == 2:
        x1, x2 = _each(pixel_unshuffle, x1), _each(pixel_unshuffle, x2)
    return x2, [(f + at_least_f32(a)).to(a.dtype) for f, a in zip(fx2, x1)]


def _block_inverse(y1, y2, blocks, branch):
    stride = blocks[0].stride
    x2 = _each(pixel_shuffle, y1) if stride == 2 else y1
    fx2 = branch(x2, [b.weights() for b in blocks], stride)
    x1 = [(at_least_f32(a) - f).to(a.dtype) for f, a in zip(fx2, y2)]
    if stride == 2:
        x1 = _each(pixel_shuffle, x1)
    return x1, x2


_NCHW = _whole_image(residual_branch_nchw)
_NATIVE = _whole_image(residual_branch_native)


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

    def _step(self, fn, x1, x2, blocks, branch):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, x1, x2, blocks, branch, use_reentrant=False)
        return fn(x1, x2, blocks, branch)

    def _copies(self, replicas, n):
        """Each block as a tuple of its copies beside n shards: the
        replicas' blocks, or this net's for every shard."""
        nets = replicas or (self,) * n
        return list(zip(*(net.blocks() for net in nets)))

    def _encode(self, xs, branch, replicas=None):
        """The encode walk over xs, an image batch (B, H, W, 3) as a list
        of row shards in row order (one shard: the whole image). Every
        step but the branch is local to a shard; replicas[k] holds the
        weights beside shard k (default: this net for every shard)."""
        cfg = self.cfg
        ds = cfg.down_scale
        for x in xs:
            if x.shape[1] % ds or x.shape[2] % ds:
                raise ValueError(
                    f"encode: spatial dims {x.shape[1]}x{x.shape[2]} must "
                    f"be multiples of {ds}; pad the input first")
        x = [injective_pad(x.permute(0, 3, 1, 2), cfg.inj_pad) for x in xs]
        x1, x2 = map(list, zip(*_each(channel_split, x)))
        # channel reduction: merge + split of equal halves is the identity
        for blocks in self._copies(replicas, len(xs)):
            x1, x2 = self._step(_block_forward, x1, x2, blocks, branch)
        out = []
        for a, b in zip(x1, x2):
            x = channel_merge(a, b)
            for _ in range(cfg.sp_steps):
                x = pixel_shuffle(x)
            out.append(x.permute(0, 2, 3, 1))
        return out

    def _decode(self, zs, branch, replicas=None):
        """The decode walk over zs, a latent as a list of row shards, as
        in _encode."""
        cfg = self.cfg
        x = []
        for z in zs:
            z = z.permute(0, 3, 1, 2)
            for _ in range(cfg.sp_steps):
                z = pixel_unshuffle(z)
            x.append(z)
        x1, x2 = map(list, zip(*_each(channel_split, x)))
        for blocks in reversed(self._copies(replicas, len(zs))):
            x1, x2 = self._step(_block_inverse, x1, x2, blocks, branch)
        return [injective_unpad(channel_merge(a, b), cfg.inj_pad)
                .permute(0, 2, 3, 1) for a, b in zip(x1, x2)]

    @torch.no_grad()
    def encode(self, x):
        """Image (B, H, W, 3) in [0,1] -> latent (B, H/ls, W/ls, 2*hidden).

        H and W must be multiples of cfg.down_scale (= 4). Builds no
        autograd graph."""
        return self._encode([x], _NCHW)[0]

    @torch.no_grad()
    def decode(self, z):
        """Latent -> image; the exact inverse of `encode`."""
        return self._decode([z], _NCHW)[0]

    def forward(self, x):
        """Differentiable encode for training, every conv in x's dtype."""
        return self._encode([x], _NATIVE)[0]

    def inverse(self, z):
        """Differentiable decode for training; the inverse of `forward`."""
        return self._decode([z], _NATIVE)[0]
