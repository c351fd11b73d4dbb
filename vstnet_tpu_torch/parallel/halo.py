"""Row (spatial) sharding of the standard RevResNet: a halo exchange for
the reflect-padded 3x3 convs, and the encode and decode walks over row
shards.

Counterpart of what GSPMD does for vstnet_tpu/parallel/sharding.py's
spatial=True programs, where XLA partitions the convs of the standard
path (ops/pad_conv.py) over the "spatial" mesh axis and inserts the halo
exchanges itself. Here they are placed by hand.

An image batch (B, H, W, C) is split into S row shards of L = H / S rows,
shard k holding image rows [k*L, (k+1)*L) on its own device, in order.
Each conv of a block's 3-conv branch builds its own padded input:

  * at a boundary between two shards the neighbour's first or last row is
    taken as a halo (`_neighbour_rows`), copied to the shard's device;
  * at the image's true top and bottom, and on both sides in width, the
    shard reflects, as ReflectionPad2d(1) does on the whole image;
  * a stride-2 conv (conv1 of a transition) reads image rows 2i-1 .. 2i+1
    for output row i, so a shard, which starts at an even row, takes one
    halo row above and none below: its last output row reads its own last
    row, and the image's bottom reflect row is never read.

Then F.conv2d runs with padding 0. The branch rounds as the unsharded one
(ops/pad_conv.residual_branch_nchw): float32 sums, h1 and h2 rounded to
the working dtype, conv3 returned in float32; every output row is
computed from the same window as on the whole image. Everything else of
the walk (channel split and merge, the injective pad, the pixel
(un)shuffles, the coupling add) is local to a shard, because L is a
multiple of cfg.down_scale. All shards pass through a conv, one conv at a
time, before the next starts.

The training walk (forward_rows, inverse_rows) is the same walk with
grad enabled, on the branch of RevResNet.forward (ops/pad_conv.
residual_branch_native: every conv in the shards' dtype). It is one
autograd graph over the row's devices: a halo is a slice copied with
`.to()`, whose backward carries the cotangent back to the shard that owns
the row, and each conv's weights are the master's, cast and copied to the
shard's device inside the graph, so that every shard's part of a weight's
gradient lands in the master's .grad. With cfg.remat each block is
recomputed in the backward over the whole list of shards.

A copy between two cards is ordered by PyTorch against both devices'
current streams; between two replicas on one card it is no copy at all.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from vstnet_tpu_torch.config import RevResNetConfig


def _neighbour_rows(x, rows: slice, device):
    """Rows of neighbour shard x (NCHW) as a halo on `device`."""
    return x[:, :, rows].to(device, non_blocking=True)


def _halo_pad(xs, stride: int):
    """Each shard of xs (NCHW, in row order) padded for a 3x3 VALID conv
    at `stride`: halo rows from its neighbours, reflect at the image's
    top and bottom and on both sides in width."""
    last = len(xs) - 1
    out = []
    for k, x in enumerate(xs):
        parts = [x]
        top = bottom = 0
        if k == 0:
            top = 1
        else:
            parts.insert(0, _neighbour_rows(xs[k - 1], slice(-1, None),
                                            x.device))
        if stride == 1:
            if k == last:
                bottom = 1
            else:
                parts.append(_neighbour_rows(xs[k + 1], slice(0, 1),
                                             x.device))
        x = torch.cat(parts, dim=2) if len(parts) > 1 else x
        out.append(F.pad(x, (1, 1, top, bottom), mode="reflect"))
    return out


def reflect_conv_rows(xs, weights, stride: int = 1, relu: bool = False):
    """ops/pad_conv.reflect_conv of the image that the row shards xs make
    up, as row shards: weights[k] = (w, b) beside shard k."""
    out = []
    for x, (w, b) in zip(_halo_pad(xs, stride), weights):
        y = F.conv2d(x, w, b, stride=stride)
        out.append(F.relu(y) if relu else y)
    return out


def residual_branch_rows(xs, weights, stride: int = 1):
    """residual_branch_nchw of the image that the row shards xs make up,
    as row shards: weights[k] = ((w1, b1), (w2, b2), (w3, b3)) beside
    shard k. Returns float32; h1 and h2 are rounded to xs' dtype."""
    dt = xs[0].dtype

    def conv(hs, i, st, relu):
        return reflect_conv_rows(
            hs, [(ws[i][0].float(), ws[i][1].float()) for ws in weights],
            st, relu)

    h = conv([x.float() for x in xs], 0, stride, True)
    h = [t.to(dt).float() for t in h]
    h = [t.to(dt).float() for t in conv(h, 1, 1, True)]
    return conv(h, 2, 1, False)


def residual_branch_native_rows(xs, weights, stride: int = 1):
    """residual_branch_native of the image that the row shards xs make up,
    as row shards, differentiable: every conv in xs' dtype, weights[k] =
    ((w1, b1), (w2, b2), (w3, b3)) for shard k, each cast to that dtype
    and copied to the shard's device in the graph."""
    dt = xs[0].dtype

    def conv(hs, i, st, relu):
        cast = [(ws[i][0].to(dt), ws[i][1].to(dt)) for ws in weights]
        return reflect_conv_rows(
            hs, [(w.to(h.device), b.to(h.device))
                 for (w, b), h in zip(cast, hs)], st, relu)

    h = conv(xs, 0, stride, True)
    h = conv(h, 1, 1, True)
    return conv(h, 2, 1, False)


def _check_rows(cfg: RevResNetConfig, shards: int, rows: int,
               what: str = "image") -> None:
    """Raise ValueError unless `rows`, the rows of a shard of an image
    split over `shards` devices, are a multiple of cfg.down_scale with at
    least 2 rows at 1/down_scale, where reflect needs 2."""
    ds = cfg.down_scale
    if rows % ds or rows // ds < 2:
        raise ValueError(
            f"row sharding: {shards} shards of {rows} {what} rows; each "
            f"must hold a multiple of {ds} rows and at least 2 at "
            f"1/{ds} (the {what}'s height a multiple of {shards * ds}, "
            f"at least {2 * shards * ds})")


@torch.no_grad()
def encode_rows(nets: Sequence, shards):
    """RevResNet.encode of the image that `shards` (NHWC row shards in row
    order, one a device) make up, as latent row shards: nets[k] is the
    network's replica beside shard k."""
    for s in shards:
        _check_rows(nets[0].cfg, len(shards), s.shape[1])
    return nets[0]._encode(list(shards), residual_branch_rows, nets)


@torch.no_grad()
def decode_rows(nets: Sequence, shards):
    """RevResNet.decode of a latent given as row shards, as image row
    shards; the inverse of encode_rows."""
    cfg = nets[0].cfg
    for s in shards:
        _check_rows(cfg, len(shards), s.shape[1] * cfg.latent_scale,
                   "latent's image")
    return nets[0]._decode(list(shards), residual_branch_rows, nets)


def forward_rows(net, shards):
    """RevResNet.forward (the differentiable encode) of the image that
    `shards` (NHWC row shards in row order) make up, as latent row shards,
    in the shards' dtype; net's weights serve every shard (copied to its
    device inside the graph, so their .grad collects every shard's
    part)."""
    for s in shards:
        _check_rows(net.cfg, len(shards), s.shape[1])
    return net._encode(list(shards), residual_branch_native_rows)


def inverse_rows(net, shards):
    """RevResNet.inverse (the differentiable decode) of a latent given as
    row shards, as image row shards; the inverse of forward_rows."""
    cfg = net.cfg
    for s in shards:
        _check_rows(cfg, len(shards), s.shape[1] * cfg.latent_scale,
                   "latent's image")
    return net._decode(list(shards), residual_branch_native_rows)
