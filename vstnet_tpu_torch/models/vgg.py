"""VGG19 loss network in the `vgg_normalised` layout.

Counterpart of vstnet_tpu/models/vgg.py: the custom Sequential of the
reference's loss network, a 1x1 RGB conv first (no ReLU), reflection-padded
3x3 convs, 2x2 max pools with ceil_mode (odd sizes keep their last row and
column), producing relu1_1..relu5_1; the AdaIN-style style loss (squared
differences of per-channel mean and std) and the content loss at relu4_1.

`VGG` is itself the nn.Sequential, with a conv at every index of
_CONV_IDX, so the bare-Sequential `vgg_normalised.pth` ('0.weight',
'2.weight', ...) loads with `load_state_dict`; its tensors past index 43
are not part of the network and `load_vgg` leaves them out. Images are
NHWC at the boundary, features NCHW. The network is a fixed loss: its
parameters never require grad.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vstnet_tpu_torch.device import resolve_device
from vstnet_tpu_torch.ops import at_least_f32

# Sequential indices of the convs, of the max pools, and of the ReLUs whose
# outputs are relu1_1 .. relu5_1
_CONV_IDX = [0, 2, 5, 9, 12, 16, 19, 22, 25, 29, 32, 35, 38, 42]
_POOL_IDX = (7, 14, 27, 40)
_CAPTURE_IDX = (3, 10, 17, 30, 43)
_CHANNELS = [
    (3, 3), (3, 64), (64, 64), (64, 128), (128, 128),
    (128, 256), (256, 256), (256, 256), (256, 256),
    (256, 512), (512, 512), (512, 512), (512, 512), (512, 512),
]


class VGG(nn.Sequential):
    """Layers 0..43 of vgg_normalised. Parameters start uninitialized:
    call `init_weights(generator)` or `load_state_dict`. device=None builds
    on the CUDA card; pass "cpu" for the CPU."""

    def __init__(self, device=None):
        device = resolve_device(device)
        channels = iter(_CHANNELS)
        layers = []
        for i in range(_CAPTURE_IDX[-1] + 1):
            if i in _CONV_IDX:
                cin, cout = next(channels)
                layers.append(nn.utils.skip_init(
                    nn.Conv2d, cin, cout, 1 if i == 0 else 3, device=device))
            elif i in _POOL_IDX:
                layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
            elif i - 1 in _CONV_IDX and i > 1:  # conv 0: no ReLU
                layers.append(nn.ReLU())
            else:
                layers.append(nn.ReflectionPad2d(1))
        super().__init__(*layers)
        self.requires_grad_(False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """U(+-1/sqrt(fan_in)) weights and zero biases, drawn from
        `generator` on the CPU."""
        for i in _CONV_IDX:
            conv = self[i]
            bound = conv.weight[0].numel() ** -0.5
            w = torch.rand(conv.weight.shape, generator=generator)
            conv.weight.copy_(w * (2 * bound) - bound)
            conv.bias.zero_()
        return self

    def features(self, x, n_layer: int = 4) -> List[torch.Tensor]:
        """x NHWC in [0,1] -> [relu1_1, ..., relu{n_layer}_1], NCHW, in
        x's dtype (the convs run on casts of the weights to it)."""
        x = x.permute(0, 3, 1, 2)
        feats = []
        for i, layer in enumerate(self):
            if isinstance(layer, nn.Conv2d):
                x = F.conv2d(x, layer.weight.to(x.dtype),
                             layer.bias.to(x.dtype))
            else:
                x = layer(x)
            if i in _CAPTURE_IDX:
                feats.append(x)
                if len(feats) == n_layer:
                    break
        return feats


def calc_mean_std(feat, eps: float = 1e-5):
    """Per-sample, per-channel spatial mean and std of an NCHW feature, in
    float32 whatever its dtype (float64 stays float64): the unbiased
    variance plus eps, then the square root."""
    feat = at_least_f32(feat)
    var = feat.var(dim=(2, 3), unbiased=True) + eps
    return feat.mean(dim=(2, 3)), var.sqrt()


def style_loss(stylized_feats, style_feats, mean_std=calc_mean_std):
    loss = 0.0
    for sf, tf in zip(stylized_feats, style_feats):
        sm, ss = mean_std(sf)
        tm, ts = mean_std(tf)
        loss = loss + ((sm - tm) ** 2).mean() + ((ss - ts) ** 2).mean()
    return loss


def content_loss(stylized_feat, content_feat):
    return ((at_least_f32(stylized_feat) - at_least_f32(content_feat))
            ** 2).mean()


def vgg_losses(vgg: VGG, content, style, stylized, n_layer: int = 4,
               content_weight: float = 0.0):
    """(loss_c, loss_s), float32 scalars (float64 on float64 images). The
    style (and content) branch runs without grad; the stylized branch
    carries it."""
    with torch.no_grad():
        style_feats = vgg.features(style, n_layer)
    stylized_feats = vgg.features(stylized, n_layer)
    loss_s = style_loss(stylized_feats, style_feats)
    if content_weight > 0:
        with torch.no_grad():
            cf = vgg.features(content, 4)[-1]
        loss_c = content_loss(stylized_feats[3], cf)
    else:
        loss_c = torch.zeros((), device=stylized.device)
    return loss_c, loss_s


# ---------------------------------------------------------------------------
# Row shards: an image split over rows onto several devices (the row form
# of the training step, train/losses.py)
# ---------------------------------------------------------------------------

def _check_rows(shards, n_layer: int) -> None:
    """Raise ValueError unless every shard's rows are a multiple of 2**p,
    p the pools before relu{n_layer}_1, with at least 2 rows at 1/2**p,
    where reflect needs 2: then each pool runs on a shard alone."""
    k = 2 ** sum(p < _CAPTURE_IDX[n_layer - 1] for p in _POOL_IDX)
    for x in shards:
        if x.shape[1] % k or x.shape[1] // k < 2:
            raise ValueError(
                f"VGG row sharding: {len(shards)} shards of {x.shape[1]} "
                f"image rows; each must hold a multiple of {k} rows and at "
                f"least {2 * k} (the image's height a multiple of "
                f"{len(shards) * k}, at least {2 * len(shards) * k})")


def features_rows(vgg: VGG, shards, n_layer: int = 4):
    """VGG.features of the image that `shards` (NHWC row shards in row
    order, one a device) make up: [relu1_1, ..., relu{n_layer}_1], each a
    list of NCHW row shards. Each ReflectionPad2d becomes the halo pad of
    parallel/halo.py (the neighbours' rows inside, reflect at the image's
    top and bottom and in width); the convs run on the weights cast to
    the shards' dtype and copied to each shard's device; ReLUs and pools
    are local."""
    from vstnet_tpu_torch.parallel.halo import _halo_pad

    _check_rows(shards, n_layer)
    xs = [s.permute(0, 3, 1, 2) for s in shards]
    dt = xs[0].dtype
    feats = []
    for i, layer in enumerate(vgg):
        if isinstance(layer, nn.Conv2d):
            w, b = layer.weight.to(dt), layer.bias.to(dt)
            xs = [F.conv2d(x, w.to(x.device), b.to(x.device)) for x in xs]
        elif isinstance(layer, nn.ReflectionPad2d):
            xs = _halo_pad(xs, 1)
        else:
            xs = [layer(x) for x in xs]
        if i in _CAPTURE_IDX:
            feats.append(xs)
            if len(feats) == n_layer:
                break
    return feats


def mean_std_rows(feats, eps: float = 1e-5):
    """calc_mean_std of the NCHW feature that the row shards make up, on
    the first shard's device, in two passes: the shards' sums give the
    mean, then their sums of squares centred on it give the unbiased
    variance over the global pixel count."""
    dev = feats[0].device
    n = sum(f.shape[2] * f.shape[3] for f in feats)
    fs = [at_least_f32(f) for f in feats]
    mean = sum(f.sum(dim=(2, 3)).to(dev) for f in fs) / n
    ss = sum((f - mean.to(f.device)[:, :, None, None]).square()
             .sum(dim=(2, 3)).to(dev) for f in fs)
    return mean, (ss / (n - 1) + eps).sqrt()


def vgg_losses_rows(vgg: VGG, content, style, stylized, n_layer: int = 4,
                    content_weight: float = 0.0):
    """vgg_losses of the images that the row shards make up (each a list
    of NHWC shards on one data row's devices), on the first shard's
    device: the style loss from mean_std_rows, the content loss a sum
    over the shards divided by the global count."""
    with torch.no_grad():
        style_feats = features_rows(vgg, style, n_layer)
    stylized_feats = features_rows(vgg, stylized, n_layer)
    loss_s = style_loss(stylized_feats, style_feats, mean_std_rows)
    dev = stylized[0].device
    if content_weight > 0:
        with torch.no_grad():
            cf = features_rows(vgg, content, 4)[-1]
        sf = stylized_feats[3]
        loss_c = sum(((at_least_f32(a) - at_least_f32(b)) ** 2).sum()
                     .to(dev) for a, b in zip(sf, cf)) / sum(
                         a.numel() for a in sf)
    else:
        loss_c = torch.zeros((), device=dev)
    return loss_c, loss_s


def init_vgg(generator: torch.Generator, device=None) -> VGG:
    return VGG(device=device).init_weights(generator)


def load_vgg(path: str, strict: bool = True, seed: int = 0,
             device=None) -> VGG:
    """A VGG from a bare-Sequential state dict (`vgg_normalised.pth`).

    strict=True reads the network's 28 tensors and ignores the file's
    deeper layers; strict=False goes through io/checkpoint's
    tolerant_state_dict: a missing or misshapen tensor keeps its value
    from init_vgg(seed), with a warning."""
    from vstnet_tpu_torch.io.checkpoint import tolerant_state_dict

    sd = torch.load(path, map_location="cpu", weights_only=True)
    vgg = VGG(device=device)
    if strict:
        sd = {k: sd[k] for k in vgg.state_dict()}
    else:
        expected = init_vgg(torch.Generator().manual_seed(seed),
                            device="cpu").state_dict()
        sd = tolerant_state_dict(sd, expected, label=path)
    vgg.load_state_dict(sd)
    return vgg


def vgg_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG params (a list of {"w": HWIO, "b"}, numpy
    arrays or anything np.asarray takes) -> a VGG state dict (OIHW)."""
    out = {}
    for idx, p in zip(_CONV_IDX, params):
        w = np.asarray(p["w"], dtype=np.float32).transpose(3, 2, 0, 1)
        out[f"{idx}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[f"{idx}.bias"] = torch.from_numpy(
            np.array(p["b"], dtype=np.float32))
    return out
