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


def style_loss(stylized_feats, style_feats):
    loss = 0.0
    for sf, tf in zip(stylized_feats, style_feats):
        sm, ss = calc_mean_std(sf)
        tm, ts = calc_mean_std(tf)
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
