"""End-to-end global stylization.

Counterpart of the global parts of vstnet_tpu/models/pipeline.py:
`stylize` (standard float32 path), `stylize_fast` and `stylize_interp_fast`
(the fused bf16 packed-latent path), `make_fused_video_fn` (the video
program) and `StyleModel`. Inputs are NHWC float images in [0,1] whose
height and width are multiples of 4.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vstnet_tpu_torch.config import ARTISTIC_CONFIG, PHOTO_CONFIG, RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import load_revresnet
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models.revresnet import RevResNet


@torch.no_grad()
def stylize(net: RevResNet, content, style):
    """Global stylization on the standard path:
    decode(cWCT(encode(content), encode(style)))."""
    z_c = net.encode(content)
    z_s = net.encode(style)
    return net.decode(cwct.transfer(z_c, z_s))


@torch.no_grad()
def stylize_interp(net: RevResNet, content, style, alpha_c):
    """Single-style interpolation on the standard path: the style factors
    blended with the content's by alpha_c."""
    z_c = net.encode(content)
    ls, mu = cwct.style_factors(net.encode(style))
    return net.decode(cwct.interp_with_factors(z_c, ls, mu, alpha_c))


def _fast_pair(fast_params, content, style, cfg, alpha_c=None):
    dt = fast_params["dtype"]
    c_lat = cfg.latent_channels
    zp_c = rf.encode_fast(fast_params, content.to(dt), cfg, packed_latent=True)
    zp_s = rf.encode_fast(fast_params, style.to(dt), cfg, packed_latent=True)
    ls, mu_s = cwct.style_factors_packed(zp_s, c_lat)
    if alpha_c is None:
        z_cs = cwct.transfer_with_factors_packed(zp_c, ls, mu_s, c_lat)
    else:
        z_cs = cwct.interp_with_factors_packed(zp_c, ls, mu_s, alpha_c,
                                               c_lat)
    out = rf.decode_fast(fast_params, z_cs, cfg, packed_latent=True)
    return out.float()


@torch.no_grad()
def stylize_fast(fast_params, content, style, cfg: RevResNetConfig):
    """Global stylization on the fused path with the packed latent (the
    transfer commutes with the final pixel shuffles, so both are skipped).
    Computes in the packed weights' dtype; returns float32."""
    return _fast_pair(fast_params, content, style, cfg)


@torch.no_grad()
def stylize_interp_fast(fast_params, content, style, cfg: RevResNetConfig,
                        alpha_c):
    """stylize_interp on the fused packed-latent path."""
    return _fast_pair(fast_params, content, style, cfg, alpha_c=alpha_c)


def make_fused_video_fn(cfg: RevResNetConfig, out_u8: bool = False,
                        interp: bool = False):
    """fn(fast_params, frames, ls, mu_s[, alpha_c]) -> stylized frames.

    The global video program: packed-latent encode -> transfer (or the
    alpha_c interpolated transfer; alpha_c is a run-time value) against the
    precomputed packed style factors (cwct.style_factors_packed) ->
    packed decode, clamped to [0,1]. Computes in the packed weights' dtype;
    out_u8 packs the frames to uint8 on the device."""
    c_lat = cfg.latent_channels

    @torch.no_grad()
    def fn(fast_params, frames, ls, mu_s, *alpha):
        zp = rf.encode_fast(fast_params, frames.to(fast_params["dtype"]),
                            cfg, packed_latent=True)
        if interp:
            z_cs = cwct.interp_with_factors_packed(zp, ls, mu_s, alpha[0],
                                                   c_lat)
        else:
            z_cs = cwct.transfer_with_factors_packed(zp, ls, mu_s, c_lat)
        out = rf.decode_fast(fast_params, z_cs, cfg, packed_latent=True)
        out = out.float().clamp(0.0, 1.0)
        if out_u8:
            return torch.round(out * 255.0).to(torch.uint8)
        return out

    return fn


def _config(mode: str) -> RevResNetConfig:
    return PHOTO_CONFIG if mode.lower() == "photorealistic" else ARTISTIC_CONFIG


@dataclasses.dataclass
class StyleModel:
    """A loaded stylization model: config + network on one device."""

    cfg: RevResNetConfig
    net: RevResNet
    mode: str = "photorealistic"
    _fast_params: Optional[dict] = dataclasses.field(default=None,
                                                     repr=False)

    @property
    def fast_params(self):
        """bf16 packed weights for the fused kernel path (cached)."""
        if self._fast_params is None:
            self._fast_params = rf.pack_revresnet(self.net, torch.bfloat16)
        return self._fast_params

    @classmethod
    def random_init(cls, seed: int = 0, mode: str = "photorealistic",
                    device="cpu"):
        cfg = _config(mode)
        net = RevResNet(cfg, device=device)
        net.init_weights(torch.Generator().manual_seed(seed))
        return cls(cfg=cfg, net=net, mode=mode)

    @classmethod
    def from_checkpoint(cls, path: str, mode: str = "photorealistic",
                        device="cpu"):
        cfg = _config(mode)
        net = RevResNet(cfg, device=device)
        net.load_state_dict(load_revresnet(path))
        return cls(cfg=cfg, net=net, mode=mode)

    def stylize(self, content, style, alpha_c=None, fast: bool = False):
        """Stylize NHWC float images (sizes multiples of 4). Returns the raw
        decoder output in float32. alpha_c selects the interpolated
        transfer; fast=True runs the fused bf16 kernel path."""
        if alpha_c is not None:
            if fast:
                return stylize_interp_fast(self.fast_params, content, style,
                                           self.cfg, alpha_c)
            return stylize_interp(self.net, content, style, alpha_c)
        if fast:
            return stylize_fast(self.fast_params, content, style, self.cfg)
        return stylize(self.net, content, style)


def create_photo_style_model(checkpoint: Optional[str] = None,
                             device="cpu", seed: int = 0):
    if checkpoint:
        return StyleModel.from_checkpoint(checkpoint, "photorealistic",
                                          device=device)
    return StyleModel.random_init(seed, "photorealistic", device=device)


def create_artist_style_model(checkpoint: Optional[str] = None,
                              device="cpu", seed: int = 0):
    if checkpoint:
        return StyleModel.from_checkpoint(checkpoint, "artistic",
                                          device=device)
    return StyleModel.random_init(seed, "artistic", device=device)
