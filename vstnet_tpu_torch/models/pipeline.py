"""End-to-end stylization: global, and regional under semantic masks.

Counterpart of vstnet_tpu/models/pipeline.py's research tier and video
tier: `stylize` (standard float32 path), `stylize_fast` and
`stylize_interp_fast` (the fused bf16 packed-latent path), `stylize_masked`
and `stylize_masked_fast` (regional cWCT under given masks),
`make_fused_video_fn` (the global video program),
`make_masked_fused_video_fn` with `prepare_masked_style` (the masked,
auto-seg video program and its per-video set-up) and `StyleModel`. Inputs
are NHWC float images in [0,1] whose height and width are multiples of 4.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vstnet_tpu_torch.config import ARTISTIC_CONFIG, PHOTO_CONFIG, RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import load_revresnet
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models.remapping import (
    self_remapping,
    video_remap,
    video_remap_plan,
)
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.segformer import Segmenter, segment_mask
from vstnet_tpu_torch.ops.resize import resize_bilinear, resize_nearest


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


def _mask_to_latent(mask, z_shape):
    """Nearest-resample an int mask (B, H, W) to the latent grid of an NHWC
    latent of shape z_shape."""
    return resize_nearest(mask, z_shape[1], z_shape[2])


@torch.no_grad()
def stylize_masked(net: RevResNet, content, style, cmask, smask,
                   max_labels: int = 32):
    """Regional stylization on the standard path. Masks are (B, H, W) int
    labels at image resolution, nearest-resampled to the latent grid."""
    z_c = net.encode(content)
    z_s = net.encode(style)
    z_cs = cwct.transfer_masked(z_c, z_s, _mask_to_latent(cmask, z_c.shape),
                                _mask_to_latent(smask, z_s.shape),
                                max_labels=max_labels)
    return net.decode(z_cs)


@torch.no_grad()
def stylize_masked_fast(fast_params, content, style, cmask, smask,
                        cfg: RevResNetConfig, max_labels: int = 32):
    """Regional stylization on the fused path (statistics and Cholesky in
    float32). Computes in the packed weights' dtype; returns float32."""
    dt = fast_params["dtype"]
    z_c = rf.encode_fast(fast_params, content.to(dt), cfg)
    z_s = rf.encode_fast(fast_params, style.to(dt), cfg)
    z_cs = cwct.transfer_masked(z_c, z_s, _mask_to_latent(cmask, z_c.shape),
                                _mask_to_latent(smask, z_s.shape),
                                max_labels=max_labels)
    return rf.decode_fast(fast_params, z_cs.to(dt), cfg).float()


def _pack_frames(out, out_u8: bool):
    out = out.float().clamp(0.0, 1.0)
    if out_u8:
        return torch.round(out * 255.0).to(torch.uint8)
    return out


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
        return _pack_frames(out, out_u8)

    return fn


@torch.no_grad()
def prepare_masked_style(fast_params, segmenter: Segmenter, style,
                         cfg: RevResNetConfig, min_ratio: float = 0.02):
    """The per-video set-up of the masked video program, done once for a
    fixed style image (1, H, W, 3): segment the style and self-remap its
    mask, encode it on the fused path, resample the mask to the latent
    grid, size the region capacity from its labels, take the per-label
    style statistics and the frame-independent halves of the remap.

    Returns (style_region, remap_plan, smask): the arguments of the
    program of make_masked_fused_video_fn and the style's (1, H, W) mask."""
    smask = segmenter.segment(style)
    smask = self_remapping(smask, segmenter.label_mapping, min_ratio)
    z_s = rf.encode_fast(fast_params, style.to(fast_params["dtype"]), cfg)
    sm_lat = _mask_to_latent(smask, z_s.shape)
    style_region = cwct.style_region_factors(
        z_s, sm_lat, max_labels=cwct.label_capacity(sm_lat))
    return (style_region, video_remap_plan(smask, segmenter.label_mapping),
            smask)


def make_masked_fused_video_fn(cfg: RevResNetConfig, min_ratio: float = 0.02,
                               out_u8: bool = False, seg_hw=None,
                               seg_half: bool = True):
    """fn(fast_params, seg_net, mapping, style_region, remap_plan, frames)
    -> (stylized, content_masks).

    The masked (auto-seg) video program: per-frame segmentation (SegFormer)
    -> the composed one-gather video_remap -> fused encode -> content-side
    regional cWCT against the per-video style statistics
    (prepare_masked_style) -> fused decode, clamped to [0,1].

    seg_hw=(sh, sw): run the segmenter on bilinearly downscaled frames; the
    returned masks are upsampled back to frame resolution (nearest).
    seg_half (default True): bf16 backbone and head. out_u8 packs the
    frames to uint8 on the device."""

    @torch.no_grad()
    def fn(fast_params, seg_net, mapping, style_region, remap_plan, frames):
        labels_k, ns_k, mean_s_k, cov_s_k = style_region
        in_style, cross_tab = remap_plan
        h, w = frames.shape[1], frames.shape[2]
        seg_in = frames
        if seg_hw is not None and tuple(seg_hw) != (h, w):
            seg_in = resize_bilinear(frames, seg_hw[0], seg_hw[1])
        cm = segment_mask(seg_net, seg_in, half=seg_half)
        cm = video_remap(cm, in_style, cross_tab, mapping, min_ratio)
        cm = resize_nearest(cm, h, w)
        dt = fast_params["dtype"]
        z_c = rf.encode_fast(fast_params, frames.to(dt), cfg)
        z_cs = cwct.transfer_masked_factored(
            z_c, _mask_to_latent(cm, z_c.shape), labels_k, ns_k, mean_s_k,
            cov_s_k)
        out = rf.decode_fast(fast_params, z_cs.to(dt), cfg)
        return _pack_frames(out, out_u8), cm

    return fn


def _config(mode: str) -> RevResNetConfig:
    return PHOTO_CONFIG if mode.lower() == "photorealistic" else ARTISTIC_CONFIG


@dataclasses.dataclass
class StyleModel:
    """A loaded stylization model: config + network on one device, and
    optionally the segmenter of the masked (auto-seg) routes."""

    cfg: RevResNetConfig
    net: RevResNet
    mode: str = "photorealistic"
    segmenter: Optional[Segmenter] = None
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
                    device=None, segmenter: Optional[Segmenter] = None):
        cfg = _config(mode)
        net = RevResNet(cfg, device=device)
        net.init_weights(torch.Generator().manual_seed(seed))
        return cls(cfg=cfg, net=net, mode=mode, segmenter=segmenter)

    @classmethod
    def from_checkpoint(cls, path: str, mode: str = "photorealistic",
                        device=None, segmenter: Optional[Segmenter] = None):
        cfg = _config(mode)
        net = RevResNet(cfg, device=device)
        net.load_state_dict(load_revresnet(path))
        return cls(cfg=cfg, net=net, mode=mode, segmenter=segmenter)

    def stylize(self, content, style, cmask=None, smask=None, alpha_c=None,
                fast: bool = False):
        """Stylize NHWC float images (sizes multiples of 4). Returns the raw
        decoder output in float32. alpha_c selects the interpolated
        transfer; cmask and smask ((B, H, W) int labels) the regional one;
        fast=True runs the fused bf16 kernel path."""
        if alpha_c is not None and cmask is None:
            if fast:
                return stylize_interp_fast(self.fast_params, content, style,
                                           self.cfg, alpha_c)
            return stylize_interp(self.net, content, style, alpha_c)
        if cmask is not None and smask is not None:
            k = cwct.label_capacity(cmask)
            if fast:
                return stylize_masked_fast(self.fast_params, content, style,
                                           cmask, smask, self.cfg,
                                           max_labels=k)
            return stylize_masked(self.net, content, style, cmask, smask,
                                  max_labels=k)
        if fast:
            return stylize_fast(self.fast_params, content, style, self.cfg)
        return stylize(self.net, content, style)


def _create(mode, checkpoint, device, seed, segmenter):
    if checkpoint:
        return StyleModel.from_checkpoint(checkpoint, mode, device=device,
                                          segmenter=segmenter)
    return StyleModel.random_init(seed, mode, device=device,
                                  segmenter=segmenter)


def create_photo_style_model(checkpoint: Optional[str] = None,
                             device=None, seed: int = 0,
                             segmenter: Optional[Segmenter] = None):
    return _create("photorealistic", checkpoint, device, seed, segmenter)


def create_artist_style_model(checkpoint: Optional[str] = None,
                              device=None, seed: int = 0,
                              segmenter: Optional[Segmenter] = None):
    return _create("artistic", checkpoint, device, seed, segmenter)
