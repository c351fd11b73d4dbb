"""End-to-end stylization: global, interpolated, and regional under
semantic masks.

Counterpart of vstnet_tpu/models/pipeline.py. Research tier: `stylize`
(standard float32 path), `stylize_interp` (multi-style interpolation),
`stylize_fast`, `stylize_interp_fast` and `stylize_interp_multi_fast` (the
fused packed-latent path), `stylize_masked` and `stylize_masked_fast`
(regional cWCT under given masks). Video tier: `make_fused_video_fn` (the
global video program), `make_masked_fused_video_fn` with
`prepare_masked_style` (the masked, auto-seg video program and its
per-video set-up). Package tier: `photo_forward` and `photo_forward_fast`
(the Lab luminance blend), `StyleModel.photo_pipeline` and
`image_photo_predict`. Research-tier inputs are NHWC float images in [0,1]
whose height and width are multiples of 4; the package tier pads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vstnet_tpu_torch.config import ARTISTIC_CONFIG, PHOTO_CONFIG, RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import load_revresnet, params_from_jax
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models.remapping import (
    self_remapping,
    video_remap,
    video_remap_plan,
)
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.segformer import Segmenter, segment_mask
from vstnet_tpu_torch.ops.color import lab2rgb, rgb2lab
from vstnet_tpu_torch.ops.resize import (
    pad_to_multiple,
    resize_bilinear,
    resize_nearest,
)
from vstnet_tpu_torch.runtime.profiling import span


@torch.no_grad()
def stylize(net: RevResNet, content, style):
    """Global stylization on the standard path:
    decode(cWCT(encode(content), encode(style))), its stages under the
    spans encode (each image), cwct and decode."""
    with span("encode"):
        z_c = net.encode(content)
    with span("encode"):
        z_s = net.encode(style)
    with span("cwct"):
        z_cs = cwct.transfer(z_c, z_s)
    with span("decode"):
        return net.decode(z_cs)


@torch.no_grad()
def stylize_interp(net: RevResNet, content, styles, alpha_s, alpha_c=0.0):
    """Multi-style interpolation on the standard path: styles (S, B, H, W,
    3) stacked at one shape, alpha_s (S,) weights, alpha_c the content
    blend (cwct.interpolation)."""
    z_c = net.encode(content)
    z_styles = torch.stack([net.encode(s) for s in styles])
    return net.decode(cwct.interpolation(z_c, z_styles, alpha_s,
                                         alpha_c=alpha_c))


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


@torch.no_grad()
def stylize_interp_multi_fast(fast_params, content, styles, alpha_s,
                              cfg: RevResNetConfig, alpha_c):
    """Multi-style interpolation on the fused packed-latent path: styles
    (S, H, W, 3) encoded as one batch, their packed factors mixed by
    alpha_s (S,) weights (cwct.mix_factors), then applied with the alpha_c
    content blend. Computes in the packed weights' dtype; returns
    float32."""
    dt = fast_params["dtype"]
    c_lat = cfg.latent_channels
    zp_c = rf.encode_fast(fast_params, content.to(dt), cfg, packed_latent=True)
    zp_s = rf.encode_fast(fast_params, styles.to(dt), cfg, packed_latent=True)
    ls, mu = cwct.mix_factors(*cwct.style_factors_packed(zp_s, c_lat),
                              alpha_s)
    z_cs = cwct.interp_with_factors_packed(zp_c, ls[None], mu[None], alpha_c,
                                           c_lat)
    return rf.decode_fast(fast_params, z_cs, cfg, packed_latent=True).float()


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
    out_u8 packs the frames to uint8 on the device. The stages run under
    the spans encode, cwct and decode (runtime/profiling.span)."""
    c_lat = cfg.latent_channels

    @torch.no_grad()
    def fn(fast_params, frames, ls, mu_s, *alpha):
        with span("encode"):
            zp = rf.encode_fast(fast_params, frames.to(fast_params["dtype"]),
                                cfg, packed_latent=True)
        with span("cwct"):
            if interp:
                z_cs = cwct.interp_with_factors_packed(zp, ls, mu_s,
                                                       alpha[0], c_lat)
            else:
                z_cs = cwct.transfer_with_factors_packed(zp, ls, mu_s, c_lat)
        with span("decode"):
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
    frames to uint8 on the device. The stages run under the spans segment,
    remap, encode, regional_cwct and decode (runtime/profiling.span)."""

    @torch.no_grad()
    def fn(fast_params, seg_net, mapping, style_region, remap_plan, frames):
        labels_k, ns_k, mean_s_k, cov_s_k = style_region
        in_style, cross_tab = remap_plan
        h, w = frames.shape[1], frames.shape[2]
        dt = fast_params["dtype"]
        with span("segment"):
            seg_in = frames
            if seg_hw is not None and tuple(seg_hw) != (h, w):
                seg_in = resize_bilinear(frames, seg_hw[0], seg_hw[1])
            cm = segment_mask(seg_net, seg_in, half=seg_half)
        with span("remap"):
            cm = video_remap(cm, in_style, cross_tab, mapping, min_ratio)
            cm = resize_nearest(cm, h, w)
        with span("encode"):
            z_c = rf.encode_fast(fast_params, frames.to(dt), cfg)
        with span("regional_cwct"):
            z_cs = cwct.transfer_masked_factored(
                z_c, _mask_to_latent(cm, z_c.shape), labels_k, ns_k,
                mean_s_k, cov_s_k)
        with span("decode"):
            out = rf.decode_fast(fast_params, z_cs.to(dt), cfg)
            return _pack_frames(out, out_u8), cm

    return fn


# ---------------------------------------------------------------------------
# Package tier: the photo pipeline with the Lab luminance blend
# ---------------------------------------------------------------------------

def _lab_blend(content_lab, output):
    """The content's Lab luminance with the output's ab, back to RGB."""
    out_lab = rgb2lab(output.float().clamp(0.0, 1.0))
    return lab2rgb(torch.cat([content_lab[..., 0:1], out_lab[..., 1:3]],
                             dim=-1))


def _encode_pair(encode, c_image, s_image):
    """encode(content), encode(style): one batched call when the shapes
    match."""
    if c_image.shape == s_image.shape:
        z = encode(torch.cat([c_image, s_image]))
        return z[:c_image.shape[0]], z[c_image.shape[0]:]
    return encode(c_image), encode(s_image)


@torch.no_grad()
def photo_forward(net: RevResNet, c_image, s_image, cmask, smask,
                  max_labels: int = 32, use_masks: bool = True):
    """The package tier on inputs padded to a multiple of 4: encode both
    images, the regional cWCT under the masks ((B, H, W) int labels at
    image resolution) or the global one, decode, clamp, and keep the
    content's Lab luminance under the stylized ab. float32 standard path;
    returns RGB in [0, 1]."""
    content_lab = rgb2lab(c_image)
    z_c, z_s = _encode_pair(net.encode, c_image, s_image)
    if use_masks:
        z_cs = cwct.transfer_masked(
            z_c, z_s, _mask_to_latent(cmask, z_c.shape),
            _mask_to_latent(smask, z_s.shape), max_labels=max_labels)
    else:
        z_cs = cwct.transfer(z_c, z_s)
    return _lab_blend(content_lab, net.decode(z_cs))


@torch.no_grad()
def photo_forward_fast(fast_params, c_image, s_image, cmask, smask,
                       cfg: RevResNetConfig, max_labels: int = 32,
                       use_masks: bool = True):
    """photo_forward on the fused path: encode and decode through the
    kernels in the packed weights' dtype, the cWCT statistics and Cholesky
    in float32; the global route on the packed latent."""
    dt = fast_params["dtype"]
    content_lab = rgb2lab(c_image)
    cb, sb = c_image.to(dt), s_image.to(dt)
    if use_masks:
        z_c, z_s = _encode_pair(
            lambda x: rf.encode_fast(fast_params, x, cfg), cb, sb)
        z_cs = cwct.transfer_masked(
            z_c, z_s, _mask_to_latent(cmask, z_c.shape),
            _mask_to_latent(smask, z_s.shape), max_labels=max_labels)
        out = rf.decode_fast(fast_params, z_cs.to(dt), cfg)
    else:
        c_lat = cfg.latent_channels
        zp_s = rf.encode_fast(fast_params, sb, cfg, packed_latent=True)
        zp_c = rf.encode_fast(fast_params, cb, cfg, packed_latent=True)
        ls, mu_s = cwct.style_factors_packed(zp_s, c_lat)
        z_cs = cwct.transfer_with_factors_packed(zp_c, ls, mu_s, c_lat)
        out = rf.decode_fast(fast_params, z_cs, cfg, packed_latent=True)
    return _lab_blend(content_lab, out)


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

    MAX_TIMES = 4

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
                        device=None, segmenter: Optional[Segmenter] = None,
                        strict: bool = True):
        """strict=False loads a foreign checkpoint: missing and misshapen
        tensors keep seeded initial values, with warnings."""
        cfg = _config(mode)
        net = RevResNet(cfg, device=device)
        net.load_state_dict(load_revresnet(path, strict=strict, cfg=cfg))
        return cls(cfg=cfg, net=net, mode=mode, segmenter=segmenter)

    @classmethod
    def from_jax_params(cls, tree, mode: str = "photorealistic",
                        device=None, segmenter: Optional[Segmenter] = None):
        """The JAX package's params tree ({"stack", "reduction"} of HWIO
        arrays; its .msgpack weights are io.checkpoint.load_native's)."""
        cfg = _config(mode)
        net = RevResNet(cfg, device=device)
        net.load_state_dict(params_from_jax(tree))
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
            return stylize_interp(self.net, content, style[None], [1.0],
                                  alpha_c=float(alpha_c))
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

    def stylize_multi(self, content, styles, alpha_s, alpha_c=None,
                      fast: bool = False):
        """Multi-style interpolation, global transfer only: styles (S, H,
        W, 3) stacked at one shape, alpha_s (S,) weights (the caller
        normalises them), an optional alpha_c content blend. Returns the
        raw decoder output in float32."""
        a_c = 0.0 if alpha_c is None else float(alpha_c)
        if fast:
            return stylize_interp_multi_fast(self.fast_params, content,
                                             styles, alpha_s, self.cfg, a_c)
        return stylize_interp(self.net, content, styles[:, None], alpha_s,
                              alpha_c=a_c)

    def photo_pipeline(self, c_image, s_image, cmask=None, smask=None,
                       fast: bool = False):
        """The package pipeline on unpadded NHWC images: replicate-pad to
        a multiple of MAX_TIMES, segment both when no masks are given and
        a segmenter is attached, stylize with the Lab blend
        (photo_forward, or photo_forward_fast with fast=True), resize back
        to the content's size."""
        b, h, w, _ = c_image.shape
        c_pad = pad_to_multiple(c_image, self.MAX_TIMES)
        s_pad = pad_to_multiple(s_image, self.MAX_TIMES)
        if cmask is None and self.segmenter is not None:
            if c_pad.shape == s_pad.shape:
                masks = self.segmenter.segment(torch.cat([c_pad, s_pad]))
                cmask, smask = masks[:b], masks[b:]
            else:
                cmask = self.segmenter.segment(c_pad)
                smask = self.segmenter.segment(s_pad)
        use_masks = cmask is not None
        k = cwct.label_capacity(cmask) if use_masks else 32
        if fast:
            out = photo_forward_fast(self.fast_params, c_pad, s_pad, cmask,
                                     smask, self.cfg, max_labels=k,
                                     use_masks=use_masks)
        else:
            out = photo_forward(self.net, c_pad, s_pad, cmask, smask,
                                max_labels=k, use_masks=use_masks)
        if out.shape[1] != h or out.shape[2] != w:
            out = resize_bilinear(out, h, w)
        return out


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


def image_photo_predict(content_files, style_file, output_dir: str,
                        checkpoint: Optional[str] = None, device=None):
    """Write a [content | style | output] triptych PNG per content image
    through the photo pipeline; content_files is a glob pattern or a list
    of paths. Returns the written paths. device=None is the CUDA card."""
    import glob
    import os

    from vstnet_tpu_torch.device import resolve_device
    from vstnet_tpu_torch.io.image import (
        device_put_image,
        load_image,
        save_image,
    )

    if isinstance(content_files, str):
        pattern = content_files
        content_files = sorted(glob.glob(pattern))
        if not content_files:
            raise FileNotFoundError(f"no content images match {pattern!r}")
    device = resolve_device(device)
    model = create_photo_style_model(checkpoint, device=device)
    os.makedirs(output_dir, exist_ok=True)
    style = device_put_image(load_image(style_file, as_uint8=True), device)
    results = []
    for cf in content_files:
        content = device_put_image(load_image(cf, as_uint8=True), device)
        sh, sw = content.shape[1:3]
        s = style
        if s.shape[1:3] != (sh, sw):
            s = resize_bilinear(s, sh, sw)
        out = cwct.host_check_finite(model.photo_pipeline(content, s))
        dst = os.path.join(
            output_dir, os.path.splitext(os.path.basename(cf))[0] + ".png")
        save_image(torch.cat([content[0], s[0], out[0]], dim=1), dst)
        results.append(dst)
    return results
