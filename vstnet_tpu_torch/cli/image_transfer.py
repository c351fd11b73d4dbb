"""Image style transfer CLI of the PyTorch port.

Counterpart of vstnet_tpu/cli/image_transfer.py, with its flags and one
more, --device (default: the CUDA card; `--device cpu` runs on the CPU):

    python -m vstnet_tpu_torch.cli.image_transfer \
        --mode photorealistic --ckpoint checkpoints/photo_image.pt \
        --content data/content/01.jpg --style data/style/01.jpg \
        --out_dir output --max_size 1280 [--alpha_c A] [--fast] \
        [--styles S1 S2 ... [--alpha_s W1 W2 ...]] \
        [--auto_seg | --content_seg C.png --style_seg S.png] \
        [--save_seg_label] [--save_seg_color] [--min_ratio R] \
        [--ultra_threshold N] [--tile T] [--overlap O]

A content whose longer side exceeds --ultra_threshold takes the tiled
ultra-resolution path (models/ultra.py) in every mode: global, regional
(--auto_seg or given masks), interpolated (--styles/--alpha_s or
--alpha_c), and fused (--fast). --ckpoint takes a reference .pt/.pth
file or the JAX package's native .msgpack weights (io/checkpoint.py's
load_native, no flax needed).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        description="vstnet_tpu_torch image style transfer")
    p.add_argument("--mode", type=str, default="photorealistic",
                   choices=["photorealistic", "artistic"])
    p.add_argument("--ckpoint", type=str, default=None,
                   help=".pt/.pth (reference format) or .msgpack "
                        "(the JAX package's native format)")
    p.add_argument("--content", type=str, default="data/content/01.jpg")
    p.add_argument("--style", type=str, default="data/style/01.jpg")
    p.add_argument("--out_dir", type=str, default="output")
    p.add_argument("--max_size", type=int, default=1280)
    p.add_argument("--alpha_c", type=float, default=None)
    p.add_argument("--styles", type=str, nargs="+", default=None,
                   help="two or more style images for multi-style "
                        "interpolation (global transfer; combine with "
                        "--alpha_s weights and optionally --alpha_c)")
    p.add_argument("--alpha_s", type=float, nargs="+", default=None,
                   help="interpolation weights for --styles "
                        "(default uniform; normalized to sum to 1)")
    p.add_argument("--content_seg", type=str, default=None)
    p.add_argument("--style_seg", type=str, default=None)
    p.add_argument("--auto_seg", action="store_true", default=False)
    p.add_argument("--save_seg_label", action="store_true", default=True)
    p.add_argument("--save_seg_color", action="store_true", default=True)
    p.add_argument("--label_mapping", type=str, default=None,
                   help="ade20k semantic relation .npy (defaults to bundled)")
    p.add_argument("--palette", type=str, default=None)
    p.add_argument("--min_ratio", type=float, default=0.02)
    p.add_argument("--seg_ckpoint", type=str, default=None,
                   help="SegFormer-B4 checkpoint for --auto_seg")
    p.add_argument("--seg_size", type=int, default=0,
                   help="run the segmenter on a downscale capped at this "
                        "size (0 = a cap of 1024)")
    p.add_argument("--ultra_threshold", type=int, default=1536,
                   help="route images larger than this through spatial "
                        "tiling (models/ultra.py)")
    p.add_argument("--tile", type=int, default=1024)
    p.add_argument("--overlap", type=int, default=128)
    p.add_argument("--fast", action="store_true", default=False,
                   help="fused bf16 kernel path (>= 40 dB agreement with "
                        "the float32 default)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "on the CPU)")
    return p


def _style_weights(args):
    """The normalised --alpha_s weights of --styles, or None."""
    if not args.styles:
        if args.alpha_s is not None:
            raise SystemExit("error: --alpha_s requires --styles")
        return None
    if args.auto_seg or args.content_seg or args.style_seg:
        raise SystemExit(
            "error: --styles interpolation is a global transfer "
            "(no segmentation)")
    k = len(args.styles)
    if args.alpha_s is None:
        return [1.0 / k] * k
    if len(args.alpha_s) != k:
        raise SystemExit(
            f"error: --alpha_s needs {k} weights (one per style), "
            f"got {len(args.alpha_s)}")
    if any(a < 0 for a in args.alpha_s) or sum(args.alpha_s) <= 0:
        raise SystemExit(
            "error: --alpha_s weights must be non-negative with a "
            "positive sum")
    tot = sum(args.alpha_s)
    return [a / tot for a in args.alpha_s]


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.alpha_c is not None and not 0.0 <= args.alpha_c <= 1.0:
        raise SystemExit(
            f"error: --alpha_c must be in [0, 1], got {args.alpha_c}")
    alpha_s = _style_weights(args)

    import torch

    from vstnet_tpu_torch.device import resolve_device
    from vstnet_tpu_torch.io.image import (
        device_put_image,
        load_image,
        load_segment_image,
    )
    from vstnet_tpu_torch.models.pipeline import StyleModel
    from vstnet_tpu_torch.ops.resize import resize_bilinear

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"error: {exc} (the flag: --device cpu)")
    # float32 routes stay float32 on the card: no TF32 in cuDNN's convs
    # or in matmuls, for this process
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ckpoint and args.ckpoint.endswith(".msgpack"):
        from vstnet_tpu_torch.io.checkpoint import load_native

        model = StyleModel.from_jax_params(load_native(args.ckpoint),
                                           args.mode, device=device)
    elif args.ckpoint:
        model = StyleModel.from_checkpoint(args.ckpoint, args.mode,
                                           device=device)
    else:
        print("WARNING: no --ckpoint given; using random weights (smoke mode)")
        model = StyleModel.random_init(mode=args.mode, device=device)

    ds = model.cfg.down_scale
    # uint8 host arrays, normalised on the device
    content = load_image(args.content, args.max_size, ds, as_uint8=True)
    style_paths = args.styles if alpha_s is not None else [args.style]
    style = load_image(style_paths[0], args.max_size, ds, as_uint8=True)

    # the segmenter sees at most seg_max pixels a side: a larger image is
    # segmented on a downscale and its mask upsampled (nearest)
    seg_max = args.seg_size if args.seg_size > 0 else 1024

    def _segment_capped(seg, img_u8):
        from vstnet_tpu_torch.ops.resize import resize_nearest

        h0, w0 = img_u8.shape[1:3]
        x = device_put_image(img_u8, device)
        if max(h0, w0) > seg_max:
            f = seg_max / max(h0, w0)
            nh = max(int(h0 * f) // 4 * 4, 4)
            nw = max(int(w0 * f) // 4 * 4, 4)
            return resize_nearest(seg.segment(resize_bilinear(x, nh, nw)),
                                  h0, w0)
        return seg.segment(x)

    cmask = smask = None
    if args.auto_seg:
        from vstnet_tpu_torch.models.segformer import Segmenter

        seg = Segmenter.load(args.seg_ckpoint, min_ratio=args.min_ratio,
                             label_mapping=args.label_mapping,
                             half=args.fast, device=device)
        cmask, smask = seg.remap(_segment_capped(seg, content),
                                 _segment_capped(seg, style))
        _maybe_save_seg(args, cmask.cpu().numpy(), smask.cpu().numpy())
    elif args.content_seg and args.style_seg:
        cmask = torch.from_numpy(load_segment_image(
            args.content_seg, content.shape[1:3])).to(device)
        smask = torch.from_numpy(load_segment_image(
            args.style_seg, style.shape[1:3])).to(device)

    c = device_put_image(content, device)
    s = device_put_image(style, device)
    styles = None
    if alpha_s is not None:
        # every style at the first style's shape (the factors are
        # statistics, stable under scale; the stack needs one shape)
        parts = [s]
        for sp in style_paths[1:]:
            si = device_put_image(
                load_image(sp, args.max_size, ds, as_uint8=True), device)
            if si.shape[1:3] != s.shape[1:3]:
                si = resize_bilinear(si, s.shape[1], s.shape[2])
            parts.append(si)
        styles = torch.cat(parts)
    if max(content.shape[1:3]) > args.ultra_threshold:
        out = _ultra(args, model, c, s, styles, alpha_s, cmask, smask)
    elif alpha_s is not None:
        out = model.stylize_multi(c, styles, alpha_s, alpha_c=args.alpha_c,
                                  fast=args.fast)
    elif cmask is not None:
        out = model.stylize(c, s, cmask, smask, fast=args.fast)
    elif args.alpha_c is not None:
        out = model.stylize(c, s, alpha_c=args.alpha_c, fast=args.fast)
    else:
        out = model.stylize(c, s, fast=args.fast)
    return _finish(args, style_paths, out)


def _ultra(args, model, c, s, styles, alpha_s, cmask, smask):
    """The tiled ultra-resolution path (models/ultra.py) in the mode the
    flags pick: regional under masks, interpolated (--styles/--alpha_s or
    --alpha_c) or global; --fast tiles through the fused kernels. A style
    above the threshold is shrunk to it first (its factors are statistics,
    stable under scale), its mask by nearest."""
    from vstnet_tpu_torch.models import cwct, ultra
    from vstnet_tpu_torch.ops.resize import resize_bilinear, resize_nearest

    if max(s.shape[1:3]) > args.ultra_threshold:
        sh, sw = s.shape[1:3]
        f = args.ultra_threshold / max(sh, sw)
        nh = max(int(sh * f) // 4 * 4, 4)
        nw = max(int(sw * f) // 4 * 4, 4)
        print(f"note: style resized {sh}x{sw} -> {nh}x{nw} for factor "
              "computation (statistics are scale-stable)")
        s = resize_bilinear(s, nh, nw)
        if styles is not None:
            styles = resize_bilinear(styles, nh, nw)
        if smask is not None:
            smask = resize_nearest(smask, nh, nw)
    print(f"ultra-res: tiling {c.shape[1]}x{c.shape[2]} "
          f"(tile={args.tile}, overlap={args.overlap}"
          + (", fused bf16" if args.fast else "") + ")")
    kw = {"tile": args.tile, "overlap": args.overlap,
          "fast_params": model.fast_params if args.fast else None}
    if cmask is not None:
        return ultra.stylize_tiled_masked(
            model.net, c, s, cmask, smask, model.cfg,
            max_labels=cwct.label_capacity(cmask), **kw)
    if alpha_s is not None or args.alpha_c is not None:
        s_list, a_s = ((list(styles.split(1)), alpha_s)
                       if alpha_s is not None else ([s], [1.0]))
        return ultra.stylize_tiled_interp(
            model.net, c, s_list, a_s, model.cfg,
            alpha_c=float(args.alpha_c or 0.0), **kw)
    return ultra.stylize_tiled(model.net, c, s, model.cfg, **kw)


def _finish(args, style_paths, out):
    """Check the output is finite (a failed Cholesky poisons it), then
    save it as <content>_<style[+style...]>.png in --out_dir."""
    from vstnet_tpu_torch.io.image import save_image
    from vstnet_tpu_torch.models.cwct import host_check_finite

    host_check_finite(out)
    cn = os.path.splitext(os.path.basename(args.content))[0]
    sn = "+".join(os.path.splitext(os.path.basename(sp))[0]
                  for sp in style_paths)
    path = os.path.join(args.out_dir, f"{cn}_{sn}.png")
    save_image(out, path)
    print(f"Save at {path}")
    return path


def _maybe_save_seg(args, cmask, smask):
    if not (args.save_seg_label or args.save_seg_color):
        return
    from PIL import Image

    seg_dir = os.path.join(args.out_dir, "segmentation")
    os.makedirs(seg_dir, exist_ok=True)
    if args.save_seg_label:
        Image.fromarray(cmask[0].astype(np.uint8)).save(
            os.path.join(seg_dir, "content_seg_label.png"))
        Image.fromarray(smask[0].astype(np.uint8)).save(
            os.path.join(seg_dir, "style_seg_label.png"))
    if args.save_seg_color:
        from vstnet_tpu_torch.models.remapping import ade20k_palette

        pal = ade20k_palette(args.palette)
        for name, m in (("content", cmask), ("style", smask)):
            color = pal[np.clip(m[0], 0, len(pal) - 1)]
            Image.fromarray(color.astype(np.uint8)).save(
                os.path.join(seg_dir, f"{name}_seg_color.png"))


if __name__ == "__main__":
    main()
