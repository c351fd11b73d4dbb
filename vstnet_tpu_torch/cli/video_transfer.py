"""Video style transfer CLI of the PyTorch port.

Counterpart of vstnet_tpu/cli/video_transfer.py, with its flags and one
more, --device. Without it the CLI runs on every visible CUDA card, as the
JAX CLI runs on every device: each batch is --batch frames a card, split
into contiguous shards, one replica of the route's program on each card
(parallel/sharding.py), and the uint8 frames come back shard by shard in
frame order. `--device cuda:k` or `--device cpu` runs on that one device:

    python -m vstnet_tpu_torch.cli.video_transfer \
        --video data/content/04.avi --style data/style/04.jpg \
        --out_dir output [--precision bf16|f32] [--alpha_c A] \
        [--auto_seg [--seg_size N]] [--batch 8] [--max_size 1280]

A frame-batched streaming pipeline: the style is encoded and factored once;
frames are decoded ahead on a thread, uploaded as uint8, scaled and resized
on the device, stylized a batch at a time (the last batch padded with its
last frame, so every batch has one shape), packed to uint8 on the device,
and read back into pinned memory while the next batches run: two batches
stay in flight, and the writers encode on threads of their own.

Routes, chosen by --precision alone, each through its data-parallel
form (one device is the mesh of one):
  * bf16, global: make_fused_video_fn(out_u8=True) against the style's
    factors (parallel_stylize_fused);
  * bf16, --alpha_c: the same program with interp=True, against the
    style's packed factors, alpha_c a run-time value;
  * bf16, --auto_seg: prepare_masked_style once, then
    make_masked_fused_video_fn per batch (parallel_stylize_masked_fused);
    --seg_size -1 picks the segmenter's input size on the first frame
    (segformer.pick_seg_size);
  * f32: the standard path (RevResNet encode and decode), global
    (parallel_stylize_factored), interpolated (cwct.interpolation) or
    masked (segment, self- and cross-remap, cwct.transfer_masked), in
    float32 (the last two through map_shards).
On a CUDA device the bf16 routes run the hand-written kernels; on the CPU
their plain versions. Output: <video>_<style>.mp4 with cv2, else an MJPEG
.avi; with --auto_seg also the label and colour videos of the content
masks under <out_dir>/segmentation/.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(
        description="vstnet_tpu_torch video style transfer")
    p.add_argument("--mode", type=str, default="photorealistic",
                   choices=["photorealistic", "artistic"])
    p.add_argument("--ckpoint", type=str, default=None)
    p.add_argument("--video", type=str, default="data/content/04.avi",
                   help="video file (MJPEG avi, or any container cv2 "
                        "reads) or frame directory")
    p.add_argument("--style", type=str, default="data/style/04.jpg")
    p.add_argument("--out_dir", type=str, default="output")
    p.add_argument("--max_size", type=int, default=1280)
    p.add_argument("--alpha_c", type=float, default=None)
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--batch", type=int, default=8,
                   help="frames per device step (the batch is this times "
                        "the number of devices)")
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["bf16", "f32"],
                   help="bf16 runs the fused kernel path (>= 40 dB vs "
                        "f32); f32 runs the float32 standard path")
    p.add_argument("--auto_seg", action="store_true", default=False)
    p.add_argument("--save_seg_label", action="store_true", default=True)
    p.add_argument("--save_seg_color", action="store_true", default=True)
    p.add_argument("--label_mapping", type=str, default=None)
    p.add_argument("--palette", type=str, default=None)
    p.add_argument("--min_ratio", type=float, default=0.02)
    p.add_argument("--seg_ckpoint", type=str, default=None)
    p.add_argument("--seg_size", type=int, default=-1,
                   help="max side of the segmenter's input on the bf16 "
                        "masked route (0 = the frame size; -1 = pick the "
                        "largest downscale whose masks agree with "
                        "frame-size masks on the first frame)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: every visible CUDA card; "
                        "'cuda:k' or 'cpu' runs on that one)")
    return p


@torch.no_grad()
def _style_setup(args, model, style, first, h, w, devices):
    """The per-video state of the chosen route, made once on the first
    device, and the function that stylizes one batch of frames, given as
    one (b, h, w, 3) shard in [0,1] per device: shards -> (uint8 frame
    shards, content mask shards or None)."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import pipeline as pl
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.ops.resize import resize_bilinear
    from vstnet_tpu_torch.parallel import sharding as ps

    cfg = model.cfg
    net = model.net
    if args.precision == "bf16":
        fast = model.fast_params
        if args.auto_seg:
            from vstnet_tpu_torch.models.segformer import (
                Segmenter,
                pick_seg_size,
                seg_hw_for,
            )

            seg = Segmenter.load(args.seg_ckpoint, min_ratio=args.min_ratio,
                                 label_mapping=args.label_mapping,
                                 device=style.device)
            seg_size = args.seg_size
            if seg_size == -1:
                probe = resize_bilinear(
                    torch.from_numpy(np.array(first)).to(style.device)[None].float()
                    / 255.0, h, w)
                seg_size = pick_seg_size(seg.net, probe, half=True)
                print(f"auto seg_size: {seg_size or 'native'} "
                      "(mask-agreement gate on the first frame)")
            region, plan, _ = pl.prepare_masked_style(
                fast, seg, style, cfg, args.min_ratio)
            fn = ps.parallel_stylize_masked_fused(
                devices, cfg, min_ratio=args.min_ratio, out_u8=True,
                seg_hw=seg_hw_for(h, w, seg_size))
            return lambda xs: fn(fast, seg.net, seg.label_mapping, region,
                                 plan, xs)
        if args.alpha_c is not None:
            zp_s = rf.encode_fast(fast, style.to(fast["dtype"]), cfg,
                                  packed_latent=True)
            ls_p, mu_p = cwct.style_factors_packed(zp_s,
                                                   cfg.latent_channels)
            fn = ps.parallel_stylize_fused(devices, cfg, out_u8=True,
                                           interp=True)
            return lambda xs: (fn(fast, xs, ls_p, mu_p, args.alpha_c), None)
        ls, mu_s = cwct.style_factors(net.encode(style))
        fn = ps.parallel_stylize_fused(devices, cfg, out_u8=True)
        return lambda xs: (fn(fast, xs, ls, mu_s), None)

    z_s = net.encode(style)
    if args.auto_seg:
        from vstnet_tpu_torch.models.remapping import (
            cross_remapping,
            self_remapping,
        )
        from vstnet_tpu_torch.models.segformer import Segmenter, segment_mask

        seg = Segmenter.load(args.seg_ckpoint, min_ratio=args.min_ratio,
                             label_mapping=args.label_mapping,
                             device=style.device)
        smask = self_remapping(seg.segment(style), seg.label_mapping,
                               args.min_ratio)

        @torch.no_grad()
        def masked(net, seg_net, mapping, smask, z_s, x):
            b = x.shape[0]
            cm = self_remapping(segment_mask(seg_net, x), mapping,
                                args.min_ratio)
            sm_b = smask.expand(b, *smask.shape[-2:])
            cm = cross_remapping(cm, sm_b, mapping)
            z_c = net.encode(x)
            z_ss = z_s.expand(b, *z_s.shape[1:])
            z_cs = cwct.transfer_masked(
                z_c, z_ss, pl._mask_to_latent(cm, z_c.shape),
                pl._mask_to_latent(sm_b, z_ss.shape))
            return pl._pack_frames(net.decode(z_cs), True), cm

        fn = ps.map_shards(devices, masked, sharded=(5,))
        return lambda xs: fn(net, seg.net, seg.label_mapping, smask, z_s, xs)

    if args.alpha_c is not None:
        @torch.no_grad()
        def interp(net, z_s, x):
            z_cs = cwct.interpolation(net.encode(x), z_s[None], [1.0],
                                      alpha_c=float(args.alpha_c))
            return pl._pack_frames(net.decode(z_cs), True)

        fn = ps.map_shards(devices, interp, sharded=(2,))
        return lambda xs: (fn(net, z_s, xs), None)

    ls, mu_s = cwct.style_factors(z_s)
    fn = ps.parallel_stylize_factored(devices, cfg)
    return lambda xs: ([pl._pack_frames(o, True)
                        for o in fn(net, xs, ls, mu_s)], None)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from vstnet_tpu_torch.device import resolve_device
    from vstnet_tpu_torch.io.image import device_put_image, load_image
    from vstnet_tpu_torch.io.video import (
        AsyncWriter,
        AviWriter,
        have_cv2,
        make_video_writer,
        prefetch_frames,
        read_frames,
    )
    from vstnet_tpu_torch.models.pipeline import StyleModel
    from vstnet_tpu_torch.ops.resize import resize_bilinear
    from vstnet_tpu_torch.parallel import map_shards
    from vstnet_tpu_torch.parallel.mesh import make_mesh

    try:
        devices = (make_mesh() if args.device is None
                   else (resolve_device(args.device),))
    except RuntimeError as exc:
        raise SystemExit(f"error: {exc} (the flag: --device cpu)")
    device = devices[0]
    # float32 routes stay float32 on the card: no TF32 in cuDNN's convs
    # or in matmuls, for this process
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ckpoint:
        model = StyleModel.from_checkpoint(args.ckpoint, args.mode,
                                           device=device)
    else:
        print("WARNING: no --ckpoint given; using random weights (smoke mode)")
        model = StyleModel.random_init(mode=args.mode, device=device)
    cfg = model.cfg
    batch = args.batch * len(devices)
    if len(devices) > 1:
        print(f"data-parallel over {len(devices)} devices "
              f"({', '.join(map(str, devices))}), {batch} frames a batch")

    frames_iter, _, _ = read_frames(args.video)
    # decode-ahead thread, bounded at two batches of decoded frames
    frames_iter = prefetch_frames(frames_iter, depth=2 * batch)
    first = next(frames_iter)
    h0, w0 = first.shape[:2]
    scale = min(args.max_size / max(h0, w0), 1.0)
    h = int(h0 * scale) // cfg.down_scale * cfg.down_scale
    w = int(w0 * scale) // cfg.down_scale * cfg.down_scale

    style = device_put_image(
        load_image(args.style, args.max_size, cfg.down_scale, as_uint8=True),
        device)
    stylize_batch = _style_setup(args, model, style, first, h, w, devices)

    vname = os.path.splitext(os.path.basename(args.video))[0]
    sname = os.path.splitext(os.path.basename(args.style))[0]
    ext = ".mp4" if have_cv2() else ".avi"
    out_path = os.path.join(args.out_dir, f"{vname}_{sname}{ext}")
    if ext == ".avi":
        print(f"writing MJPEG AVI to {out_path} (no mp4 encoder here)")
    else:
        print(f"writing mp4 to {out_path}")
    writers = [AsyncWriter(make_video_writer(out_path, fps=args.fps))]
    palette = None
    seg_dir = os.path.join(args.out_dir, "segmentation")
    if args.auto_seg and args.save_seg_label:
        writers.append(AsyncWriter(AviWriter(
            os.path.join(seg_dir, "content_seg_label.avi"), fps=args.fps)))
    else:
        writers.append(None)
    if args.auto_seg and args.save_seg_color:
        from vstnet_tpu_torch.models.remapping import ade20k_palette

        palette = ade20k_palette(args.palette)
        writers.append(AsyncWriter(AviWriter(
            os.path.join(seg_dir, "content_seg_color.avi"), fps=args.fps)))
    else:
        writers.append(None)

    on_card = device.type == "cuda"
    # the uint8 batch is split on the host, each shard uploaded to its
    # device and scaled and resized there
    prep = map_shards(devices, lambda x: resize_bilinear(
        x.float() / 255.0, h, w), sharded=(0,))

    def upload(batch_np):
        x = torch.from_numpy(np.stack(batch_np))
        if on_card:
            x = x.pin_memory()
        return prep(x)

    def readback(shards):
        """The shards, in order, into one host batch (pinned, filled
        asynchronously on the card)."""
        if shards is None:
            return None
        if not on_card:
            return torch.cat([t.cpu() for t in shards])
        per = shards[0].shape[0]
        host = torch.empty((per * len(shards), *shards[0].shape[1:]),
                           dtype=shards[0].dtype, pin_memory=True)
        for i, t in enumerate(shards):
            host[i * per:(i + 1) * per].copy_(t, non_blocking=True)
        return host

    def flush(batch_np):
        """Launch one batch; its results come back into pinned host memory
        behind one event a device, so the host goes on to the next
        batch."""
        n = len(batch_np)
        batch_np = batch_np + [batch_np[-1]] * (batch - n)
        out, cm = stylize_batch(upload(batch_np))
        out, cm = readback(out), readback(cm)
        events = []
        if on_card:
            for d in dict.fromkeys(devices):
                with torch.cuda.device(d):
                    events.append(torch.cuda.Event())
                    events[-1].record()
        return out, cm, n, events

    def frame_stream():
        yield first
        yield from frames_iter

    t0 = time.time()
    done = 0
    pending = []
    batch_np = []
    try:
        for frame in frame_stream():
            batch_np.append(frame)
            if len(batch_np) == batch:
                pending.append(flush(batch_np))
                batch_np = []
            while len(pending) > 2:  # two batches in flight
                done += _drain(pending.pop(0), writers, palette)
        if batch_np:
            pending.append(flush(batch_np))
        for p in pending:
            done += _drain(p, writers, palette)
    finally:
        # close every writer even if one fails: a writer that is not
        # closed leaves its container unfinished
        close_err = None
        for wtr in writers:
            if wtr is None:
                continue
            try:
                wtr.close()
            except Exception as e:
                close_err = close_err or e
    if close_err is not None:
        raise close_err
    dt = time.time() - t0
    print(f"Save at {out_path}: {done} frames at {w}x{h}, "
          f"{done / dt:.2f} frames/sec end-to-end")
    return out_path


def _drain(item, writers, palette):
    """Wait for one batch's readback and hand its n valid frames (and
    masks) to the writers."""
    out, cm, n, events = item
    for event in events:
        event.synchronize()
    arr = out.numpy()
    cm = None if cm is None else cm.numpy()
    writer, label_writer, color_writer = writers
    for i in range(n):
        writer.write(arr[i])
        if cm is not None and label_writer is not None:
            label_writer.write(np.stack([cm[i].astype(np.uint8)] * 3, -1))
        if cm is not None and color_writer is not None:
            color_writer.write(palette[np.clip(cm[i], 0, len(palette) - 1)])
    return n


if __name__ == "__main__":
    main()
