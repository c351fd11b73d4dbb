"""Artifact export CLI: python -m vstnet_tpu_torch.cli.export
(vstnet-torch-export).

Counterpart of vstnet_tpu/cli/export.py: the same artifacts (the whole
stylize program, the encoder, the decoder, the segmenter and the
segment-render program), as torch.export programs saved to
`{what}_{H}x{W}.pt2` (runtime/export.py). --device takes the place of the
JAX CLI's --platform (default: the CUDA card; `--device cpu` exports on
the CPU). The weights are held in the artifact:

    vstnet-torch-export --what stylize --ckpoint photo_image.pt \
        --height 512 --width 512 -o artifacts/
    vstnet-torch-export --what segment-render \
        --seg_ckpoint image_segment.pth -o artifacts/

Load one with runtime/export.load_exported(path), which runs it with TF32
cleared.

With --native each artifact is also compiled into an AOTInductor package,
`{what}_{H}x{W}.aoti.pt2`, for --device (runtime/native.package_program),
which the standalone runner vstnet-torch-native (native/main.cc, built at
first use by runtime/native.build) runs with no Python at run time:

    vstnet-torch-export --what stylize --ckpoint photo_image.pt --native \
        -o artifacts/
    vstnet-torch-native --artifact artifacts/stylize_512x512.aoti.pt2 \
        --style style.png -o out/ content1.png content2.png
    vstnet-torch-native --artifact \
        artifacts/segment_render_512x512.aoti.pt2 -o out/ scene.png

`python -m vstnet_tpu_torch.runtime.native` is the runner too (it builds
it, then replaces itself with it); the runner takes --device cuda (the
default), cuda:N or cpu, and the package must have been made for that
device type.
"""

from __future__ import annotations

import argparse
import os

WHAT = ("stylize", "encoder", "decoder", "segmenter", "segment-render")


def build_parser():
    p = argparse.ArgumentParser(
        description="export vstnet_tpu_torch torch.export artifacts")
    p.add_argument("--what", default="stylize", choices=WHAT + ("all",),
                   help="which program to export (all = every one)")
    p.add_argument("--mode", type=str, default="photorealistic",
                   choices=["photorealistic", "artistic"])
    p.add_argument("--ckpoint", type=str, default=None,
                   help="RevResNet .pt/.pth (reference format); random "
                        "weights with a warning if omitted")
    p.add_argument("--seg_ckpoint", type=str, default=None,
                   help="SegFormer checkpoint for segmenter/segment-render")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--blend", type=float, default=0.5,
                   help="segment-render: blend * label color + "
                        "(1-blend) * input (1.0 = pure color render)")
    p.add_argument("--min_ratio", type=float, default=0.02)
    p.add_argument("--device", default=None,
                   help="torch device to export on (default: the CUDA card)")
    p.add_argument("--out_dir", "-o", type=str, default="artifacts")
    p.add_argument("--native", action="store_true",
                   help="also compile each artifact into an AOTInductor "
                        "package {what}_{H}x{W}.aoti.pt2 for --device "
                        "(the input of vstnet-torch-native)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.height % 4 or args.width % 4:
        raise SystemExit("error: --height/--width must be multiples of 4")

    from vstnet_tpu_torch.device import resolve_device
    from vstnet_tpu_torch.runtime import export as ex

    device = resolve_device(args.device)
    wanted = list(WHAT) if args.what == "all" else [args.what]
    h, w, b = args.height, args.width, args.batch
    written = []

    def save(what, blob, oshape):
        stem = os.path.join(args.out_dir, f"{what.replace('-', '_')}_{h}x{w}")
        path = ex.save_exported(stem + ".pt2", blob)
        print(f"wrote {path} (out {oshape})")
        written.append(path)
        if args.native:
            from vstnet_tpu_torch.runtime import native

            pkg = native.package_program(path, stem + ".aoti.pt2",
                                         device=device, what=what)
            print(f"wrote {pkg} (AOTInductor package for {device})")
            written.append(pkg)

    if any(x in ("stylize", "encoder", "decoder") for x in wanted):
        from vstnet_tpu_torch.models.pipeline import StyleModel

        if args.ckpoint:
            model = StyleModel.from_checkpoint(args.ckpoint, args.mode,
                                               device=device)
        else:
            print("WARNING: no --ckpoint; exporting RANDOM weights "
                  "(smoke artifacts only)")
            model = StyleModel.random_init(mode=args.mode, device=device)
        fns = {"stylize": ex.export_stylize, "encoder": ex.export_encoder,
               "decoder": ex.export_decoder}
        for what in wanted:
            if what in fns:
                save(what, *fns[what](model.net, model.cfg, h, w, batch=b,
                                      device=device, serialized=True))

    if any(x in ("segmenter", "segment-render") for x in wanted):
        from vstnet_tpu_torch.models.segformer import Segmenter

        if not args.seg_ckpoint:
            print("WARNING: no --seg_ckpoint; exporting RANDOM segmenter "
                  "weights (smoke artifacts only)")
        net = Segmenter.load(args.seg_ckpoint, device=device).net
        if "segmenter" in wanted:
            save("segmenter", *ex.export_segmenter(
                net, h, w, batch=b, device=device, serialized=True))
        if "segment-render" in wanted:
            save("segment-render", *ex.export_segment_render(
                net, h, w, blend=args.blend, min_ratio=args.min_ratio,
                device=device, serialized=True))
    return written


if __name__ == "__main__":
    main()
