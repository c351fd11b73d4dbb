"""HTTP stylization service of the PyTorch port (vstnet_tpu_torch/serve.py).

Counterpart of vstnet_tpu/cli/serve.py, with its flags and two more.
Without --device the service keeps a replica on every visible CUDA card,
as the JAX service runs over its mesh; `--device cuda:k` or `--device cpu`
keeps one device. --trace_dir profiles the batch worker into a Chrome
trace (runtime/profiling.trace), written when the server stops:

    python -m vstnet_tpu_torch.cli.serve --ckpoint model.pt --port 8790 --fast
    curl -X PUT  --data-binary @style.jpg localhost:8790/styles/wave
    curl -X POST --data-binary @content.jpg \\
         "localhost:8790/stylize?style=wave" -o out.png
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser("vstnet-torch-serve")
    p.add_argument("--mode", type=str, default="photorealistic",
                   choices=["photorealistic", "artistic"])
    p.add_argument("--ckpoint", type=str, default=None,
                   help="torch .pt checkpoint (random weights if omitted)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8790)
    p.add_argument("--fast", action="store_true", default=False,
                   help="fused bf16 kernel path (packed latent)")
    p.add_argument("--max_size", type=int, default=1280)
    p.add_argument("--grid", type=int, default=64,
                   help="shape-bucket grid in pixels")
    p.add_argument("--max_batch", type=int, default=8,
                   help="coalesce up to this many concurrent requests "
                        "into one device batch")
    p.add_argument("--batch_window_ms", type=float, default=5.0,
                   help="how long a request waits for batch-mates")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: every visible CUDA card; "
                        "'cuda:k' or 'cpu' runs on that one)")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="profile the batch worker into a Chrome trace "
                        "under this directory, written at shutdown")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from vstnet_tpu_torch.device import resolve_device
    from vstnet_tpu_torch.models.pipeline import StyleModel
    from vstnet_tpu_torch.serve import StyleService, serve

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"error: {exc} (the flag: --device cpu)")
    # the float32 route stays float32 on the card: no TF32 in cuDNN's
    # convs or in matmuls, for this process
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ckpoint:
        model = StyleModel.from_checkpoint(args.ckpoint, mode=args.mode,
                                           device=device)
    else:
        print("WARNING: no --ckpoint given; using random weights "
              "(smoke mode)")
        model = StyleModel.random_init(mode=args.mode, device=device)

    service = StyleService(model, fast=args.fast, grid=args.grid,
                           max_size=args.max_size,
                           max_batch=args.max_batch,
                           batch_window_ms=args.batch_window_ms,
                           devices=None if args.device is None
                           else (device,),
                           trace_dir=args.trace_dir)
    httpd = serve(service, host=args.host, port=args.port)
    print(f"vstnet-torch-serve: {args.mode} "
          f"({'fused bf16' if args.fast else 'f32'}) on "
          f"{len(service.devices)} x {service.device_name()} at "
          f"http://{args.host}:{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()


if __name__ == "__main__":
    main()
