"""Training CLI: python -m vstnet_tpu_torch.cli.train (vstnet-torch-train).

The JAX CLI's flags (vstnet_tpu/cli/train.py), with --log_every (the
trainer's log interval) and --device (default: the CUDA card; `--device
cpu` trains on the CPU). Without --vgg_ckpoint's file the loss network
takes seeded random weights (a smoke run).

Several cards: --data_parallel auto (the default) with several visible
cards starts one rank per card itself; under torchrun each process is a
rank on cuda:LOCAL_RANK,

    torchrun --nproc_per_node N -m vstnet_tpu_torch.cli.train \
        --data_parallel on --train_content D1 --train_style D2

and the JAX package's VSTNET_COORDINATOR, VSTNET_NUM_PROCESSES and
VSTNET_PROCESS_ID describe a group as well (parallel/multihost.py). Each
rank loads --batch_size images a step; rank 0 writes the logs and
checkpoints. --data_parallel on needs several devices; off trains on one.
"""

from __future__ import annotations

import argparse
import datetime
import os


def _str2bool(v: str) -> bool:
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y", "on"):
        return True
    if s in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def build_parser():
    p = argparse.ArgumentParser(description="vstnet_tpu_torch trainer")
    p.add_argument("--base_name", default=None)
    p.add_argument("--mode", type=str, default="photorealistic")
    p.add_argument("--vgg_ckpoint", type=str,
                   default="checkpoints/vgg_normalised.pth")
    p.add_argument("--train_content", default=None, required=False)
    p.add_argument("--train_style", default=None, required=False)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--new_size", type=int, default=512)
    p.add_argument("--crop_size", type=int, default=256)
    # the reference declares `type=bool`, with which `--use_lap False`
    # parses True; the same spellings parse correctly here
    p.add_argument("--use_lap", type=_str2bool, nargs="?", const=True,
                   default=True, metavar="{true,false}")
    p.add_argument("--win_rad", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_decay", type=float, default=5e-5)
    p.add_argument("--style_weight", type=float, default=1.0)
    p.add_argument("--content_weight", type=float, default=0.0)
    p.add_argument("--lap_weight", type=float, default=1500.0)
    p.add_argument("--rec_weight", type=float, default=10.0)
    p.add_argument("--temporal_weight", type=float, default=60.0)
    p.add_argument("--training_iterations", type=int, default=160000)
    p.add_argument("--fine_tuning_iterations", type=int, default=10000)
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--resume_iter", type=int, default=-1)
    p.add_argument("--logs_directory", default="logs")
    p.add_argument("--display_size", type=int, default=16)
    p.add_argument("--image_display_iter", type=int, default=1000)
    p.add_argument("--image_save_iter", type=int, default=10000)
    p.add_argument("--model_save_interval", type=int, default=10000)
    p.add_argument("--log_every", type=int, default=10,
                   help="write a loss.log line every N steps")
    p.add_argument("--precision", choices=["f32", "bf16"], default="f32",
                   help="bf16 = mixed precision (float32 master weights, "
                        "bf16 convs); f32 = true float32")
    p.add_argument("--max_steps", type=int, default=None,
                   help="cap the steps of this run (smoke runs)")
    p.add_argument("--data_parallel", choices=["auto", "on", "off"],
                   default="auto",
                   help="auto: data-parallel over every visible card, "
                        "or over the ranks of a torchrun group; on: the "
                        "same, and fails on one device; off: one device")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "on the CPU)")
    return p


def main(argv=None):
    """Train; returns the final TrainState."""
    args = build_parser().parse_args(argv)

    import torch

    from vstnet_tpu_torch.device import resolve_device
    from vstnet_tpu_torch.models.vgg import init_vgg, load_vgg
    from vstnet_tpu_torch.parallel.multihost import init_distributed
    from vstnet_tpu_torch.train.losses import LossWeights
    from vstnet_tpu_torch.train.trainer import TrainConfig, train

    if args.win_rad != 1:
        raise SystemExit("error: only --win_rad 1 is supported (the on-device "
                         "matting Laplacian is specialized to 3x3 windows)")
    # a torchrun (or VSTNET_*) group first: it makes each rank's card the
    # current device, which resolve_device then picks
    if args.data_parallel != "off":
        init_distributed(backend="gloo" if args.device == "cpu" else None)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"error: {exc} (the flag: --device cpu)")

    tc = TrainConfig(
        mode=args.mode,
        lr=args.lr,
        lr_decay=args.lr_decay,
        batch_size=args.batch_size,
        new_size=args.new_size,
        crop_size=args.crop_size,
        training_iterations=args.training_iterations,
        fine_tuning_iterations=args.fine_tuning_iterations,
        weights=LossWeights(
            style=args.style_weight,
            content=args.content_weight,
            lap=args.lap_weight if args.use_lap else 0.0,
            rec=args.rec_weight,
            temporal=args.temporal_weight,
        ),
        logs_directory=args.logs_directory,
        base_name=args.base_name
        or datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S"),
        precision=args.precision,
        log_every=args.log_every,
        display_size=args.display_size,
        image_display_iter=args.image_display_iter,
        image_save_iter=args.image_save_iter,
        model_save_interval=args.model_save_interval,
    )

    if os.path.exists(args.vgg_ckpoint):
        vgg = load_vgg(args.vgg_ckpoint, device=device)
    else:
        print(f"WARNING: VGG checkpoint {args.vgg_ckpoint} not found; "
              "using random VGG weights (smoke mode)")
        vgg = init_vgg(torch.Generator().manual_seed(42), device=device)

    return train(tc, args.train_content, args.train_style, vgg,
                 resume=args.resume, resume_iter=args.resume_iter,
                 max_steps=args.max_steps, data_parallel=args.data_parallel,
                 device=device)


if __name__ == "__main__":
    main()
