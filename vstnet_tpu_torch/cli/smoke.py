"""Smoke, benchmark and parity harness of the port:
python -m vstnet_tpu_torch.cli.smoke.

Counterpart of vstnet_tpu/cli/smoke.py, with the same tests and flags plus
--device (default: the CUDA card; `--device cpu` runs on the CPU) and
--reference:

  * shapes:  seeded resolutions +-16 px around --size through
             runtime/buckets.BucketedStylizer on the standard path; each
             output's shape and finiteness are checked.
  * bench:   the standard path's encode, decode and cWCT in bf16 at
             --batch x --size^2, timed with CUDA events after a warm-up.
  * photo:   the photo pipeline at --size^2: float32 photo_forward with
             the float32 segmenter, photo_forward_fast with the bf16
             segmenter (the route of the port's kernels; it prints their
             launches per call), and the segmenter alone in both dtypes.
  * train:   the training step's components and the trainer's full step
             at 256x256 B=2, float32.
  * parity:  the stylize program on the device against the same seeded
             PHOTO_CONFIG weights on the CPU, float32 with TF32 cleared, at
             128x128: rtol = atol = 0.01 and PSNR >= 40 dB, or exit 1.
             --reference DIR also holds the port against the upstream
             models/RevResNet.py and its per-sample cWCT under DIR.

--test all runs parity, shapes and bench. --profile LOGDIR captures a
torch.profiler trace of the run (runtime/profiling.trace) and prints at
exit the trace's device kernels by total time with the device's idle share
(runtime/profiling.summarize_trace), and the device's memory. The process clears TF32, as the port's other
CLIs do, so its float32 routes are true float32. Times on a card are the
card's; with --device cpu they are the CPU's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(fn, device, iters: int, warmup: int = 1) -> float:
    """Mean ms of one fn() call after `warmup` calls: CUDA events on a card,
    the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _rand(rng, shape, device, dtype=torch.float32):
    return torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(
        device, dtype)


def _check(out, shape, what):
    if tuple(out.shape) != tuple(shape):
        raise SystemExit(f"smoke {what}: shape {tuple(out.shape)}, want "
                         f"{tuple(shape)}")
    if not bool(torch.isfinite(out).all()):
        raise SystemExit(f"smoke {what}: non-finite output")


def test_input_shapes(size: int, device, n: int = 20, jitter: int = 16,
                      seed: int = 0):
    from vstnet_tpu_torch.models.pipeline import StyleModel
    from vstnet_tpu_torch.runtime.buckets import BucketedStylizer

    stylizer = BucketedStylizer(StyleModel.random_init(device=device))
    rng = np.random.default_rng(seed)
    times = []
    for i in range(n):
        h = size + int(rng.integers(-jitter, jitter + 1))
        w = size + int(rng.integers(-jitter, jitter + 1))
        h, w = h // 4 * 4, w // 4 * 4
        c = _rand(rng, (1, h, w, 3), device)
        s = _rand(rng, (1, h, w, 3), device)
        _sync(device)
        t0 = time.perf_counter()
        out = stylizer(c, s)
        _sync(device)
        dt = time.perf_counter() - t0
        _check(out, (1, h, w, 3), f"shapes {h}x{w}")
        times.append(dt)
        print(f"  [{i + 1}/{n}] {h}x{w}: {dt * 1000:.1f} ms")
    print(f"shape sweep OK: mean {np.mean(times) * 1000:.1f} ms, "
          f"median {np.median(times) * 1000:.1f} ms (first calls included)")


def run_benchmark(size: int, batch: int, iters: int, device):
    from vstnet_tpu_torch.config import PHOTO_CONFIG
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models.revresnet import RevResNet

    net = RevResNet(PHOTO_CONFIG, device=device).init_weights(
        torch.Generator().manual_seed(0)).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    x = _rand(rng, (batch, size, size, 3), device, torch.bfloat16)
    z = net.encode(x)
    ls, mu = cwct.style_factors(z[:1])
    stages = {"encode": lambda: net.encode(x),
              "decode": lambda: net.decode(z),
              "cwct": lambda: cwct.transfer_with_factors(z, ls, mu)}
    print(f"per-stage timings ({batch}x{size}x{size}, bf16, standard path, "
          f"{iters} iters):")
    for name, fn in stages.items():
        dt = _ms(fn, device, iters)
        print(f"  {name:8s}: {dt:7.2f} ms ({dt / batch:.2f} ms/frame)")


def photo_pipeline_bench(size: int, iters: int, device):
    """The package tier's photo pipeline at size x size: pad -> encode
    content and style -> one SegFormer-B4 pass over both -> regional cWCT
    -> decode -> Lab blend, on the float32 standard path and on the fused
    bf16 path with the bf16 segmenter."""
    from vstnet_tpu_torch import ops
    from vstnet_tpu_torch.models.pipeline import (
        StyleModel,
        photo_forward,
        photo_forward_fast,
    )
    from vstnet_tpu_torch.models.segformer import Segmenter, segment_mask

    model = StyleModel.random_init(mode="photorealistic", device=device)
    net = Segmenter.load(None, device=device).net
    rng = np.random.default_rng(0)
    c = _rand(rng, (1, size, size, 3), device)
    s = _rand(rng, (1, size, size, 3), device)

    dt = _ms(lambda: segment_mask(net, c), device, iters)
    print(f"  segformer-b4 @{size}^2 float32 : {dt:7.1f} ms")
    dt = _ms(lambda: segment_mask(net, c, half=True), device, iters)
    print(f"  segformer-b4 @{size}^2 bf16    : {dt:7.1f} ms")

    def full():
        cm, sm = segment_mask(net, torch.cat([c, s])).chunk(2)
        return photo_forward(model.net, c, s, cm, sm, max_labels=64)

    def full_fast():
        cm, sm = segment_mask(net, torch.cat([c, s]), half=True).chunk(2)
        return photo_forward_fast(model.fast_params, c, s, cm, sm,
                                  model.cfg, max_labels=64)

    for name, fn in (("float32", full), ("fast", full_fast)):
        _check(fn(), (1, size, size, 3), f"photo {name}")    # warms up
        dt = _ms(fn, device, iters, warmup=0)
        print(f"  full photo pipeline @{size}^2 {name:7s}: {dt:7.1f} ms")
    ops.reset_launch_counts()
    full_fast()
    _sync(device)
    print("  kernel launches per fast call: "
          + json.dumps({k: v for k, v in ops.launch_counts().items() if v}))


def train_profile(size: int, batch: int, iters: int, device):
    """The training step's components and the trainer's full step (the
    reference trains at crop 256, batch 2), float32."""
    from vstnet_tpu_torch.models.vgg import init_vgg, vgg_losses
    from vstnet_tpu_torch.ops.matting import matting_loss_and_grad
    from vstnet_tpu_torch.train import trainer as tr

    rng = np.random.default_rng(0)
    a = _rand(rng, (batch, size, size, 3), device)
    b = _rand(rng, (batch, size, size, 3), device)
    flow = torch.zeros((batch, size, size, 2), device=device)
    noise = torch.zeros_like(a)
    vgg = init_vgg(torch.Generator().manual_seed(1), device=device)
    tc = tr.TrainConfig()
    state = tr.init_train_state(tc, device=device)
    net = state.net
    z = net.encode(a)

    def encode_bwd():
        net.zero_grad(set_to_none=True)
        net(a).square().sum().backward()
        return torch.stack([p.grad.square().sum()
                            for p in net.parameters()]).sum()

    def vgg_fwd():
        with torch.no_grad():
            return vgg_losses(vgg, a, b, b, n_layer=4)

    rows = [("encode (1 of 5 passes, fwd only)", lambda: net.encode(a)),
            ("decode (fwd only)", lambda: net.decode(z)),
            ("encode fwd+bwd", encode_bwd),
            ("vgg losses (fwd only)", vgg_fwd),
            ("matting loss+grad", lambda: matting_loss_and_grad(a, b)),
            ("full step (5-pass + losses + adam)",
             lambda: tr.train_step(state, vgg, a, b, tc, flow, noise))]
    print(f"train ({batch}x{size}x{size}, float32, remat on):")
    for name, fn in rows:
        dt = _ms(fn, device, iters)
        print(f"  {name:34s}: {dt:8.1f} ms")
    print(f"  => {1e3 / dt:.2f} steps/s")


def _gate(what, got, ref):
    err = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    mse = float((err ** 2).mean())
    psnr = 10 * np.log10(1.0 / mse) if mse > 0 else float("inf")
    ok = np.allclose(got, ref, rtol=0.01, atol=0.01) and psnr >= 40.0
    print(f"parity gate, {what}: max err {err.max():.2e}, PSNR {psnr:.1f} "
          f"dB, rtol/atol 0.01 and >= 40 dB -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)


def _reference_stylize(reference, state_dict, cfg, c, s):
    """The upstream RevResNet and its per-sample cWCT (the batched
    whitening of upstream's cWCT.py is broken) on the CPU."""
    import types

    sys.modules.setdefault(
        "todos", types.SimpleNamespace(debug=types.SimpleNamespace(
            output_var=lambda *a, **k: None)))
    sys.path.insert(0, reference)
    try:
        from models.cWCT import cWCT  # type: ignore
        from models.RevResNet import RevResNet  # type: ignore
    finally:
        sys.path.remove(reference)
    tmodel = RevResNet(hidden_dim=cfg.hidden_dim, sp_steps=cfg.sp_steps)
    tmodel.load_state_dict({k: v.cpu() for k, v in state_dict.items()})
    tmodel.eval()
    with torch.no_grad():
        tzc = tmodel(torch.from_numpy(c.transpose(0, 3, 1, 2)))
        tzs = tmodel(torch.from_numpy(s.transpose(0, 3, 1, 2)))
        cw = cWCT()
        n = tzc.shape[1]
        col = cw.coloring(cw.whitening(tzc[0].reshape(n, -1)),
                          tzs[0].reshape(n, -1))
        out = tmodel(col.reshape(tzc.shape), forward=False)
    return out.numpy().transpose(0, 2, 3, 1)


def parity_gate(size: int, device, seed: int = 0, reference=None):
    """The stylize program on `device` against the same weights on the
    CPU (and, with `reference`, against the upstream model)."""
    from vstnet_tpu_torch.config import PHOTO_CONFIG
    from vstnet_tpu_torch.models.pipeline import stylize
    from vstnet_tpu_torch.models.revresnet import RevResNet

    cfg = PHOTO_CONFIG
    cpu = RevResNet(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed))
    net = RevResNet(cfg, device=device)
    net.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed)
    c = rng.uniform(size=(1, size, size, 3)).astype(np.float32)
    s = rng.uniform(size=(1, size, size, 3)).astype(np.float32)
    ref = stylize(cpu, torch.from_numpy(c), torch.from_numpy(s)).numpy()
    got = stylize(net, torch.from_numpy(c).to(device),
                  torch.from_numpy(s).to(device)).cpu().numpy()
    _gate(f"{device.type} against the CPU", got, ref)
    if reference is not None:
        _gate("port against upstream",
              got, _reference_stylize(reference, cpu.state_dict(), cfg, c,
                                      s))


def build_parser():
    p = argparse.ArgumentParser(
        description="vstnet_tpu_torch smoke, benchmark and parity harness")
    p.add_argument("--test", default="all",
                   choices=["shapes", "bench", "parity", "train", "photo",
                            "all"])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n_shapes", type=int, default=10)
    p.add_argument("--profile", metavar="LOGDIR", default=None,
                   help="capture a torch.profiler trace of the run under "
                        "LOGDIR (Chrome/TensorBoard format) and print its "
                        "device kernels by time and the device's memory at "
                        "exit")
    p.add_argument("--reference", metavar="DIR", default=None,
                   help="parity: also hold the port against the upstream "
                        "models/RevResNet.py and models/cWCT.py under DIR "
                        "(a missing DIR is an error)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def _run_tests(args, device):
    if args.test in ("parity", "all"):
        parity_gate(min(args.size, 128), device, reference=args.reference)
    if args.test in ("shapes", "all"):
        test_input_shapes(args.size, device, n=args.n_shapes)
    if args.test in ("bench", "all"):
        run_benchmark(args.size, args.batch, args.iters, device)
    if args.test == "train":
        train_profile(min(args.size, 256), 2, args.iters, device)
    if args.test == "photo":
        photo_pipeline_bench(args.size, args.iters, device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.reference is not None and not os.path.isdir(args.reference):
        raise SystemExit(f"smoke: --reference {args.reference}: no such "
                         "directory")
    from vstnet_tpu_torch.device import resolve_device
    from vstnet_tpu_torch.runtime.profiling import (
        format_memory_report,
        summarize_trace,
        trace,
    )

    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"smoke --test {args.test} on {name}")
    with trace(args.profile) if args.profile else contextlib.nullcontext():
        _run_tests(args, device)
    if args.profile:
        print(f"profile trace written to {args.profile}")
        print("device time in the trace (kernels by total time):")
        print(summarize_trace(args.profile, top=10))
        print("device memory:")
        print(format_memory_report(device=device))


if __name__ == "__main__":
    main()
