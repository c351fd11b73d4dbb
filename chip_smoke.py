"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

Drives the port's global video stylize path (vstnet_tpu_torch) through the
entry points a user calls, at the full width and depth of PHOTO_CONFIG on
512x512 frames in bf16, with random weights made from a seed. Phases, in
order; any failure raises and the process exits non-zero:

  1. device   a CUDA card is present; print its nvidia-smi name and power
              limit.
  2. build    build the CUDA kernels from csrc/ (nvcc, first use); clear
              TF32 for cuDNN and matmul so the float32 plain versions are
              true float32.
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes, batch 2, forward and inverse,
              float32 and bf16, plus the float32 round trip.
  4. slice    StyleModel.random_init -> style factors from one 512x512
              style image -> make_fused_video_fn(out_u8=True) on 3 batches
              of 4 frames, with launch counts and the fidelity gates; then
              the interp variant and ARTISTIC_CONFIG.
  5. timings  each kernel against its plain version at batch 8 (bf16) and
              the slice's frames/s at batch 8, with CUDA events.

The last two lines of output are the kernels' JSON record and
{"ok": true, "device": {...}}. Imports neither jax nor vstnet_tpu.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

# Tolerances of phase 3. Inputs are N(0,1); weights 0.2 * N(0,1) *
# sqrt(16 / fan_in), i.e. 0.2-scaled at a fan-in of 16 and normalised by
# fan-in so that every width keeps unit-scale activations; biases
# 0.1 * N(0,1).
F32_TOL = 1e-4
# bf16: the kernel and the plain version sum in float32 in different orders,
# so a value of h1 or h2 that lies near a bf16 rounding boundary may round
# the other way, and the output, rounded once to bf16, may land one ulp off.
# Two bf16 ulps (2 * 2**-7 relative) at the output's scale covers one such
# flip in h1/h2 and one in the output rounding.
BF16_ULPS = 2
ROUND_TRIP_TOL = 1e-5

# (name, C, H, W) of the coupling kernel and (name, C, H, W full-res) of the
# transition kernel at 512x512 PHOTO_CONFIG, with launches per encode
K1_SHAPES = [("stage1", 16, 512, 512, 10), ("stage2", 64, 256, 256, 9),
             ("stage3", 256, 128, 128, 9), ("reduction", 256, 128, 128, 2)]
K2_SHAPES = [("T1", 16, 512, 512, 1), ("T2", 64, 256, 256, 1)]


def _require_card():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return smi


def _rand_branch(gen, cin, mid, cout, device):
    out = []
    for ci, co in ((cin, mid), (mid, mid), (mid, cout)):
        scale = 0.2 * math.sqrt(16.0 / (9 * ci))
        w = torch.randn((co, ci, 3, 3), generator=gen) * scale
        b = torch.randn((co,), generator=gen) * 0.1
        out.append((w.to(device), b.to(device)))
    return tuple(out)


def _bf16_tol(ref):
    scale = float(ref.float().abs().max())
    return BF16_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _psnr(a, b):
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def _time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(cf, device, gen):
    """Kernel vs plain on the card; returns max bf16 error per kernel."""
    worst = {"coupling": 0.0, "transition": 0.0}
    for name, c, h, w, _ in K1_SHAPES:
        branch = _rand_branch(gen, c, c // 4, c, device)
        for dt in (torch.float32, torch.bfloat16):
            wp = cf.pack_coupling_weights(branch, dt)
            x1 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            x2 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            for inv in (False, True):
                got = cf.fused_coupling(x1, x2, wp, inverse=inv)
                ref = cf.coupling_block_plain(x1, x2, wp, inverse=inv)
                torch.cuda.synchronize()
                err = _max_err(got, ref)
                tol = F32_TOL if dt == torch.float32 else _bf16_tol(ref)
                print(f"K1 {name} C={c} {h}x{w} {str(dt)[6:]} "
                      f"{'inv' if inv else 'fwd'}: max abs err {err:.3e} "
                      f"(tol {tol:.3e})")
                if not err <= tol:
                    raise AssertionError(f"K1 {name} {dt} inverse={inv}: "
                                         f"{err} > {tol}")
                if dt == torch.bfloat16:
                    worst["coupling"] = max(worst["coupling"], err)
            if dt == torch.float32:
                y = cf.fused_coupling(x1, x2, wp)
                back = cf.fused_coupling(y, x2, wp, inverse=True)
                err = _max_err(back, x1)
                print(f"K1 {name} f32 round trip: max abs err {err:.3e}")
                if not err <= ROUND_TRIP_TOL:
                    raise AssertionError(f"K1 {name} round trip {err}")
    for name, c, h, w, _ in K2_SHAPES:
        branch = _rand_branch(gen, c, c, 4 * c, device)
        for dt in (torch.float32, torch.bfloat16):
            wp = cf.pack_transition_weights(branch, dt)
            x1 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            x2 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            g0, g1 = cf.fused_transition(x1, x2, wp)
            r0, r1 = cf.transition_block_plain(x1, x2, wp)
            i0, i1 = cf.fused_transition(r1, r0, wp, inverse=True)
            j0, j1 = cf.transition_block_plain(r1, r0, wp, inverse=True)
            torch.cuda.synchronize()
            tol = F32_TOL if dt == torch.float32 else _bf16_tol(r1)
            for what, got, ref in (("fwd", g1, r1), ("inv", i0, j0)):
                err = _max_err(got, ref)
                print(f"K2 {name} C={c} {h}x{w} {str(dt)[6:]} {what}: max "
                      f"abs err {err:.3e} (tol {tol:.3e})")
                if not err <= tol:
                    raise AssertionError(f"K2 {name} {dt} {what}: {err}")
                if dt == torch.bfloat16:
                    worst["transition"] = max(worst["transition"], err)
            if not (torch.equal(g0, r0) and torch.equal(i1, j1)):
                raise AssertionError(f"K2 {name}: (un)shuffled copy differs")
            if dt == torch.float32:
                k0, k1 = cf.fused_transition(g1, g0, wp, inverse=True)
                err = _max_err(k0, x1)
                print(f"K2 {name} f32 round trip: max abs err {err:.3e}")
                if not (err <= ROUND_TRIP_TOL and torch.equal(k1, x2)):
                    raise AssertionError(f"K2 {name} round trip {err}")
    return worst


def _frames(gen, n, size, device):
    """Smooth image-like frames in [0,1]: bilinear-upsampled noise."""
    small = torch.rand((n, 3, size // 16, size // 16), generator=gen)
    x = torch.nn.functional.interpolate(small, size=(size, size),
                                        mode="bilinear", align_corners=False)
    x = x + 0.05 * torch.rand((n, 3, size, size), generator=gen)
    return x.clamp(0, 1).permute(0, 2, 3, 1).contiguous().to(device)


def _plain_video(model, frames, style, alpha_c=None):
    """The float32 plain route: the standard-path encode/decode (plain
    torch convs), with the latent moved to and from the packed layout so
    that the cWCT is the same code as the kernel route's."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.ops.coupling import pixel_shuffle, pixel_unshuffle

    cfg = model.cfg
    c_lat = cfg.latent_channels

    def packed(x):
        z = model.net.encode(x).permute(0, 3, 1, 2)
        for _ in range(cfg.sp_steps):
            z = pixel_unshuffle(z)
        return z

    ls, mu = cwct.style_factors_packed(packed(style), c_lat)
    zp = packed(frames)
    if alpha_c is None:
        z = cwct.transfer_with_factors_packed(zp, ls, mu, c_lat)
    else:
        z = cwct.interp_with_factors_packed(zp, ls, mu, alpha_c, c_lat)
    for _ in range(cfg.sp_steps):
        z = pixel_shuffle(z)
    return model.net.decode(z.permute(0, 2, 3, 1)).clamp(0, 1)


def phase_slice(device, gen):
    from vstnet_tpu_torch import ARTISTIC_CONFIG, PHOTO_CONFIG
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.models.pipeline import StyleModel, make_fused_video_fn
    from vstnet_tpu_torch.ops import coupling_fused as cf

    cfg = PHOTO_CONFIG
    model = StyleModel.random_init(seed=0, device=device)
    fast = model.fast_params
    style = _frames(gen, 1, 512, device)
    c_lat = cfg.latent_channels
    zs = rf.encode_fast(fast, style.to(torch.bfloat16), cfg,
                        packed_latent=True)
    ls, mu = cwct.style_factors_packed(zs, c_lat)
    cwct.host_check_finite(ls, "style factor")
    video = make_fused_video_fn(cfg, out_u8=True)
    batches = [_frames(gen, 4, 512, device) for _ in range(3)]
    torch.cuda.synchronize()

    cf.reset_launches()
    outs = []
    for frames in batches:
        k1, k2 = cf.fused_coupling.launches, cf.fused_transition.launches
        outs.append(video(fast, frames, ls, mu))
        d1 = cf.fused_coupling.launches - k1
        d2 = cf.fused_transition.launches - k2
        if (d1, d2) != (60, 4):
            raise AssertionError(f"launches per batch {d1}/{d2}, want 60/4 "
                                 "(30 coupling + 2 transition per encode "
                                 "and per decode)")
    torch.cuda.synchronize()
    launches = {"coupling": cf.fused_coupling.launches,
                "transition": cf.fused_transition.launches}
    print(f"slice: 3 batches of 4 frames, launches {launches}")
    for out in outs:
        if out.dtype != torch.uint8 or tuple(out.shape) != (4, 512, 512, 3):
            raise AssertionError(f"output {out.dtype} {tuple(out.shape)}")
    frames = batches[0]

    # bf16 kernel route vs float32 plain route
    ref = _plain_video(model, frames, style)
    got = make_fused_video_fn(cfg)(fast, frames, ls, mu)
    cwct.host_check_finite(got)
    p = _psnr(got, ref)
    print(f"gate bf16 kernel vs f32 plain: PSNR {p:.2f} dB (>= 40)")
    if not p >= 40.0:
        raise AssertionError(f"bf16 PSNR {p}")
    if _max_err(outs[0].float() / 255.0, got) > 0.5 / 255.0 + 1e-6:
        raise AssertionError("uint8 output disagrees with the float output")

    # float32 kernel route vs float32 plain route
    fast32 = rf.pack_revresnet(model.net, torch.float32)
    zs32 = rf.encode_fast(fast32, style, cfg, packed_latent=True)
    ls32, mu32 = cwct.style_factors_packed(zs32, c_lat)
    got32 = make_fused_video_fn(cfg)(fast32, frames, ls32, mu32)
    err = _max_err(got32, ref)
    print(f"gate f32 kernel vs f32 plain: max abs err {err:.3e} (<= 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"f32 kernel route error {err}")

    # round trips through the kernels
    for dt, fp, bar in ((torch.bfloat16, fast, 55.0),
                        (torch.float32, fast32, 100.0)):
        x = frames.to(dt)
        back = rf.decode_fast(fp, rf.encode_fast(fp, x, cfg), cfg)
        p = _psnr(back, x)
        print(f"gate round trip {str(dt)[6:]}: PSNR {p:.2f} dB (> {bar})")
        if not p > bar:
            raise AssertionError(f"round trip {dt}: {p}")

    # interp variant at alpha_c = 0.5
    got = make_fused_video_fn(cfg, interp=True)(fast, frames, ls, mu, 0.5)
    p = _psnr(got, _plain_video(model, frames, style, alpha_c=0.5))
    print(f"interp alpha_c=0.5: PSNR {p:.2f} dB vs f32 plain (>= 40)")
    if not p >= 40.0:
        raise AssertionError(f"interp PSNR {p}")

    # ARTISTIC_CONFIG at batch 2
    art = StyleModel.random_init(seed=1, mode="artistic", device=device)
    acfg = ARTISTIC_CONFIG
    zs_a = rf.encode_fast(art.fast_params, style.to(torch.bfloat16), acfg,
                          packed_latent=True)
    ls_a, mu_a = cwct.style_factors_packed(zs_a, acfg.latent_channels)
    got = make_fused_video_fn(acfg)(art.fast_params, frames[:2], ls_a, mu_a)
    cwct.host_check_finite(got)
    p = _psnr(got, _plain_video(art, frames[:2], style))
    print(f"artistic batch 2: shape {tuple(got.shape)}, PSNR {p:.2f} dB vs "
          f"f32 plain (>= 40)")
    if tuple(got.shape) != (2, 512, 512, 3) or not p >= 40.0:
        raise AssertionError(f"artistic: {tuple(got.shape)} {p}")
    return model, style, launches


def phase_timings(cf, model, style, device, gen):
    from vstnet_tpu_torch import PHOTO_CONFIG
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.models.pipeline import make_fused_video_fn

    bf = torch.bfloat16
    per_encode = {"coupling": [0.0, 0.0], "transition": [0.0, 0.0]}
    for kernel, shapes in (("coupling", K1_SHAPES), ("transition", K2_SHAPES)):
        for name, c, h, w, count in shapes:
            if kernel == "coupling":
                wp = cf.pack_coupling_weights(
                    _rand_branch(gen, c, c // 4, c, device), bf)
                fused, plain = cf.fused_coupling, cf.coupling_block_plain
            else:
                wp = cf.pack_transition_weights(
                    _rand_branch(gen, c, c, 4 * c, device), bf)
                fused, plain = cf.fused_transition, cf.transition_block_plain
            x1 = torch.randn((8, c, h, w), generator=gen).to(device, bf)
            x2 = torch.randn((8, c, h, w), generator=gen).to(device, bf)
            t_plain0 = _time_ms(lambda: plain(x1, x2, wp))
            t_kernel = _time_ms(lambda: fused(x1, x2, wp))
            t_kernel2 = _time_ms(lambda: fused(x1, x2, wp))
            t_plain1 = _time_ms(lambda: plain(x1, x2, wp))
            tk = min(t_kernel, t_kernel2)
            tp = min(t_plain0, t_plain1)
            print(f"time {kernel} {name} C={c} {h}x{w} bf16 B=8: kernel "
                  f"{tk:.3f} ms, plain {tp:.3f} ms (runs {t_plain0:.3f} "
                  f"{t_kernel:.3f} {t_kernel2:.3f} {t_plain1:.3f})")
            per_encode[kernel][0] += count * tk
            per_encode[kernel][1] += count * tp

    cfg = PHOTO_CONFIG
    fast = model.fast_params
    zs = rf.encode_fast(fast, style.to(bf), cfg, packed_latent=True)
    ls, mu = cwct.style_factors_packed(zs, cfg.latent_channels)
    frames = _frames(gen, 8, 512, device)
    video = make_fused_video_fn(cfg, out_u8=True)
    ms = _time_ms(lambda: video(fast, frames, ls, mu), iters=5, warmup=2)
    fps = 8 * 1000.0 / ms
    print(f"time slice PHOTO 512x512 bf16 B=8: {ms:.2f} ms per batch, "
          f"{fps:.2f} frames/s")
    return per_encode


def main():
    smi = _require_card()
    from vstnet_tpu_torch.ops import _build
    from vstnet_tpu_torch.ops import coupling_fused as cf

    print(f"device: {torch.cuda.get_device_name(0)}")
    print(smi)
    device = torch.device("cuda:0")

    t0 = time.perf_counter()
    path, compile_s = _build.build()
    _build.load()
    print(f"build: {path.name} (nvcc {compile_s:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator().manual_seed(0)
    worst = phase_kernels(cf, device, gen)
    model, style, launches = phase_slice(device, gen)
    per_encode = phase_timings(cf, model, style, device, gen)

    sources = {"coupling": ("vstnet_tpu_torch/csrc/coupling.cu",
                            "vstnet_tpu/ops/coupling_flat.py:523"),
               "transition": ("vstnet_tpu_torch/csrc/transition.cu",
                              "vstnet_tpu/ops/coupling_flat.py:738")}
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1], "launches": launches[k],
         "max_abs_err": worst[k], "ms": per_encode[k][0],
         "plain_ms": per_encode[k][1]}
        for k in ("coupling", "transition")]}
    print("kernels: ms/plain_ms are one encode's launches at 512x512 bf16 "
          "B=8; max_abs_err the largest bf16 kernel-vs-plain error of phase 3")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
