"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

Drives the port's two video paths (vstnet_tpu_torch) through the entry
points a user calls, at the full width and depth of PHOTO_CONFIG and
SegFormer-B4 on 512x512 frames in bf16, with random weights made from a
seed. Phases, in order; any failure raises and the process exits non-zero:

  1. device   a CUDA card is present; print its nvidia-smi name and power
              limit.
  2. build    build the CUDA kernels from csrc/ (nvcc, one process per
              source, first use); clear TF32 for cuDNN and matmul so the
              float32 plain versions are true float32.
  3. kernels  each of the five kernels against its plain PyTorch version on
              the card, at the paths' shapes: K1 coupling and K2 transition
              (batch 2, forward and inverse, float32 and bf16, float32
              round trip), K3 half-res transition at the 640x360 shapes
              (the same, plus K2 == K3 on unshuffled streams bit for bit),
              K4 attention at the SegFormer shapes and one ragged N, K5
              depthwise conv + GELU at the four MixFFN widths.
  4. global   StyleModel.random_init -> style factors from one 512x512
              style image -> make_fused_video_fn(out_u8=True) on 2 batches
              of 4 frames, with launch counts and the fidelity gates; then
              the interp variant and ARTISTIC_CONFIG.
  5. masked   Segmenter.load(None) (B4 depths) -> prepare_masked_style ->
              make_masked_fused_video_fn(out_u8=True, seg_half=True) on 2
              batches of 4 frames, with launch counts per batch (K1 60,
              K2 4, K4 3, K5 41) and the gates: kernel-route logits against
              the plain bf16 route's, mask agreement, bf16 kernel route
              against the float32 plain route on the same masks; then once
              with the segmenter at 256x256 (no K4: under the routing
              threshold) and once on 640x360 frames (K3 in place of K2).
  6. timings  each kernel against its plain version (and, for K4, against
              scaled_dot_product_attention) at batch 8 in bf16, beside its
              bound; K2 against K3 at the 640x360 shapes; SegFormer-B4
              alone; both programs' frames/s and the masked program's
              stages, with CUDA events.

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
# flip in h1/h2 and one in the output rounding. The attention kernel (K4)
# rounds its probabilities to bf16 before P.V: a flipped probability moves
# the output by far less than an ulp of its scale, and the same two ulps
# are allowed. The depthwise conv + GELU kernel (K5) rounds once: one ulp.
BF16_ULPS = 2
K5_ULPS = 1
ROUND_TRIP_TOL = 1e-5
# Gates of phase 5, on seeded random weights. The kernel route and the
# plain bf16 route of the segmenter share one dtype chain, so they differ
# by bf16 rounding flips carried through 41 blocks: the logits must agree
# within 5 % of their largest magnitude and the masks on 99 % of the pixels.
LOGIT_REL_TOL = 0.05
MASK_AGREE = 0.99
PSNR_GATE = 40.0

# Published peaks of the H100 SXM (NVIDIA's data sheet): HBM3 bytes/s,
# dense bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12

# (name, C, H, W, launches per encode) of the coupling kernel and of the
# transition kernel (full-res size) at 512x512 PHOTO_CONFIG; K3 at 640x360
K1_SHAPES = [("stage1", 16, 512, 512, 10), ("stage2", 64, 256, 256, 9),
             ("stage3", 256, 128, 128, 9), ("reduction", 256, 128, 128, 2)]
K2_SHAPES = [("T1", 16, 512, 512, 1), ("T2", 64, 256, 256, 1)]
K3_SHAPES = [("T1", 16, 360, 640, 1), ("T2", 64, 180, 320, 1)]
# (name, G, N, M, launches per segment call) of the attention kernel:
# stage 1 of 512x512 frames (G = batch), stages 1 and 2 of 1024x1024 frames
K4_SHAPES = [("512 s1", 1, 16384, 256, 3), ("1024 s1", 1, 65536, 1024, 3),
             ("1024 s2", 2, 16384, 1024, 8)]
# the same shapes at the batch of the masked path, and one whose N is no
# multiple of any query tile and whose M is no multiple of the key chunk
K4_CHECKS = [("512 s1", 4, 16384, 256), ("1024 s1", 1, 65536, 1024),
             ("1024 s2", 2, 16384, 1024), ("ragged", 2, 9001, 250)]
# (name, hidden C, H, W, launches per segment call) of the MixFFN kernel at
# 512x512 frames, SegFormer-B4 depths 3/8/27/3
K5_SHAPES = [("s1", 256, 128, 128, 3), ("s2", 512, 64, 64, 8),
             ("s3", 1280, 32, 32, 27), ("s4", 2048, 16, 16, 3)]

KERNELS = {
    "coupling": ("vstnet_tpu_torch/csrc/coupling.cu",
                 "vstnet_tpu/ops/coupling_flat.py:523"),
    "transition": ("vstnet_tpu_torch/csrc/transition.cu",
                   "vstnet_tpu/ops/coupling_flat.py:738"),
    "transition_half": ("vstnet_tpu_torch/csrc/transition.cu",
                        "vstnet_tpu/ops/coupling_flat.py:466"),
    "attention": ("vstnet_tpu_torch/csrc/attention.cu",
                  "vstnet_tpu/ops/attention.py:62"),
    "dwconv_gelu": ("vstnet_tpu_torch/csrc/dwconv.cu",
                    "vstnet_tpu/ops/dwconv.py:112"),
}


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


def _bf16_tol(ref, ulps=BF16_ULPS):
    scale = float(ref.float().abs().max())
    return ulps * 2.0 ** (math.floor(math.log2(scale)) - 7)


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _psnr(a, b):
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def _dt(dt):
    return str(dt)[6:]


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


def _time_pair(kernel, plain, iters=10):
    """Kernel and plain version in turns (plain, kernel, kernel, plain);
    the smaller of each pair."""
    p0 = _time_ms(plain, iters)
    k0 = _time_ms(kernel, iters)
    k1 = _time_ms(kernel, iters)
    p1 = _time_ms(plain, iters)
    return min(k0, k1), min(p0, p1)


def _bound(nbytes, flops, peak_flops=PEAK_BF16):
    """(ms, "bytes" | "operations"): the least time the card could take,
    each input read once and each output written once against the
    operations at the peak rate of their type."""
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _branch_flops(b, c_in, mid, c_out, pixels):
    """Multiply-adds x 2 of the three 3x3 convs at `pixels` output pixels."""
    return 2.0 * 9 * (c_in * mid + mid * mid + mid * c_out) * b * pixels


def bound_coupling(b, c, h, w, esize=2):
    """K1: x1, x2 read, out written; C -> C/4 -> C/4 -> C."""
    return _bound(3.0 * b * c * h * w * esize,
                  _branch_flops(b, c, c // 4, c, h * w))


def bound_transition(b, c, h, w, streams, esize=2):
    """K2 (4 streams: x1, x2 read, two outputs written) and K3 (3 streams:
    a, b read, one output written) at a full-res (h, w), C -> C -> C -> 4C
    on the half-res pixels."""
    return _bound(float(streams) * b * c * h * w * esize,
                  _branch_flops(b, c, c, 4 * c, (h // 2) * (w // 2)))


def bound_attention(g, n, m, d=64, esize=2):
    """K4: q read, o written, k and v read; 4 N M D operations."""
    return _bound(2.0 * g * (n + m) * d * esize, 4.0 * g * n * m * d)


def bound_dwconv(b, h, w, c):
    """K5: x read, out written in bf16, taps and bias in float32; nine
    multiply-adds, the bias and about 10 operations of GELU per element,
    float32 outside the tensor cores."""
    return _bound(4.0 * b * h * w * c + 40.0 * c, 29.0 * b * h * w * c,
                  PEAK_F32)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _check(label, got, ref, tol, worst=None, key=None):
    err = _max_err(got, ref)
    print(f"{label}: max abs err {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{label}: {err} > {tol}")
    if worst is not None:
        worst[key] = max(worst[key], err)


def phase_kernels(cf, att, dw, device, gen):
    """Kernel vs plain on the card; returns max bf16 error per kernel."""
    from vstnet_tpu_torch.ops.coupling import pixel_shuffle, pixel_unshuffle

    worst = dict.fromkeys(KERNELS, 0.0)
    bf = torch.bfloat16
    for name, c, h, w, _ in K1_SHAPES:
        branch = _rand_branch(gen, c, c // 4, c, device)
        for dt in (torch.float32, bf):
            wp = cf.pack_coupling_weights(branch, dt)
            x1 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            x2 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            for inv in (False, True):
                got = cf.fused_coupling(x1, x2, wp, inverse=inv)
                ref = cf.coupling_block_plain(x1, x2, wp, inverse=inv)
                torch.cuda.synchronize()
                tol = F32_TOL if dt == torch.float32 else _bf16_tol(ref)
                _check(f"K1 {name} C={c} {h}x{w} {_dt(dt)} "
                       f"{'inv' if inv else 'fwd'}", got, ref, tol,
                       worst if dt == bf else None, "coupling")
            if dt == torch.float32:
                y = cf.fused_coupling(x1, x2, wp)
                back = cf.fused_coupling(y, x2, wp, inverse=True)
                _check(f"K1 {name} f32 round trip", back, x1, ROUND_TRIP_TOL)
    for name, c, h, w, _ in K2_SHAPES:
        branch = _rand_branch(gen, c, c, 4 * c, device)
        for dt in (torch.float32, bf):
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
                _check(f"K2 {name} C={c} {h}x{w} {_dt(dt)} {what}", got, ref,
                       tol, worst if dt == bf else None, "transition")
            if not (torch.equal(g0, r0) and torch.equal(i1, j1)):
                raise AssertionError(f"K2 {name}: (un)shuffled copy differs")
            if dt == torch.float32:
                k0, k1 = cf.fused_transition(g1, g0, wp, inverse=True)
                _check(f"K2 {name} f32 round trip", k0, x1, ROUND_TRIP_TOL)
                if not torch.equal(k1, x2):
                    raise AssertionError(f"K2 {name}: x2 not restored")
    for name, c, h, w, _ in K3_SHAPES:
        branch = _rand_branch(gen, c, c, 4 * c, device)
        for dt in (torch.float32, bf):
            wp = cf.pack_transition_weights(branch, dt)
            x1 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            x2 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            a_u = pixel_unshuffle(x1).contiguous()
            b_u = pixel_unshuffle(x2).contiguous()
            g0, g1 = cf.fused_transition_half(a_u, b_u, wp)
            r0, r1 = cf.transition_half_plain(a_u, b_u, wp)
            i0, i1 = cf.fused_transition_half(g1, g0, wp, inverse=True)
            j0, j1 = cf.transition_half_plain(g1, g0, wp, inverse=True)
            k0, k1 = cf.fused_transition(x1, x2, wp)
            f0, f1 = cf.fused_transition(k1, k0, wp, inverse=True)
            torch.cuda.synchronize()
            tol = F32_TOL if dt == torch.float32 else _bf16_tol(r1)
            tag = f"K3 {name} C_u={4 * c} {h // 2}x{w // 2} {_dt(dt)}"
            for what, got, ref in (("fwd", g1, r1), ("inv", i0, j0)):
                _check(f"{tag} {what}", got, ref, tol,
                       worst if dt == bf else None, "transition_half")
            if not (g0 is b_u and i1 is g0):
                raise AssertionError(f"{tag}: pass-through stream copied")
            same = (torch.equal(k0, g0) and torch.equal(k1, g1)
                    and torch.equal(f0, pixel_shuffle(i0))
                    and torch.equal(f1, pixel_shuffle(i1)))
            print(f"{tag}: K2(x1, x2) == K3(u(x1), u(x2)) bit for bit, "
                  f"forward and inverse: {same}")
            if not same:
                raise AssertionError(f"{tag}: K2 and K3 differ")
            if dt == torch.float32:
                _check(f"{tag} round trip", i0, a_u, ROUND_TRIP_TOL)
    for name, g, n, m in K4_CHECKS:
        q, k, v = (torch.randn(s, generator=gen).to(device, bf)
                   for s in ((g, n, 64), (g, m, 64), (g, m, 64)))
        got = att.sr_attention(q, k, v, 0.125)
        ref = att.sr_attention_plain(q, k, v, 0.125)
        torch.cuda.synchronize()
        _check(f"K4 {name} G={g} N={n} M={m} bf16", got, ref, _bf16_tol(ref),
               worst, "attention")
    for name, c, h, w, _ in K5_SHAPES:
        x = torch.randn((2, h, w, c), generator=gen).to(device, bf)
        taps = (torch.randn((3, 3, c), generator=gen) / 3).to(device)
        bias = (torch.randn((c,), generator=gen) * 0.1).to(device)
        got = dw.dwconv3x3_bias_gelu(x, taps, bias)
        ref = dw.dwconv3x3_bias_gelu_plain(x, taps, bias)
        torch.cuda.synchronize()
        _check(f"K5 {name} C={c} {h}x{w} bf16", got, ref,
               _bf16_tol(ref, K5_ULPS), worst, "dwconv_gelu")
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the global video path
# ---------------------------------------------------------------------------

def _frames(gen, n, hw, device):
    """Smooth image-like frames in [0,1]: bilinear-upsampled noise."""
    h, w = (hw, hw) if isinstance(hw, int) else hw
    small = torch.rand((n, 3, h // 16, w // 16), generator=gen)
    x = torch.nn.functional.interpolate(small, size=(h, w), mode="bilinear",
                                        align_corners=False)
    x = x + 0.05 * torch.rand((n, 3, h, w), generator=gen)
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


def _add(total, counts):
    for k, v in counts.items():
        total[k] += v


def phase_global(ops, device, gen, total):
    from vstnet_tpu_torch import ARTISTIC_CONFIG, PHOTO_CONFIG
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.models.pipeline import StyleModel, make_fused_video_fn

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
    batches = [_frames(gen, 4, 512, device) for _ in range(2)]
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    outs = []
    for frames in batches:
        before = ops.launch_counts()
        outs.append(video(fast, frames, ls, mu))
        after = ops.launch_counts()
        d = {k: after[k] - before[k] for k in after}
        if (d["coupling"], d["transition"]) != (60, 4):
            raise AssertionError(f"launches per batch {d}, want 60 coupling "
                                 "and 4 transition (30 + 2 per encode and "
                                 "per decode)")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _add(total, counts)
    print(f"global: 2 batches of 4 frames, launches {counts}")
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
    if not p >= PSNR_GATE:
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
        print(f"gate round trip {_dt(dt)}: PSNR {p:.2f} dB (> {bar})")
        if not p > bar:
            raise AssertionError(f"round trip {dt}: {p}")

    # interp variant at alpha_c = 0.5
    got = make_fused_video_fn(cfg, interp=True)(fast, frames, ls, mu, 0.5)
    p = _psnr(got, _plain_video(model, frames, style, alpha_c=0.5))
    print(f"interp alpha_c=0.5: PSNR {p:.2f} dB vs f32 plain (>= 40)")
    if not p >= PSNR_GATE:
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
    if tuple(got.shape) != (2, 512, 512, 3) or not p >= PSNR_GATE:
        raise AssertionError(f"artistic: {tuple(got.shape)} {p}")
    return model, style


# ---------------------------------------------------------------------------
# Phase 5: the masked (auto-seg) video path
# ---------------------------------------------------------------------------

class _plain_segformer_kernels:
    """Within the block the segmenter's two kernel call sites run the
    kernels' plain versions: the plain bf16 route, same dtype chain."""

    def __enter__(self):
        from vstnet_tpu_torch.models import segformer as sf
        from vstnet_tpu_torch.ops import attention, dwconv

        self.sf = sf
        self.saved = sf.sr_attention, sf.dwconv3x3_bias_gelu
        sf.sr_attention = attention.sr_attention_plain
        sf.dwconv3x3_bias_gelu = dwconv.dwconv3x3_bias_gelu_plain

    def __exit__(self, *exc):
        self.sf.sr_attention, self.sf.dwconv3x3_bias_gelu = self.saved


def _plain_masked(model, style, smask, frames, masks):
    """The float32 plain route of the masked program on given masks:
    standard-path encode/decode (plain torch convs) around the float32
    regional cWCT."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models.pipeline import _mask_to_latent

    z_s = model.net.encode(style)
    sm_lat = _mask_to_latent(smask, z_s.shape)
    region = cwct.style_region_factors(
        z_s, sm_lat, max_labels=cwct.label_capacity(sm_lat))
    z_c = model.net.encode(frames)
    z_cs = cwct.transfer_masked_factored(
        z_c, _mask_to_latent(masks, z_c.shape), *region)
    return model.net.decode(z_cs).clamp(0, 1)


def phase_masked(ops, model, style, device, gen, total):
    from vstnet_tpu_torch import PHOTO_CONFIG
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.models import segformer as sf
    from vstnet_tpu_torch.models.pipeline import (
        make_masked_fused_video_fn,
        prepare_masked_style,
    )
    from vstnet_tpu_torch.ops.attention import MIN_Q

    cfg = PHOTO_CONFIG
    fast = model.fast_params
    seg = sf.Segmenter.load(None, seed=0, device=device)
    if seg.net.depths != sf.DEPTHS:
        raise AssertionError(f"segmenter depths {seg.net.depths}")
    region, plan, smask = prepare_masked_style(fast, seg, style, cfg)
    style_labels = set(torch.unique(smask).tolist())
    k_cap = region[0].shape[0]
    print(f"masked: style labels {sorted(style_labels)}, capacity {k_cap}")
    cwct.host_check_finite(region[3], "style region covariance")
    video = make_masked_fused_video_fn(cfg, out_u8=True, seg_hw=None,
                                       seg_half=True)
    batches = [_frames(gen, 4, 512, device) for _ in range(2)]
    torch.cuda.synchronize()

    def run(fn, frames, want, what):
        before = ops.launch_counts()
        out, masks = fn(fast, seg.net, seg.label_mapping, region, plan,
                        frames)
        after = ops.launch_counts()
        d = {k: after[k] - before[k] for k in after}
        if d != want:
            raise AssertionError(f"{what}: launches per batch {d}, want "
                                 f"{want}")
        return out, masks

    want = {"coupling": 60, "transition": 4, "transition_half": 0,
            "attention": 3, "dwconv_gelu": 41}
    ops.reset_launch_counts()
    outs = [run(video, frames, want, "masked 512x512") for frames in batches]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _add(total, counts)
    print(f"masked: 2 batches of 4 frames at 512x512, launches {counts}")
    for out, masks in outs:
        if (out.dtype != torch.uint8 or tuple(out.shape) != (4, 512, 512, 3)
                or masks.dtype != torch.int32
                or tuple(masks.shape) != (4, 512, 512)):
            raise AssertionError(f"output {out.dtype} {tuple(out.shape)}, "
                                 f"masks {masks.dtype} {tuple(masks.shape)}")
        extra = set(torch.unique(masks).tolist()) - style_labels
        if extra:
            raise AssertionError(f"mask labels {extra} are not the style's")
    frames, masks = batches[0], outs[0][1]
    print(f"masked: frame labels {torch.unique(masks).tolist()}")

    # the segmenter: kernel route vs plain bf16 route
    logits = sf.segment_logits(seg.net, frames, half=True)
    with _plain_segformer_kernels():
        before = ops.launch_counts()
        logits_p = sf.segment_logits(seg.net, frames, half=True)
        if ops.launch_counts() != before:
            raise AssertionError("the plain route launched a kernel")
    cwct.host_check_finite(logits, "segmenter logits")
    scale = float(logits_p.abs().max())
    err = _max_err(logits, logits_p)
    agree = float((logits.argmax(-1) == logits_p.argmax(-1)).float().mean())
    print(f"gate segmenter kernel vs plain bf16 route: logits max abs err "
          f"{err:.3e} at scale {scale:.3e} (<= {LOGIT_REL_TOL} of it), mask "
          f"agreement {agree:.5f} (>= {MASK_AGREE})")
    if not (err <= LOGIT_REL_TOL * scale and agree >= MASK_AGREE):
        raise AssertionError(f"segmenter routes disagree: {err} {agree}")

    # bf16 kernel route vs float32 plain route, the kernel route's masks
    got, _ = make_masked_fused_video_fn(cfg, seg_half=True)(
        fast, seg.net, seg.label_mapping, region, plan, frames)
    cwct.host_check_finite(got)
    ref = _plain_masked(model, style, smask, frames, masks)
    p = _psnr(got, ref)
    print(f"gate masked bf16 kernel vs f32 plain: PSNR {p:.2f} dB (>= 40)")
    if not p >= PSNR_GATE:
        raise AssertionError(f"masked bf16 PSNR {p}")
    if _max_err(outs[0][0].float() / 255.0, got) > 0.5 / 255.0 + 1e-6:
        raise AssertionError("uint8 output disagrees with the float output")
    changed = float((got - frames).abs().mean())
    print(f"masked: mean |stylized - frame| {changed:.4f}")
    if not changed > 1e-3:
        raise AssertionError("the regional transfer changed nothing")

    # the segmenter at 256x256: under the routing threshold, no K4
    small = make_masked_fused_video_fn(cfg, out_u8=True, seg_hw=(256, 256))
    ops.reset_launch_counts()
    out, m256 = run(small, frames, dict(want, attention=0), "seg 256x256")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _add(total, counts)
    agree = float((m256 == masks).float().mean())
    print(f"masked seg_hw=(256, 256): launches {counts}: attention is 0, "
          f"4096 queries are under the routing threshold of {MIN_Q}; masks "
          f"agree with native on {agree:.4f}")
    if tuple(m256.shape) != (4, 512, 512) or out.dtype != torch.uint8:
        raise AssertionError(f"seg 256: {tuple(m256.shape)} {out.dtype}")

    # 640x360 frames: half-res widths 320 and 160 take K3, not K2
    wide = _frames(gen, 2, (360, 640), device)
    ops.reset_launch_counts()
    z = rf.encode_fast(fast, wide.to(torch.bfloat16), cfg)
    enc = ops.launch_counts()
    rf.decode_fast(fast, z, cfg)
    dec = {k: v - enc[k] for k, v in ops.launch_counts().items()}
    for what, d in (("encode", enc), ("decode", dec)):
        if (d["coupling"], d["transition"], d["transition_half"]) != (
                30, 0, 2):
            raise AssertionError(f"640x360 {what}: launches {d}")
    ops.reset_launch_counts()
    out, mw = run(video, wide, dict(want, transition=0, transition_half=4),
                  "masked 640x360")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _add(total, counts)
    print(f"masked 640x360 batch 2: launches {counts} (K3 2 per encode and "
          f"2 per decode, K2 0)")
    if (tuple(out.shape) != (2, 360, 640, 3)
            or set(torch.unique(mw).tolist()) - style_labels):
        raise AssertionError(f"640x360: {tuple(out.shape)}")
    got, _ = make_masked_fused_video_fn(cfg)(
        fast, seg.net, seg.label_mapping, region, plan, wide)
    p = _psnr(got, _plain_masked(model, style, smask, wide, mw))
    print(f"gate masked 640x360 bf16 kernel vs f32 plain: PSNR {p:.2f} dB "
          f"(>= 40)")
    if not p >= PSNR_GATE:
        raise AssertionError(f"masked 640x360 PSNR {p}")
    return seg, region, plan


# ---------------------------------------------------------------------------
# Phase 6: timings
# ---------------------------------------------------------------------------

def _line(kernel, name, shape, tk, tp, bound, lib=None):
    bms, by = bound
    lib_s = "" if lib is None else f", library {lib:.3f} ms"
    print(f"time {kernel} {name} {shape} bf16: kernel {tk:.3f} ms, plain "
          f"{tp:.3f} ms{lib_s}, bound {bms:.4f} ms ({by})")


def phase_timings(cf, att, dw, device, gen, batch=8):
    """Per-launch times at batch 8 in bf16. Returns per kernel
    {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}: the sums over
    the launches of one encode (K1, K2 at 512x512; K3 at 640x360) or of
    one segment call at 512x512 (K4, K5)."""
    from vstnet_tpu_torch.ops.coupling import pixel_shuffle, pixel_unshuffle

    bf = torch.bfloat16
    rec = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
               "bound_ms": 0.0, "library_ms": None} for k in KERNELS}

    def tally(kernel, count, tk, tp, bound, lib=None):
        r = rec[kernel]
        r["ms"] += count * tk
        r["plain_ms"] += count * tp
        r["bound_ms"] += count * bound[0]
        r["bytes_ms" if bound[1] == "bytes" else "ops_ms"] += count * bound[0]
        if lib is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + count * lib

    def pair(c, h, w):
        return (torch.randn((batch, c, h, w), generator=gen).to(device, bf),
                torch.randn((batch, c, h, w), generator=gen).to(device, bf))

    for name, c, h, w, count in K1_SHAPES:
        wp = cf.pack_coupling_weights(
            _rand_branch(gen, c, c // 4, c, device), bf)
        x1, x2 = pair(c, h, w)
        tk, tp = _time_pair(lambda: cf.fused_coupling(x1, x2, wp),
                            lambda: cf.coupling_block_plain(x1, x2, wp))
        bound = bound_coupling(batch, c, h, w)
        _line("coupling", name, f"C={c} {h}x{w} B={batch}", tk, tp, bound)
        tally("coupling", count, tk, tp, bound)
    for name, c, h, w, count in K2_SHAPES:
        wp = cf.pack_transition_weights(
            _rand_branch(gen, c, c, 4 * c, device), bf)
        x1, x2 = pair(c, h, w)
        tk, tp = _time_pair(lambda: cf.fused_transition(x1, x2, wp),
                            lambda: cf.transition_block_plain(x1, x2, wp))
        bound = bound_transition(batch, c, h, w, 4)
        _line("transition", name, f"C={c} {h}x{w} B={batch}", tk, tp, bound)
        tally("transition", count, tk, tp, bound)
    # K3 at the 640x360 shapes, and both entries on the same frames: the
    # caller's pixel (un)shuffle copies are part of the half-res entry
    for name, c, h, w, count in K3_SHAPES:
        wp = cf.pack_transition_weights(
            _rand_branch(gen, c, c, 4 * c, device), bf)
        x1, x2 = pair(c, h, w)
        a_u = pixel_unshuffle(x1).contiguous()
        b_u = pixel_unshuffle(x2).contiguous()
        tk, tp = _time_pair(
            lambda: cf.fused_transition_half(a_u, b_u, wp),
            lambda: cf.transition_half_plain(a_u, b_u, wp))
        bound = bound_transition(batch, c, h, w, 3)
        _line("transition_half", name,
              f"C_u={4 * c} {h // 2}x{w // 2} B={batch}", tk, tp, bound)
        tally("transition_half", count, tk, tp, bound)

        def k3_forward():
            return cf.fused_transition_half(
                pixel_unshuffle(x1).contiguous(),
                pixel_unshuffle(x2).contiguous(), wp)

        def k3_inverse():
            y0, y1 = cf.fused_transition_half(a_u, b_u, wp, inverse=True)
            return (pixel_shuffle(y0).contiguous(),
                    pixel_shuffle(y1).contiguous())

        f3, f2 = _time_pair(k3_forward,
                            lambda: cf.fused_transition(x1, x2, wp))
        i3, i2 = _time_pair(
            k3_inverse,
            lambda: cf.fused_transition(a_u, b_u, wp, inverse=True))
        print(f"time entries {name} C={c} {h}x{w} B={batch} bf16: forward "
              f"K2 {f2:.3f} ms, K3 + unshuffle {f3:.3f} ms; inverse K2 "
              f"{i2:.3f} ms, K3 + shuffle {i3:.3f} ms")
    for name, g, n, m, count in K4_SHAPES:
        g = g * batch if name == "512 s1" else g
        q, k, v = (torch.randn(s, generator=gen).to(device, bf)
                   for s in ((g, n, 64), (g, m, 64), (g, m, 64)))
        tk, tp = _time_pair(lambda: att.sr_attention(q, k, v, 0.125),
                            lambda: att.sr_attention_plain(q, k, v, 0.125))
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        lib = _time_ms(lambda: torch.nn.functional.
                       scaled_dot_product_attention(q4, k4, v4, scale=0.125))
        bound = bound_attention(g, n, m)
        _line("attention", name, f"G={g} N={n} M={m}", tk, tp, bound, lib)
        if name == "512 s1":
            tally("attention", count, tk, tp, bound, lib)
    for name, c, h, w, count in K5_SHAPES:
        x = torch.randn((batch, h, w, c), generator=gen).to(device, bf)
        taps = (torch.randn((3, 3, c), generator=gen) / 3).to(device)
        bias = (torch.randn((c,), generator=gen) * 0.1).to(device)
        tk, tp = _time_pair(
            lambda: dw.dwconv3x3_bias_gelu(x, taps, bias),
            lambda: dw.dwconv3x3_bias_gelu_plain(x, taps, bias))
        bound = bound_dwconv(batch, h, w, c)
        _line("dwconv_gelu", name, f"C={c} {h}x{w} B={batch}", tk, tp, bound)
        tally("dwconv_gelu", count, tk, tp, bound)
    for r in rec.values():
        r["bound_by"] = ("bytes" if r.pop("bytes_ms") >= r.pop("ops_ms")
                         else "operations")
    return rec


def phase_programs(model, style, seg, region, plan, device, gen, batch=8):
    """SegFormer-B4 alone, both programs' frames/s and the masked
    program's stages, bf16, with CUDA events."""
    from vstnet_tpu_torch import PHOTO_CONFIG
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.models import segformer as sf
    from vstnet_tpu_torch.models.pipeline import (
        _mask_to_latent,
        make_fused_video_fn,
        make_masked_fused_video_fn,
    )
    from vstnet_tpu_torch.models.remapping import video_remap

    cfg = PHOTO_CONFIG
    bf = torch.bfloat16
    fast = model.fast_params
    frames = _frames(gen, batch, 512, device)
    big = _frames(gen, 1, 1024, device)
    for x, what in ((frames, f"512x512 B={batch}"), (big, "1024x1024 B=1")):
        def segment():
            return sf.segment_mask(seg.net, x, half=True)

        def segment_plain():
            with _plain_segformer_kernels():
                return sf.segment_mask(seg.net, x, half=True)

        ms, ms_p = _time_pair(segment, segment_plain, iters=3)
        # the host's share: the time the Python side takes to enqueue one
        # call's launches with the device already idle
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segment()
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        print(f"time SegFormer-B4 bf16 {what}: kernel route {ms:.2f} ms, "
              f"plain route {ms_p:.2f} ms; the host enqueues one call's "
              f"launches in {enqueue:.2f} ms")

    zs = rf.encode_fast(fast, style.to(bf), cfg, packed_latent=True)
    ls, mu = cwct.style_factors_packed(zs, cfg.latent_channels)
    video = make_fused_video_fn(cfg, out_u8=True)
    ms = _time_ms(lambda: video(fast, frames, ls, mu), iters=5, warmup=2)
    print(f"time global program PHOTO 512x512 bf16 B={batch}: {ms:.2f} ms "
          f"per batch, {batch * 1000.0 / ms:.2f} frames/s")
    masked = make_masked_fused_video_fn(cfg, out_u8=True)
    args = (fast, seg.net, seg.label_mapping, region, plan, frames)
    ms = _time_ms(lambda: masked(*args), iters=3, warmup=1)
    print(f"time masked program PHOTO + SegFormer-B4 512x512 bf16 "
          f"B={batch}: {ms:.2f} ms per batch, {batch * 1000.0 / ms:.2f} "
          f"frames/s")

    # the masked program's stages, each timed alone on the same batch
    cm_raw = sf.segment_mask(seg.net, frames, half=True)
    cm = video_remap(cm_raw, *plan, seg.label_mapping, 0.02)
    z_c = rf.encode_fast(fast, frames.to(bf), cfg)
    cm_lat = _mask_to_latent(cm, z_c.shape)
    z_cs = cwct.transfer_masked_factored(z_c, cm_lat, *region)
    stages = {
        "segmenter": lambda: sf.segment_mask(seg.net, frames, half=True),
        "remap": lambda: video_remap(cm_raw, *plan, seg.label_mapping, 0.02),
        "encode": lambda: rf.encode_fast(fast, frames.to(bf), cfg),
        "regional cWCT": lambda: cwct.transfer_masked_factored(
            z_c, cm_lat, *region),
        "decode": lambda: rf.decode_fast(fast, z_cs, cfg),
    }
    times = {k: _time_ms(fn, iters=3, warmup=1) for k, fn in stages.items()}
    whole = sum(times.values())
    print("time masked program stages 512x512 bf16 B=%d: %s (sum %.2f ms)" % (
        batch, ", ".join(f"{k} {v:.2f} ms ({100 * v / whole:.1f} %)"
                         for k, v in times.items()), whole))

    # peak memory of the regional cWCT at the largest capacity bucket used
    # for video (K = 32): the style statistics padded with absent labels
    k = 32
    pad = k - region[0].shape[0]
    if pad > 0:
        labels = torch.cat([region[0], region[0].new_full((pad,), -1)])
        ns = torch.cat([region[1], region[1].new_zeros(pad)])
        mean = torch.cat([region[2], region[2].new_zeros(pad, 32)])
        cov = torch.cat([region[3], torch.eye(32, device=device).expand(
            pad, 32, 32)])
        wide = (labels, ns, mean, cov)
    else:
        wide = region
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(lambda: cwct.transfer_masked_factored(z_c, cm_lat, *wide),
                  iters=2, warmup=1)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"regional cWCT 512x512 bf16 B={batch} K={wide[0].shape[0]}: "
          f"{ms:.2f} ms, peak memory {peak / 2 ** 20:.1f} MiB above the "
          f"{base / 2 ** 20:.1f} MiB already held")


def main():
    smi = _require_card()
    from vstnet_tpu_torch import ops
    from vstnet_tpu_torch.ops import _build
    from vstnet_tpu_torch.ops import attention as att
    from vstnet_tpu_torch.ops import coupling_fused as cf
    from vstnet_tpu_torch.ops import dwconv as dw

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
    worst = phase_kernels(cf, att, dw, device, gen)
    print(f"phase kernels done at {time.perf_counter() - t0:.1f} s")
    # launches of the main paths only: every count is set to 0 just before
    # a path is driven and read just after
    total = dict.fromkeys(KERNELS, 0)
    model, style = phase_global(ops, device, gen, total)
    print(f"phase global done at {time.perf_counter() - t0:.1f} s")
    seg, region, plan = phase_masked(ops, model, style, device, gen, total)
    print(f"phase masked done at {time.perf_counter() - t0:.1f} s")
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{missing}")
    rec = phase_timings(cf, att, dw, device, gen)
    phase_programs(model, style, seg, region, plan, device, gen)
    print(f"phase timings done at {time.perf_counter() - t0:.1f} s")

    record = {"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": total[k],
         "max_abs_err": worst[k], **rec[k]} for k in KERNELS]}
    print("kernels: launches are those of the main paths' runs (global 2 "
          "batches, masked 2 batches, seg 256 and 640x360 one each); ms, "
          "plain_ms, bound_ms and library_ms are sums over the launches of "
          "one encode at bf16 B=8 (coupling 30 and transition 2 at 512x512, "
          "transition_half 2 at 640x360) or of one segment call at 512x512 "
          "B=8 (attention 3, dwconv_gelu 41); bound_ms sums each launch's "
          "bound and bound_by names the kind that holds the larger share; "
          "max_abs_err is the largest bf16 kernel-vs-plain error of phase 3")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
