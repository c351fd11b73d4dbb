"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

Drives the port's two video paths (vstnet_tpu_torch), its two CLIs, the
ultra-resolution tiler, the HTTP style service and the trainer through the
entry points a user calls, at the full width and depth of PHOTO_CONFIG and
SegFormer-B4 (512x512 frames in bf16, 1280x720 clips, 3840x2160 images,
1280x720 and 960x540 requests, 256x256 training crops), with random
weights made from a seed. Phases, in
order; any failure raises and the process exits non-zero:

  1. device   a CUDA card is present; print its nvidia-smi name and power
              limit.
  2. build    build the CUDA kernels from csrc/ (nvcc, one process per
              source, first use); clear TF32 for cuDNN and matmul so the
              float32 plain versions are true float32.
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the paths' shapes: K1 coupling and K2 transition (batch 2,
              forward and inverse, float32 on the CUDA-core kernels with a
              float32 round trip, bf16 on the tensor-core kernels, checked
              also at sizes with tails and with H or W below the tile, and
              inverse(forward(x)) against x), K3 half-res transition at the
              640x360 shapes (the same, plus K2 == K3 on unshuffled streams
              bit for bit, also at the ragged sizes), K4 attention at
              the SegFormer shapes, one ragged shape and one with M = 4096,
              K5 depthwise conv + GELU at the four MixFFN shapes of 512x512
              and of 1024x1024 frames and at one ragged shape, each printed
              with whether it equals its plain version bit for bit.
  4. global   StyleModel.random_init -> style factors from one 512x512
              style image -> make_fused_video_fn(out_u8=True) on 2 batches
              of 4 frames in bf16 (K1 and K2 on the tensor cores) and one in
              float32 (both on the CUDA cores), then 2 float32 frames at
              640x360 (K3 on the CUDA cores), with launch counts and the
              fidelity gates;
              then the interp variant and ARTISTIC_CONFIG.
  5. masked   Segmenter.load(None) (B4 depths) -> prepare_masked_style ->
              make_masked_fused_video_fn(out_u8=True, seg_half=True) on 2
              batches of 4 frames, with launch counts per batch (K1 60,
              and K2 4, all on the tensor cores, K4 3, K5 41) and the gates:
              kernel-route logits against the plain bf16 route's, mask
              agreement on the pixels the plain route decides by more than
              a bf16 ulp, bf16 kernel route against the float32 plain route
              on the same masks; then once
              with the segmenter at 256x256 (no K4: under the routing
              threshold) and once on 640x360 frames (K3 in place of K2).
  6. timings  each kernel against its plain version (and, for K4, against
              scaled_dot_product_attention) at batch 8 in bf16, beside its
              bound, with the route each K1 shape took; the CUDA-core K1,
              K2 and K3 kernels in float32; K2 against K3 with the caller's
              (un)shuffle at the 512x512 and the 640x360 shapes; K5 by
              CUDA-graph replay (its device time: called eagerly, the
              wrapper's host time is the larger at the small shapes), also
              at the 1024x1024 shapes, beside cuDNN's depthwise conv + GELU
              as a yardstick; SegFormer-B4 alone (CUDA events, and one call
              under torch.profiler for its device time and idle share);
              both programs' frames/s and the masked program's stages,
              with CUDA events.
  7. cli      (run after phase 5; phases 7-10 before the timings) the
              command-line entry points as a user runs them, on synthetic
              files: the video CLI on a 16-frame 1280x720 MJPEG clip,
              --batch 8, the default --max_size 1280, in bf16 global
              (twice), --alpha_c 0.5, --auto_seg --seg_size -1 and f32,
              then on an 8-frame
              640x360 clip in bf16 and f32; every bf16 batch launches
              coupling_mma 60 and the stride-2 blocks' kernels (auto-seg:
              and one segment call's attention and dwconv_gelu), its input
              frames equal an independent decode of the clip, and the
              frames handed to the writer equal what the video program,
              made anew, gives on the same frames and factors bit for bit;
              bf16 vs f32 >= 40 dB; the CLI's end-to-end frames/s beside
              the card's name and power limit. The image CLI on a 1024x768
              content in --fast and float32 (global, --auto_seg, --styles
              A B --alpha_s 0.3 0.7), each --fast output >= 40 dB against
              float32 (auto-seg: on the --fast run's saved masks); then
              photo_pipeline(fast=True) against photo_pipeline().
  8. ultra    (after phase 7) the tiled path on a smooth 3840x2160 content
              with a 1024x576 style: ultra.stylize_tiled in float32 at the
              exact overlap (the receptive field, rounded up to a multiple
              of 4) against whole-image StyleModel.stylize (> 55 dB), the
              fused route on the same grid against it (>= 40 dB), the
              default overlap 128 against the whole image (printed); then
              the image CLI on the 4K PNG in --fast global, --auto_seg,
              --styles A B --alpha_s 0.3 0.7, --alpha_c 0.5 and their
              float32 routes (auto-seg: float32 on the --fast run's saved
              masks), each --fast output >= 40 dB against float32, every
              tile batch's launches checked (pass 1 coupling_mma 30 and
              transition_mma 2, pass 2 60 and 4; none on float32), with
              main()'s wall seconds beside pass 1's and pass 2's device ms.
  9. serve    StyleService(fast=True) behind serve(port=0) in this
              process: one style registered, 16 concurrent requests at
              1280x720 and 8 at 960x540, every reply 200 and equal bit for
              bit to the same content sent alone, each batch's launches
              (coupling_mma 60 and the stride-2 blocks' kernels),
              requests/s, requests a batch, p50/p95 latency; a float32
              service on four of the contents >= 40 dB against the fused
              replies.
 10. train    (after phase 9; no kernel of the port lies on this path)
              the train CLI in the process, PHOTO_CONFIG at full depth,
              float32, no VGG file (seeded random VGG): 24 content and 24
              style PNGs of 600x520, B=2, 512 resizes, 256 crops, 8 image
              and 4 temporal steps, then --resume to step 16; loss.log's 16
              lines in the reference format with finite losses and
              loss_tmp > 0 in the temporal steps, model_image.pt (step 8)
              and model_video.pt (step 16) stylizing finite frames through
              StyleModel, the sample grids and index.html. loss_and_grads at
              128x128 B=2 with every term on, float32 against float64 on the
              card and bf16 against float32 (gates printed beside the
              numbers); a step resumed from last.pt equal to the
              uninterrupted one. Steps/s (CUDA events, 10 steps after 3),
              peak memory and the device's idle share of one step
              (torch.profiler) at 256x256 B=2 in both phases, float32 and
              bf16, remat on and off; 2 steps of ARTISTIC_CONFIG.

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
# flip in h1/h2 and one in the output rounding. The tensor-core kernels (K1
# in bf16 at C >= 64, K4) sum in another order than the plain versions, so
# bit identity is not expected of them. The attention kernel (K4) rounds
# its probabilities to bf16 before P.V: a flipped probability moves the
# output by far less than an ulp of its scale, and the same two ulps are
# allowed. inverse(forward(x1)) through K1 in bf16 recomputes F bit for bit,
# so x1 comes back within the roundings of y and of x1: two ulps of y's
# scale. The depthwise conv + GELU kernel (K5) rounds once: one ulp.
BF16_ULPS = 2
K5_ULPS = 1
ROUND_TRIP_TOL = 1e-5
# Gates of phase 5, on seeded random weights. The kernel route and the
# plain bf16 route of the segmenter share one dtype chain, so they differ
# by bf16 rounding flips carried through 41 blocks: the logits must agree
# within 5 % of their largest magnitude and have a cosine above 0.9999.
# The masks must agree on 99 % of the decided pixels: those where the plain
# route's best class leads its second by more than one bf16 ulp of the
# logits' scale. A smaller lead is a tie in the working dtype (random
# weights spread 150 classes over a narrow range, so there are many), and
# which side of a tie a route lands on is no property of a kernel. The run
# prints the decided share, the agreement over all pixels, and how well the
# plain bf16 route's masks agree with the float32 route's: what the working
# dtype itself moves.
LOGIT_REL_TOL = 0.05
LOGIT_COSINE = 0.9999
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
# the stride-2 blocks of 1280x720 frames, which the video CLI's default
# --max_size keeps: T1 takes K2 (half-res width 640), T2 K3 (width 320)
K23_HD = [("T1 1280x720", 16, 720, 1280, 1), ("T2 1280x720", 64, 360, 640,
                                              1)]
# (C, full-res H, W) of the tensor-core transition kernel's extra checks:
# half-res planes that cut the 16x16 tile on both axes, lie below it, are
# the smallest a reflect pad allows, or fit it exactly
K2_TAILS = [(64, 100, 136), (16, 100, 136), (64, 6, 90), (16, 4, 4),
            (16, 64, 32)]
# (C, H, W) of the tensor-core coupling kernel's extra checks: tiles cut by
# the image edge, H or W below the 16x16 tile, the 640x360 planes' 45x80
K1_TAILS = [(256, 20, 36), (256, 7, 45), (256, 45, 80), (64, 40, 36),
            (64, 9, 50), (16, 70, 33), (16, 5, 100)]
# (name, G, N, M, launches per segment call) of the attention kernel:
# stage 1 of 512x512 frames (G = batch), stages 1 and 2 of 1024x1024 frames
K4_SHAPES = [("512 s1", 1, 16384, 256, 3), ("1024 s1", 1, 65536, 1024, 3),
             ("1024 s2", 2, 16384, 1024, 8)]
# stage 1 of the segmenter at 256x256 (G = batch): under the routing
# threshold, so not on the path; timed for the record only
K4_UNROUTED = ("256 s1", 1, 4096, 64)
# the same shapes at the batch of the masked path, one whose N is no
# multiple of the query tile and whose M is no multiple of 16, and one with
# many key tiles
K4_CHECKS = [("512 s1", 4, 16384, 256), ("1024 s1", 1, 65536, 1024),
             ("1024 s2", 2, 16384, 1024), ("ragged", 2, 9001, 250),
             ("large M", 1, 8200, 4096)]
# (name, hidden C, H, W, launches per segment call) of the MixFFN kernel at
# 512x512 frames, SegFormer-B4 depths 3/8/27/3
K5_SHAPES = [("s1", 256, 128, 128, 3), ("s2", 512, 64, 64, 8),
             ("s3", 1280, 32, 32, 27), ("s4", 2048, 16, 16, 3)]
# the same at 1024x1024 frames (batch 1), and a shape whose tiles the image
# cuts on both axes and whose C is no multiple of the kernel's channel slab
K5_BIG = [("1024 s1", 256, 256, 256), ("1024 s2", 512, 128, 128),
          ("1024 s3", 1280, 64, 64), ("1024 s4", 2048, 32, 32)]
K5_RAGGED = ("ragged", 200, 23, 17)
# the tiler's batch of 4 tiles at 1024x1024 (K1 at its three widths, K2 at
# both stride-2 blocks) and the service's buckets at its largest batch:
# 960x576 (K3 at both stride-2 blocks: half-res widths 480 and 240) and
# 1280x768 (T1 K2 at half-res width 640, T2 K3 at 320). Phase 3 holds the
# kernels against their plain versions at every one of these shapes;
# phase 6 times them for the record, outside the kernels line's sums
TILE_B = 4
TILE_K1 = [("tile s1", 16, 1024, 1024), ("tile s2", 64, 512, 512),
           ("tile s3", 256, 256, 256)]
TILE_K2 = [("tile T1", 16, 1024, 1024), ("tile T2", 64, 512, 512)]
SERVE_B = 8
BUCKET_K2 = [("bucket 1280x768 T1", 16, 768, 1280)]
BUCKET_K3 = [("bucket 960x576 T1", 16, 576, 960),
             ("bucket 960x576 T2", 64, 288, 480),
             ("bucket 1280x768 T2", 64, 384, 640)]

# "coupling" is the CUDA-core kernel (float32) and "coupling_mma" the
# tensor-core kernels (bf16 at C=16, C=64 and C=256) of the one K1 wrapper,
# fused_coupling; "transition" / "transition_mma" and "transition_half" /
# "transition_half_mma" are the same pair behind K2's and K3's wrappers
KERNELS = {
    "coupling": ("vstnet_tpu_torch/csrc/coupling.cu",
                 "vstnet_tpu/ops/coupling_flat.py:523"),
    "coupling_mma": ("vstnet_tpu_torch/csrc/coupling_mma.cu",
                     "vstnet_tpu/ops/coupling_flat.py:523"),
    "transition": ("vstnet_tpu_torch/csrc/transition.cu",
                   "vstnet_tpu/ops/coupling_flat.py:738"),
    "transition_mma": ("vstnet_tpu_torch/csrc/transition_mma.cu",
                       "vstnet_tpu/ops/coupling_flat.py:738"),
    "transition_half": ("vstnet_tpu_torch/csrc/transition.cu",
                        "vstnet_tpu/ops/coupling_flat.py:466"),
    "transition_half_mma": ("vstnet_tpu_torch/csrc/transition_mma.cu",
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
    return ulps * _bf16_ulp(float(ref.float().abs().max()))


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _psnr(a, b):
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def _bf16_ulp(scale):
    """One bf16 ulp at a value of magnitude `scale`."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


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


def _graph_ms(fn, n=20, reps=5):
    """Device time of one fn() call: n calls captured in a CUDA graph and
    replayed, so that the host's time to enqueue them is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _time_ms(graph.replay, iters=reps, warmup=1) / n


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


def bound_coupling(b, c, h, w, esize=2, peak=PEAK_BF16):
    """K1: x1, x2 read, out written; C -> C/4 -> C/4 -> C."""
    return _bound(3.0 * b * c * h * w * esize,
                  _branch_flops(b, c, c // 4, c, h * w), peak)


def bound_transition(b, c, h, w, streams, esize=2, peak=PEAK_BF16):
    """K2 (4 streams: x1, x2 read, two outputs written) and K3 (3 streams:
    a, b read, one output written) at a full-res (h, w), C -> C -> C -> 4C
    on the half-res pixels."""
    return _bound(float(streams) * b * c * h * w * esize,
                  _branch_flops(b, c, c, 4 * c, (h // 2) * (w // 2)), peak)


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

def _check(label, got, ref, tol, worst=None, key=None, exact=False):
    """got against ref within tol; exact=True (the CUDA-core kernels in
    float32, which sum in their plain versions' order) also bit for bit."""
    err = _max_err(got, ref)
    same = torch.equal(got, ref)
    print(f"{label}: max abs err {err:.3e} (tol {tol:.3e}"
          + (f", bit-identical {same})" if exact else ")"))
    if not err <= tol or (exact and not same):
        raise AssertionError(f"{label}: {err} > {tol} or not bit-identical")
    if worst is not None:
        worst[key] = max(worst[key], err)


def _k1_bf16_round_trip(cf, label, x1, x2, wp):
    """inverse(forward(x1)) against x1 through the bf16 kernel."""
    y = cf.fused_coupling(x1, x2, wp)
    back = cf.fused_coupling(y, x2, wp, inverse=True)
    torch.cuda.synchronize()
    _check(f"{label} bf16 round trip", back, x1, _bf16_tol(y))


def _k2_k3_checks(cf, tag, x1, x2, wp, worst):
    """Both entries of the stride-2 block on one pair of full-res streams:
    K2 and K3 forward and inverse against their plain versions, the
    pass-through streams exact, K2(x1, x2) == K3(u(x1), u(x2)) bit for bit
    both ways, and the round trip (float32: within ROUND_TRIP_TOL; bf16:
    within the roundings of y and x1, F being recomputed bit for bit)."""
    from vstnet_tpu_torch.ops.coupling import pixel_shuffle, pixel_unshuffle

    dt = x1.dtype
    f32 = dt == torch.float32
    mma = cf.transition_route(dt, wp["cin"], wp["mid"]) == "mma"
    k2, k3 = (("transition_mma", "transition_half_mma") if mma
              else ("transition", "transition_half"))
    # the CUDA-core kernels' record is their float32 error, as "coupling"'s
    keep = worst if (mma or f32) else None
    g0, g1 = cf.fused_transition(x1, x2, wp)
    r0, r1 = cf.transition_block_plain(x1, x2, wp)
    i0, i1 = cf.fused_transition(r1, r0, wp, inverse=True)
    j0, j1 = cf.transition_block_plain(r1, r0, wp, inverse=True)
    torch.cuda.synchronize()
    tol = F32_TOL if f32 else _bf16_tol(r1)
    for what, got, ref in (("fwd", g1, r1), ("inv", i0, j0)):
        _check(f"K2 {tag} {what}", got, ref, tol, keep, k2, exact=f32)
    if not (torch.equal(g0, r0) and torch.equal(i1, j1)):
        raise AssertionError(f"K2 {tag}: (un)shuffled copy differs")
    b0, b1 = cf.fused_transition(g1, g0, wp, inverse=True)
    _check(f"K2 {tag} round trip", b0, x1,
           ROUND_TRIP_TOL if f32 else _bf16_tol(g1))
    if not torch.equal(b1, x2):
        raise AssertionError(f"K2 {tag}: x2 not restored")

    a_u = pixel_unshuffle(x1).contiguous()
    b_u = pixel_unshuffle(x2).contiguous()
    h0, h1 = cf.fused_transition_half(a_u, b_u, wp)
    s0, s1 = cf.transition_half_plain(a_u, b_u, wp)
    m0, m1 = cf.fused_transition_half(h1, h0, wp, inverse=True)
    n0, n1 = cf.transition_half_plain(h1, h0, wp, inverse=True)
    torch.cuda.synchronize()
    for what, got, ref in (("fwd", h1, s1), ("inv", m0, n0)):
        _check(f"K3 {tag} {what}", got, ref, tol, keep, k3, exact=f32)
    if not (h0 is b_u and m1 is h0):
        raise AssertionError(f"K3 {tag}: pass-through stream copied")
    same = (torch.equal(g0, h0) and torch.equal(g1, h1)
            and torch.equal(b0, pixel_shuffle(m0))
            and torch.equal(b1, pixel_shuffle(m1)))
    print(f"{tag}: K2(x1, x2) == K3(u(x1), u(x2)) bit for bit, forward and "
          f"inverse: {same}")
    if not same:
        raise AssertionError(f"{tag}: K2 and K3 differ")
    _check(f"K3 {tag} round trip", m0, a_u,
           ROUND_TRIP_TOL if f32 else _bf16_tol(h1))


def phase_kernels(cf, att, dw, device, gen):
    """Kernel vs plain on the card; returns the max error per kernel, in
    bf16 for the tensor-core kernels, K4 and K5, and in float32 for
    "coupling", "transition" and "transition_half", the CUDA-core kernels
    that the float32 route runs."""
    worst = dict.fromkeys(KERNELS, 0.0)
    bf = torch.bfloat16
    for name, c, h, w, _ in K1_SHAPES:
        branch = _rand_branch(gen, c, c // 4, c, device)
        for dt in (torch.float32, bf):
            wp = cf.pack_coupling_weights(branch, dt)
            x1 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            x2 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            route = cf.coupling_route(dt, c, c // 4)
            key = "coupling_mma" if route == "mma" else "coupling"
            for inv in (False, True):
                got = cf.fused_coupling(x1, x2, wp, inverse=inv)
                ref = cf.coupling_block_plain(x1, x2, wp, inverse=inv)
                torch.cuda.synchronize()
                tol = F32_TOL if dt == torch.float32 else _bf16_tol(ref)
                _check(f"K1 {name} C={c} {h}x{w} {_dt(dt)} {route} "
                       f"{'inv' if inv else 'fwd'}", got, ref, tol, worst,
                       key, exact=dt == torch.float32)
            if dt == torch.float32:
                y = cf.fused_coupling(x1, x2, wp)
                back = cf.fused_coupling(y, x2, wp, inverse=True)
                _check(f"K1 {name} f32 round trip", back, x1, ROUND_TRIP_TOL)
            elif route == "mma":
                _k1_bf16_round_trip(cf, f"K1 {name} C={c}", x1, x2, wp)
    for c, h, w in K1_TAILS:
        wp = cf.pack_coupling_weights(
            _rand_branch(gen, c, c // 4, c, device), bf)
        if cf.coupling_route(bf, c, c // 4) != "mma":
            raise AssertionError(f"K1 C={c} bf16 is not on the tensor cores")
        x1 = torch.randn((2, c, h, w), generator=gen).to(device, bf)
        x2 = torch.randn((2, c, h, w), generator=gen).to(device, bf)
        for inv in (False, True):
            got = cf.fused_coupling(x1, x2, wp, inverse=inv)
            ref = cf.coupling_block_plain(x1, x2, wp, inverse=inv)
            torch.cuda.synchronize()
            _check(f"K1 tails C={c} {h}x{w} bf16 mma "
                   f"{'inv' if inv else 'fwd'}", got, ref, _bf16_tol(ref),
                   worst, "coupling_mma")
        _k1_bf16_round_trip(cf, f"K1 tails C={c} {h}x{w}", x1, x2, wp)
    for name, c, h, w, _ in K2_SHAPES + K3_SHAPES + K23_HD:
        branch = _rand_branch(gen, c, c, 4 * c, device)
        for dt in (torch.float32, bf):
            wp = cf.pack_transition_weights(branch, dt)
            x1 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            x2 = torch.randn((2, c, h, w), generator=gen).to(device, dt)
            route = cf.transition_route(dt, c, c)
            if route != ("mma" if dt == bf else "fma"):
                raise AssertionError(f"{name} C={c} {_dt(dt)}: route {route}")
            _k2_k3_checks(cf, f"{name} C={c} {h}x{w} {_dt(dt)} {route}", x1,
                          x2, wp, worst)
    for c, h, w in K2_TAILS:
        wp = cf.pack_transition_weights(
            _rand_branch(gen, c, c, 4 * c, device), bf)
        x1 = torch.randn((2, c, h, w), generator=gen).to(device, bf)
        x2 = torch.randn((2, c, h, w), generator=gen).to(device, bf)
        _k2_k3_checks(cf, f"tails C={c} {h}x{w} bf16 mma", x1, x2, wp, worst)
    # the tiler's and the service's shapes at their batches, bf16 (the
    # routes they run); the streams are drawn on the card
    dgen = torch.Generator(device=device).manual_seed(1)

    def streams(b, c, h, w):
        return (torch.randn((b, c, h, w), generator=dgen, device=device,
                            dtype=bf) for _ in range(2))

    for name, c, h, w in TILE_K1:
        wp = cf.pack_coupling_weights(
            _rand_branch(gen, c, c // 4, c, device), bf)
        x1, x2 = streams(TILE_B, c, h, w)
        for inv in (False, True):
            got = cf.fused_coupling(x1, x2, wp, inverse=inv)
            ref = cf.coupling_block_plain(x1, x2, wp, inverse=inv)
            torch.cuda.synchronize()
            _check(f"K1 {name} C={c} {h}x{w} B={TILE_B} bf16 mma "
                   f"{'inv' if inv else 'fwd'}", got, ref, _bf16_tol(ref),
                   worst, "coupling_mma")
        _k1_bf16_round_trip(cf, f"K1 {name} C={c} B={TILE_B}", x1, x2, wp)
    for (name, c, h, w), b in ([(k, TILE_B) for k in TILE_K2]
                               + [(k, SERVE_B) for k in BUCKET_K2
                                  + BUCKET_K3]):
        wp = cf.pack_transition_weights(
            _rand_branch(gen, c, c, 4 * c, device), bf)
        x1, x2 = streams(b, c, h, w)
        _k2_k3_checks(cf, f"{name} C={c} {h}x{w} B={b} bf16 mma", x1, x2,
                      wp, worst)
    for name, g, n, m in K4_CHECKS:
        q, k, v = (torch.randn(s, generator=gen).to(device, bf)
                   for s in ((g, n, 64), (g, m, 64), (g, m, 64)))
        got = att.sr_attention(q, k, v, 0.125)
        ref = att.sr_attention_plain(q, k, v, 0.125)
        torch.cuda.synchronize()
        _check(f"K4 {name} G={g} N={n} M={m} bf16", got, ref, _bf16_tol(ref),
               worst, "attention")
    k5 = ([(2,) + k[:4] for k in K5_SHAPES] + [(1,) + k for k in K5_BIG]
          + [(3,) + K5_RAGGED])
    for b, name, c, h, w in k5:
        x = torch.randn((b, h, w, c), generator=gen).to(device, bf)
        taps = (torch.randn((3, 3, c), generator=gen) / 3).to(device)
        bias = (torch.randn((c,), generator=gen) * 0.1).to(device)
        got = dw.dwconv3x3_bias_gelu(x, taps, bias)
        ref = dw.dwconv3x3_bias_gelu_plain(x, taps, bias)
        torch.cuda.synchronize()
        _check(f"K5 {name} C={c} {h}x{w} B={b} bf16 (bit-identical to plain: "
               f"{torch.equal(got, ref)})", got, ref, _bf16_tol(ref, K5_ULPS),
               worst, "dwconv_gelu")
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

    # the float32 program on the same frames: K1 on the CUDA cores
    fast32 = rf.pack_revresnet(model.net, torch.float32)
    zs32 = rf.encode_fast(fast32, style, cfg, packed_latent=True)
    ls32, mu32 = cwct.style_factors_packed(zs32, c_lat)
    video32 = make_fused_video_fn(cfg)
    torch.cuda.synchronize()

    def counted(fn, mma, half=False):
        """fn() with its launches checked: 60 of K1 and 4 of the stride-2
        block (30 + 2 per encode and per decode), on the tensor-core
        kernels (mma) or the CUDA-core ones, through K2 or (half) K3."""
        want = dict.fromkeys(("coupling", "coupling_mma", "transition",
                              "transition_mma", "transition_half",
                              "transition_half_mma"), 0)
        want["coupling_mma" if mma else "coupling"] = 60
        want[("transition_half" if half else "transition")
             + ("_mma" if mma else "")] = 4
        before = ops.launch_counts()
        out = fn()
        after = ops.launch_counts()
        d = {k: after[k] - before[k] for k in want}
        if d != want:
            raise AssertionError(f"launches per batch {d}, want {want}")
        return out

    ops.reset_launch_counts()
    outs = [counted(lambda: video(fast, frames, ls, mu), True)
            for frames in batches]
    got32 = counted(lambda: video32(fast32, batches[0], ls32, mu32), False)
    # float32 on 640x360 frames (half-res widths 320 and 160): the
    # CUDA-core kernel's K3
    wide = _frames(gen, 2, (360, 640), device)
    wide32 = counted(lambda: video32(fast32, wide, ls32, mu32), False,
                     half=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _add(total, counts)
    print(f"global: 2 bf16 batches and 1 float32 batch of 4 frames at "
          f"512x512, 1 float32 batch of 2 at 640x360, launches {counts}")
    err = _max_err(wide32, _plain_video(model, wide, style))
    print(f"gate f32 kernel vs f32 plain at 640x360: max abs err {err:.3e} "
          f"(<= 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"640x360 f32 kernel route error {err}")
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

    want = {"coupling": 0, "coupling_mma": 60, "transition": 0,
            "transition_mma": 4, "transition_half": 0,
            "transition_half_mma": 0, "attention": 3, "dwconv_gelu": 41}
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
    same = logits.argmax(-1) == logits_p.argmax(-1)
    top2 = logits_p.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > _bf16_ulp(scale)
    share = float(decided.float().mean())
    agree = float(same[decided].float().mean())
    agree_all = float(same.float().mean())
    cos = float(torch.nn.functional.cosine_similarity(
        logits.float().flatten(), logits_p.float().flatten(), dim=0))
    masks32 = sf.segment_logits(seg.net, frames, half=False).argmax(-1)
    floor = float((logits_p.argmax(-1) == masks32).float().mean())
    print(f"gate segmenter kernel vs plain bf16 route: logits max abs err "
          f"{err:.3e} at scale {scale:.3e} (<= {LOGIT_REL_TOL} of it), "
          f"cosine {cos:.6f} (> {LOGIT_COSINE}), mask agreement {agree:.5f} "
          f"(>= {MASK_AGREE}) on the {share:.5f} of the pixels that the "
          f"plain route decides by more than a bf16 ulp of the scale "
          f"({_bf16_ulp(scale):.3e}); over all pixels {agree_all:.5f} (the "
          f"plain bf16 route agrees with the float32 route on {floor:.5f})")
    if not (err <= LOGIT_REL_TOL * scale and cos > LOGIT_COSINE
            and agree >= MASK_AGREE):
        raise AssertionError(f"segmenter routes disagree: {err} {cos} "
                             f"{agree} on {share} of the pixels, {agree_all} "
                             f"on all (float32 floor {floor})")

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

    # 640x360 frames: half-res widths 320 and 160 take K3, not K2 (planes
    # 180x320 and 90x160, tile tails on both axes)
    wide = _frames(gen, 2, (360, 640), device)
    ops.reset_launch_counts()
    z = rf.encode_fast(fast, wide.to(torch.bfloat16), cfg)
    enc = ops.launch_counts()
    rf.decode_fast(fast, z, cfg)
    dec = {k: v - enc[k] for k, v in ops.launch_counts().items()}
    for what, d in (("encode", enc), ("decode", dec)):
        if (d["coupling"], d["coupling_mma"], d["transition"],
                d["transition_mma"], d["transition_half"],
                d["transition_half_mma"]) != (0, 30, 0, 0, 0, 2):
            raise AssertionError(f"640x360 {what}: launches {d}")
    ops.reset_launch_counts()
    out, mw = run(video, wide,
                  dict(want, transition_mma=0, transition_half_mma=4),
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

def _line(kernel, name, shape, tk, tp, bound, lib=None, dtype="bf16"):
    bms, by = bound
    lib_s = "" if lib is None else f", library {lib:.3f} ms"
    print(f"time {kernel} {name} {shape} {dtype}: kernel {tk:.3f} ms, plain "
          f"{tp:.3f} ms{lib_s}, bound {bms:.4f} ms ({by})")


def phase_timings(cf, att, dw, device, gen, batch=8):
    """Per-launch times at batch 8, in bf16 and, for the CUDA-core K1, K2
    and K3 kernels, in float32. Returns per kernel {"ms", "plain_ms",
    "bound_ms", "bound_by", "library_ms"}: the sums over the launches of
    one encode (K1 and K2, by kernel, at 512x512; K3 at 640x360) or of one
    segment call at 512x512 (K4, K5)."""
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
        route = cf.coupling_route(bf, c, c // 4)
        key = "coupling_mma" if route == "mma" else "coupling"
        _line(key, name, f"C={c} {h}x{w} B={batch} route {route}", tk, tp,
              bound)
        tally(key, count, tk, tp, bound)
        # the float32 route: the CUDA-core kernel, TF32 off on both sides
        wp = cf.pack_coupling_weights(
            _rand_branch(gen, c, c // 4, c, device), torch.float32)
        x1, x2 = x1.float(), x2.float()
        tk, tp = _time_pair(lambda: cf.fused_coupling(x1, x2, wp),
                            lambda: cf.coupling_block_plain(x1, x2, wp),
                            iters=5)
        bound = bound_coupling(batch, c, h, w, esize=4, peak=PEAK_F32)
        route = cf.coupling_route(torch.float32, c, c // 4)
        _line("coupling", name, f"C={c} {h}x{w} B={batch} route {route}",
              tk, tp, bound, dtype="float32")
        tally("coupling", count, tk, tp, bound)
    # K2 at the 512x512 shapes and K3 at the 640x360 shapes: the tensor-core
    # kernel in bf16 and the CUDA-core kernel in float32 (TF32 off on both
    # sides); then both entries on the same frames in bf16, the caller's
    # pixel (un)shuffle copies being part of the half-res entry
    f32 = torch.float32
    for shapes, half in ((K2_SHAPES, False), (K3_SHAPES, True)):
        for name, c, h, w, count in shapes:
            branch = _rand_branch(gen, c, c, 4 * c, device)
            x1, x2 = pair(c, h, w)
            for dt, peak, iters in ((bf, PEAK_BF16, 10), (f32, PEAK_F32, 5)):
                wp = cf.pack_transition_weights(branch, dt)
                xa, xb = x1.to(dt), x2.to(dt)
                if half:
                    xa = pixel_unshuffle(xa).contiguous()
                    xb = pixel_unshuffle(xb).contiguous()
                    kernel, plain = (cf.fused_transition_half,
                                     cf.transition_half_plain)
                    shape = f"C_u={4 * c} {h // 2}x{w // 2} B={batch}"
                else:
                    kernel, plain = (cf.fused_transition,
                                     cf.transition_block_plain)
                    shape = f"C={c} {h}x{w} B={batch}"
                tk, tp = _time_pair(lambda: kernel(xa, xb, wp),
                                    lambda: plain(xa, xb, wp), iters=iters)
                bound = bound_transition(batch, c, h, w, 3 if half else 4,
                                         esize=xa.element_size(), peak=peak)
                route = cf.transition_route(dt, c, c)
                key = ("transition_half" if half else "transition") + (
                    "_mma" if route == "mma" else "")
                _line(key, name, f"{shape} route {route}", tk, tp, bound,
                      dtype=_dt(dt))
                tally(key, count, tk, tp, bound)

            wp = cf.pack_transition_weights(branch, bf)
            a_u = pixel_unshuffle(x1).contiguous()
            b_u = pixel_unshuffle(x2).contiguous()

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
            print(f"time entries {name} C={c} {h}x{w} B={batch} bf16: "
                  f"forward K2 {f2:.3f} ms, K3 + unshuffle {f3:.3f} ms; "
                  f"inverse K2 {i2:.3f} ms, K3 + shuffle {i3:.3f} ms")
    # the tiler's and the service's shapes, bf16
    for name, c, h, w in TILE_K1:
        wp = cf.pack_coupling_weights(
            _rand_branch(gen, c, c // 4, c, device), bf)
        x1, x2 = (torch.randn((TILE_B, c, h, w), generator=gen).to(device, bf)
                  for _ in range(2))
        tk, tp = _time_pair(lambda: cf.fused_coupling(x1, x2, wp),
                            lambda: cf.coupling_block_plain(x1, x2, wp),
                            iters=5)
        _line("coupling_mma", name, f"C={c} {h}x{w} B={TILE_B}", tk, tp,
              bound_coupling(TILE_B, c, h, w))
    for (name, c, h, w), b, half in ([(k, TILE_B, False) for k in TILE_K2]
                                     + [(k, SERVE_B, True)
                                        for k in BUCKET_K3]):
        wp = cf.pack_transition_weights(
            _rand_branch(gen, c, c, 4 * c, device), bf)
        xa, xb = (torch.randn((b, c, h, w), generator=gen).to(device, bf)
                  for _ in range(2))
        kernel, plain, key = (cf.fused_transition, cf.transition_block_plain,
                              "transition_mma")
        if half:
            xa = pixel_unshuffle(xa).contiguous()
            xb = pixel_unshuffle(xb).contiguous()
            kernel, plain, key = (cf.fused_transition_half,
                                  cf.transition_half_plain,
                                  "transition_half_mma")
        tk, tp = _time_pair(lambda: kernel(xa, xb, wp),
                            lambda: plain(xa, xb, wp), iters=5)
        _line(key, name, f"C={c} {h}x{w} (full-res) B={b}", tk, tp,
              bound_transition(b, c, h, w, 3 if half else 4))
    for name, g, n, m, count in K4_SHAPES + [K4_UNROUTED + (0,)]:
        g = g * batch if name in ("512 s1", "256 s1") else g
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
    # K5 by graph replay; eagerly too, and cuDNN's bf16 channels_last
    # depthwise conv with bias, then F.gelu: a yardstick of two calls that
    # the port never makes (no single call computes K5: library_ms is None)
    for b, name, c, h, w, count in ([(batch,) + k for k in K5_SHAPES]
                                    + [(1,) + k + (0,) for k in K5_BIG]):
        x = torch.randn((b, h, w, c), generator=gen).to(device, bf)
        taps = (torch.randn((3, 3, c), generator=gen) / 3).to(device)
        bias = (torch.randn((c,), generator=gen) * 0.1).to(device)
        xc = x.permute(0, 3, 1, 2)             # NCHW view, channels_last
        wc = taps.permute(2, 0, 1)[:, None].to(bf).contiguous(
            memory_format=torch.channels_last)
        bc = bias.to(bf)

        def kernel():
            return dw.dwconv3x3_bias_gelu(x, taps, bias)

        def cudnn():
            return torch.nn.functional.gelu(torch.nn.functional.conv2d(
                xc, wc, bc, padding=1, groups=c))

        plain = _time_ms(lambda: dw.dwconv3x3_bias_gelu_plain(x, taps, bias))
        g0 = _graph_ms(kernel)
        eager = _time_ms(kernel)
        g1 = _graph_ms(kernel)
        tk = min(g0, g1)
        yard, yard_eager = _graph_ms(cudnn), _time_ms(cudnn)
        plain = min(plain, _time_ms(
            lambda: dw.dwconv3x3_bias_gelu_plain(x, taps, bias)))
        bound = bound_dwconv(b, h, w, c)
        _line("dwconv_gelu", name, f"C={c} {h}x{w} B={b}", tk, plain, bound)
        print(f"time dwconv_gelu {name} C={c} {h}x{w} B={b} bf16: kernel "
              f"called eagerly {eager:.4f} ms (host-bound where above the "
              f"graph's {tk:.4f}); yardstick cuDNN bf16 depthwise conv + "
              f"bias, then F.gelu: {yard:.4f} ms by graph replay, "
              f"{yard_eager:.4f} ms eagerly")
        if count:
            tally("dwconv_gelu", count, tk, plain, bound)
    for r in rec.values():
        r["bound_by"] = ("bytes" if r.pop("bytes_ms") >= r.pop("ops_ms")
                         else "operations")
    return rec


def _segment_device_time(segment, what):
    """One segment call under torch.profiler: the device time its kernels
    take (their sum; one stream), its share of the call's wall time, and
    the kernels that take the most. A measurement, not a gate: where the
    profiler sees no device time, the line says so."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            segment()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count,
                 e.key) for e in prof.key_averages()]
    except RuntimeError as exc:       # the profiler cannot trace this card
        print(f"time SegFormer-B4 bf16 {what} device: not measured ({exc})")
        return
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        print(f"time SegFormer-B4 bf16 {what} device: not measured (the "
              f"profiler saw no device time)")
        return
    top = ", ".join(f"{k[:48]} x{n} {t:.3f} ms"
                    for t, n, k in sorted(rows, reverse=True)[:6])
    print(f"time SegFormer-B4 bf16 {what} device: kernels {busy:.2f} ms of "
          f"a {wall:.2f} ms call under the profiler (device idle "
          f"{100 * (1 - busy / wall):.1f} %); most: {top}")


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
        _segment_device_time(segment, what)

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


# ---------------------------------------------------------------------------
# Phase 7: the command-line entry points
# ---------------------------------------------------------------------------

# (frames, H, W) of the video CLI's clips: 16 frames at 1280x720, which the
# default --max_size 1280 keeps (K2 at T1, K3 at T2), at --batch 8; one
# batch at 640x360 (K3 at both stride-2 blocks). (H, W) of the image CLI's
# content and styles.
CLI_CLIP = (16, 720, 1280)
CLI_WIDE = (8, 360, 640)
CLI_IMAGE = (768, 1024)
CLI_BATCH = 8
# launches per bf16 batch of the video programs: 30 of K1 and one of each
# stride-2 block per encode and per decode
CLI_PER_BATCH = {"1280x720": {"coupling_mma": 60, "transition_mma": 2,
                              "transition_half_mma": 2},
                 "640x360": {"coupling_mma": 60, "transition_half_mma": 4}}


class _CliProbe:
    """Within the block, the frames that the CLIs hand their video writers
    are kept by file name, and every call of a program that
    make_fused_video_fn or make_masked_fused_video_fn made is kept with its
    factory's arguments, its own arguments, its input frames and the
    launches it made."""

    def __init__(self, ops):
        self.ops = ops
        self.frames, self.calls = {}, []

    def __enter__(self):
        import os

        import numpy as np

        from vstnet_tpu_torch.io import video
        from vstnet_tpu_torch.models import pipeline

        probe = self

        class Recording(video.AsyncWriter):
            def write(self, frame):
                probe.frames.setdefault(os.path.basename(self.path),
                                        []).append(np.array(frame))
                super().write(frame)

        self.video, self.pipeline = video, pipeline
        self.saved = (video.AsyncWriter, pipeline.make_fused_video_fn,
                      pipeline.make_masked_fused_video_fn)
        video.AsyncWriter = Recording
        pipeline.make_fused_video_fn = self._wrap(self.saved[1])
        pipeline.make_masked_fused_video_fn = self._wrap(self.saved[2])
        return self

    def _wrap(self, factory):
        masked = factory is self.saved[2]

        def make(*fa, **fkw):
            fn = factory(*fa, **fkw)

            def run(*args):
                before = self.ops.launch_counts()
                out = fn(*args)
                after = self.ops.launch_counts()
                self.calls.append({
                    "factory": factory, "make": (fa, fkw), "args": args,
                    "masked": masked, "frames": args[5 if masked else 1],
                    "launches": {k: v - before[k] for k, v in after.items()
                                 if v != before[k]}})
                return out
            return run
        return make

    def __exit__(self, *exc):
        (self.video.AsyncWriter, self.pipeline.make_fused_video_fn,
         self.pipeline.make_masked_fused_video_fn) = self.saved


def _run_cli(main, argv):
    """main(argv) with its standard output kept and echoed; returns (what
    main returned, the output, the wall seconds of the call)."""
    import contextlib
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"  | {line}")
    return ret, out, wall


def _u8_psnr(a, b):
    import numpy as np

    d = a.astype(np.float64) / 255.0 - b.astype(np.float64) / 255.0
    mse = float((d ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def _write_inputs(gen, root, device):
    """The synthetic inputs, written as a user's would be: MJPEG clips by
    the port's AviWriter, PNG content and styles."""
    from PIL import Image

    from vstnet_tpu_torch.io.video import AviWriter

    for name, (n, h, w) in (("clip", CLI_CLIP), ("wide", CLI_WIDE)):
        frames = (_frames(gen, n, (h, w), device) * 255).round().to(
            torch.uint8).cpu().numpy()
        with AviWriter(f"{root}/{name}.avi", fps=10) as wr:
            for f in frames:
                wr.write(f)
    for name in ("content", "style", "style2"):
        img = (_frames(gen, 1, CLI_IMAGE, device)[0] * 255).round().to(
            torch.uint8).cpu().numpy()
        Image.fromarray(img).save(f"{root}/{name}.png")


def _check_video_calls(ops, probe, clip, size, written, seg_calls=None):
    """The video programs' calls of one CLI run: their input frames equal
    an independent decode, upload and resize of the clip; each made the
    launches of one bf16 batch (seg_calls: the launches of one segment
    call on the program's segmenter input besides); and each, made anew
    from its factory and called again on the same frames and factors,
    gives bit for bit the frames that the CLI handed its writer (and the
    masks of its label video)."""
    import numpy as np

    from vstnet_tpu_torch.io.video import read_frames
    from vstnet_tpu_torch.ops.resize import resize_bilinear

    frames_iter, _, _ = read_frames(clip)
    decoded = np.stack(list(frames_iter))
    out_frames = np.stack(written[0])
    labels = np.stack(written[1]) if len(written) > 1 else None
    want = dict(CLI_PER_BATCH[size], **(seg_calls or {}))
    want = {k: v for k, v in want.items() if v}
    lo = 0
    for call in probe.calls:
        masked, x = call["masked"], call["frames"]
        b, h, w = x.shape[:3]
        n = min(b, len(decoded) - lo)
        chunk = list(decoded[lo:lo + n]) + [decoded[lo + n - 1]] * (b - n)
        ref_in = torch.from_numpy(np.stack(chunk)).to(x.device)
        ref_in = resize_bilinear(ref_in.float() / 255.0, h, w)
        if not torch.equal(ref_in, x):
            raise AssertionError(f"{clip} batch at {lo}: input frames differ "
                                 f"from the clip's")
        if call["launches"] != want:
            raise AssertionError(f"{clip} batch at {lo}: launches "
                                 f"{call['launches']}, want {want}")
        fa, fkw = call["make"]
        again = call["factory"](*fa, **fkw)(*call["args"])
        frames = again[0] if masked else again
        if not np.array_equal(frames[:n].cpu().numpy(),
                              out_frames[lo:lo + n]):
            raise AssertionError(f"{clip} batch at {lo}: the written frames "
                                 f"differ from the program's")
        if masked:
            m = again[1][:n].cpu().numpy().astype(np.uint8)
            if not np.array_equal(m, labels[lo:lo + n, ..., 0]):
                raise AssertionError(f"{clip} batch at {lo}: the label "
                                     f"video differs from the masks")
        lo += n
    if lo != len(decoded) or len(out_frames) != len(decoded):
        raise AssertionError(f"{clip}: {lo} frames stylized, "
                             f"{len(out_frames)} written, {len(decoded)} in")


def _segment_call_launches(ops, call):
    """The launches of one bf16 segment call on the masked program's
    segmenter input (its frames resized to seg_hw)."""
    from vstnet_tpu_torch.models import segformer as sf
    from vstnet_tpu_torch.ops.resize import resize_bilinear

    seg_net, x = call["args"][1], call["frames"]
    seg_hw = call["make"][1].get("seg_hw")
    if seg_hw is not None and tuple(seg_hw) != tuple(x.shape[1:3]):
        x = resize_bilinear(x, *seg_hw)
    before = ops.launch_counts()
    sf.segment_mask(seg_net, x, half=True)
    after = ops.launch_counts()
    return {k: after[k] - before[k] for k in ("attention", "dwconv_gelu")}


def _cli_breakdown(root, clip, frames, calls):
    """Where a video CLI run's time goes, each part alone: the host's JPEG
    decode of the clip (one thread, as the CLI's decode-ahead thread), the
    container writer's encode (as the CLI's writer thread), and each video
    program's device time a batch (CUDA events), its own run's call made
    anew."""
    from vstnet_tpu_torch.io.video import (
        have_cv2,
        make_video_writer,
        read_frames,
    )

    t0 = time.perf_counter()
    n = len(list(read_frames(clip)[0]))
    decode = (time.perf_counter() - t0) * 1e3 / n
    ext = ".mp4" if have_cv2() else ".avi"
    t0 = time.perf_counter()
    writer = make_video_writer(f"{root}/writer_probe{ext}", fps=10)
    for f in frames:
        writer.write(f)
    writer.close()
    write = (time.perf_counter() - t0) * 1e3 / len(frames)
    parts = [f"JPEG decode {decode:.2f} ms a frame, {ext} write "
             f"{write:.2f} ms a frame (host, one thread each)"]
    for tag, call in calls.items():
        fn = call["factory"](*call["make"][0], **call["make"][1])
        b = call["frames"].shape[0]
        ms = _time_ms(lambda: fn(*call["args"]), iters=3, warmup=1)
        parts.append(f"{tag} program {ms:.2f} ms a batch of {b} "
                     f"({b * 1000.0 / ms:.2f} frames/s on the device alone)")
    print("video CLI 1280x720 breakdown: " + "; ".join(parts))


def phase_cli(ops, device, gen, total, smi):
    """The video CLI at 1280x720 in its four routes and at 640x360, and the
    image CLI at 1024x768 in its --fast and float32 routes, with random
    weights from their default seed; then photo_pipeline, fused against
    float32."""
    import os
    import re
    import tempfile

    import numpy as np
    from PIL import Image

    from vstnet_tpu_torch.cli import image_transfer, video_transfer
    from vstnet_tpu_torch.models import segformer as sf
    from vstnet_tpu_torch.models.pipeline import StyleModel

    tmp = tempfile.TemporaryDirectory(prefix="vstnet_cli_")
    root = tmp.name
    _write_inputs(gen, root, device)
    style = f"{root}/style.png"

    def video(tag, clip, *flags):
        """One video CLI run: its launches join the main paths' counts."""
        out_dir = f"{root}/{tag}"
        argv = ["--video", f"{root}/{clip}.avi", "--style", style,
                "--out_dir", out_dir, "--batch", str(CLI_BATCH), *flags]
        with _CliProbe(ops) as probe:
            ops.reset_launch_counts()
            path, out, wall = _run_cli(video_transfer.main, argv)
            counts = ops.launch_counts()
        _add(total, counts)
        fps = float(re.search(r"([\d.]+) frames/sec end-to-end",
                              out).group(1))
        name = os.path.basename(path)
        written = [probe.frames[name]]
        if "--auto_seg" in flags:
            written.append(probe.frames["content_seg_label.avi"])
        print(f"video CLI {tag}: {fps:.2f} frames/s end to end (the CLI's "
              f"clock: decode, upload, stylize, readback and writes), main() "
              f"{wall:.2f} s with set-up; launches {counts}")
        return probe, written, fps

    n, h, w = CLI_CLIP
    clip = f"{root}/clip.avi"
    fps = {}
    runs = {}
    probes = {}
    for tag, flags in (("bf16 global", ()), ("bf16 global again", ()),
                       ("bf16 alpha_c 0.5", ("--alpha_c", "0.5")),
                       ("bf16 auto_seg", ("--auto_seg", "--seg_size", "-1")),
                       ("f32 global", ("--precision", "f32"))):
        probe, written, fps[tag] = video(tag.replace(" ", "_"), "clip",
                                         *flags)
        runs[tag], probes[tag] = written, probe
        if tag.startswith("bf16"):
            seg = None
            if "--auto_seg" in flags:
                seg = _segment_call_launches(ops, probe.calls[0])
                print(f"video CLI {tag}: segmenter input "
                      f"{probe.calls[0]['make'][1].get('seg_hw') or 'native'}"
                      f", one segment call launches {seg}")
            _check_video_calls(ops, probe, clip, "1280x720", written, seg)
            print(f"video CLI {tag}: {len(probe.calls)} batches, each with "
                  f"the launches of one bf16 batch; inputs equal the clip's "
                  f"decode; written frames equal the program's bit for bit")
        elif probe.calls:
            raise AssertionError("the f32 route called a fused program")
    p = _u8_psnr(np.stack(runs["bf16 global"][0]),
                 np.stack(runs["f32 global"][0]))
    print(f"gate video CLI bf16 vs f32 at 1280x720: PSNR {p:.2f} dB (>= 40)")
    if not p >= PSNR_GATE:
        raise AssertionError(f"video CLI bf16 PSNR {p}")
    for tag, written in runs.items():
        got = np.stack(written[0])
        if got.shape != (n, h, w, 3) or got.dtype != np.uint8:
            raise AssertionError(f"video CLI {tag}: {got.shape} {got.dtype}")
    print(f"video CLI end to end at 1280x720, 16 frames, --batch 8, on "
          f"{smi}: " + ", ".join(f"{k} {v:.2f} frames/s"
                                 for k, v in fps.items()))
    _cli_breakdown(root, clip, runs["bf16 global"][0],
                   {k: probes[k].calls[0] for k in ("bf16 global again",
                                                    "bf16 auto_seg")})

    wide = {}
    for tag, flags in (("bf16 640x360", ()),
                       ("f32 640x360", ("--precision", "f32"))):
        probe, written, _ = video(tag.replace(" ", "_"), "wide", *flags)
        wide[tag] = np.stack(written[0])
        if tag.startswith("bf16"):
            _check_video_calls(ops, probe, f"{root}/wide.avi", "640x360",
                               written)
    p = _u8_psnr(wide["bf16 640x360"], wide["f32 640x360"])
    print(f"gate video CLI bf16 vs f32 at 640x360: PSNR {p:.2f} dB (>= 40)")
    if not p >= PSNR_GATE:
        raise AssertionError(f"video CLI 640x360 PSNR {p}")

    def image(tag, *flags):
        out_dir = f"{root}/img_{tag.replace(' ', '_')}"
        argv = ["--content", f"{root}/content.png", "--out_dir", out_dir,
                *flags]
        if "--styles" not in flags:
            argv += ["--style", style]
        ops.reset_launch_counts()
        path, _, wall = _run_cli(image_transfer.main, argv)
        counts = ops.launch_counts()
        _add(total, counts)
        got = np.asarray(Image.open(path))
        if got.shape != CLI_IMAGE + (3,):
            raise AssertionError(f"image CLI {tag}: {got.shape}")
        print(f"image CLI {tag} {CLI_IMAGE[1]}x{CLI_IMAGE[0]}: main() "
              f"{wall:.3f} s; launches {counts}")
        return got, out_dir

    styles = ("--styles", style, f"{root}/style2.png", "--alpha_s", "0.3",
              "0.7")
    img = {}
    for tag, flags in (("fast global", ("--fast",)),
                       ("f32 global", ()),
                       ("fast global again", ("--fast",)),
                       ("fast auto_seg", ("--fast", "--auto_seg")),
                       ("f32 auto_seg", ("--auto_seg",)),
                       ("fast styles", ("--fast",) + styles),
                       ("f32 styles", styles)):
        img[tag] = image(tag, *flags)
    seg_dir = f"{img['fast auto_seg'][1]}/segmentation"
    img["f32 on the fast masks"] = image(
        "f32 on the fast masks", "--content_seg",
        f"{seg_dir}/content_seg_label.png", "--style_seg",
        f"{seg_dir}/style_seg_label.png")
    agree = float((np.asarray(Image.open(f"{seg_dir}/content_seg_label.png"))
                   == np.asarray(Image.open(
                       f"{img['f32 auto_seg'][1]}/segmentation/"
                       "content_seg_label.png"))).mean())
    print(f"image CLI auto_seg: the bf16 segmenter's content mask agrees "
          f"with the float32 one's on {agree:.5f} of the pixels")
    for fast_tag, ref_tag in (("fast global", "f32 global"),
                              ("fast auto_seg", "f32 on the fast masks"),
                              ("fast styles", "f32 styles")):
        p = _u8_psnr(img[fast_tag][0], img[ref_tag][0])
        print(f"gate image CLI {fast_tag} vs {ref_tag}: PSNR {p:.2f} dB "
              f"(>= 40)")
        if not p >= PSNR_GATE:
            raise AssertionError(f"image CLI {fast_tag} PSNR {p}")

    # photo_pipeline with a bf16 segmenter attached: both routes get the
    # same masks
    from vstnet_tpu_torch.io.image import device_put_image, load_image

    model = StyleModel.random_init(
        seed=0, device=device,
        segmenter=sf.Segmenter.load(None, seed=0, half=True, device=device))
    c = device_put_image(load_image(f"{root}/content.png", as_uint8=True),
                         device)
    s = device_put_image(load_image(style, as_uint8=True), device)
    ops.reset_launch_counts()
    fused = model.photo_pipeline(c, s, fast=True)
    counts = ops.launch_counts()
    _add(total, counts)
    ref = model.photo_pipeline(c, s)
    p = _psnr(fused, ref)
    print(f"gate photo_pipeline fast vs float32 {CLI_IMAGE[1]}x"
          f"{CLI_IMAGE[0]}: PSNR {p:.2f} dB (>= 40); launches {counts}")
    if not p >= PSNR_GATE:
        raise AssertionError(f"photo_pipeline PSNR {p}")
    tmp.cleanup()


# ---------------------------------------------------------------------------
# Phase 8: ultra-resolution tiling
# ---------------------------------------------------------------------------

# a 4K content (H, W) and its style; the tiler's defaults (tile 1024,
# overlap 128); the exact overlap is the receptive field (234 px for
# PHOTO_CONFIG) rounded up to a multiple of 4
ULTRA_HW = (2160, 3840)
ULTRA_STYLE = (576, 1024)
ULTRA_TILE = 1024
ULTRA_OVERLAP = 128
ULTRA_GATE = 55.0
# launches of one batch of 4 tiles at 1024x1024 on the fused path: pass 1
# encodes (30 coupling blocks, 2 stride-2 blocks on the full-res entry:
# half-res widths 512 and 256), pass 2 encodes and decodes
ULTRA_PER_CHUNK = {1: {"coupling_mma": 30, "transition_mma": 2},
                   2: {"coupling_mma": 60, "transition_mma": 4}}
# launches of one style encode at 1024x576 (half-res widths 512 and 256)
ULTRA_STYLE_ENCODE = {"coupling_mma": 30, "transition_mma": 2}
# one bf16 segment call at 1024x576 (the 4K content capped at 1024 a side,
# and the style): stage 1 has 36864 queries and stage 2 9216, both at or
# above MIN_Q, so 3 + 8 attention launches; 41 MixFFN blocks
ULTRA_SEG_CALL = {"attention": 11, "dwconv_gelu": 41}


class _UltraProbe:
    """Within the block, every tile batch that models/ultra.py runs is kept
    with its pass (1: moments, 2: stylize and blend), its launches and its
    device time (CUDA events around the batch)."""

    PASSES = {"_moments_chunk": 1, "_moments_chunk_masked": 1,
              "_stylize_chunk": 2, "_stylize_chunk_masked": 2}

    def __init__(self, ops):
        self.ops = ops
        self.calls = []

    def __enter__(self):
        from vstnet_tpu_torch.models import ultra

        self.ultra = ultra
        self.saved = {n: getattr(ultra, n) for n in self.PASSES}
        for name, fn in self.saved.items():
            setattr(ultra, name, self._wrap(fn, self.PASSES[name]))
        return self

    def _wrap(self, fn, pass_no):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = self.ops.launch_counts()
            start.record()
            out = fn(*args, **kw)
            end.record()
            after = self.ops.launch_counts()
            self.calls.append({
                "pass": pass_no, "events": (start, end),
                "launches": {k: v - before[k] for k, v in after.items()
                             if v != before[k]}})
            return out
        return run

    def device_ms(self, pass_no):
        torch.cuda.synchronize()
        return sum(c["events"][0].elapsed_time(c["events"][1])
                   for c in self.calls if c["pass"] == pass_no)

    def check(self, what, fast):
        """Each tile batch made the launches of its pass (none on the
        float32 route); returns the batch count of each pass."""
        n = {p: sum(c["pass"] == p for c in self.calls) for p in (1, 2)}
        if n[1] != n[2] or not n[1]:
            raise AssertionError(f"ultra {what}: tile batches {n}")
        for c in self.calls:
            want = ULTRA_PER_CHUNK[c["pass"]] if fast else {}
            if c["launches"] != want:
                raise AssertionError(f"ultra {what}: a pass-{c['pass']} "
                                     f"batch launched {c['launches']}, "
                                     f"want {want}")
        return n

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ultra, name, fn)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _ultra_breakdown(root, out, device):
    """Where an ultra CLI run's wall time goes besides the device, each
    part alone: the 4K PNG load, the 4K PNG save (host, one thread) and
    the model's set-up on the card."""
    from vstnet_tpu_torch.io.image import load_image, save_image
    from vstnet_tpu_torch.models.pipeline import StyleModel

    _, t_load = _timed(lambda: load_image(f"{root}/content.png",
                                          max(ULTRA_HW), 4, as_uint8=True))
    x = torch.from_numpy(out.copy()).to(device)[None].float() / 255.0
    _, t_save = _timed(lambda: save_image(x, f"{root}/save_probe.png"))
    _, t_init = _timed(lambda: StyleModel.random_init(device=device))
    print(f"ultra CLI breakdown, each part alone: content PNG load "
          f"{t_load:.2f} s, output PNG save {t_save:.2f} s (host, one "
          f"thread), StyleModel.random_init {t_init:.2f} s")


def _check_tile_latents(model, content, grid):
    """The fused kernels give a pixel the same bits wherever a tile's
    origin puts it: the tiles' owned latent pixels at the exact overlap,
    put together, equal the whole image's fused latent bit for bit (the
    whole image's T2 takes K3 where a tile's takes K2; both give the same
    bits, phase 3)."""
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.models import ultra

    fp, cfg, sc = model.fast_params, model.cfg, grid.sc
    z_whole = rf.encode_fast(fp, content.to(fp["dtype"]), cfg)
    z_tiles = torch.full_like(z_whole, float("nan"))
    items = list(grid.tiles())
    for c0 in range(0, len(items), ultra.TILE_BATCH):
        chunk = items[c0:c0 + ultra.TILE_BATCH]
        tiles = ultra._slice_tiles(content, [it[1] for it in chunk],
                                   [it[3] for it in chunk], grid.th, grid.tw)
        z = rf.encode_fast(fp, tiles.to(fp["dtype"]), cfg)
        for i, it in enumerate(chunk):
            oy0, oy1, ox0, ox1 = grid.own_bounds(*it)
            y0, x0 = it[1] // sc, it[3] // sc
            z_tiles[0, y0 + oy0:y0 + oy1, x0 + ox0:x0 + ox1] = \
                z[i, oy0:oy1, ox0:ox1]
    same = torch.equal(z_tiles, z_whole)
    print(f"gate ultra fused latent: the {len(items)} tiles' owned pixels "
          f"equal the whole image's latent bit for bit: {same} (max abs "
          f"err {_max_err(z_tiles, z_whole):.3e})")
    if not same:
        raise AssertionError("tiled fused latent differs from the whole "
                             "image's")


def phase_ultra(ops, model, device, gen, total, smi):
    """The tiled path at 3840x2160, full PHOTO_CONFIG: the library entry
    (float32 at the exact overlap against the whole image, fused against
    float32 on the same grid, the default overlap against the whole image),
    then the image CLI on a 4K PNG in five routes."""
    import os
    import tempfile

    import numpy as np
    from PIL import Image

    from vstnet_tpu_torch.cli import image_transfer
    from vstnet_tpu_torch.models import ultra

    cfg = model.cfg
    exact_ov = ultra.receptive_field(cfg) + (-ultra.receptive_field(cfg)) % 4
    content = _frames(gen, 1, ULTRA_HW, device)
    style = _frames(gen, 1, ULTRA_STYLE, device)
    h, w = ULTRA_HW

    whole, t_whole = _timed(lambda: model.stylize(content, style))
    whole = whole.clamp(0, 1)
    exact, t_exact = _timed(lambda: ultra.stylize_tiled(
        model.net, content, style, cfg, tile=ULTRA_TILE,
        overlap=exact_ov))
    exact = exact.clamp(0, 1)
    p = _psnr(exact, whole)
    grid = ultra._TileGrid(h, w, cfg, ULTRA_TILE, exact_ov)
    print(f"gate ultra float32 tiled (overlap {exact_ov}, "
          f"{len(grid.ys)}x{len(grid.xs)} tiles) vs whole image "
          f"{w}x{h}: PSNR {p:.2f} dB (> {ULTRA_GATE}); max abs err "
          f"{_max_err(exact, whole):.3e}; {t_exact:.2f} s tiled, "
          f"{t_whole:.2f} s whole")
    if not p > ULTRA_GATE:
        raise AssertionError(f"ultra exact PSNR {p}")
    _check_tile_latents(model, content, grid)

    with _UltraProbe(ops) as probe:
        ops.reset_launch_counts()
        fast, t_fast = _timed(lambda: ultra.stylize_tiled(
            model.net, content, style, cfg, tile=ULTRA_TILE,
            overlap=exact_ov, fast_params=model.fast_params))
        counts = ops.launch_counts()
    _add(total, counts)
    n = probe.check("library fused", True)
    p = _psnr(fast.clamp(0, 1), exact)
    print(f"gate ultra fused tiled vs float32 tiled (overlap "
          f"{exact_ov}): PSNR {p:.2f} dB (>= {PSNR_GATE}); {n[1]} tile "
          f"batches a pass, launches {counts}; {t_fast:.2f} s, pass 1 "
          f"{probe.device_ms(1):.1f} ms and pass 2 {probe.device_ms(2):.1f} "
          f"ms on the device")
    if not p >= PSNR_GATE:
        raise AssertionError(f"ultra fused PSNR {p}")
    del fast, exact

    default = ultra.stylize_tiled(model.net, content, style, cfg,
                                  tile=ULTRA_TILE, overlap=ULTRA_OVERLAP)
    print(f"ultra float32 tiled at the default overlap {ULTRA_OVERLAP} vs "
          f"whole image: PSNR {_psnr(default.clamp(0, 1), whole):.2f} dB "
          f"(not gated: seams blended inside the receptive field)")
    del default, whole

    tmp = tempfile.TemporaryDirectory(prefix="vstnet_ultra_")
    root = tmp.name
    for name, img in (("content", content), ("style", style),
                      ("style2", _frames(gen, 1, ULTRA_STYLE, device))):
        Image.fromarray((img[0] * 255).round().to(torch.uint8).cpu()
                        .numpy()).save(f"{root}/{name}.png")
    del content

    def image(tag, *flags, fast, seg_calls=0, styles=1):
        out_dir = f"{root}/{tag.replace(' ', '_')}"
        argv = ["--content", f"{root}/content.png", "--out_dir", out_dir,
                "--max_size", str(max(ULTRA_HW)), *flags]
        if "--styles" not in flags:
            argv += ["--style", f"{root}/style.png"]
        with _UltraProbe(ops) as probe:
            ops.reset_launch_counts()
            path, out, wall = _run_cli(image_transfer.main, argv)
            counts = ops.launch_counts()
        _add(total, counts)
        if f"ultra-res: tiling {h}x{w}" not in out:
            raise AssertionError(f"ultra CLI {tag}: no tiling line")
        n = probe.check(f"CLI {tag}", fast)
        want = {}
        if fast:
            for k in ULTRA_STYLE_ENCODE:
                want[k] = (n[1] * (ULTRA_PER_CHUNK[1][k]
                                   + ULTRA_PER_CHUNK[2][k])
                           + styles * ULTRA_STYLE_ENCODE[k])
            for k, v in ULTRA_SEG_CALL.items():
                want[k] = seg_calls * v
        got_counts = {k: v for k, v in counts.items() if v}
        if got_counts != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"ultra CLI {tag}: launches {counts}, "
                                 f"want {want}")
        got = np.asarray(Image.open(path))
        if got.shape != ULTRA_HW + (3,):
            raise AssertionError(f"ultra CLI {tag}: {got.shape}")
        print(f"ultra CLI {tag} {w}x{h}: main() {wall:.2f} s with set-up; "
              f"pass 1 {probe.device_ms(1):.1f} ms, pass 2 "
              f"{probe.device_ms(2):.1f} ms on the device ({n[1]} tile "
              f"batches a pass); launches {counts}")
        return got, out_dir, wall

    styles = ("--styles", f"{root}/style.png", f"{root}/style2.png",
              "--alpha_s", "0.3", "0.7")
    img = {}
    for tag, flags, kw in (
            ("fast global", ("--fast",), {}),
            ("fast auto_seg", ("--fast", "--auto_seg"), {"seg_calls": 2}),
            ("fast styles", ("--fast",) + styles, {"styles": 2}),
            ("fast alpha_c", ("--fast", "--alpha_c", "0.5"), {}),
            ("f32 global", (), {}),
            ("f32 styles", styles, {}),
            ("f32 alpha_c", ("--alpha_c", "0.5"), {})):
        img[tag] = image(tag, *flags, fast=tag.startswith("fast"), **kw)
    seg_dir = f"{img['fast auto_seg'][1]}/segmentation"
    img["f32 on the fast masks"] = image(
        "f32 on the fast masks", "--content_seg",
        f"{seg_dir}/content_seg_label.png", "--style_seg",
        f"{seg_dir}/style_seg_label.png", fast=False)
    for fast_tag, ref_tag in (("fast global", "f32 global"),
                              ("fast auto_seg", "f32 on the fast masks"),
                              ("fast styles", "f32 styles"),
                              ("fast alpha_c", "f32 alpha_c")):
        p = _u8_psnr(img[fast_tag][0], img[ref_tag][0])
        print(f"gate ultra CLI {fast_tag} vs {ref_tag}: PSNR {p:.2f} dB "
              f"(>= {PSNR_GATE})")
        if not p >= PSNR_GATE:
            raise AssertionError(f"ultra CLI {fast_tag} PSNR {p}")
    print(f"ultra CLI {w}x{h} main() wall seconds on {smi}: "
          + ", ".join(f"{k} {v[2]:.2f}" for k, v in img.items()))
    _ultra_breakdown(root, img["fast global"][0], device)
    if not os.path.isdir(seg_dir):
        raise AssertionError("no segmentation saved")
    tmp.cleanup()


# ---------------------------------------------------------------------------
# Phase 9: the HTTP style service
# ---------------------------------------------------------------------------

# (requests, H, W) of the concurrent burst: 1280x720 pads to the 1280x768
# bucket (half-res widths 640 and 320: K2 then K3), 960x540 to 960x576
# (480 and 240: K3 at both)
SERVE_BURST = [(16, 720, 1280), (8, 540, 960)]
SERVE_PER_BATCH = {
    (768, 1280): {"coupling_mma": 60, "transition_mma": 2,
                  "transition_half_mma": 2},
    (576, 960): {"coupling_mma": 60, "transition_half_mma": 4}}
# the float32 service gets this many requests of each burst shape
SERVE_F32_EACH = 2
# the steady window: closed-loop clients, each sending its next request as
# soon as its last reply came, measured for SERVE_WINDOW_S after
# SERVE_WARM_S of warm-up
SERVE_CLIENTS = 8
SERVE_WARM_S = 3.0
SERVE_WINDOW_S = 30.0


def _serve_probe_class():
    from vstnet_tpu_torch.serve import StyleService

    class _ServeProbe(StyleService):
        """A service that keeps, for every batch, its requests, its padded
        shape, when it ended on time.perf_counter, its launches and its
        device time."""

        def __init__(self, ops, *a, **kw):
            self.ops = ops
            self.sizes, self.batches = [], []
            super().__init__(*a, **kw)

        def _drain_batch(self, first=None):
            batch, stash = super()._drain_batch(first)
            if batch is not None:
                self.sizes.append(len(batch))
            return batch, stash

        def _stylize_batch(self, frames, style_name):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = self.ops.launch_counts()
            start.record()
            out = super()._stylize_batch(frames, style_name)
            end.record()
            after = self.ops.launch_counts()
            end.synchronize()
            self.batches.append({
                "shape": tuple(frames.shape[:3]),
                "t": time.perf_counter(),
                "ms": start.elapsed_time(end),
                "launches": {k: v - before[k] for k, v in after.items()
                             if v != before[k]}})
            return out

    return _ServeProbe


def _png(arr):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _serve_breakdown(data, reps=3):
    """A request's host work, each part alone on one thread: decoding the
    content PNG (a handler thread) and encoding the reply PNG (the worker,
    one reply after another)."""
    from vstnet_tpu_torch.serve import _decode_image, _encode_png

    arr = _decode_image(data, 1280, 4)
    t0 = time.perf_counter()
    for _ in range(reps):
        _decode_image(data, 1280, 4)
    t_dec = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        _encode_png(arr[0])
    t_enc = (time.perf_counter() - t0) / reps
    print(f"serve breakdown at {arr.shape[2]}x{arr.shape[1]}, each part "
          f"alone on one host thread: request PNG decode {t_dec * 1e3:.1f} "
          f"ms, reply PNG encode {t_enc * 1e3:.1f} ms")


def _tail(lat_s):
    """'p50 x ms, pK y ms, p95 z ms (n requests)': pK is the highest whole
    percentile with at least ten samples beyond it."""
    import numpy as np

    n = len(lat_s)
    k = max(50, int(100 * (n - 10) / n)) if n > 10 else 50
    qs = sorted({50, k, 95})
    return ", ".join(f"p{q} {float(np.percentile(lat_s, q)) * 1e3:.1f} ms"
                     for q in qs) + f" ({n} requests)"


def _serve_window(call, url, contents, alone):
    """SERVE_CLIENTS closed-loop clients on the live service, each cycling
    through its share of the contents until the window ends. Returns the
    requests that ended inside the window as (start, end, seconds), and
    the window's (start, end) on time.perf_counter. Every reply must be
    200 and equal the same content sent alone."""
    import threading

    t_w0 = time.perf_counter() + SERVE_WARM_S
    t_w1 = t_w0 + SERVE_WINDOW_S
    done, errors = [], []

    def client(k):
        idx = list(range(k, len(contents), SERVE_CLIENTS))
        i = 0
        while time.perf_counter() < t_w1:
            n = idx[i % len(idx)]
            i += 1
            t0 = time.perf_counter()
            try:
                status, body, sec = call(url, contents[n][0])
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"{type(e).__name__}: {e}")
                return
            if status != 200 or body != alone[n]:
                errors.append(f"request {n}: status {status}, equal to "
                              f"alone {body == alone[n]}")
                return
            done.append((t0, t0 + sec, sec))

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_WARM_S + SERVE_WINDOW_S + 300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve window: {errors or 'a client hung'}")
    return [d for d in done if t_w0 <= d[1] <= t_w1], (t_w0, t_w1)


def _serve_batched_cwct(model, ls, mu, gen, device):
    """The service's batch with the cWCT as one batched call against the
    per-frame calls the service makes, on both of its routes: max abs
    difference of the transferred latents and of the uint8 outputs, and
    each form's time, at both burst buckets and the service's largest
    batch. The fused route uses the registered style's factors (ls, mu),
    the float32 route the first frame's. Printed, not gated: it records
    why the service runs the cWCT frame by frame."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import revresnet_fast as rf

    fp, cfg, net = model.fast_params, model.cfg, model.net
    c = cfg.latent_channels
    for h, w in sorted(SERVE_PER_BATCH):
        x = (_frames(gen, SERVE_B, (h, w), device) * 255).round() / 255.0
        with torch.no_grad():
            zp = rf.encode_fast(fp, x.to(fp["dtype"]), cfg,
                                packed_latent=True)
            z32 = net.encode(x)
            ls32, mu32 = cwct.style_factors(z32[:1])
            routes = {
                "fused": (zp, lambda z: cwct.transfer_with_factors_packed(
                    z, ls, mu, c), lambda z: rf.decode_fast(
                        fp, z, cfg, packed_latent=True)),
                "float32": (z32, lambda z: cwct.transfer_with_factors(
                    z, ls32, mu32), net.decode)}
            for route, (z, transfer, decode) in routes.items():

                def loop():
                    return torch.cat([transfer(z[i:i + 1])
                                      for i in range(z.shape[0])])

                def batched():
                    return transfer(z)

                z_loop, z_bat = loop(), batched()
                t_loop = _time_ms(loop, iters=5)
                t_bat = _time_ms(batched, iters=5)
                o_loop, o_bat = (torch.round(decode(v).float().clamp(0, 1)
                                             * 255.0)
                                 for v in (z_loop, z_bat))
                torch.cuda.synchronize()
                print(f"serve cWCT {route} at {w}x{h} B={SERVE_B}: one "
                      f"batched call vs the per-frame calls: latent max abs "
                      f"diff {_max_err(z_bat.float(), z_loop.float()):.3e} "
                      f"(bit-equal {torch.equal(z_bat, z_loop)}), uint8 "
                      f"output max diff {_max_err(o_bat, o_loop):.0f} "
                      f"level(s) on {int((o_bat != o_loop).sum())} of "
                      f"{o_loop.numel()} values; batched {t_bat:.3f} ms, "
                      f"per-frame {t_loop:.3f} ms")


def phase_serve(ops, model, device, gen, total, smi):
    """StyleService(fast=True) behind serve(port=0) in this process: one
    style registered, a burst of concurrent requests at two bucket shapes,
    each reply against the same content sent alone, launches per batch,
    the burst's drain time and latencies; then a steady window of
    closed-loop clients (requests/s, latency, the worker's device and
    encode shares); the batched cWCT against the per-frame one; then a
    float32 service on requests of both shapes."""
    import io
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from vstnet_tpu_torch.serve import StyleService, serve

    def up(svc):
        httpd = serve(svc, host="127.0.0.1", port=0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        return httpd, th, f"http://127.0.0.1:{httpd.server_address[1]}"

    def down(httpd, th, svc):
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
        svc.close(timeout=60)

    def call(url, data, method="POST"):
        """(status, body, seconds); a non-200 reply raises HTTPError."""
        t0 = time.perf_counter()
        req = urllib.request.Request(url, data=data, method=method)
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read(), time.perf_counter() - t0

    def check_launches(batches, what):
        for b in batches:
            want = SERVE_PER_BATCH.get(b["shape"][1:])
            if b["launches"] != want:
                raise AssertionError(f"serve {what} batch {b['shape']}: "
                                     f"launches {b['launches']}, want "
                                     f"{want}")

    style = _png((_frames(gen, 1, ULTRA_STYLE, device)[0] * 255).round()
                 .to(torch.uint8).cpu().numpy())
    contents = []
    for n, h, w in SERVE_BURST:
        frames = (_frames(gen, n, (h, w), device) * 255).round().to(
            torch.uint8).cpu().numpy()
        contents += [(_png(f), (h, w)) for f in frames]

    svc = _serve_probe_class()(ops, model, fast=True)
    httpd, th, base = up(svc)
    try:
        url = f"{base}/stylize?style=s"
        ops.reset_launch_counts()
        call(f"{base}/styles/s", style, "PUT")
        reg = {k: v for k, v in ops.launch_counts().items() if v}
        # one request of each shape first: the first batch at a shape
        # pays cuBLAS set-up
        for data, _ in contents[:1] + contents[-1:]:
            call(url, data)
        _add(total, ops.launch_counts())
        svc.sizes.clear()
        svc.batches.clear()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(contents)) as pool:
            futs = [pool.submit(call, url, data) for data, _ in contents]
            replies = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        _add(total, counts)
        sizes, batches = list(svc.sizes), list(svc.batches)
        alone = [call(url, data)[1] for data, _ in contents]

        svc.sizes.clear()
        svc.batches.clear()
        ops.reset_launch_counts()
        win, (t_w0, t_w1) = _serve_window(call, url, contents, alone)
        _add(total, ops.launch_counts())
        w_batches = list(svc.batches)
        w_log = [e for e in svc.batch_log if t_w0 <= e[0] <= t_w1]
        ls, mu = svc.styles["s"]
    finally:
        down(httpd, th, svc)
    if reg != ULTRA_STYLE_ENCODE:
        raise AssertionError(f"serve registration launches {reg}, want "
                             f"{ULTRA_STYLE_ENCODE}")
    for (status, body, _), (_, (h, w)), solo in zip(replies, contents,
                                                   alone):
        if status != 200:
            raise AssertionError(f"serve: status {status}")
        if np.asarray(Image.open(io.BytesIO(body))).shape != (
                h - h % 4, w - w % 4, 3):
            raise AssertionError(f"serve: reply shape at {w}x{h}")
        if body != solo:
            raise AssertionError(f"serve: a {w}x{h} reply differs from the "
                                 f"same content sent alone")
    check_launches(batches, "burst")
    check_launches(w_batches, "window")
    lat = [r[2] for r in replies]
    dev_ms = sum(b["ms"] for b in batches)
    per_batch = ", ".join(f"{b['shape']} {b['ms']:.1f}" for b in batches)
    print(f"serve fused burst: {len(contents)} requests sent at once "
          f"({', '.join(f'{n} at {w}x{h}' for n, h, w in SERVE_BURST)}) "
          f"drained in {wall:.3f} s (start-up and tail included: not a "
          f"steady rate); {len(sizes)} batches, requests a batch {sizes} "
          f"(mean {np.mean(sizes):.2f}); latency {_tail(lat)}; device (CUDA "
          f"events) {dev_ms:.1f} ms over the batches ({per_batch}); "
          f"every reply 200 and equal, bit for bit, to the same content "
          f"sent alone; launches {counts}; on {smi}")

    if not win or not w_log:
        raise AssertionError("serve window: no request or batch completed")
    w_sizes = [e[1] for e in w_log]
    w_dev = sum(e[3] for e in w_log)
    w_enc = sum(e[4] for e in w_log)
    w_gpu = sum(b["ms"] for b in w_batches if t_w0 <= b["t"] <= t_w1) / 1e3
    print(f"serve fused steady window: {SERVE_CLIENTS} closed-loop clients "
          f"(their share of the {len(contents)} contents each, in turn), "
          f"{SERVE_WINDOW_S:.0f} s after {SERVE_WARM_S:.0f} s of warm-up: "
          f"{len(win)} requests ended in the window = "
          f"{len(win) / SERVE_WINDOW_S:.2f} requests/s; latency "
          f"{_tail([d[2] for d in win])}; "
          f"{len(w_log)} batches ended in the window, mean "
          f"{np.mean(w_sizes):.2f} requests a batch; the worker's host "
          f"clock over the window: device section (lock, upload, launches, "
          f"readback) {w_dev:.3f} s = "
          f"{100 * w_dev / SERVE_WINDOW_S:.1f} %, "
          f"reply PNG encodes {w_enc:.3f} s = "
          f"{100 * w_enc / SERVE_WINDOW_S:.1f} % "
          f"({1e3 * w_enc / sum(w_sizes):.1f} ms a reply); the device by "
          f"CUDA events {w_gpu:.3f} s = {100 * w_gpu / SERVE_WINDOW_S:.1f} "
          f"%; every reply 200 and equal "
          f"to the same content sent alone; on {smi}")

    _serve_breakdown(contents[0][0])
    _serve_batched_cwct(model, ls, mu, gen, device)

    offsets = np.cumsum([0] + [n for n, _, _ in SERVE_BURST[:-1]])
    picks = [int(o) + i for o in offsets for i in range(SERVE_F32_EACH)]
    svc32 = StyleService(model, fast=False)
    httpd, th, base = up(svc32)
    try:
        call(f"{base}/styles/s", style, "PUT")
        ops.reset_launch_counts()
        with ThreadPoolExecutor(max_workers=len(picks)) as pool:
            futs = [pool.submit(call, f"{base}/stylize?style=s",
                                contents[i][0]) for i in picks]
            ref = [f.result()[1] for f in futs]
        if any(ops.launch_counts().values()):
            raise AssertionError("the float32 service launched a kernel")
    finally:
        down(httpd, th, svc32)
    for i, want in zip(picks, ref):
        h, w = contents[i][1]
        p = _u8_psnr(np.asarray(Image.open(io.BytesIO(replies[i][1]))),
                     np.asarray(Image.open(io.BytesIO(want))))
        print(f"gate serve fused vs float32 reply at {w}x{h}: PSNR "
              f"{p:.2f} dB (>= {PSNR_GATE})")
        if not p >= PSNR_GATE:
            raise AssertionError(f"serve PSNR {p} at {w}x{h}")


# ---------------------------------------------------------------------------
# Phase 10: training
# ---------------------------------------------------------------------------

# Gates of phase 10, set from the first card run (H100 80GB HBM3, 700 W).
# A float32 loss_and_grads at full depth (TF32 off) against the same call in
# float64 on the card: each aux loss within TRAIN_F64_AUX_RTOL (measured
# 3.9e-4 at worst), the flattened gradient's cosine above TRAIN_F64_COS
# (measured 0.999999) and its relative L2 error below TRAIN_F64_REL_L2
# (measured 1.4e-3: the gradient is a sum of terms that cancel, decode
# undoing encode, and cuDNN's float32 backward sums in an order that leaves
# a residue float64 does not). bf16 against float32: the contract of
# tests/test_train.py's bf16 step (cosine > 0.95; aux rtol 0.1, atol 5e-3),
# which the CPU test holds in its own setting, on the same temporal call
# with every term on. The aux bounds apply to each loss term; loss_total,
# their weighted sum, is printed: it carries 10 x the cycle loss, which is
# zero in exact arithmetic for any weights (decode undoes encode, and the
# Cholesky cWCT of an affine image of z_c returns z_c), so its value is
# the route's roundoff, larger in bf16 by design (+59 %, within the atol;
# loss_total +10.4 % and +10.8 % in two runs).
# A step resumed from last.pt and last.pt.opt.pt against the uninterrupted
# step on the same batch: the checkpoint restores the weights, Adam's
# moments, its step and the schedule bit for bit; the step's parameters
# then agree within TRAIN_RESUME_TOL, a tenth of one step's size (lr 1e-4;
# a resume that lost Adam's moments moves parameters by ~lr). cuDNN runs
# deterministic algorithms for the check, but the reflection pad's backward
# adds with atomics, so two runs of one step differ (measured 5.4e-7; the
# run prints that floor).
TRAIN_F64_AUX_RTOL = 2e-3
TRAIN_F64_COS = 0.99999
TRAIN_F64_REL_L2 = 1e-2
TRAIN_BF16_COS = 0.95
TRAIN_BF16_AUX_RTOL = 0.1
TRAIN_BF16_AUX_ATOL = 5e-3
TRAIN_RESUME_TOL = 1e-5
# the CLI run: 24 content and 24 style PNGs of about 600x520, so that the
# loader resizes (shorter side to 512) and crops (256)
TRAIN_IMAGES = (24, 520, 600)
TRAIN_LINE = (r"^Iteration: (\d{8})/(\d{8})  content_loss:(\S+)  "
              r"lap_loss:(\S+)  rec_loss:(\S+)  style_loss:(\S+)  "
              r"loss_tmp:(\S+)  loss_tmp_GT:(\S+)  \((\S+) s/it\)$")


def _flat_grads(grads):
    return torch.cat([g.flatten().double() for g in grads.values()])


def _train_batch(gen, b, hw, device):
    """(a, s, flow, noise) on the card: smooth content and style crops, a
    fake flow from the trainer's generator, noise at the trainer's
    stddev."""
    import numpy as np

    from vstnet_tpu_torch.ops.warp import generate_fake_flow

    a = _frames(gen, b, hw, device)
    s = _frames(gen, b, hw, device)
    f = generate_fake_flow(np.random.default_rng(7), hw, hw)
    flow = torch.from_numpy(f).to(device)[None].expand(b, hw, hw, 2)
    noise = (0.0015 * torch.randn(a.shape, generator=gen)).to(device)
    return a, s, flow, noise


def _train_cli(device, gen, smi):
    """Part 1: the train CLI as a user runs it, two phases and a resume."""
    import os
    import re
    import tempfile

    from PIL import Image

    from vstnet_tpu_torch.cli.train import main as train_main
    from vstnet_tpu_torch.models.pipeline import StyleModel

    tmp = tempfile.TemporaryDirectory(prefix="vstnet_train_")
    root = tmp.name
    n, h, w = TRAIN_IMAGES
    for side in ("content", "style"):
        os.makedirs(f"{root}/{side}")
        imgs = (_frames(gen, n, (h, w), device) * 255).round().to(
            torch.uint8).cpu().numpy()
        for i, img in enumerate(imgs):
            Image.fromarray(img).save(f"{root}/{side}/{i:02d}.png")
    argv = ["--train_content", f"{root}/content",
            "--train_style", f"{root}/style",
            "--vgg_ckpoint", f"{root}/no_vgg.pth",
            "--batch_size", "2", "--new_size", "512", "--crop_size", "256",
            "--training_iterations", "8", "--fine_tuning_iterations", "8",
            "--model_save_interval", "4", "--image_display_iter", "4",
            "--image_save_iter", "8", "--display_size", "4",
            "--log_every", "1", "--logs_directory", f"{root}/logs",
            "--base_name", "run"]
    run = f"{root}/logs/run"
    ckpt = f"{run}/checkpoints"
    state, out, wall1 = _run_cli(train_main, argv + ["--max_steps", "12"])
    assert state.step == 12, state.step
    assert "random VGG weights" in out
    assert os.path.exists(f"{ckpt}/model_image.pt")
    assert not os.path.exists(f"{ckpt}/model_video.pt")
    state, out, wall2 = _run_cli(train_main,
                                 argv + ["--max_steps", "4", "--resume"])
    assert state.step == 16, state.step
    assert "at iter 12" in out
    lines = open(f"{run}/loss.log").read().splitlines()
    assert len(lines) == 16, len(lines)
    for i, line in enumerate(lines, 1):
        m = re.match(TRAIN_LINE, line)
        assert m, line
        vals = [float(v) for v in m.groups()[2:8]]
        assert int(m.group(1)) == i and int(m.group(2)) == 16, line
        assert all(math.isfinite(v) for v in vals), line
        # the step that starts past training_iterations (8) is temporal
        assert (vals[4] > 0) == (i > 9), line
    for name in ("model_image.pt", "model_video.pt", "last.pt",
                 "last.pt.opt.pt"):
        assert os.path.exists(f"{ckpt}/{name}"), name
    for name in ("train_current.jpg", "train_00000008.jpg",
                 "train_00000016.jpg"):
        assert os.path.exists(f"{run}/images/{name}"), name
    html = open(f"{run}/index.html").read()
    assert "train_00000016.jpg" in html and "train_00000008.jpg" in html
    x = _frames(gen, 2, 256, device)
    for name in ("model_image.pt", "model_video.pt"):
        model = StyleModel.from_checkpoint(f"{ckpt}/{name}", device=device)
        y = model.stylize(x[:1], x[1:])
        assert y.shape == (1, 256, 256, 3) and bool(torch.isfinite(y).all())
    print(f"train cli: PHOTO_CONFIG full depth, B=2, 256 crops of 512 "
          f"resizes, float32: 12 steps (8 image, 4 temporal) in {wall1:.2f} "
          f"s, --resume 4 more (step 16) in {wall2:.2f} s, start-up, loader "
          f"and samples included; loss.log 16 lines; last: {lines[-1]} "
          f"[{smi}]")
    tmp.cleanup()


def _bf16_vs_f32(net, vgg, batch, weights, ref, ref_aux, smi):
    """The temporal loss_and_grads in bf16 against the float32 gradient
    `ref` and aux `ref_aux` of the same call: float32 gradients, finite,
    cosine above TRAIN_BF16_COS, each loss term within the contract's aux
    bounds; loss_total, their weighted sum, is printed (see the gates)."""
    from vstnet_tpu_torch.train.losses import AUX_KEYS, loss_and_grads

    g16, aux16 = loss_and_grads(net, vgg, *batch[:2], weights, *batch[2:],
                                True, precision="bf16")
    assert all(g.dtype == torch.float32 for g in g16.values())
    g16 = _flat_grads(g16)
    cos = float(ref @ g16 / (ref.norm() * g16.norm()))
    dev = {k: abs(float(aux16[k]) - float(ref_aux[k])) for k in AUX_KEYS}
    bad = [k for k in AUX_KEYS[:-1] if dev[k] > TRAIN_BF16_AUX_ATOL
           + TRAIN_BF16_AUX_RTOL * abs(float(ref_aux[k]))]
    total = dev["loss_total"] / abs(float(ref_aux["loss_total"]))
    print(f"train bf16 vs f32 (same inputs): grad cosine {cos:.5f} (gate > "
          f"{TRAIN_BF16_COS}), aux bf16/f32 "
          + ", ".join(f"{k} {float(aux16[k]):.6g}/{float(ref_aux[k]):.6g}"
                      for k in AUX_KEYS)
          + f" (gate on each term: rtol {TRAIN_BF16_AUX_RTOL}, atol "
          f"{TRAIN_BF16_AUX_ATOL}; loss_total off by {100 * total:.1f} %) "
          f"[{smi}]")
    assert bool(torch.isfinite(g16).all()) and cos > TRAIN_BF16_COS, cos
    assert not bad, bad


def _train_correctness(device, gen, smi):
    """Part 2: float32 against float64, bf16 against float32, and a resumed
    step against the uninterrupted one."""
    import copy
    import tempfile

    from vstnet_tpu_torch.config import PHOTO_CONFIG
    from vstnet_tpu_torch.models.revresnet import RevResNet
    from vstnet_tpu_torch.models.vgg import init_vgg
    from vstnet_tpu_torch.train import trainer as tr
    from vstnet_tpu_torch.train.losses import (
        AUX_KEYS,
        LossWeights,
        loss_and_grads,
    )

    net = RevResNet(PHOTO_CONFIG.with_remat(), device=device)
    net.init_weights(torch.Generator().manual_seed(0))
    vgg = init_vgg(torch.Generator().manual_seed(42), device=device)
    a, s, flow, noise = _train_batch(gen, 2, 128, device)
    w = LossWeights()
    g32, aux32 = loss_and_grads(net, vgg, a, s, w, flow, noise, True)
    g32 = _flat_grads(g32)
    net64, vgg64 = copy.deepcopy(net).double(), copy.deepcopy(vgg).double()
    g64, aux64 = loss_and_grads(net64, vgg64, a.double(), s.double(), w,
                                flow, noise.double(), True,
                                precision="f64")
    g64 = _flat_grads(g64)
    cos = float(g32 @ g64 / (g32.norm() * g64.norm()))
    rel = float((g32 - g64).norm() / g64.norm())
    errs = {k: abs(float(aux32[k]) / float(aux64[k]) - 1)
            for k in AUX_KEYS if float(aux64[k]) != 0}
    worst = max(errs.values())
    print(f"train f32 vs f64: PHOTO_CONFIG full depth, B=2, 128x128, "
          f"temporal, lap 1500, rec 10: aux rel err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (gate {TRAIN_F64_AUX_RTOL}), grad cosine {cos:.7f} (gate > "
          f"{TRAIN_F64_COS}), rel L2 {rel:.3e} (gate < {TRAIN_F64_REL_L2}); "
          + ", ".join(f"{k} {float(aux32[k]):.6g}" for k in AUX_KEYS)
          + f" [{smi}]")
    assert all(math.isfinite(float(aux32[k])) for k in AUX_KEYS)
    assert worst <= TRAIN_F64_AUX_RTOL and cos > TRAIN_F64_COS
    assert rel < TRAIN_F64_REL_L2
    del net64, vgg64

    _bf16_vs_f32(net, vgg, (a, s, flow, noise), w, g32, aux32, smi)

    # resume: two steps, a checkpoint, then the same third step from the
    # live state and from the checkpoint (twice, for the floor)
    tc = tr.TrainConfig(weights=LossWeights(temporal=0.0))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state = tr.init_train_state(tc, device)
        batches = [_train_batch(gen, 2, 128, device)[:2] for _ in range(3)]
        for a_, s_ in batches[:2]:
            tr.train_step(state, vgg, a_, s_, tc)
        tmp = tempfile.TemporaryDirectory(prefix="vstnet_resume_")
        tr.save_checkpoint(state, tmp.name)
        resumed = [tr.load_checkpoint(tc, tmp.name, device=device)
                   for _ in range(2)]
        r = resumed[0]
        assert r.step == state.step == 2
        for p, q in zip(state.net.parameters(), r.net.parameters()):
            assert torch.equal(p, q)
        so, ro = state.opt.state_dict(), r.opt.state_dict()
        for i, st in so["state"].items():
            for k, v in st.items():
                assert torch.equal(v.cpu(), ro["state"][i][k].cpu()), k
        assert state.sched.state_dict() == r.sched.state_dict()
        for st in [state] + resumed:
            tr.train_step(st, vgg, *batches[2], tc)

        def diff(x, y):
            return max(float((p - q).abs().max()) for p, q in
                       zip(x.net.state_dict().values(),
                           y.net.state_dict().values()))

        d_resume, d_floor = diff(state, resumed[0]), diff(resumed[0],
                                                          resumed[1])
        tmp.cleanup()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"train resume: checkpoint at step 2 restores weights, Adam state "
          f"and schedule bit for bit; step 3 resumed vs uninterrupted: max "
          f"param diff {d_resume:.3e} (gate {TRAIN_RESUME_TOL}), two resumed "
          f"runs of step 3: {d_floor:.3e} [{smi}]")
    assert d_resume <= TRAIN_RESUME_TOL


def _idle_share(step):
    """One step under torch.profiler: (device busy ms, wall ms), or None
    where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()) / 1e3
    except RuntimeError:
        return None
    return (busy, wall) if busy > 0 else None


def _train_timings(device, gen, smi):
    """Part 3: steps/s, peak memory and the device's idle share at 256x256
    B=2, PHOTO_CONFIG, both phases, float32 and bf16, remat on and off;
    then 2 steps of ARTISTIC_CONFIG."""
    from vstnet_tpu_torch.config import ARTISTIC_CONFIG, PHOTO_CONFIG
    from vstnet_tpu_torch.models.revresnet import RevResNet
    from vstnet_tpu_torch.models.vgg import init_vgg
    from vstnet_tpu_torch.train import trainer as tr

    vgg = init_vgg(torch.Generator().manual_seed(42), device=device)
    a, s, flow, noise = _train_batch(gen, 2, 256, device)
    for precision in ("f32", "bf16"):
        for remat in (True, False):
            for temporal in (False, True):
                tc = tr.TrainConfig(precision=precision)
                cfg = PHOTO_CONFIG.with_remat() if remat else PHOTO_CONFIG
                net = RevResNet(cfg, device=device)
                net.init_weights(torch.Generator().manual_seed(0))
                state = tr.init_train_state(tc, device, net)

                def step():
                    return tr.train_step(state, vgg, a, s, tc, flow, noise,
                                         temporal)

                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = _time_ms(step, iters=10, warmup=3)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                aux = step()
                assert math.isfinite(float(aux["loss_total"]))
                idle = _idle_share(step)
                idle_s = ("not measured" if idle is None else
                          f"{100 * (1 - idle[0] / idle[1]):.1f} % (kernels "
                          f"{idle[0]:.2f} ms of {idle[1]:.2f} ms)")
                print(f"time train step PHOTO_CONFIG 256x256 B=2 "
                      f"{precision} remat {'on' if remat else 'off'} "
                      f"{'temporal' if temporal else 'image'}: {ms:.2f} ms "
                      f"= {1e3 / ms:.3f} steps/s, peak memory {peak:.2f} "
                      f"GiB, device idle {idle_s} [{smi}]")
                del state, net
    tc = tr.TrainConfig(mode="artistic")
    state = tr.init_train_state(tc, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        aux = tr.train_step(state, vgg, a, s, tc)
        assert math.isfinite(float(aux["loss_total"]))
    torch.cuda.synchronize()
    print(f"train ARTISTIC_CONFIG (hidden 64, sp_steps 1) 256x256 B=2 "
          f"float32 remat on: 2 steps in {time.perf_counter() - t0:.2f} s "
          f"(first calls included), loss_total {float(aux['loss_total']):.6g}"
          f" [{smi}]")


def phase_train(device, gen, smi):
    """Phase 10: the training path (no kernel of the port lies on it)."""
    _train_cli(device, gen, smi)
    _train_correctness(device, gen, smi)
    _train_timings(device, gen, smi)


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
    phase_cli(ops, device, gen, total, smi)
    print(f"phase cli done at {time.perf_counter() - t0:.1f} s")
    phase_ultra(ops, model, device, gen, total, smi)
    print(f"phase ultra done at {time.perf_counter() - t0:.1f} s")
    phase_serve(ops, model, device, gen, total, smi)
    print(f"phase serve done at {time.perf_counter() - t0:.1f} s")
    phase_train(device, gen, smi)
    print(f"phase train done at {time.perf_counter() - t0:.1f} s")
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
          "bf16 batches and 1 float32 batch at 512x512 and 1 float32 batch "
          "at 640x360, masked 2 batches, seg 256 and 640x360 one each, "
          "phase 7's CLI runs and photo_pipeline, phase 8's fused tiled "
          "runs at 3840x2160, phase 9's fused service); ms, plain_ms, "
          "bound_ms and library_ms are sums over the launches of one "
          "encode at B=8 (coupling_mma 30 "
          "and transition_mma 2 in bf16 at 512x512, transition_half_mma 2 "
          "in bf16 at 640x360; coupling, transition and transition_half, "
          "the float32 route's kernels, 30, 2 and 2 in float32 at the same "
          "sizes) or of one segment call at 512x512 B=8 in bf16 "
          "(attention 3, dwconv_gelu 41; dwconv_gelu's ms by CUDA-graph "
          "replay, the others' eagerly); bound_ms sums each launch's "
          "bound and bound_by names the kind that holds the larger share; "
          "max_abs_err is the largest kernel-vs-plain error of phase 3, in "
          "bf16 (coupling, transition, transition_half: in float32)")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
