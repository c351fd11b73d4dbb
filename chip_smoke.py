"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

Drives the port's two video paths (vstnet_tpu_torch), its two CLIs, the
ultra-resolution tiler, the HTTP style service, the trainer, GGUF weights,
the smoke CLI, the export artifacts, the data-parallel layer, the
native tier, row sharding and the row-sharded training step through the
entry points a user calls, at the full width and depth of PHOTO_CONFIG
and SegFormer-B4 (512x512 frames in bf16, 1280x720 clips, 3840x2160
images, 1280x720 and 960x540 requests, 256x256 and 1024x1024 training
crops), with random
weights made from a seed. Phases, in
order; any failure raises and the process exits non-zero:

  1. device   a CUDA card is present; print its nvidia-smi name and power
              limit.
  2. build    build the CUDA kernels from csrc/ (nvcc, one process per
              source, first use); clear TF32 for cuDNN and matmul so the
              float32 plain versions are true float32.
     export   make phase 4's model and phase 5's segmenter from their
              seeds; export the full-depth stylize program and
              SegFormer-B4's segment-render at 512x512 (phase 11's
              artifacts of those names and phase 13's programs) to .pt2
              files, and start phase 13's two AOTInductor compiles in two
              child processes at once, each with a cold Inductor cache
              (Packages). They run beside phases 3-5 and phase 15's
              float64 references ("spatial train f64") only, which print
              gates and launch counts (the references nothing); the run
              waits for both ("package join") before phase 7, so that no
              phase that
              prints a host clock, an enqueue, frames/s, requests/s,
              steps/s or the runner's execute ms (phases 7-15) and no
              timing phase runs beside a compile. A child that fails or
              outlives PACKAGE_TIMEOUT fails the run.
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the paths' shapes: K1 coupling and K2 transition (batch 2,
              forward and inverse, float32 on the CUDA-core kernels with a
              float32 round trip, bit for bit, also at planes that no 16x16
              tile divides at B=1 and 3 (F32_TAILS), bf16 on the
              tensor-core kernels, checked also at sizes with tails and
              with H or W below the tile, and inverse(forward(x)) against
              x), K3 half-res transition at the
              640x360 shapes (the same, plus K2 == K3 on unshuffled streams
              bit for bit, also at the ragged sizes), K4 attention at
              the SegFormer shapes, one ragged shape and one with M = 4096,
              K5 depthwise conv + GELU at the four MixFFN shapes of 512x512
              and of 1024x1024 frames and at one ragged shape, each printed
              with whether it equals its plain version bit for bit; then
              in bf16 at the shapes of the later phases' paths: the tiler
              (B=4), the service (B=8), the stage-3 plane of 1280x720
              frames that the video programs run (K1 at 180x320, B=8),
              the smoke CLI's photo test
              (1024x1024 at B=2: K1, K2, K4 on the model's views, K5) and
              phase 11's GGUF stylizes (512x512 at B=1: K1, K2).
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
              and K2 4, all on the tensor cores, K4 3, K5 41, each regional
              cWCT kernel 1) and the gates:
              kernel-route logits against the plain bf16 route's, mask
              agreement on the pixels the plain route decides by more than
              a bf16 ulp, bf16 kernel route against the float32 plain route
              on the same masks; then once
              with the segmenter at 256x256 (no K4: under the routing
              threshold) and once on 640x360 frames (K3 in place of K2).
  6. timings  each kernel against its plain version (and, for K4, against
              scaled_dot_product_attention) at batch 8 in bf16, beside its
              bound, with the route each K1 shape took (and, at C=256,
              how many launches took the warpgroup kernel, also at the
              tiler's, the smoke photo's, the service buckets' and the
              video programs' 180x320 C=256 shapes); the CUDA-core K1,
              K2 and K3 kernels in float32, beside PERF.md's PR 4 time
              from before the redesign (F32_EARLIER, not measured here); K2 against K3 with the
              caller's (un)shuffle at the 512x512 and the 640x360 shapes;
              K5 by CUDA-graph replay (its device time: called eagerly, the
              wrapper's host time is the larger at the small shapes), also
              at the 1024x1024 shapes, beside cuDNN's depthwise conv + GELU
              as a yardstick; SegFormer-B4 alone (CUDA events, and one call
              under torch.profiler for its device time and idle share);
              both programs' frames/s and the masked program's stages,
              with CUDA events, the regional cWCT's ms and peak memory at
              K = 32, and its statistics against float64 on the batch's
              latents under synthetic label maps (each valid region's
              covariance within 5e-7 of its max, transfer_masked and
              transfer_masked_factored within 2e-5 of the transfer's
              max); the remap's label counts (scatter_add_)
              against torch.bincount; for the record, outside the kernels
              line, K1-K5 at the tiler's, the smoke CLI's photo test's and
              the service's shapes.
     regions  (after the timings) the regional cWCT's two kernels
              (csrc/regions.cu) against their plain loops in bf16 at the
              auto-seg cell's batch (8 x 1280x720, C=32, K=16) and the 4K
              tiler's tile batch (4 x 1024x1024 as one frame of rows,
              K=32): the moments bit-equal twice over, counts equal, sums
              and Gram within 1e-12 of the plain float64 sums' max, the
              apply within 2 bf16 ulps of its scale; kernel, plain and
              bound ms of each; transfer_masked_factored on the auto-seg
              batch with the kernels and with the plain loops, and its
              launches (one of each kernel).
  7. cli      (run after phase 5; phases 7-11 before the timings) the
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
              float32 (auto-seg: on the --fast run's saved masks), and in
              --fast on phase 4's weights written as a .pt and as the JAX
              package's native .msgpack (save_native(params_to_jax(...))),
              the two PNGs equal byte for byte; then
              photo_pipeline(fast=True) against photo_pipeline().
  8. ultra    (after phase 7) the tiled path on a smooth 3840x2160 content
              with a 1024x576 style: ultra.stylize_tiled in float32 at the
              exact overlap (the receptive field, rounded up to a multiple
              of 4) against whole-image StyleModel.stylize (> 55 dB), the
              fused route on the same grid against it (>= 40 dB), the
              regional pass 1's statistics and transform (fused, synthetic
              label maps) against float64 of the owned latent rows (5e-7,
              2e-5, as phase 6), the global pass 1's likewise on the fused
              route (one untimed ultra._content_stats call) and on the
              float32 route (the default-overlap call), the
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
              numbers); a step resumed from last.pt and its
              .opt.msgpack (the JAX trainer's flat layout, and the same
              mid-run state in the JAX tree layout) equal to the
              uninterrupted one. Steps/s (CUDA events, 10 steps after 3),
              peak memory and the device's idle share of one step
              (torch.profiler) at 256x256 B=2 in both phases, float32 and
              bf16, remat on and off; 2 steps of ARTISTIC_CONFIG.
 11. tools    (after phase 10) GGUF: the random PHOTO_CONFIG weights
              written at F16, Q8_0 and Q4_0 and read back to the card, each
              through the fused bf16 stylize at 512x512 (90 K1 and 6 K2
              launches) against the float32 weights, F16 >= 40 dB and every
              F16 weight equal to its original rounded to float16, with the
              write and read seconds. The smoke CLI as child processes, one
              after another: --test all (parity, shapes at 512, 10
              shapes, bench at 512 B=8), train (3 iterations) and photo at
              1024x1024 under --profile, whose trace must name K1, K2, K4
              and K5 (each by its __global__ function), with the fast
              call's launches, the trace's kernels by time and the memory
              report. torch.export: the five artifacts at
              512x512 (stylize, encoder, decoder on the PHOTO_CONFIG
              weights; segmenter, segment-render on SegFormer-B4; stylize
              and segment-render are the programs exported before phase 3,
              with the export and save seconds measured then), loaded
              by load_exported and run on the card against the eager
              functions: <= 1e-4, masks equal on >= 99 % of the decided
              pixels; export and load seconds, each artifact's MB and one
              call's measured memory, and what TF32 would cost the stylize
              artifact; the stylize program at one block a stage traced on
              the CPU and run on the card against the one traced on the
              card (within 1e-6 of its max, beside float64). The
              invertible 1x1 conv (ops/invconv.py) at 64 channels on a
              512x512 batch of 4 in float32: inverse(forward(x)) within
              INVCONV_TOL of x, forward within it of float64, its ms.
 12. parallel (after phase 11) the data-parallel layer over every card, or
              over two replicas on cuda:0 where the host has one card (a
              line then says that NCCL between cards was not exercised):
              parallel_stylize_fused (global and alpha_c 0.5) and
              parallel_stylize_masked_fused at 512x512, 8 frames a
              replica, each shard equal bit for bit to the single-device
              program on it, the batch >= 40 dB against float32, each
              device's K1-K5 launches equal to one call's times its
              replicas, frames/s over the replicas (CUDA events on each
              device) beside one device's; max(2, cards) training ranks
              (NCCL across cards, gloo over CUDA tensors when they share
              one) for 3 steps (image, image, temporal) at 256x256, 2
              images a rank, PHOTO_CONFIG float32, weights bit-equal
              across ranks and within the stated bound of the
              single-process steps on the global batch, steps/s; the video
              CLI over the devices on 16 frames of 1280x720 (K2 and K3)
              and a service burst of 16 requests, each frame and reply
              within one uint8 level of the single-device run, with
              per-device launches.
 13. native   (after phase 12; no kernel of the port lies on this path)
              the engine and the runner built with g++ against torch's
              CUDA libraries (ldd: libtorch_cuda, no libpython), the
              full-depth PHOTO_CONFIG stylize and SegFormer-B4's
              segment-render packaged by AOTInductor at 512x512 float32
              for the card with a cold Inductor cache beside phases 3-5
              (each package's compile seconds, measured in its child,
              with the phases and the other compile beside it, and MB);
              NativeEngine within 1e-4 of the
              eager float32 stylize under true_f32; the runner on four
              512x512 contents and one 1280x720 (both resizes), each PNG
              within one uint8 level of the eager output, its own process
              holding a CUDA context on the card; segment-render through
              NativeEngine within 1e-4 on >= 99 % of the pixels (label
              flips printed) and through the runner within one level;
              the runner's execute ms per image beside the eager
              program's, with the card's name and power limit.
 14. spatial  (after phase 13; no kernel of the port lies on this path)
              row sharding: parallel_stylize and
              parallel_stylize_factored with spatial=True on a (1, S)
              mesh, S = 2 and 4, over S cards or S replicas on cuda:0
              (said so), full-depth PHOTO_CONFIG in float32 with TF32 off
              on phase 8's 3840x2160 content and 1024x576 style, each
              within 1e-4 of model.stylize and of the single-device
              factored program, decode_rows(encode_rows(x)) > 100 dB;
              wall, device and host enqueue ms a call, halo bytes a
              call, each card's peak memory beside the single-device
              run's, with the card's name and power limit.
 15. spatial train (after phase 14; no kernel of the port lies on this
              path) the row-sharded training step:
              parallel_train_step(rows=...) on a (1, S) mesh, S = 2 and
              4, over S cards or S replicas on cuda:0 (said so),
              full-depth PHOTO_CONFIG with remat in float32 with TF32 off,
              one 1024x1024 content and style at B=1 from the phase's own
              generator, one step of the image and of the temporal phase,
              each against train_step on one device and the unsharded
              float64 gradient (computed once a phase, before phase 7,
              beside the package compiles: "spatial train f64"): cosine >
              0.99999 and rel L2 < 1e-2 against the unsharded step, the
              row form no further from float64 than 2x the unsharded
              float32 step (+1e-4) over the tensors, each aux term
              within rtol 1e-4 / atol 2e-5, the parameters after the step
              within 3 lr (mean 1e-6); ms a step (CUDA events), host
              enqueue ms, calls that wait for the device and each
              device's peak memory beside the unsharded step's, with the
              card's name and power limit; then loss_and_grads_rows in
              bf16 against the unsharded bf16 call (cosine > 0.99); no
              kernel of the port launched.

Before the kernels' line, `phase seconds: build ..., spatial train ...,
timings ..., regions ..., programs ..., total T of 1200` gives each
phase's wall seconds. The last two lines of output are the kernels' JSON record and
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
# (kernel, C, full-res H, W, B, cuDNN) of the float32 CUDA-core kernels'
# extra checks: planes that no 16x16 tile divides (half-res for K2/K3),
# below one tile, the smallest a reflect pad allows, at B=1 and B=3, at
# shapes where the plain version's convs sum in the kernels' order (K1 with
# cuDNN on at C=16 and 64, off at C=256; the transitions' plain versions
# run without it): bit for bit. scripts/torch_f32_parent.py holds the
# kernels against their earlier version where no plain conv does
F32_TAILS = [("K1", 16, 70, 33, 3, True), ("K1", 16, 2, 2, 1, True),
             ("K1", 64, 9, 50, 3, True), ("K1", 64, 3, 17, 1, True),
             ("K1", 256, 100, 140, 1, False), ("K1", 256, 140, 100, 3, False),
             ("K2", 16, 250, 300, 1, False), ("K2", 16, 130, 270, 3, False),
             ("K2", 64, 260, 200, 1, False), ("K2", 64, 300, 180, 3, False)]
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
# (name, B, heads, N, M, launches per segment call) of the attention that
# K4 is not routed to (fewer than MIN_Q queries), PyTorch's flash SDPA in
# the model's views: stages 2-4 of 512x512 frames at the timings' batch;
# then stages 3 and 4 of the auto-seg cell's 1280x720 frames at its batch
SDPA_SHAPES = [("512 s2", 8, 2, 4096, 256, 8), ("512 s3", 8, 5, 1024, 256, 27),
               ("512 s4", 8, 8, 256, 256, 3)]
SDPA_CELL = [("720p s3", 8, 5, 3600, 880), ("720p s4", 8, 8, 920, 920)]
# (name, B, h, w, H, W) of the logits' upsample and argmax: 512x512 frames
# at the timings' batch, the auto-seg cell's batch, and shapes whose tiles
# the image cuts on both axes at a scale other than 4
UA_SHAPES = [("512", 8, 128, 128, 512, 512),
             ("720p", 8, 180, 320, 720, 1280),
             ("ragged", 2, 17, 23, 67, 91), ("twofold", 1, 45, 80, 90, 160)]
SEG_CLASSES = 150
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
# the smoke CLI's photo test at 1024x1024 encodes and segments the content
# and the style as one batch of 2: K1 and K2 at the tiler's shapes at B=2,
# K4 in the model's layout (q a (B, N, heads, 64) view of the q
# projection, k and v views of one (B, M, 2, heads, 64) kv projection):
# stage 1 with 1 head (G=2), stage 2 with 2 heads (G=4); K5 at the
# 1024x1024 shapes at B=2. Phase 11's GGUF stylizes encode content and
# style apart at 512x512: K1 and K2 at B=1
SMOKE_B = 2
SMOKE_K4 = [("smoke 1024 s1", 1, 65536, 1024), ("smoke 1024 s2", 2, 16384,
                                                1024)]
GGUF_B = 1
SERVE_B = 8
BUCKET_K1 = [("bucket 960x576 s3", 256, 144, 240),
             ("bucket 1280x768 s3", 256, 192, 320)]
# the stage-3 plane of 1280x720 frames, as the video programs (phase 7's
# CLI at --batch 8) run K1 there: C=256 at 180x320, batch 8
HD_B = 8
HD_K1 = [("720p s3", 256, 180, 320)]
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
    # no TPU kernel: the JAX package's one-hot scans, left to XLA
    "region_moments": ("vstnet_tpu_torch/csrc/regions.cu", "none"),
    "region_apply": ("vstnet_tpu_torch/csrc/regions.cu", "none"),
    # no TPU kernel: the segmenter stages' attention that K4 is not routed
    # to, on PyTorch's flash SDPA (a library kernel, counted by its
    # wrapper), and the logits' upsample and argmax
    "attention_sdpa": ("torch flash SDPA, vstnet_tpu_torch/ops/attention.py",
                       "none"),
    "upsample_argmax": ("vstnet_tpu_torch/csrc/upsample_argmax.cu", "none"),
}
# one bf16 segment call's launches of the two at 512x512 frames (and at
# 640x360: stage 1 takes K4, stages 2-4 SDPA)
SEG_NEW_512 = {"attention_sdpa": 38, "upsample_argmax": 1}
# the regional cWCT's launches: one of each kernel a regional transfer
# of a batch (the moments once more for a style, twice for
# transfer_masked's content and style)
REGION_ONCE = {"region_moments": 1, "region_apply": 1}


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


def bound_upsample_argmax(b, h, w, big_h, big_w, c=SEG_CLASSES):
    """The logits (B, h, w, C) float32 read, the int32 mask (B, H, W)
    written; three multiply-adds a class a pixel (two x blends and a y
    blend), float32 outside the tensor cores."""
    return _bound(4.0 * b * (h * w * c + big_h * big_w),
                  6.0 * b * big_h * big_w * c, PEAK_F32)


def _model_views(gen, b, heads, n, m, device):
    """q a (B, N, heads, 64) view of a q projection, k and v views of one
    (B, M, 2, heads, 64) kv projection, bf16, drawn on the card."""
    d, bf = 64, torch.bfloat16
    q = torch.randn((b, n, heads * d), generator=gen, device=device,
                    dtype=bf).view(b, n, heads, d)
    kv = torch.randn((b, m, 2 * heads * d), generator=gen, device=device,
                     dtype=bf).view(b, m, 2, heads, d)
    return q, kv[:, :, 0], kv[:, :, 1]


def upsample_argmax_ties(got, logits, h, w):
    """The pixels where the fused mask differs from the plain one, and how
    many of them have their two largest upsampled logits more than a
    float32 ulp apart (0 where the difference is only rounding)."""
    from vstnet_tpu_torch.ops.resize import resize_bilinear

    up = resize_bilinear(logits, h, w)
    off = got != up.argmax(-1).to(torch.int32)
    top2 = up[off].topk(2, dim=-1).values
    next_up = torch.nextafter(top2[:, 0], torch.full_like(top2[:, 0],
                                                          float("inf")))
    wide = int((top2[:, 0] - top2[:, 1] > next_up - top2[:, 0]).sum())
    return int(off.sum()), wide


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
    f32 = torch.float32
    for kind, c, h, w, b, cudnn in F32_TAILS:
        x1 = torch.randn((b, c, h, w), generator=gen).to(device)
        x2 = torch.randn((b, c, h, w), generator=gen).to(device)
        if kind == "K2":
            wp = cf.pack_transition_weights(
                _rand_branch(gen, c, c, 4 * c, device), f32)
            _k2_k3_checks(cf, f"f32 tails C={c} {h}x{w} B={b} fma", x1, x2,
                          wp, worst)
            continue
        wp = cf.pack_coupling_weights(
            _rand_branch(gen, c, c // 4, c, device), f32)
        y = cf.fused_coupling(x1, x2, wp)
        back = cf.fused_coupling(y, x2, wp, inverse=True)
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            refs = (cf.coupling_block_plain(x1, x2, wp),
                    cf.coupling_block_plain(y, x2, wp, inverse=True))
        torch.cuda.synchronize()
        for what, got, ref in (("fwd", y, refs[0]), ("inv", back, refs[1])):
            _check(f"K1 f32 tails C={c} {h}x{w} B={b} fma {what} (cuDNN "
                   f"{'on' if cudnn else 'off'})", got, ref, F32_TOL,
                   worst, "coupling", exact=True)
        _check(f"K1 f32 tails C={c} {h}x{w} B={b} round trip", back, x1,
               ROUND_TRIP_TOL)
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

    k1 = ([(k, TILE_B) for k in TILE_K1] + [(k, SMOKE_B) for k in TILE_K1]
          + [(k[:4], GGUF_B) for k in K1_SHAPES[:3]]
          + [(k, SERVE_B) for k in BUCKET_K1] + [(k, HD_B) for k in HD_K1])
    for (name, c, h, w), b in k1:
        wp = cf.pack_coupling_weights(
            _rand_branch(gen, c, c // 4, c, device), bf)
        x1, x2 = streams(b, c, h, w)
        for inv in (False, True):
            got = cf.fused_coupling(x1, x2, wp, inverse=inv)
            ref = cf.coupling_block_plain(x1, x2, wp, inverse=inv)
            torch.cuda.synchronize()
            _check(f"K1 {name} C={c} {h}x{w} B={b} bf16 mma "
                   f"{'inv' if inv else 'fwd'}", got, ref, _bf16_tol(ref),
                   worst, "coupling_mma")
        _k1_bf16_round_trip(cf, f"K1 {name} C={c} B={b}", x1, x2, wp)
    for (name, c, h, w), b in ([(k, TILE_B) for k in TILE_K2]
                               + [(k, SMOKE_B) for k in TILE_K2]
                               + [(k[:4], GGUF_B) for k in K2_SHAPES]
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
    for name, heads, n, m in SMOKE_K4:
        d = att.HEAD_DIM
        q = torch.randn((SMOKE_B, n, heads * d), generator=dgen,
                        device=device, dtype=bf).view(SMOKE_B, n, heads, d)
        kv = torch.randn((SMOKE_B, m, 2 * heads * d), generator=dgen,
                         device=device, dtype=bf).view(SMOKE_B, m, 2, heads,
                                                       d)
        k, v = kv[:, :, 0], kv[:, :, 1]
        got = att.sr_attention(q, k, v, 0.125)
        ref = att.sr_attention_plain(q, k, v, 0.125)
        torch.cuda.synchronize()
        _check(f"K4 {name} G={SMOKE_B * heads} N={n} M={m} bf16 (B="
               f"{SMOKE_B}, {heads} head(s), the model's views)", got, ref,
               _bf16_tol(ref), worst, "attention")
    k5 = ([(2,) + k[:4] for k in K5_SHAPES] + [(1,) + k for k in K5_BIG]
          + [(SMOKE_B,) + k for k in K5_BIG] + [(3,) + K5_RAGGED])
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
    for name, b, heads, n, m in [x[:5] for x in SDPA_SHAPES] + SDPA_CELL:
        q, k, v = _model_views(dgen, b, heads, n, m, device)
        before = att.sr_attention.launches
        got = att.sr_attention_sdpa(q, k, v, 0.125)
        ref = att.sr_attention_plain(q, k, v, 0.125)
        torch.cuda.synchronize()
        if att.sr_attention.launches != before:
            raise AssertionError("the SDPA route launched K4")
        _check(f"SDPA {name} B={b} heads={heads} N={n} M={m} bf16 (flash, "
               f"the model's views)", got, ref, _bf16_tol(ref), worst,
               "attention_sdpa")
    from vstnet_tpu_torch.ops import upsample_argmax as ua

    for name, b, h, w, big_h, big_w in UA_SHAPES:
        logits = torch.randn((b, h, w, SEG_CLASSES), generator=dgen,
                             device=device) * 4
        got = ua.upsample_argmax(logits, big_h, big_w)
        off, wide = upsample_argmax_ties(got, logits, big_h, big_w)
        print(f"check upsample_argmax {name} B={b} {h}x{w} -> {big_h}x"
              f"{big_w}: {off} of {got.numel()} pixels differ from "
              f"resize_bilinear + argmax, {wide} of them by more than a "
              f"float32 ulp between their two largest logits")
        worst["upsample_argmax"] = max(worst["upsample_argmax"], float(off))
        if wide or got.dtype != torch.int32:
            raise AssertionError(f"upsample_argmax {name}: {wide} pixels "
                                 "differ beyond rounding")
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


def phase_global(ops, model, device, gen, total):
    """model: StyleModel.random_init(seed=0), made in main before phase 3."""
    from vstnet_tpu_torch import ARTISTIC_CONFIG, PHOTO_CONFIG
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.models.pipeline import StyleModel, make_fused_video_fn

    cfg = PHOTO_CONFIG
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
    return style


# ---------------------------------------------------------------------------
# Phase 5: the masked (auto-seg) video path
# ---------------------------------------------------------------------------

class _plain_segformer_kernels:
    """Within the block the segmenter's kernel call sites (K4, the SDPA
    route, K5, the fused upsample and argmax) run their plain versions:
    the plain bf16 route, same dtype chain."""

    NAMES = ("sr_attention", "sr_attention_sdpa", "dwconv3x3_bias_gelu",
             "fused_mask")

    def __enter__(self):
        from vstnet_tpu_torch.models import segformer as sf
        from vstnet_tpu_torch.ops import attention, dwconv

        self.sf = sf
        self.saved = [getattr(sf, n) for n in self.NAMES]
        for name, plain in zip(self.NAMES, (
                attention.sr_attention_plain, attention.sr_attention_plain,
                dwconv.dwconv3x3_bias_gelu_plain, lambda *a: False)):
            setattr(sf, name, plain)

    def __exit__(self, *exc):
        for name, fn in zip(self.NAMES, self.saved):
            setattr(self.sf, name, fn)


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


def phase_masked(ops, model, seg, style, device, gen, total):
    """seg: Segmenter.load(None, seed=0), made in main before phase 3."""
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
            "transition_half_mma": 0, "attention": 3, "dwconv_gelu": 41,
            **SEG_NEW_512, **REGION_ONCE}
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
    out, m256 = run(small, frames, dict(want, attention=0,
                                        attention_sdpa=41), "seg 256x256")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _add(total, counts)
    agree = float((m256 == masks).float().mean())
    print(f"masked seg_hw=(256, 256): launches {counts}: attention is 0, "
          f"4096 queries are under the routing threshold of {MIN_Q} (all 41 "
          f"blocks on SDPA); masks agree with native on {agree:.4f}")
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
    return region, plan


# ---------------------------------------------------------------------------
# Phase 6: timings
# ---------------------------------------------------------------------------

# the float32 CUDA-core kernels' ms a launch at batch 8 before their
# redesign, as PERF.md records them from PR 4's chip run (K1 and K2 at
# 512x512, K3 at 640x360, H100 80GB HBM3 at 700 W): constants, printed
# beside phase 6's float32 rows under that label and measured by no run of
# this script; scripts/torch_f32_parent.py times the earlier kernels in the
# same call as the current ones
F32_EARLIER = {("coupling", 16): 1.052, ("coupling", 64): 1.851,
               ("coupling", 256): 7.828, ("transition", 16): 1.818,
               ("transition", 64): 4.166, ("transition_half", 16): 1.338,
               ("transition_half", 64): 3.642}


def _line(kernel, name, shape, tk, tp, bound, lib=None, dtype="bf16",
          earlier=None):
    bms, by = bound
    lib_s = "" if lib is None else f", library {lib:.3f} ms"
    old_s = ("" if earlier is None else
             f", earlier {earlier:.3f} ms (PERF.md, PR 4; not this run)")
    print(f"time {kernel} {name} {shape} {dtype}: kernel {tk:.3f} ms, plain "
          f"{tp:.3f} ms{lib_s}, bound {bms:.4f} ms ({by}), "
          f"{100 * bms / tk:.1f} % of it{old_s}")


def phase_timings(cf, att, dw, device, gen, batch=8):
    """Per-launch times at batch 8, in bf16 and, for the CUDA-core K1, K2
    and K3 kernels, in float32. Returns per kernel {"ms", "plain_ms",
    "bound_ms", "bound_by", "library_ms"}: the sums over the launches of
    one encode (K1 and K2, by kernel, at 512x512; K3 at 640x360) or of one
    segment call at 512x512 (K4, K5)."""
    from vstnet_tpu_torch.ops.coupling import pixel_shuffle, pixel_unshuffle

    bf = torch.bfloat16
    gen_dev = torch.Generator(device=device).manual_seed(2)
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

    def wg_share(run):
        """run(), and its launches of the C=256 warpgroup kernel out of
        its tensor-core K1 launches (fused_coupling.wg_launches of
        .mma_launches), as text."""
        wg0 = cf.fused_coupling.wg_launches
        mma0 = cf.fused_coupling.mma_launches
        out = run()
        wg = cf.fused_coupling.wg_launches - wg0
        mma = cf.fused_coupling.mma_launches - mma0
        return out, f", warpgroup kernel {wg} of {mma} launches"

    for name, c, h, w, count in K1_SHAPES:
        wp = cf.pack_coupling_weights(
            _rand_branch(gen, c, c // 4, c, device), bf)
        x1, x2 = pair(c, h, w)
        (tk, tp), wg = wg_share(lambda: _time_pair(
            lambda: cf.fused_coupling(x1, x2, wp),
            lambda: cf.coupling_block_plain(x1, x2, wp)))
        bound = bound_coupling(batch, c, h, w)
        route = cf.coupling_route(bf, c, c // 4)
        key = "coupling_mma" if route == "mma" else "coupling"
        _line(key, name, f"C={c} {h}x{w} B={batch} route {route}{wg}", tk,
              tp, bound)
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
              tk, tp, bound, dtype="float32",
              earlier=F32_EARLIER[("coupling", c)])
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
                      dtype=_dt(dt), earlier=F32_EARLIER.get((key, c))
                      if dt == f32 else None)
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
    # the tiler's, the smoke CLI's photo test's, the service's and the
    # video programs' stage-3 shapes, bf16
    for (name, c, h, w), b in ([(k, TILE_B) for k in TILE_K1]
                               + [(k, SMOKE_B) for k in TILE_K1]
                               + [(k, SERVE_B) for k in BUCKET_K1]
                               + [(k, HD_B) for k in HD_K1]):
        wp = cf.pack_coupling_weights(
            _rand_branch(gen, c, c // 4, c, device), bf)
        x1, x2 = (torch.randn((b, c, h, w), generator=gen).to(device, bf)
                  for _ in range(2))
        (tk, tp), wg = wg_share(lambda: _time_pair(
            lambda: cf.fused_coupling(x1, x2, wp),
            lambda: cf.coupling_block_plain(x1, x2, wp), iters=5))
        _line("coupling_mma", name, f"C={c} {h}x{w} B={b}{wg}", tk, tp,
              bound_coupling(b, c, h, w))
    for (name, c, h, w), b, half in ([(k, TILE_B, False) for k in TILE_K2]
                                     + [(k, SMOKE_B, False)
                                        for k in TILE_K2]
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
    # the smoke CLI's photo test: B=2 in the model's layout (as phase 3)
    for name, heads, n, m in SMOKE_K4:
        q = torch.randn((SMOKE_B, n, heads * 64), generator=gen).to(
            device, bf).view(SMOKE_B, n, heads, 64)
        kv = torch.randn((SMOKE_B, m, 2 * heads * 64), generator=gen).to(
            device, bf).view(SMOKE_B, m, 2, heads, 64)
        k, v = kv[:, :, 0], kv[:, :, 1]
        tk, tp = _time_pair(lambda: att.sr_attention(q, k, v, 0.125),
                            lambda: att.sr_attention_plain(q, k, v, 0.125))
        lib = _time_ms(lambda: torch.nn.functional.
                       scaled_dot_product_attention(
                           q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), scale=0.125))
        _line("attention", name, f"G={SMOKE_B * heads} N={n} M={m} (B="
              f"{SMOKE_B}, {heads} head(s))", tk, tp,
              bound_attention(SMOKE_B * heads, n, m), lib)
    # the stages K4 is not routed to, on flash SDPA in the model's views:
    # at 512x512 B=8 (the record's segment call) and at the auto-seg cell's
    # shapes, beside K4 (csrc/attention.cu) and cuDNN's SDPA at the same
    # shapes, neither of which the route takes
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def cudnn_sdpa(q, k, v):
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                scale=0.125)

    for name, b, heads, n, m, *count in SDPA_SHAPES + SDPA_CELL:
        q, k, v = _model_views(gen_dev, b, heads, n, m, device)
        tk, tp = _time_pair(lambda: att.sr_attention_sdpa(q, k, v, 0.125),
                            lambda: att.sr_attention_plain(q, k, v, 0.125),
                            iters=5)
        bound = bound_attention(b * heads, n, m)
        _line("attention_sdpa", name, f"B={b} heads={heads} N={n} M={m}",
              tk, tp, bound)
        if count:
            tally("attention_sdpa", count[0], tk, tp, bound)
        else:
            k4 = _time_ms(lambda: att.sr_attention(q, k, v, 0.125))
            try:
                cudnn = f"{_time_ms(lambda: cudnn_sdpa(q, k, v)):.3f} ms"
            except RuntimeError as exc:
                cudnn = f"not run ({str(exc)[:60]})"
            print(f"time attention_sdpa {name}: beside it K4 (not routed "
                  f"here) {k4:.3f} ms, cuDNN SDPA {cudnn}")
    from vstnet_tpu_torch.ops import upsample_argmax as ua

    for name, b, h, w, big_h, big_w in UA_SHAPES[:2]:
        logits = torch.randn((b, h, w, SEG_CLASSES), generator=gen_dev,
                             device=device)
        tk, tp = _time_pair(
            lambda: ua.upsample_argmax(logits, big_h, big_w),
            lambda: ua.upsample_argmax_plain(logits, big_h, big_w), iters=5)
        bound = bound_upsample_argmax(b, h, w, big_h, big_w)
        _line("upsample_argmax", name, f"B={b} {h}x{w}x{SEG_CLASSES} -> "
              f"{big_h}x{big_w}", tk, tp, bound, dtype="float32")
        if name == "512":
            tally("upsample_argmax", 1, tk, tp, bound)
    # K5 by graph replay; eagerly too, and cuDNN's bf16 channels_last
    # depthwise conv with bias, then F.gelu: a yardstick of two calls that
    # the port never makes (no single call computes K5: library_ms is None)
    for b, name, c, h, w, count in ([(batch,) + k for k in K5_SHAPES]
                                    + [(1,) + k + (0,) for k in K5_BIG]
                                    + [(SMOKE_B,) + k + (0,)
                                       for k in K5_BIG]):
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
    from vstnet_tpu_torch.models import remapping
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
    # the remap's per-frame label counts: the fixed-length scatter_add_
    # that torch.export needs, against the torch.bincount it replaced
    n = remapping.NUM_CLASSES + 1
    flat = (cm_raw.reshape(batch, -1).long() + n * torch.arange(
        batch, device=device)[:, None]).reshape(-1)
    ms, ms_b = _time_pair(lambda: remapping._count(flat, batch * n),
                          lambda: torch.bincount(flat, minlength=batch * n))
    same = torch.equal(remapping._count(flat, batch * n),
                       torch.bincount(flat, minlength=batch * n))
    print(f"time remap label counts 512x512 B={batch}: scatter_add_ "
          f"{ms:.4f} ms, torch.bincount {ms_b:.4f} ms, equal {same}")
    if not same:
        raise AssertionError("remap counts differ from torch.bincount")

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

    # the regional statistics against float64 on this batch's latents, cast
    # up, under synthetic label maps at the same bucket
    zs = rf.encode_fast(fast, style.to(bf), cfg)
    cm = region_masks(1, k, *z_c.shape[:3]).to(device)
    sm = region_masks(2, k, *zs.shape[:3]).to(device)
    cov, masked_d, factored_d = region_distances(z_c.float(), zs.float(), cm,
                                                 sm, k)
    print(f"gate regional cWCT 512x512 B={batch} K={k} (the batch's bf16 "
          f"latents cast up, synthetic label maps) vs float64: covariances "
          f"{cov:.3e} of their max (<= {REGION_COV_GATE}), transfer_masked "
          f"{masked_d:.3e} and transfer_masked_factored {factored_d:.3e} of "
          f"the transfer's max (<= {REGION_TRANSFER_GATE})")
    if not (cov <= REGION_COV_GATE
            and max(masked_d, factored_d) <= REGION_TRANSFER_GATE):
        raise AssertionError("regional cWCT statistics off float64")


# ---------------------------------------------------------------------------
# The regional cWCT's kernels (phase "regions", after the timings)
# ---------------------------------------------------------------------------

# (what, frames, H, W, capacity K) of the regional kernels' rows: the
# auto-seg cell's batch (8 frames of 1280x720, the full-res 32-channel
# latent) and the 4K tiler's tile batch (4 tiles of 1024x1024 summed as
# one frame of rows)
REGION_SHAPES = (("auto-seg batch", 8, 720, 1280, 16),
                 ("tiler tile batch", 1, 4 * 1024, 1024, 32))
# the kernel's float64 moments against the plain loops' float64 sums, of
# the largest of them; the apply within BF16_ULPS of the output's scale
REGION_MOMENTS_TOL = 1e-12
# dense float64 on the tensor cores (NVIDIA's data sheet, H100 SXM)
PEAK_F64 = 67e12


def bound_region_moments(b, rows, c, k):
    """x (bf16) and its int32 labels read, the float64 moments written;
    the upper triangle's and the sums' multiply-adds in float64."""
    return _bound(rows * (2.0 * c + 4) + b * k * (c * c + c + 1) * 8.0,
                  2.0 * rows * (c * (c + 1) // 2 + c), PEAK_F64)


def bound_region_apply(b, rows, c, k):
    """x and its labels read, y written in bf16, the frames' transforms
    read; C * C multiply-adds a row in float32."""
    return _bound(rows * (4.0 * c + 4) + b * k * (c * c + c + 1) * 4.0,
                  2.0 * rows * c * c, PEAK_F32)


def _region_batch(gen, b, h, w, k, device, c=32, cell=40):
    """bf16 rows (b, h*w, c) of a skewed latent, label maps (b, h*w) of
    cell x cell blocks over k - 2 labels, the table (k,) with two -1 pad
    slots, and each frame's transforms T = I + noise, b, all valid."""
    mix = torch.randn((c, c), generator=gen) / math.sqrt(c)
    x = (torch.randn((b * h * w, c), generator=gen) @ mix).to(
        device, torch.bfloat16).reshape(b, h * w, c)
    cells = torch.randint(0, k - 2, (b, -(-h // cell), -(-w // cell)),
                          generator=gen)
    m = cells.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    m = m[:, :h, :w].reshape(b, -1).to(device, torch.int32)
    labels = torch.cat([torch.arange(k - 2, dtype=torch.int32),
                        torch.full((2,), -1, dtype=torch.int32)]).to(device)
    ts = (torch.eye(c) + 0.1 * torch.randn((b, k, c, c), generator=gen)).to(
        device)
    bs = torch.randn((b, k, c), generator=gen).to(device)
    return x, m, labels, ts, bs, (labels >= 0).expand(b, k).contiguous()


def phase_regions(ops, device, gen):
    """The regional cWCT's two kernels against their plain loops at
    REGION_SHAPES in bf16: the moments equal twice over bit for bit, their
    counts equal the plain loops', sums and Gram within REGION_MOMENTS_TOL
    of the plain float64 sums' max; the apply within BF16_ULPS of the
    output's scale; then kernel, plain and bound ms of each (CUDA events,
    plain, kernel, kernel, plain), and transfer_masked_factored on the
    auto-seg batch with the kernels and with the plain loops, with its
    launches. Returns ({kernel: the largest error}, {kernel: the auto-seg
    batch's ms, plain_ms, bound_ms, bound_by, library_ms})."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.ops import regions

    worst = {"region_moments": 0.0, "region_apply": 0.0}
    rec = {}
    for what, b, h, w, k in REGION_SHAPES:
        x, m, labels, ts, bs, ok = _region_batch(gen, b, h, w, k, device)
        rows, c = b * h * w, x.shape[-1]
        got = regions.region_moments(x, m, labels)
        again = regions.region_moments(x, m, labels)
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"region_moments {what}: two runs differ")
        err = 0.0
        for i in range(b):
            want = cwct.region_moments_plain(x[i], m[i], labels)
            if not torch.equal(got[0][i], want[0]):
                raise AssertionError(f"region_moments {what}: counts differ")
            err = max(err, *(float((g[i] - v).abs().max() / v.abs().max())
                             for g, v in zip(got[1:], want[1:])))
        y = regions.apply_regions(x, m, labels, ts, bs, ok)
        y_plain = torch.stack([cwct.apply_regions_plain(
            x[i], m[i], labels, ts[i], bs[i], ok[i]) for i in range(b)])
        err_a = _max_err(y, y_plain)
        tol_a = _bf16_tol(y_plain)
        print(f"gate region_moments {what} C={c} K={k} B={b} {h}x{w} bf16: "
              f"two runs equal bit for bit, counts equal the plain loops', "
              f"sums and Gram {err:.3e} of the plain float64 sums' max "
              f"(<= {REGION_MOMENTS_TOL}); region_apply max abs err "
              f"{err_a:.3e} (<= {tol_a:.3e}, {BF16_ULPS} bf16 ulps of the "
              f"scale)")
        if not (err <= REGION_MOMENTS_TOL and err_a <= tol_a):
            raise AssertionError(f"regional kernels {what} off the plain "
                                 f"loops: {err}, {err_a}")
        worst["region_moments"] = max(worst["region_moments"], err)
        worst["region_apply"] = max(worst["region_apply"], err_a)

        def plain_moments():
            return [cwct.region_moments_plain(x[i], m[i], labels)
                    for i in range(b)]

        def plain_apply():
            return [cwct.apply_regions_plain(x[i], m[i], labels, ts[i],
                                             bs[i], ok[i]) for i in range(b)]

        for kernel, fn, plain, bound in (
                ("region_moments",
                 lambda: regions.region_moments(x, m, labels), plain_moments,
                 bound_region_moments(b, rows, c, k)),
                ("region_apply",
                 lambda: regions.apply_regions(x, m, labels, ts, bs, ok),
                 plain_apply, bound_region_apply(b, rows, c, k))):
            p0 = _time_ms(plain, iters=2, warmup=1)
            tk = min(_time_ms(fn, iters=20), _time_ms(fn, iters=20))
            tp = min(p0, _time_ms(plain, iters=2, warmup=1))
            _line(kernel, what, f"C={c} K={k} B={b} {h}x{w}", tk, tp, bound)
            if b == REGION_SHAPES[0][1]:
                rec[kernel] = {"ms": tk, "plain_ms": tp, "bound_ms": bound[0],
                               "bound_by": bound[1], "library_ms": None}

    # the masked program's regional stage on the auto-seg batch
    _, b, h, w, k = REGION_SHAPES[0]
    x, m, labels, _, _, _ = _region_batch(gen, b, h, w, k, device)
    style = cwct.style_region_factors(x[:1].reshape(1, h, w, -1),
                                      m[:1].reshape(1, h, w), k)
    feat, mask = x.reshape(b, h, w, -1), m.reshape(b, h, w)

    def stage():
        return cwct.transfer_masked_factored(feat, mask, *style)

    ops.reset_launch_counts()
    stage()
    counts = _nonzero(ops.launch_counts())
    tk = _time_ms(stage, iters=10)
    saved = regions.takes
    regions.takes = lambda x: False
    try:
        tp = _time_ms(stage, iters=2, warmup=1)
    finally:
        regions.takes = saved
    print(f"time regional cWCT (transfer_masked_factored) auto-seg batch "
          f"C=32 K={k} B={b} {h}x{w} bf16: kernels {tk:.3f} ms, plain loops "
          f"{tp:.3f} ms; launches of the kernels {counts}")
    if counts != REGION_ONCE:
        raise AssertionError(f"regional cWCT launches {counts}")
    return worst, rec


# ---------------------------------------------------------------------------
# The regional cWCT against float64 (phases 6 and 8; the card test
# tests/test_torch_cuda.py::test_region_statistics_on_card_match_float64)
# ---------------------------------------------------------------------------

# A float32 latent's regional statistics on the card: each valid region's
# covariance within REGION_COV_GATE of its own max from the float64
# statistics of the same values, and the regional transfer within
# REGION_TRANSFER_GATE of the max of the float64 transfer (the global
# cWCT's bounds, test_cwct_statistics_on_card_match_float64)
REGION_COV_GATE = 5e-7
REGION_TRANSFER_GATE = 2e-5
# the side of the one small square region of every synthetic label map
REGION_SMALL = 20


def region_masks(seed, n_labels, b, h, w):
    """(b, h, w) int32 label maps: n_labels distinct class ids in [0, 150)
    drawn by numpy's generator n_labels (so maps of one n_labels share
    them), laid out by its generator `seed`. All ids but the last tile a
    grid of blocks (each on at least two blocks); the last is one
    REGION_SMALL-square region a map, which MIN_PIXELS and
    MAX_RATIO_RESEARCH keep valid against a map of the same construction
    at up to ~30x the area."""
    import numpy as np

    ids = np.random.default_rng(n_labels).choice(
        150, n_labels, replace=False).astype(np.int32)
    rng = np.random.default_rng(seed)
    g = math.ceil(math.sqrt(2 * (n_labels - 1)))
    ys, xs = np.arange(h) * g // h, np.arange(w) * g // w
    out = np.empty((b, h, w), np.int32)
    for i in range(b):
        cells = ids[rng.permutation(g * g) % (n_labels - 1)].reshape(g, g)
        out[i] = cells[ys[:, None], xs[None, :]]
        y0 = int(rng.integers(0, h - REGION_SMALL))
        x0 = int(rng.integers(0, w - REGION_SMALL))
        out[i, y0:y0 + REGION_SMALL, x0:x0 + REGION_SMALL] = ids[-1]
    return torch.from_numpy(out)


def _rel(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max())


def stats_f64(x):
    """(mean, covariance with /(n-1)) of the rows of x (N, C) in float64
    from its float64 copy: the mean, then the centred Gram."""
    x = x.double()
    mean = x.mean(dim=0)
    xc = x - mean
    return mean, xc.t() @ xc / max(x.shape[0] - 1, 1)


def transform_f64(mc, cc, ms, cs):
    """(T, b) of the cWCT in float64 from float64 content statistics (mc,
    cc) and style statistics (ms, cs): T = Ls Lc^{-1} (Cholesky factors),
    b = mu_s - T mu_c."""
    lc = torch.linalg.cholesky(cc)
    t = torch.linalg.cholesky(cs) @ torch.linalg.solve_triangular(
        lc, torch.eye(lc.shape[0], dtype=lc.dtype, device=lc.device),
        upper=False)
    return t, ms - t @ mc


def region_f64(x, m, labels):
    """{label: (count, mean, covariance with /(n-1))} of the rows of x
    (N, C) under labels m (N,), for each real label of `labels`, in
    float64 (stats_f64 of the label's rows, picked by a boolean mask)."""
    return {lab: (int((m == lab).sum()), *stats_f64(x[m == lab]))
            for lab in labels.tolist() if lab >= 0}


def _valid_f64(nc, ns):
    from vstnet_tpu_torch.models import cwct

    r = cwct.MAX_RATIO_RESEARCH
    return (nc > cwct.MIN_PIXELS and ns > cwct.MIN_PIXELS and nc < r * ns
            and ns < r * nc)


def region_transfer_f64(x, m, sc, ss):
    """The regional cWCT of rows x (N, C) under labels m, in float64 from
    the float64 statistics sc (the content's) and ss (the style's) of
    region_f64: per valid label T = Ls Lc^{-1} (Cholesky factors), b =
    mu_s - T mu_c, applied to its rows; every other row keeps its
    content."""
    x = x.double()
    y = x.clone()
    for lab, (nc, mc, cc) in sc.items():
        if lab not in ss or not _valid_f64(nc, ss[lab][0]):
            continue
        t, b = transform_f64(mc, cc, *ss[lab][1:])
        sel = m == lab
        y[sel] = x[sel] @ t.t() + b
    return y


def _cov_worst(got, ref, other, labels):
    """The largest distance of a valid region's covariance from float64,
    each of its own max. got = (counts, means, covariances) by the index
    of `labels`; ref and other: region_f64 of this side and the other."""
    worst = 0.0
    for i, lab in enumerate(labels.tolist()):
        if lab in ref and lab in other and _valid_f64(ref[lab][0],
                                                      other[lab][0]):
            worst = max(worst, _rel(got[2][i], ref[lab][2]))
    return worst


def region_distances(zc, zs, cm, sm, k):
    """The regional cWCT of the latent zc (B, H, W, C) by the style latent
    zs (1, Hs, Ws, C) under label maps cm (B, H, W) and sm (1, Hs, Ws) at
    the latents' resolution with capacity k, on zc's device, against
    float64 on the float64 copies of the same values: (the worst valid
    region's covariance distance, content and style, each of its own max;
    transfer_masked's and transfer_masked_factored's distance of the
    float64 transfer's max)."""
    from vstnet_tpu_torch.models import cwct

    b, c = zc.shape[0], zc.shape[-1]
    xc, xs = zc.reshape(b, -1, c), zs.reshape(-1, c)
    cmr = cm.reshape(b, -1).to(torch.int32)
    smr = sm.reshape(-1).to(torch.int32)
    labels, ns, mean_s, cov_s = cwct.style_region_factors(zs, sm, k)
    ss = region_f64(xs, smr, labels)
    want = torch.empty(zc.shape, dtype=torch.float64, device=zc.device)
    worst = 0.0
    for i in range(b):
        lab_i = cwct._padded_labels(cmr[i], k)
        sc = region_f64(xc[i], cmr[i], lab_i)
        worst = max(worst,
                    _cov_worst(cwct._region_stats(xc[i], cmr[i], lab_i), sc,
                               ss, lab_i),
                    _cov_worst((ns, mean_s, cov_s), ss, sc, labels))
        want[i] = region_transfer_f64(xc[i], cmr[i], sc, ss).reshape(
            want.shape[1:])
    masked = cwct.transfer_masked(zc, zs.expand(b, *zs.shape[1:]), cm,
                                  sm.expand(b, *sm.shape[1:]), max_labels=k)
    factored = cwct.transfer_masked_factored(zc, cm, labels, ns, mean_s,
                                             cov_s)
    return worst, _rel(masked, want), _rel(factored, want)


class _TilerRegionProbe:
    """Within the block, models/ultra.py's regional pass 1 is recorded
    through the cwct functions it calls: the rows and labels of every
    region_moments call (the style's latent, then each tile batch's with
    -2 on the pixels a tile does not own), the statistics of every
    stats_from_moments call (the style's, then the content's), and the
    transforms of region_transforms, after which the block stops the run
    (pass 2 is not run)."""

    class Stop(Exception):
        pass

    def __enter__(self):
        from vstnet_tpu_torch.models import cwct

        self.cwct = cwct
        self.saved = {n: getattr(cwct, n) for n in (
            "region_moments", "stats_from_moments", "region_transforms")}
        self.moments, self.stats = [], []

        def moments(x, m, labels, *args, **kw):
            c = x.shape[-1]
            mr = m.reshape(-1)
            own = mr != -2
            self.moments.append((x.reshape(-1, c)[own], mr[own]))
            return self.saved["region_moments"](x, m, labels, *args, **kw)

        def stats(*args, **kw):
            self.stats.append(self.saved["stats_from_moments"](*args, **kw))
            return self.stats[-1]

        def transforms(labels, *args, **kw):
            self.labels = labels
            self.tsb = self.saved["region_transforms"](labels, *args, **kw)
            raise self.Stop

        cwct.region_moments = moments
        cwct.stats_from_moments = stats
        cwct.region_transforms = transforms
        return self

    def __exit__(self, kind, exc, tb):
        for name, fn in self.saved.items():
            setattr(self.cwct, name, fn)
        return kind is self.Stop


def tiler_region_distances(model, content, style, cmask, smask):
    """Pass 1 of ultra.stylize_tiled_masked on the fused route (the
    default tile and overlap, capacity cwct.label_capacity(cmask)): the
    per-label statistics it finalises for the style and for the content
    (the moments of the tile batches' owned pixels, added up) against
    float64 statistics of the same owned latent rows, and the transform
    they give (region_transforms, applied to those rows by apply_regions)
    against the float64 transfer of the rows. Returns (worst valid
    region's covariance distance, transfer distance, the probe)."""
    from vstnet_tpu_torch.models import cwct, ultra

    k = cwct.label_capacity(cmask)
    with _TilerRegionProbe() as probe:
        ultra.stylize_tiled_masked(
            model.net, content, style, cmask, smask, model.cfg,
            tile=ULTRA_TILE, overlap=ULTRA_OVERLAP, max_labels=k,
            fast_params=model.fast_params)
    labels = probe.labels
    (xs, ms), content_rows = probe.moments[0], probe.moments[1:]
    xc = torch.cat([x for x, _ in content_rows])
    mc = torch.cat([m for _, m in content_rows])
    ss, sc = region_f64(xs, ms, labels), region_f64(xc, mc, labels)
    worst = max(_cov_worst(probe.stats[0], ss, sc, labels),
                _cov_worst(probe.stats[-1], sc, ss, labels))
    got = cwct.apply_regions(xc, mc, labels, *probe.tsb)
    return worst, _rel(got, region_transfer_f64(xc, mc, sc, ss)), probe


# ---------------------------------------------------------------------------
# The global tiler's streamed statistics against float64 (phase 8;
# tests/test_torch_cuda.py::test_tiled_global_statistics_on_card_match_float64)
# ---------------------------------------------------------------------------

class _TilerGlobalProbe:
    """Within the block, pass 1 of the global tiler is recorded: the owned
    latent rows (N, C) of every tile batch that ultra._moments_chunk sums,
    taken from the batch's encode, and the (mean_c, cov_c) of every
    ultra._content_stats call."""

    def __enter__(self):
        from vstnet_tpu_torch.models import ultra

        self.ultra = ultra
        self.saved = {n: getattr(ultra, n) for n in (
            "_enc", "_moments_chunk", "_content_stats")}
        self.rows, self.stats = [], []

        def chunk(weights, content, y0s, x0s, acc, owns, *args, **kw):
            def enc(*a, **k):
                z = self.saved["_enc"](*a, **k)
                self.rows.append(z.reshape(-1, z.shape[-1])[
                    owns.reshape(-1) > 0])
                return z
            ultra._enc = enc
            try:
                return self.saved["_moments_chunk"](
                    weights, content, y0s, x0s, acc, owns, *args, **kw)
            finally:
                ultra._enc = self.saved["_enc"]

        def stats(*args, **kw):
            self.stats.append(self.saved["_content_stats"](*args, **kw))
            return self.stats[-1]

        ultra._moments_chunk = chunk
        ultra._content_stats = stats
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ultra, name, fn)


def tiler_global_distances(probe, z_style):
    """The last (mean_c, cov_c) a _TilerGlobalProbe recorded, against the
    float64 statistics of the owned rows it recorded: (the covariance's
    distance of its max, the transfer's distance of the float64
    transfer's max). The transfer is cwct.transform_from_stats against
    cwct.style_factors(z_style), as ultra.stylize_tiled makes them,
    applied to the rows by cwct.apply_transform; the float64 one takes
    the float64 statistics of the rows and of z_style (1, Hs, Ws, C)."""
    from vstnet_tpu_torch.models import cwct

    rows = torch.cat(probe.rows)
    mean_c, cov_c = probe.stats[-1]
    ls, mu_s = cwct.style_factors(z_style)
    got = cwct.apply_transform(rows, *cwct.transform_from_stats(
        mean_c, cov_c, ls[0], mu_s[0]))
    mc, cc = stats_f64(rows)
    t, b = transform_f64(mc, cc, *stats_f64(
        z_style.reshape(-1, z_style.shape[-1])))
    return _rel(cov_c, cc), _rel(got, rows.double() @ t.t() + b)


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
# of the 60, the C=256 blocks' (9 stage-3 and 2 reduction blocks an encode
# and a decode), every one on the warpgroup kernel
# (fused_coupling.wg_launches)
CLI_WG_PER_BATCH = 22


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
                from vstnet_tpu_torch.ops.coupling_fused import (
                    fused_coupling)

                before = self.ops.launch_counts()
                wg = fused_coupling.wg_launches
                out = fn(*args)
                after = self.ops.launch_counts()
                self.calls.append({
                    "factory": factory, "make": (fa, fkw), "args": args,
                    "masked": masked, "frames": args[5 if masked else 1],
                    "launches": {k: v - before[k] for k, v in after.items()
                                 if v != before[k]},
                    "wg": fused_coupling.wg_launches - wg})
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
        want_call = dict(want, **REGION_ONCE) if masked else want
        if call["launches"] != want_call:
            raise AssertionError(f"{clip} batch at {lo}: launches "
                                 f"{call['launches']}, want {want_call}")
        if call["wg"] != CLI_WG_PER_BATCH:
            raise AssertionError(f"{clip} batch at {lo}: {call['wg']} "
                                 f"launches of the C=256 warpgroup kernel, "
                                 f"want {CLI_WG_PER_BATCH}")
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
    return {k: after[k] - before[k] for k in ("attention", "dwconv_gelu",
                                              *SEG_NEW_512)}


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


def phase_cli(ops, model, device, gen, total, smi):
    """The video CLI at 1280x720 in its four routes and at 640x360, and the
    image CLI at 1024x768 in its --fast and float32 routes, with random
    weights from their default seed, and in --fast on phase 4's weights
    (`model`) as a .pt and as the JAX package's native .msgpack; then
    photo_pipeline, fused against float32."""
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
    # phase 4's weights as a reference .pt and as the JAX package's
    # native .msgpack (written by the port, read with no flax): the same
    # --fast program, so the same PNG byte for byte
    from vstnet_tpu_torch.io.checkpoint import (
        params_to_jax,
        save_native,
        save_revresnet,
    )

    t0 = time.perf_counter()
    save_native(params_to_jax(model.net.state_dict()), f"{root}/w.msgpack")
    t_write = time.perf_counter() - t0
    save_revresnet(model.net, f"{root}/w.pt")
    pngs = {}
    for ext in ("pt", "msgpack"):
        tag = f"fast --ckpoint w.{ext}"
        img[tag] = image(tag, "--fast", "--ckpoint", f"{root}/w.{ext}")
        pngs[ext] = open(f"{img[tag][1]}/content_style.png", "rb").read()
    same = np.array_equal(img["fast --ckpoint w.pt"][0],
                          img["fast global"][0])
    print(f"gate image CLI --fast --ckpoint w.msgpack ("
          f"{os.path.getsize(f'{root}/w.msgpack')} bytes, written in "
          f"{t_write:.3f} s) vs w.pt: PNG equal byte for byte: "
          f"{pngs['msgpack'] == pngs['pt']}; w.pt vs no --ckpoint (the same "
          f"seed-0 weights): equal {same} [{smi}]")
    if pngs["msgpack"] != pngs["pt"]:
        raise AssertionError("image CLI: w.msgpack and w.pt differ")
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
# of those, the C=256 blocks' on the warpgroup kernel (11 an encode)
ULTRA_WG_PER_CHUNK = {1: 11, 2: 22}
# launches of one style encode at 1024x576 (half-res widths 512 and 256)
ULTRA_STYLE_ENCODE = {"coupling_mma": 30, "transition_mma": 2}
# one bf16 segment call at 1024x576 (the 4K content capped at 1024 a side,
# and the style): stage 1 has 36864 queries and stage 2 9216, both at or
# above MIN_Q, so 3 + 8 attention launches, and stages 3 and 4 take SDPA
# (27 + 3); 41 MixFFN blocks; one upsample and argmax
ULTRA_SEG_CALL = {"attention": 11, "dwconv_gelu": 41, "attention_sdpa": 30,
                  "upsample_argmax": 1}


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
            from vstnet_tpu_torch.ops.coupling_fused import fused_coupling

            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = self.ops.launch_counts()
            wg = fused_coupling.wg_launches
            start.record()
            out = fn(*args, **kw)
            end.record()
            after = self.ops.launch_counts()
            self.calls.append({
                "pass": pass_no, "masked": fn.__name__.endswith("_masked"),
                "events": (start, end),
                "launches": {k: v - before[k] for k, v in after.items()
                             if v != before[k]},
                "wg": fused_coupling.wg_launches - wg})
            return out
        return run

    def device_ms(self, pass_no):
        torch.cuda.synchronize()
        return sum(c["events"][0].elapsed_time(c["events"][1])
                   for c in self.calls if c["pass"] == pass_no)

    def check(self, what, fast):
        """Each tile batch made the launches of its pass (none on the
        float32 route) and, in a regional pass, one of that pass's
        regional kernel (on both routes); returns the batch count of each
        pass."""
        n = {p: sum(c["pass"] == p for c in self.calls) for p in (1, 2)}
        if n[1] != n[2] or not n[1]:
            raise AssertionError(f"ultra {what}: tile batches {n}")
        for c in self.calls:
            want = dict(ULTRA_PER_CHUNK[c["pass"]]) if fast else {}
            if c["masked"]:       # both routes: the regional kernels
                want[("region_moments", "region_apply")[c["pass"] - 1]] = 1
            if c["launches"] != want:
                raise AssertionError(f"ultra {what}: a pass-{c['pass']} "
                                     f"batch launched {c['launches']}, "
                                     f"want {want}")
            want_wg = ULTRA_WG_PER_CHUNK[c["pass"]] if fast else 0
            if c["wg"] != want_wg:
                raise AssertionError(f"ultra {what}: a pass-{c['pass']} "
                                     f"batch launched the C=256 warpgroup "
                                     f"kernel {c['wg']} times, want "
                                     f"{want_wg}")
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
    cov, tr, _ = tiler_region_distances(
        model, content, style, region_masks(3, 32, 1, h, w).to(device),
        region_masks(4, 32, 1, *ULTRA_STYLE).to(device))
    print(f"gate ultra regional pass 1 (fused, K=32, synthetic label maps) "
          f"vs float64 of the owned latent rows: covariances {cov:.3e} of "
          f"their max (<= {REGION_COV_GATE}), transfer {tr:.3e} of its max "
          f"(<= {REGION_TRANSFER_GATE})")
    if not (cov <= REGION_COV_GATE and tr <= REGION_TRANSFER_GATE):
        raise AssertionError("ultra regional statistics off float64")
    # the global pass 1 of the fused route, outside every timed call
    fp = model.fast_params
    with _TilerGlobalProbe() as probe:
        ultra._content_stats(
            ultra._TileGrid(h, w, cfg, ULTRA_TILE, ULTRA_OVERLAP), fp,
            content, cfg, True, ultra.TILE_BATCH)
    global_stats = {"fused": tiler_global_distances(
        probe, ultra._enc(fp, style, cfg, True))}
    del probe

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

    with _TilerGlobalProbe() as probe:
        default = ultra.stylize_tiled(model.net, content, style, cfg,
                                      tile=ULTRA_TILE, overlap=ULTRA_OVERLAP)
    global_stats["float32"] = tiler_global_distances(
        probe, ultra._enc(model.net, style, cfg, False))
    del probe
    print(f"ultra float32 tiled at the default overlap {ULTRA_OVERLAP} vs "
          f"whole image: PSNR {_psnr(default.clamp(0, 1), whole):.2f} dB "
          f"(not gated: seams blended inside the receptive field)")
    del default, whole
    for route, (cov, tr) in global_stats.items():
        print(f"gate ultra global pass 1 ({route} route, overlap "
              f"{ULTRA_OVERLAP}) vs float64 of the owned latent rows: "
              f"covariance {cov:.3e} of its max (<= {REGION_COV_GATE}), "
              f"transfer {tr:.3e} of its max (<= {REGION_TRANSFER_GATE})")
    if not all(cov <= REGION_COV_GATE and tr <= REGION_TRANSFER_GATE
               for cov, tr in global_stats.values()):
        raise AssertionError("ultra global statistics off float64")

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
        if any(c["masked"] for c in probe.calls):
            # the style's moments and each tile batch's, each batch's apply
            want.update(region_moments=1 + n[1], region_apply=n[2])
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
# A step resumed from last.pt and last.pt.opt.msgpack (the JAX trainer's
# flat layout, which save_checkpoint writes), and from the same state in
# the JAX package's tree layout, against the uninterrupted step on the
# same batch: the checkpoint restores the weights, Adam's moments, its
# step and the schedule bit for bit; the step's parameters then agree
# within TRAIN_RESUME_TOL, a tenth of one step's size (lr 1e-4; a resume
# that lost Adam's moments moves parameters by ~lr). cuDNN runs
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
    # the resume read Adam's state from the native file, as the JAX
    # package's --resume reads its own
    for name in ("model_image.pt", "model_video.pt", "last.pt",
                 "last.pt.opt.msgpack"):
        assert os.path.exists(f"{ckpt}/{name}"), name
    assert not os.path.exists(f"{ckpt}/last.pt.opt.pt")
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
    import os
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
    t0 = time.perf_counter()
    net64, vgg64 = copy.deepcopy(net).double(), copy.deepcopy(vgg).double()
    g64, aux64 = loss_and_grads(net64, vgg64, a.double(), s.double(), w,
                                flow, noise.double(), True,
                                precision="f64")
    g64 = _flat_grads(g64)
    print(f"train f64 reference: {time.perf_counter() - t0:.1f} s")
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

    # resume: two steps, a checkpoint (last.pt and last.pt.opt.msgpack,
    # the JAX trainer's flat layout), then the same third step from the
    # live state and from the checkpoint (twice, for the floor), and from
    # the same mid-run state written in the JAX package's tree layout
    tc = tr.TrainConfig(weights=LossWeights(temporal=0.0))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state = tr.init_train_state(tc, device)
        batches = [_train_batch(gen, 2, 128, device)[:2] for _ in range(3)]
        for a_, s_ in batches[:2]:
            tr.train_step(state, vgg, a_, s_, tc)
        tmp = tempfile.TemporaryDirectory(prefix="vstnet_resume_")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save_checkpoint(state, tmp.name)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = [tr.load_checkpoint(tc, tmp.name, device=device)]
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        resumed.append(tr.load_checkpoint(tc, tmp.name, device=device))
        tree_dir = _tree_layout_checkpoint(tr, state, tmp.name)
        resumed.append(tr.load_checkpoint(tc, tree_dir, device=device))
        for r in resumed:
            _same_train_state(state, r)
        for st in [state] + resumed:
            tr.train_step(st, vgg, *batches[2], tc)

        def diff(x, y):
            return max(float((p - q).abs().max()) for p, q in
                       zip(x.net.state_dict().values(),
                           y.net.state_dict().values()))

        d_resume, d_floor = diff(state, resumed[0]), diff(resumed[0],
                                                          resumed[1])
        d_tree = diff(state, resumed[2])
        nbytes = os.path.getsize(f"{tmp.name}/last.pt.opt.msgpack")
        tmp.cleanup()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"train resume: checkpoint at step 2 (last.pt.opt.msgpack, "
          f"{nbytes} bytes; save_checkpoint {t_save:.3f} s, load_checkpoint "
          f"{t_load:.3f} s) restores weights, Adam state, its step and the "
          f"schedule's count bit for bit, and so does the JAX tree layout; "
          f"step 3 resumed vs uninterrupted: max param diff {d_resume:.3e} "
          f"(flat), {d_tree:.3e} (tree) (gate {TRAIN_RESUME_TOL}), two "
          f"resumed runs of step 3: {d_floor:.3e} [{smi}]")
    assert max(d_resume, d_tree) <= TRAIN_RESUME_TOL


def _tree_layout_checkpoint(tr, state, flat_dir):
    """`state`'s checkpoint with its optimizer in the JAX package's tree
    layout (a TrainState's save_checkpoint: Adam's count, the mu leaves
    and the nu leaves in tree order, the schedule's count), in a new
    directory under flat_dir."""
    import os
    import shutil

    import numpy as np

    from vstnet_tpu_torch.io.checkpoint import (
        jax_tree_leaves,
        params_to_jax,
        save_native,
    )

    d = os.path.join(flat_dir, "tree")
    os.makedirs(d)
    shutil.copy(os.path.join(flat_dir, "last.pt"), d)
    named = dict(state.net.named_parameters())
    moments = [jax_tree_leaves(params_to_jax(
        {k: state.opt.state[p][m] for k, p in named.items()}))
        for m in ("exp_avg", "exp_avg_sq")]
    count = int(state.opt.state[next(iter(named.values()))]["step"])
    save_native({"opt_state": {"leaves": [
        np.asarray(count, np.int32), *moments[0], *moments[1],
        np.asarray(state.sched.last_epoch, np.int32)]},
        "step": np.asarray(state.step)},
        os.path.join(d, "last.pt.opt.msgpack"))
    return d


def _same_train_state(state, r):
    """r restores state's step, weights, Adam's state (on the parameters'
    device, fused) and the schedule (its count and next learning rate) bit
    for bit."""
    assert r.step == state.step
    for p, q in zip(state.net.parameters(), r.net.parameters()):
        assert torch.equal(p, q)
        for k, v in state.opt.state[p].items():
            w = r.opt.state[q][k]
            assert w.device == v.device and torch.equal(v, w), k
    assert r.opt.defaults["fused"] == state.opt.defaults["fused"]
    assert r.sched.last_epoch == state.sched.last_epoch
    assert r.sched.get_last_lr() == state.sched.get_last_lr()


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
    walls = {}
    for part, fn in (("cli", _train_cli), ("correctness", _train_correctness),
                     ("timings", _train_timings)):
        t0 = time.perf_counter()
        fn(device, gen, smi)
        walls[part] = time.perf_counter() - t0
    print("phase train: " + ", ".join(f"{k} {v:.1f} s"
                                      for k, v in walls.items()))


# ---------------------------------------------------------------------------
# Phase 11: the tools (GGUF weights, the smoke CLI, torch.export artifacts)
# ---------------------------------------------------------------------------

# GGUF: the random PHOTO_CONFIG weights through F16 against the float32
# weights, both on the fused bf16 path at 512x512 (the fused path packs its
# weights to bf16, so F16's rounding shows only where it moves a weight's
# bf16 rounding); Q8_0 and Q4_0 are printed, not gated. The PSNR alone
# cannot tell F16 from a quantized file (Q4_0 comes within 6 dB of it), so
# every F16 weight read back to the card must also equal its float32
# original rounded to float16, bit for bit
GGUF_F16_PSNR = 40.0
# launches of one fused stylize at 512x512 B=1: two encodes and a decode,
# 30 K1 and 2 K2 each (half-res widths 256 and 128)
GGUF_LAUNCHES = {"coupling": 0, "coupling_mma": 90, "transition": 0,
                 "transition_mma": 6, "transition_half": 0,
                 "transition_half_mma": 0, "attention": 0, "dwconv_gelu": 0,
                 "region_moments": 0, "region_apply": 0, "attention_sdpa": 0,
                 "upsample_argmax": 0}
# the smoke photo path at 1024x1024 (fast route: bf16 segmenter, fused
# encode and decode) launches K1, K2, K4 and K5; the profiler names each
# by its __global__ function, templates with their arguments after it
TRACE_KERNELS = {"K1": ("coupling_mma_kernel", "coupling_mma_narrow_kernel",
                        "coupling_mma_wg_kernel"),
                 "K2": ("transition_mma_kernel",),
                 "K4": ("attention_kernel",),
                 "K5": ("dwconv_gelu_kernel",)}
# torch.export artifacts at 512x512, float32, run by load_exported (TF32
# cleared) against the eager functions on the same inputs: the same
# operators at the same shapes, so within EXPORT_TOL; masks equal on
# MASK_AGREE of the pixels whose best logit leads by more than EXPORT_TOL
# of the logits' scale
EXPORT_HW = 512
EXPORT_TOL = 1e-4
# a stylize artifact traced on the CPU and run on the card against the one
# traced on the card, of the latter's max
EXPORT_OFF_CARD_TOL = 1e-6


def _smoke(argv, timeout=600):
    """python -m vstnet_tpu_torch.cli.smoke argv in a child process, from
    the checkout, its output printed. Returns (stdout, wall seconds);
    raises with the output if the child exits non-zero."""
    import os

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "vstnet_tpu_torch.cli.smoke", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    print("\n".join(f"  | {line}" for line in res.stdout.splitlines()))
    if res.returncode != 0:
        raise AssertionError(f"smoke {' '.join(argv)} exited "
                             f"{res.returncode}:\n{res.stdout[-4000:]}\n"
                             f"{res.stderr[-4000:]}")
    print(f"smoke {' '.join(argv)}: exit 0 in {wall:.1f} s")
    return res.stdout, wall


def _named(kernel, names):
    import re

    return any(re.search(rf"(^|[^A-Za-z0-9_]){n}[<(]", kernel)
               for n in names)


def _tools_gguf(ops, model, device, gen, total, tmp, smi):
    import os

    from vstnet_tpu_torch.io import gguf
    from vstnet_tpu_torch.models.pipeline import StyleModel

    content, style = _frames(gen, 1, 512, device), _frames(gen, 1, 512,
                                                          device)
    ref = model.stylize(content, style, fast=True).clamp(0, 1)
    for dtype in ("f16", "q8_0", "q4_0"):
        path = os.path.join(tmp, f"photo_{dtype}.gguf")
        t0 = time.perf_counter()
        gguf.revresnet_to_gguf(model.net, path, dtype)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        net = gguf.revresnet_from_gguf(path, cfg=model.cfg, device=device)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        if dtype == "f16":
            sd, orig = net.state_dict(), model.net.state_dict()
            off = [k for k, v in orig.items()
                   if not torch.equal(sd[k], v.half().float())]
            print(f"gguf f16: {len(orig) - len(off)} of {len(orig)} weights "
                  f"on the card equal their float32 originals rounded to "
                  f"float16, bit for bit")
            if off or sd.keys() != orig.keys():
                raise AssertionError(f"gguf f16 weights differ: {off[:5]}")
        ops.reset_launch_counts()
        out = StyleModel(cfg=model.cfg, net=net).stylize(content, style,
                                                         fast=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        _add(total, counts)
        if counts != GGUF_LAUNCHES:
            raise AssertionError(f"gguf {dtype} stylize: launches {counts}")
        p = _psnr(out.clamp(0, 1), ref)
        gate = (f" (>= {GGUF_F16_PSNR})" if dtype == "f16" else
                " (not gated)")
        print(f"gguf {dtype}: {os.path.getsize(path) / 2**20:.2f} MB, write "
              f"{t_write:.3f} s, read to the card {t_read:.3f} s; fused "
              f"bf16 stylize 512x512 against the float32 weights: PSNR "
              f"{p:.2f} dB{gate} [{smi}]")
        if dtype == "f16" and not p >= GGUF_F16_PSNR:
            raise AssertionError(f"gguf f16 PSNR {p}")


def _tools_smoke(tmp, smi):
    """The smoke CLI's tests in child processes, one after another:
    parity, shapes and bench (one --test all run), train, and photo at
    1024x1024 under --profile, whose trace must name K1, K2, K4 and K5.
    Returns each run's wall seconds."""
    import os

    from vstnet_tpu_torch.ops import _build
    from vstnet_tpu_torch.runtime import profiling

    def builds():
        lib = _build.library_path()
        return lib, lib.stat().st_mtime_ns, sorted(
            p.name for p in lib.parent.iterdir())

    before = builds()
    walls = {}
    for argv in (["--test", "all", "--size", "512", "--n_shapes", "10",
                  "--batch", "8"],
                 ["--test", "train", "--iters", "3"]):
        walls[argv[1]] = _smoke(argv)[1]
    logdir = os.path.join(tmp, "trace")
    out, walls["photo --profile"] = _smoke(
        ["--test", "photo", "--size", "1024", "--iters", "3", "--profile",
         logdir])
    # each child loads the library phase 2 built (ops/_build.py names it
    # by a hash of the sources) and builds nothing
    if builds() != before:
        raise AssertionError(f"the smoke children rebuilt the kernels: "
                             f"{before} -> {builds()}")
    print(f"smoke children: each loaded {before[0].name} as phase 2 built "
          f"it (its file and the build directory unchanged)")
    line = [x for x in out.splitlines()
            if "kernel launches per fast call:" in x][0]
    per_call = json.loads(line.split(":", 1)[1])
    kernels = profiling.kernel_counts(logdir)
    found = {k: sum(n for name, n in kernels.items() if _named(name, names))
             for k, names in TRACE_KERNELS.items()}
    print(f"smoke photo 1024x1024 under the profiler: the fast call's "
          f"launches {per_call}; kernel events in the trace {found} [{smi}]")
    for k, names in TRACE_KERNELS.items():
        print(f"  {k}: " + ", ".join(sorted(
            {name[:100] for name in kernels if _named(name, names)})))
    missing = [k for k, n in found.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels missing from the trace: {missing}")
    return walls


def _eager_render(seg_net, x, device, blend=0.5, min_ratio=0.02):
    from vstnet_tpu_torch.models import remapping
    from vstnet_tpu_torch.models.segformer import segment_mask

    mapping = remapping.load_label_mapping(device=device)
    pal = torch.from_numpy(remapping.ade20k_palette()).float().to(
        device) / 255.0
    m = remapping.self_remapping(segment_mask(seg_net, x), mapping,
                                 min_ratio)
    return (blend * pal[m.long()] + (1.0 - blend) * x).clamp(0.0, 1.0)


def _tools_export(model, seg_net, device, gen, smi, exported):
    """exported: {name: (program, export s, .pt2 path, save s)} of the
    artifacts that Packages exported before phase 3 (stylize and
    segment-render, the same calls at the same size); the others are
    exported here."""
    import io
    import pathlib

    from vstnet_tpu_torch.models import segformer as sf
    from vstnet_tpu_torch.models.pipeline import stylize
    from vstnet_tpu_torch.runtime import export as ex
    from vstnet_tpu_torch.runtime import profiling

    cfg, net, hw = model.cfg, model.net, EXPORT_HW
    c, s = _frames(gen, 1, hw, device), _frames(gen, 1, hw, device)
    z = net.encode(c)
    cases = [
        ("stylize", lambda: ex.export_stylize(net, cfg, hw, hw,
                                              device=device), (c, s),
         lambda: stylize(net, c, s)),
        ("encoder", lambda: ex.export_encoder(net, cfg, hw, hw,
                                              device=device), (c,),
         lambda: net.encode(c)),
        ("decoder", lambda: ex.export_decoder(net, cfg, hw, hw,
                                              device=device), (z,),
         lambda: net.decode(z)),
        ("segmenter", lambda: ex.export_segmenter(seg_net, hw, hw,
                                                  device=device), (c,),
         lambda: sf.segment_mask(seg_net, c)),
        ("segment-render", lambda: ex.export_segment_render(
            seg_net, hw, hw, device=device), (c,),
         lambda: _eager_render(seg_net, c, device)),
    ]
    for name, export, args, eager in cases:
        if name in exported:
            ep, t_export, pt2, t_save = exported[name]
            blob = pathlib.Path(pt2).read_bytes()
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ep, _ = export()
            t_export = time.perf_counter() - t0
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            blob = buf.getvalue()
            t_save = time.perf_counter() - t0 - t_export
        t0 = time.perf_counter()
        fn = ex.load_exported(blob, device=device)
        t_load = time.perf_counter() - t0
        got, want = fn(*args), eager()
        if name == "segmenter":
            logits = sf.segment_logits(seg_net, c)
            top2 = logits.topk(2, dim=-1).values
            scale = float(logits.abs().max())
            decided = (top2[..., 0] - top2[..., 1]) > EXPORT_TOL * scale
            same = got == want
            agree = float(same[decided].float().mean())
            detail = (f"masks equal on {agree:.5f} (>= {MASK_AGREE}) of the "
                      f"{float(decided.float().mean()):.5f} decided pixels, "
                      f"{float(same.float().mean()):.5f} of all")
            ok = got.dtype == torch.int32 and agree >= MASK_AGREE
        else:
            err = _max_err(got, want)
            detail = f"max abs err {err:.3e} (<= {EXPORT_TOL})"
            ok = err <= EXPORT_TOL
        if name == "stylize":
            # what the TF32 that load_exported clears would cost
            saved = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                with torch.no_grad():
                    tf32 = ep.module()(*args)
            finally:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = saved
            detail += (f"; run with TF32 on it would be "
                       f"{_max_err(tf32, want):.3e} off")
        mem = profiling.call_memory_analysis(fn, *args, device=device)
        print(f"export {name} {hw}x{hw}: export {t_export:.2f} s, save "
              f"{t_save:.2f} s, {len(blob) / 2**20:.1f} MB, load "
              f"{t_load:.2f} s; one call's memory (MiB): "
              + ", ".join(f"{k} {v / 2**20:.1f}" for k, v in mem.items())
              + f"; artifact on the card vs eager: {detail} [{smi}]")
        if not ok:
            raise AssertionError(f"export {name}: {detail}")


def _tools_export_off_card(model, device, smi):
    """The stylize program traced on the CPU, moved to the card by
    load_exported, against the same program traced on the card, both at
    PHOTO_CONFIG's widths with one block a stage (so that the CPU trace
    takes seconds) and EXPORT_HW: within EXPORT_OFF_CARD_TOL of the
    card-traced output's max; both printed beside the float64 eager
    stylize of the same inputs and weights. Inputs and weights come from
    generators of their own, so that later phases draw what they drew."""
    import dataclasses

    from vstnet_tpu_torch.models.pipeline import stylize
    from vstnet_tpu_torch.models.revresnet import RevResNet
    from vstnet_tpu_torch.runtime import export as ex

    cfg = dataclasses.replace(model.cfg, n_blocks=(1, 1, 1))
    net = RevResNet(cfg, device=device).init_weights(
        torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    c, s = _frames(gen, 1, EXPORT_HW, device), _frames(gen, 1, EXPORT_HW,
                                                       device)
    out, secs = {}, {}
    for where in ("cpu", "card"):
        t0 = time.perf_counter()
        blob, _ = ex.export_stylize(net, cfg, EXPORT_HW, EXPORT_HW,
                                    device="cpu" if where == "cpu"
                                    else device, serialized=True)
        secs[where] = time.perf_counter() - t0
        out[where] = ex.load_exported(blob, device=device)(c, s)
    with torch.no_grad():
        f64 = stylize(net.double(), c.double(), s.double())
    err = _rel(out["cpu"], out["card"])
    print(f"gate export stylize {EXPORT_HW}x{EXPORT_HW} (one block a "
          f"stage) traced on the CPU, run on the card, vs traced on the "
          f"card: {err:.3e} of its max (<= {EXPORT_OFF_CARD_TOL}), bit "
          f"equal {torch.equal(out['cpu'], out['card'])}; from float64 "
          f"eager: CPU-traced {_rel(out['cpu'], f64):.3e}, card-traced "
          f"{_rel(out['card'], f64):.3e}; export {secs['cpu']:.2f} s on "
          f"the CPU, {secs['card']:.2f} s on the card [{smi}]")
    if not err <= EXPORT_OFF_CARD_TOL:
        raise AssertionError(f"export traced on the CPU: {err}")


def phase_tools(ops, model, seg, device, gen, total, smi, exported):
    """Phase 11: GGUF weights, the smoke CLI and the torch.export
    artifacts, one after another; exported: Packages.exported."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="vstnet_tools_") as tmp:
        _tools_gguf(ops, model, device, gen, total, tmp, smi)
        t_gguf = time.perf_counter() - t0
        walls = _tools_smoke(tmp, smi)
    t_smoke = time.perf_counter() - t0 - t_gguf
    _tools_export(model, seg.net, device, gen, smi, exported)
    _tools_export_off_card(model, device, smi)
    _tools_invconv(device, smi)
    wall = time.perf_counter() - t0
    print(f"phase tools: {wall:.1f} s (gguf {t_gguf:.1f}, smoke runs "
          f"{t_smoke:.1f}: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in walls.items())
          + f"; export and invconv {wall - t_gguf - t_smoke:.1f})")


# the invertible 1x1 conv's shape (B, H, W, C) and its float32 bound:
# inputs N(0,1), an orthogonal weight, so outputs of the inputs' size and
# a 64-term float32 dot product a value, twice in the round trip
INVCONV_SHAPE = (4, 512, 512, 64)
INVCONV_TOL = 1e-4


def _tools_invconv(device, smi):
    """ops/invconv.py on the card (no kernel: one matmul each way, TF32
    off): the round trip and the forward against float64. Its generator is
    its own, so that later phases draw what they drew before."""
    from vstnet_tpu_torch.ops import invconv

    gen = torch.Generator().manual_seed(11)

    params = invconv.init_invconv(gen, INVCONV_SHAPE[-1], device=device)
    x = torch.randn(INVCONV_SHAPE, generator=gen).to(device)
    y = invconv.invconv_forward(params, x)
    back = invconv.invconv_inverse(params, y)
    p64 = {k: v.double() for k, v in params.items()}
    y64 = torch.einsum("bhwc,oc->bhwo", x.double(), p64["w"]) + p64["b"]
    trip = float((back - x).abs().max())
    fwd = float((y.double() - y64).abs().max())
    ms = _time_ms(lambda: invconv.invconv_forward(params, x))
    ms_inv = _time_ms(lambda: invconv.invconv_inverse(params, y))
    print(f"invconv {INVCONV_SHAPE} float32 on the card: inverse(forward(x)) "
          f"max abs err {trip:.3e}, forward vs float64 {fwd:.3e} (gate "
          f"{INVCONV_TOL}); forward {ms:.3f} ms, inverse {ms_inv:.3f} ms "
          f"[{smi}]")
    assert y.dtype == torch.float32 and bool(torch.isfinite(back).all())
    assert max(trip, fwd) <= INVCONV_TOL, (trip, fwd)


# ---------------------------------------------------------------------------
# Phase 12: the data-parallel layer (parallel/)
# ---------------------------------------------------------------------------

# frames a replica of the three programs at 512x512; alpha_c of the
# interpolated one
PAR_BATCH = 8
PAR_ALPHA = 0.5
# the data-parallel training run: the checked steps (image, image,
# temporal), then image steps timed once the first calls are paid; crop,
# images a rank
PAR_STEPS = (False, False, True)
PAR_TIMED = 4
PAR_CROP = 256
PAR_PER_RANK = 2
# rank 0's float32 weights after the checked steps against the
# single-process steps on the global batch: max abs beyond 1e-4 of the
# weight, and mean abs. Adam's first steps move an element by up to lr
# (1e-4) whatever the size of its gradient, so where the sum order flips
# the sign of a near-zero gradient the two runs part by up to 2 lr a step:
# 6e-4 over 3 steps. The first run on an H100 80GB HBM3 at 700 W measured
# 2.154e-04 and a mean of 5.033e-07 (PERF.md); the mean bound is
# tests/test_parallel.py's for its three-step sequence.
PAR_TRAIN_RTOL, PAR_TRAIN_ATOL, PAR_TRAIN_MEAN = 1e-4, 6e-4, 1e-5


def _par_devices():
    """(devices, whether they are distinct cards): every card when the
    host shows two or more, else two replicas on cuda:0."""
    from vstnet_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() >= 2:
        return make_mesh(), True
    return (torch.device("cuda:0"),) * 2, False


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _per_device(devices, counts_of, one):
    """Each device's launches (counts_of(device)) against `one` single-
    device call's times the replicas that device holds."""
    for d in dict.fromkeys(devices):
        reps = devices.count(d)
        want = {k: v * reps for k, v in _nonzero(one).items()}
        got = _nonzero(counts_of(d))
        if got != want:
            raise AssertionError(f"{d}: launches {got}, want {want} "
                                 f"({reps} replicas of {one})")


def _host_syncs(fn):
    """Where fn() makes the host wait for a device (torch.cuda's sync
    debug mode warns at each such call): {file:line: calls}."""
    import collections
    import os
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return dict(collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in rec
        if "synchroniz" in str(w.message)))


def _par_ms(fn, devices, iters):
    """ms of one fn() over the devices: CUDA events on each device's
    stream around `iters` calls, the longest of them; and the host's ms to
    enqueue one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = (time.perf_counter() - t0) * 1e3
    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)
    ev = {}
    for d in dict.fromkeys(devices):
        with torch.cuda.device(d):
            ev[d] = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
            ev[d][0].record()
    for _ in range(iters):
        fn()
    for d, (s, e) in ev.items():
        with torch.cuda.device(d):
            e.record()
    for s, e in ev.values():
        e.synchronize()
    return max(s.elapsed_time(e) for s, e in ev.values()) / iters, enqueue


def _par_programs(ops, model, style, seg, region, plan, devices, gen, total,
                  smi):
    """The global, alpha_c and masked programs over the devices at
    512x512, PAR_BATCH frames a replica: per-device launches, each shard
    against the single-device program on it, the whole batch against
    float32, frames/s over the replicas beside one device's."""
    from vstnet_tpu_torch import PHOTO_CONFIG
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.models.pipeline import (
        make_fused_video_fn,
        make_masked_fused_video_fn,
        prepare_masked_style,
    )
    from vstnet_tpu_torch.parallel import (
        gather,
        parallel_stylize_fused,
        parallel_stylize_masked_fused,
        replicate,
        shard_batch,
    )

    cfg = PHOTO_CONFIG
    n = len(devices)
    fast = model.fast_params
    frames = _frames(gen, PAR_BATCH * n, 512, devices[0])
    zs = rf.encode_fast(fast, style.to(torch.bfloat16), cfg,
                        packed_latent=True)
    ls, mu = cwct.style_factors_packed(zs, cfg.latent_channels)
    smask = prepare_masked_style(fast, seg, style, cfg)[2]
    shards = shard_batch(devices, frames)
    masked_args = (fast, seg.net, seg.label_mapping, region, plan)
    # (name, the parallel program, the single-device one, its arguments
    # around the frames, the frames' position, the float32 reference of
    # the whole batch given its masks)
    progs = [
        ("global", parallel_stylize_fused(devices, cfg),
         make_fused_video_fn(cfg), lambda x: (fast, x, ls, mu), 1,
         lambda masks: _plain_video(model, frames, style)),
        ("alpha_c", parallel_stylize_fused(devices, cfg, interp=True),
         make_fused_video_fn(cfg, interp=True),
         lambda x: (fast, x, ls, mu, PAR_ALPHA), 1,
         lambda masks: _plain_video(model, frames, style, PAR_ALPHA)),
        ("masked", parallel_stylize_masked_fused(devices, cfg),
         make_masked_fused_video_fn(cfg),
         lambda x: (fast, seg.net, seg.label_mapping, region, plan, x), 5,
         lambda masks: _plain_masked(model, style, smask, frames, masks)),
    ]
    for name, par, local, args_of, pos, plain in progs:
        par(*args_of(frames))      # replicas made, first calls paid
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = par(*args_of(frames))
        torch.cuda.synchronize()
        per_dev = {d: ops.launch_counts(d) for d in dict.fromkeys(devices)}
        _add(total, ops.launch_counts())
        masks = None
        if isinstance(out, tuple):
            out, masks = out
        # each shard against the single-device program on that shard, on
        # the shard's device, at the same batch
        one = None
        for i, d in enumerate(devices):
            args = [x if j == pos else replicate(devices, x)[i]
                    for j, x in enumerate(args_of(shards[i]))]
            with torch.cuda.device(d):
                ops.reset_launch_counts()
                ref = local(*args)
                torch.cuda.synchronize(d)
            if one is None:
                one = ops.launch_counts(d)
            ref, ref_m = ref if masks is not None else (ref, None)
            if not torch.equal(out[i], ref) or (
                    masks is not None and not torch.equal(masks[i], ref_m)):
                raise AssertionError(f"parallel {name}: shard {i} on {d} "
                                     "differs from the single-device "
                                     "program on it")
        _per_device(devices, lambda d: per_dev[d], one)
        db = _psnr(gather(out, devices[0]), plain(
            None if masks is None else gather(masks, devices[0])))
        if db < 40.0:
            raise AssertionError(f"parallel {name}: {db:.2f} dB against "
                                 "float32 (< 40)")
        iters = 3 if name == "masked" else 5
        syncs = _host_syncs(lambda: par(*args_of(frames)))
        torch.cuda.synchronize()
        ms_all, enq = _par_ms(lambda: par(*args_of(frames)), devices, iters)
        ms_one = _time_ms(lambda: local(*args_of(shards[0])), iters=iters,
                          warmup=1)
        fps_all = PAR_BATCH * n * 1e3 / ms_all
        fps_one = PAR_BATCH * 1e3 / ms_one
        print(f"parallel {name} 512x512 bf16, {PAR_BATCH} frames x {n} "
              f"replicas: every shard equal to the single-device program "
              f"bit for bit, the batch {db:.2f} dB against float32 (>= "
              f"40), launches per device "
              + "; ".join(f"{d}: {_nonzero(c)}" for d, c in per_dev.items())
              + f" (= {_nonzero(one)} x replicas); {fps_all:.2f} frames/s "
              f"over the "
              f"replicas ({ms_all:.2f} ms a batch of {PAR_BATCH * n}; the "
              f"host enqueues it in {enq:.2f} ms; calls that wait for the "
              f"device: {syncs or 'none'}) beside {fps_one:.2f} on one "
              f"device ({ms_one:.2f} ms a batch of {PAR_BATCH}) [{smi}]")


def _par_train_rank(rank, root, tc):
    """One rank of the phase's training run (spawned): its rows of the
    global batch, parallel_train_step, its weights and step times saved."""
    import torch.distributed as dist

    from vstnet_tpu_torch.config import PHOTO_CONFIG
    from vstnet_tpu_torch.models.revresnet import RevResNet
    from vstnet_tpu_torch.models.vgg import init_vgg
    from vstnet_tpu_torch.parallel import parallel_train_step
    from vstnet_tpu_torch.train import trainer as tr

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())
    rows = slice(rank * PAR_PER_RANK, (rank + 1) * PAR_PER_RANK)
    batches = [tuple(t[rows].to(device) for t in b) for b in
               torch.load(f"{root}/batches.pt", weights_only=True)]
    net = RevResNet(PHOTO_CONFIG.with_remat(), device=device)
    net.init_weights(torch.Generator().manual_seed(0))
    vgg = init_vgg(torch.Generator().manual_seed(42), device=device)
    state = tr.init_train_state(tc, device, net)
    auxes = []
    for (a, s, flow, noise), temporal in zip(batches, PAR_STEPS):
        aux = parallel_train_step(state, vgg, a, s, tc, flow, noise,
                                  temporal)
        auxes.append({k: float(v) for k, v in aux.items()})
    params = {k: v.cpu() for k, v in state.net.state_dict().items()}
    ms = _timed_steps(lambda: parallel_train_step(state, vgg,
                                                  *batches[0][:2], tc))
    torch.save({"params": params, "aux": auxes, "ms": ms,
                "backend": dist.get_backend(), "device": str(device)},
               f"{root}/rank{rank}.pt")


def _timed_steps(step):
    """Host ms of PAR_TIMED calls of step(), each ended by a synchronise
    (a data-parallel step already waits on its all-reduce)."""
    ms = []
    for _ in range(PAR_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _par_train(gen, smi):
    """max(2, cards) ranks for PAR_STEPS at PAR_CROP, PAR_PER_RANK images a
    rank, PHOTO_CONFIG float32: weights bit-equal across ranks and against
    the single-process steps on the global batch; steps/s."""
    import tempfile

    from vstnet_tpu_torch.config import PHOTO_CONFIG
    from vstnet_tpu_torch.models.revresnet import RevResNet
    from vstnet_tpu_torch.models.vgg import init_vgg
    from vstnet_tpu_torch.parallel.multihost import spawn_ranks
    from vstnet_tpu_torch.train import trainer as tr

    world = max(2, torch.cuda.device_count())
    tc = tr.TrainConfig()
    device = torch.device("cuda:0")
    batches = [tuple(t.contiguous().cpu() for t in _train_batch(
        gen, PAR_PER_RANK * world, PAR_CROP, device)) for _ in PAR_STEPS]
    with tempfile.TemporaryDirectory(prefix="vstnet_par_") as root:
        torch.save(batches, f"{root}/batches.pt")
        t0 = time.perf_counter()
        backend = spawn_ranks(_par_train_rank, world, (root, tc))
        wall = time.perf_counter() - t0
        ranks = [torch.load(f"{root}/rank{r}.pt", weights_only=False)
                 for r in range(world)]
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            if not torch.equal(v, r["params"][k]):
                raise AssertionError(f"parallel train: {k} differs between "
                                     f"rank 0 and {r['device']}")
    net = RevResNet(PHOTO_CONFIG.with_remat(), device=device)
    net.init_weights(torch.Generator().manual_seed(0))
    vgg = init_vgg(torch.Generator().manual_seed(42), device=device)
    state = tr.init_train_state(tc, device, net)
    batches = [tuple(t.to(device) for t in b) for b in batches]
    with tr._no_tf32():
        for (a, s, flow, noise), temporal in zip(batches, PAR_STEPS):
            aux = tr.train_step(state, vgg, a, s, tc, flow, noise,
                                temporal)
        want = torch.cat([v.flatten().cpu()
                          for v in state.net.state_dict().values()])
        ms_one = _timed_steps(lambda: tr.train_step(state, vgg,
                                                    *batches[0][:2], tc))
    got = torch.cat([v.flatten() for v in ranks[0]["params"].values()])
    diff = (got.double() - want.double()).abs()
    excess = float((diff - PAR_TRAIN_RTOL * want.double().abs()).max())
    mean = float(diff.mean())
    aux_err = max(abs(ranks[0]["aux"][-1][k] - float(aux[k])) for k in aux)
    print(f"parallel train: {world} ranks ({backend}"
          + (", NCCL across cards" if backend == "nccl" else
             ", the ranks share one card: no NCCL between cards")
          + f") x {PAR_PER_RANK} images at {PAR_CROP}x{PAR_CROP}, "
          f"PHOTO_CONFIG float32, {len(PAR_STEPS)} steps (image, image, "
          f"temporal); weights bit-equal across ranks; against the "
          f"single-process steps on the global batch of "
          f"{PAR_PER_RANK * world}: max |diff| {float(diff.max()):.3e} "
          f"(beyond rtol {PAR_TRAIN_RTOL}: {excess:.3e} <= atol "
          f"{PAR_TRAIN_ATOL}), mean |diff| {mean:.3e} (< {PAR_TRAIN_MEAN}),"
          f" last step's aux {aux_err:.3e} off")
    ms = ranks[0]["ms"]
    print(f"parallel train image step ms after the checked steps, rank 0: "
          f"{', '.join(f'{m:.1f}' for m in ms)} = "
          f"{len(ms) * 1e3 / sum(ms):.3f} steps/s (a global batch of "
          f"{PAR_PER_RANK * world}); one process on the global batch: "
          f"{', '.join(f'{m:.1f}' for m in ms_one)} = "
          f"{len(ms_one) * 1e3 / sum(ms_one):.3f} steps/s; spawn to join "
          f"{wall:.1f} s [{smi}]")
    if excess > PAR_TRAIN_ATOL or mean > PAR_TRAIN_MEAN:
        raise AssertionError("parallel train: rank 0's weights beyond the "
                             "bound of the single-process steps")


def _par_cli(ops, devices, gen, total, smi):
    """The video CLI over the devices (make_mesh as it sees them) and on
    cuda:0 alone, on 16 frames of 1280x720: per-device launches, frames
    within one uint8 level."""
    import tempfile

    import numpy as np
    from PIL import Image

    from vstnet_tpu_torch.cli import video_transfer
    from vstnet_tpu_torch.io.video import AviWriter
    from vstnet_tpu_torch.parallel import mesh

    n, h, w = CLI_CLIP
    with tempfile.TemporaryDirectory(prefix="vstnet_par_cli_") as root:
        clip = (_frames(gen, n, (h, w), devices[0]) * 255).round().to(
            torch.uint8).cpu().numpy()
        with AviWriter(f"{root}/clip.avi", fps=10) as wr:
            for f in clip:
                wr.write(f)
        Image.fromarray((_frames(gen, 1, ULTRA_STYLE, devices[0])[0] * 255)
                        .round().to(torch.uint8).cpu().numpy()).save(
            f"{root}/style.png")
        argv = ["--video", f"{root}/clip.avi", "--style",
                f"{root}/style.png", "--batch", str(CLI_BATCH)]
        written, walls = {}, {}
        saved = mesh.make_mesh
        mesh.make_mesh = lambda *a, **k: devices
        try:
            for tag, extra in (("devices", []),
                               ("one", ["--device", str(devices[0])])):
                with _CliProbe(ops) as probe:
                    ops.reset_launch_counts()
                    _, out, walls[tag] = _run_cli(
                        video_transfer.main,
                        argv + ["--out_dir", f"{root}/{tag}"] + extra)
                    if tag == "devices":
                        per_dev = {d: ops.launch_counts(d)
                                   for d in dict.fromkeys(devices)}
                    _add(total, ops.launch_counts())
                written[tag] = np.stack(next(iter(probe.frames.values())))
        finally:
            mesh.make_mesh = saved
    batches = -(-n // (CLI_BATCH * len(devices)))
    _per_device(devices, lambda d: per_dev[d], {
        k: v * batches for k, v in CLI_PER_BATCH["1280x720"].items()})
    a, b = (written[k].astype(np.int32) for k in ("devices", "one"))
    if a.shape != (n, h, w, 3) or a.shape != b.shape:
        raise AssertionError(f"parallel CLI: {a.shape} frames written, want "
                             f"{(n, h, w, 3)} like {b.shape}")
    worst = int(np.abs(a - b).max())
    if worst > 1:
        raise AssertionError(f"parallel CLI: frames {worst} levels from "
                             "the single-device run")
    print(f"parallel video CLI 1280x720 x {n}, --batch {CLI_BATCH} over "
          f"{len(devices)} replicas: launches per device "
          + "; ".join(f"{d}: {_nonzero(c)}" for d, c in per_dev.items())
          + f"; frames {worst} levels from the single-device run (<= 1; "
          f"bit-equal {worst == 0}); main() {walls['devices']:.2f} s beside "
          f"{walls['one']:.2f} s on one device [{smi}]")


def _par_serve(ops, model, devices, gen, total, smi):
    """A burst of 16 requests at 1280x720 through StyleService over the
    devices and on cuda:0 alone: per-device launches, replies within one
    uint8 level."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from vstnet_tpu_torch.serve import StyleService

    n, h, w = SERVE_BURST[0]
    style = _png((_frames(gen, 1, ULTRA_STYLE, devices[0])[0] * 255)
                 .round().to(torch.uint8).cpu().numpy())
    contents = [_png(f) for f in (_frames(gen, n, (h, w), devices[0]) * 255)
                .round().to(torch.uint8).cpu().numpy()]
    replies, walls = {}, {}
    for tag, devs in (("devices", devices), ("one", devices[:1])):
        svc = StyleService(model, fast=True, devices=devs)
        try:
            svc.register_style("s", style)
            svc.stylize(contents[0], "s")       # the first batch's set-up
            ops.reset_launch_counts()
            log0 = len(svc.batch_log)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=n) as pool:
                got = list(pool.map(lambda c: svc.stylize(c, "s"),
                                    contents))
            walls[tag] = time.perf_counter() - t0
            torch.cuda.synchronize()
            if tag == "devices":
                per_dev = {d: ops.launch_counts(d)
                           for d in dict.fromkeys(devices)}
                n_batches = len(svc.batch_log) - log0
            _add(total, ops.launch_counts())
        finally:
            svc.close(timeout=60)
        replies[tag] = [np.asarray(Image.open(io.BytesIO(r))).astype(
            np.int32) for r in got]
    _per_device(devices, lambda d: per_dev[d], {
        k: v * n_batches for k, v in SERVE_PER_BATCH[(768, 1280)].items()})
    worst = max(int(np.abs(a - b).max())
                for a, b in zip(replies["devices"], replies["one"]))
    if worst > 1:
        raise AssertionError(f"parallel serve: replies {worst} levels from "
                             "the single-device service")
    print(f"parallel serve: {n} requests at {w}x{h} over {len(devices)} "
          f"replicas in {n_batches} batches, launches per device "
          + "; ".join(f"{d}: {_nonzero(c)}" for d, c in per_dev.items())
          + f"; replies {worst} levels from the single-device service (<= "
          f"1; bit-equal {worst == 0}); burst {walls['devices']:.2f} s "
          f"beside {walls['one']:.2f} s on one device [{smi}]")


def phase_parallel(ops, model, style, seg, region, plan, gen, total, smi):
    """Phase 12: the data-parallel layer over every card, or two replicas
    on one card where the host has one."""
    devices, distinct = _par_devices()
    print(f"parallel: devices {', '.join(map(str, devices))}"
          + ("" if distinct else "; one card on this host: two replicas "
             "on it, and NCCL between cards is not exercised"))
    t0 = time.perf_counter()
    _par_programs(ops, model, style, seg, region, plan, devices, gen, total,
                  smi)
    t1 = time.perf_counter()
    _par_train(gen, smi)
    t2 = time.perf_counter()
    _par_cli(ops, devices, gen, total, smi)
    _par_serve(ops, model, devices, gen, total, smi)
    print(f"phase parallel: {time.perf_counter() - t0:.1f} s (programs "
          f"{t1 - t0:.1f}, train {t2 - t1:.1f}, CLI and serve "
          f"{time.perf_counter() - t2:.1f})")


# ---------------------------------------------------------------------------
# Phase 13: the native tier (runtime/native.py, native/)
# ---------------------------------------------------------------------------

# the packages' shape; contents through the runner at that size (the first
# one pays the runner's first-call costs and is left out of its mean), one
# 1280x720 content through both resizes
NATIVE_HW = 512
NATIVE_IMAGES = 4
NATIVE_WIDE = (720, 1280)
# NativeEngine against the eager float32 programs (Inductor reorders
# float32 sums); the runner's PNGs against the eager output rounded to
# uint8, in levels; the share of segment-render pixels within NATIVE_TOL
# (a near-tied label may flip under the reordered sums)
NATIVE_TOL = 1e-4
NATIVE_LEVELS = 1
NATIVE_SEG_SHARE = 0.99


def _u8_png(path, x):
    """Write x (1, H, W, 3) in [0, 1] as an 8-bit PNG; return the float32
    image the runner reads back from it, on x's device."""
    from PIL import Image

    u8 = (x[0].clamp(0, 1) * 255.0).round().to(torch.uint8).cpu().numpy()
    Image.fromarray(u8).save(path)
    return torch.from_numpy(u8).to(x.device).float()[None] / 255.0


def _read_png(path):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(path), np.int32)


def _levels(x):
    """x (1, H, W, 3) -> the uint8 levels the runner writes for it."""
    return (x[0].clamp(0, 1) * 255.0 + 0.5).floor().to(torch.int32).cpu(
        ).numpy()


def _resize_nhwc(x, hw):
    return torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)


def _run_native(binary, args):
    """Run the runner; -> (stdout, {output name: execute ms})."""
    import re

    r = subprocess.run([str(binary), *map(str, args)], capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"vstnet-torch-native exited {r.returncode}:\n"
                             f"{r.stdout}\n{r.stderr}")
    ms = {m.group(1).rsplit("/", 1)[-1]: float(m.group(2)) for m in
          re.finditer(r"wrote (\S+) \(execute ([0-9.]+) ms\)", r.stdout)}
    return r.stdout, ms


def _ldd_check(paths):
    for p in paths:
        deps = subprocess.run(["ldd", str(p)], capture_output=True,
                              text=True, check=True).stdout
        if "libpython" in deps or "not found" in deps:
            raise AssertionError(f"ldd {p.name}:\n{deps}")
        if "libtorch_cuda" not in deps:
            raise AssertionError(f"{p.name} does not link libtorch_cuda:\n"
                                 f"{deps}")


# One package's compile in a child process (argv: .pt2, package path, what,
# device). Prints one JSON line: the wall clock at its start and end, the
# seconds to load the program and to compile it, the CPU seconds of the
# process and of its finished subprocesses, and the package's MB
_PACKAGE_CHILD = r"""
import json, os, resource, sys, time
import torch
from vstnet_tpu_torch.runtime import native
pt2, path, what, device = sys.argv[1:5]
start = time.time()
ep = torch.export.load(pt2)
t_load = time.time() - start
t0 = time.perf_counter()
native.package_program(ep, path, device=device, what=what)
t_compile = time.perf_counter() - t0
cpu = {k: sum(resource.getrusage(w)[:2]) for k, w in (
    ("self", resource.RUSAGE_SELF), ("subprocesses", resource.RUSAGE_CHILDREN))}
print(json.dumps({"start": start, "end": time.time(), "load": t_load,
                  "compile": t_compile, "cpu": cpu,
                  "mb": os.path.getsize(path) / 2**20}))
"""
# seconds from the children's start: a child that has not finished by then
# fails the run (side by side the two compiles took ~160-200 s on the H100
# machine), early enough for the failure to be the run's own
PACKAGE_TIMEOUT = 600


class Phases:
    """Each phase's wall-clock span, for the phase-seconds line and for
    naming the phases a background compile ran beside."""

    def __init__(self):
        self.t0 = time.time()
        self.spans = []

    def run(self, name, fn, *args):
        start = time.time()
        out = fn(*args)
        self.spans.append((name, start, time.time()))
        print(f"phase {name} done at {time.time() - self.t0:.1f} s")
        return out

    def beside(self, start, end):
        """The phases that ran in [start, end] (the wait of a join left
        out)."""
        return [n for n, a, b in self.spans
                if a < end and b > start and not n.endswith("join")]

    def line(self):
        return ("phase seconds: " + ", ".join(
            f"{n} {b - a:.1f}" for n, a, b in self.spans)
            + f", total {time.time() - self.t0:.1f} of 1200")


class Packages:
    """Phase 13's two AOTInductor packages at NATIVE_HW: the full-depth
    stylize program and SegFormer-B4's segment-render, exported here (the
    same programs as phase 11's stylize and segment-render artifacts, which
    take these exports) and saved as .pt2 files, then compiled by two
    child processes at once, each with a fresh TORCHINDUCTOR_CACHE_DIR (a
    cold cache), while the caller runs phases whose printed numbers are
    gates, launch counts or device times. join() waits for both; a child
    that fails or outlives PACKAGE_TIMEOUT fails the run with its output,
    and nothing is compiled again in this process."""

    def __init__(self, model, seg, device, root):
        import os

        from vstnet_tpu_torch.runtime import export as ex

        hw = NATIVE_HW
        self.root, self.exported, self.procs, self.done = root, {}, {}, {}
        for what, export in (
                ("stylize", lambda: ex.export_stylize(
                    model.net, model.cfg, hw, hw, device=device)[0]),
                ("segment-render", lambda: ex.export_segment_render(
                    seg.net, hw, hw, device=device)[0])):
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ep = export()
            t_export = time.perf_counter() - t0
            pt2 = os.path.join(root, f"{what}_{hw}x{hw}.pt2")
            t0 = time.perf_counter()
            torch.export.save(ep, pt2)
            self.exported[what] = (ep, t_export, pt2,
                                   time.perf_counter() - t0)
        self.started = time.perf_counter()
        try:
            for what, (_, _, pt2, _) in self.exported.items():
                env = dict(os.environ,
                           TORCHINDUCTOR_CACHE_DIR=os.path.join(
                               root, f"inductor_{what}"))
                log = open(os.path.join(root, f"{what}.log"), "w+")
                self.procs[what] = (subprocess.Popen(
                    [sys.executable, "-c", _PACKAGE_CHILD, pt2,
                     self.package(what), what, str(device)],
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    env=env, stdout=log, stderr=subprocess.STDOUT), log)
        except BaseException:
            self.close()
            raise
        print("packages: " + ", ".join(
            f"{w} exported in {t:.1f} s, saved in {s:.1f} s"
            for w, (_, t, _, s) in self.exported.items())
            + "; both compiling in child processes")

    def package(self, what):
        return f"{self.root}/{what}_{NATIVE_HW}x{NATIVE_HW}.aoti.pt2"

    def join(self):
        """Wait for both children; their JSON records go to self.done."""
        deadline = self.started + PACKAGE_TIMEOUT
        for what, (proc, log) in self.procs.items():
            late = ""
            try:
                proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                late = f" (killed after {PACKAGE_TIMEOUT} s)"
            log.seek(0)
            out = log.read()
            if proc.returncode != 0:
                self.close()
                raise AssertionError(f"package {what}: the compile child "
                                     f"exited {proc.returncode}{late}:\n"
                                     f"{out[-6000:]}")
            self.done[what] = json.loads(out.strip().splitlines()[-1])
        self.close()

    def close(self):
        for proc, log in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _package_line(what, packages, phases, smi):
    """The compile record of one package, with what ran beside it."""
    rec = packages.done[what]
    other = [w for w, r in packages.done.items() if w != what
             and r["start"] < rec["end"] and r["end"] > rec["start"]]
    t_export = packages.exported[what][1]
    return (f"export {t_export:.1f} s, package compile {rec['compile']:.1f} "
            f"s (cold Inductor cache; in a child process, after "
            f"{rec['load']:.1f} s to load the .pt2, beside phases "
            f"{', '.join(phases.beside(rec['start'], rec['end'])) or 'none'}"
            f" and the {', '.join(other) or 'no other'} compile; CPU s "
            + ", ".join(f"{k} {v:.1f}" for k, v in rec["cpu"].items())
            + f"), {rec['mb']:.1f} MB [{smi}]")


def _native_stylize(native, binary, model, device, gen, tmp, smi, packages,
                    phases):
    import numpy as np

    from vstnet_tpu_torch.models.pipeline import stylize
    from vstnet_tpu_torch.models.segformer import true_f32

    hw, net = NATIVE_HW, model.net
    pkg = packages.package("stylize")
    print(f"native stylize {hw}x{hw} (PHOTO_CONFIG, float32): "
          + _package_line("stylize", packages, phases, smi))

    def eager(c, s):
        with torch.no_grad(), true_f32():
            return stylize(net, c, s)

    # the engine in this process against the eager program
    c = _frames(gen, 1, hw, device)
    s = _frames(gen, 1, hw, device)
    eng = native.NativeEngine()
    eng.load(pkg)
    ch, sh = c.cpu().numpy(), s.cpu().numpy()
    (got,) = eng.execute([ch, sh])
    t0 = time.perf_counter()
    for _ in range(5):
        eng.execute([ch, sh])
    engine_ms = (time.perf_counter() - t0) / 5 * 1e3
    eng.close()
    err = float(np.abs(got - eager(c, s).cpu().numpy()).max())
    print(f"native engine stylize vs eager float32: max abs err {err:.3e} "
          f"(<= {NATIVE_TOL}); NativeEngine.execute {engine_ms:.2f} ms "
          f"(host clock, host copies included) [{smi}]")
    if not err <= NATIVE_TOL:
        raise AssertionError(f"native engine stylize: {err:.3e}")

    # the runner on PNGs: NATIVE_IMAGES contents at the package's size and
    # one wide content that goes through both resizes
    style = _u8_png(f"{tmp}/style.png", s)
    contents = {f"c{i}": _u8_png(f"{tmp}/c{i}.png",
                                 _frames(gen, 1, hw, device))
                for i in range(NATIVE_IMAGES)}
    contents["wide"] = _u8_png(f"{tmp}/wide.png",
                               _frames(gen, 1, NATIVE_WIDE, device))
    out, ms = _run_native(binary, [
        "--artifact", pkg, "--style", f"{tmp}/style.png", "-o",
        f"{tmp}/out", *(f"{tmp}/{k}.png" for k in contents)])
    info = next(line for line in out.splitlines()
                if line.startswith("device:"))
    name = torch.cuda.get_device_name(0)
    if name not in info or "primary context active" not in info:
        raise AssertionError(f"the runner's process holds no CUDA context "
                             f"on {name}: {info!r}")
    worst = {}
    for k, x in contents.items():
        if k == "wide":
            want = _resize_nhwc(eager(_resize_nhwc(x, (hw, hw)), style),
                                NATIVE_WIDE)
        else:
            want = eager(x, style)
        png = _read_png(f"{tmp}/out/{k}_style.png")
        if png.shape != tuple(x.shape[1:]):
            raise AssertionError(f"runner {k}: shape {png.shape}")
        worst[k] = int(np.abs(png - _levels(want)).max())
    if max(worst.values()) > NATIVE_LEVELS:
        raise AssertionError(f"runner PNGs vs eager: levels {worst}")
    runs = [ms[f"c{i}_style.png"] for i in range(NATIVE_IMAGES)]
    mean = sum(runs[1:]) / len(runs[1:])

    c, s = contents["c1"], style
    eager_ms = _time_ms(lambda: eager(c, s), iters=10)
    t0 = time.perf_counter()
    for _ in range(5):
        eager(c.cpu().to(device), s.cpu().to(device)).cpu()
    eager_host_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"native runner stylize: {info}; PNGs vs the eager output "
          f"rounded to uint8, levels {worst} (<= {NATIVE_LEVELS}; the wide "
          f"one {NATIVE_WIDE[1]}x{NATIVE_WIDE[0]} through both resizes); "
          f"execute ms per image {', '.join(f'{v:.2f}' for v in runs)} "
          f"(first call, then mean {mean:.2f} ms, host clock with the host "
          f"copies); eager float32 {eager_ms:.2f} ms (CUDA events) and "
          f"{eager_host_ms:.2f} ms with the host copies (host clock) [{smi}]")
    return mean, eager_ms


def _native_segment(native, binary, seg_net, device, gen, tmp, smi,
                    packages, phases):
    import numpy as np

    from vstnet_tpu_torch.models.segformer import true_f32

    hw = NATIVE_HW
    pkg = packages.package("segment-render")
    print(f"native segment-render {hw}x{hw} (SegFormer-B4, float32): "
          + _package_line("segment-render", packages, phases, smi))

    def eager(x):
        with torch.no_grad(), true_f32():
            return _eager_render(seg_net, x, device)

    x = _u8_png(f"{tmp}/scene.png", _frames(gen, 1, hw, device))
    want = eager(x)
    eng = native.NativeEngine()
    eng.load(pkg)
    (got,) = eng.execute([x.cpu().numpy()])
    eng.close()
    diff = np.abs(got - want.cpu().numpy()).max(-1)[0]
    share = float((diff <= NATIVE_TOL).mean())
    flipped = int((diff > NATIVE_TOL).sum())
    out, ms = _run_native(binary, ["--artifact", pkg, "-o", f"{tmp}/seg",
                                   f"{tmp}/scene.png", f"{tmp}/scene.png"])
    png = _read_png(f"{tmp}/seg/scene_seg.png")
    same = float((np.abs(png - _levels(want)).max(-1) <= NATIVE_LEVELS
                  ).mean())
    eager_ms = _time_ms(lambda: eager(x), iters=5)
    print(f"native segment-render vs eager float32: {share:.5f} of the "
          f"pixels within {NATIVE_TOL} (>= {NATIVE_SEG_SHARE}), {flipped} "
          f"pixels whose label flipped; the runner's PNG within "
          f"{NATIVE_LEVELS} level of the eager output on {same:.5f}; "
          f"execute {ms['scene_seg.png']:.2f} ms (second call, host clock "
          f"with the host copies), eager {eager_ms:.2f} ms (CUDA events) "
          f"[{smi}]")
    if share < NATIVE_SEG_SHARE or same < NATIVE_SEG_SHARE:
        raise AssertionError(f"native segment-render: {share:.5f} of the "
                             f"engine's pixels, {same:.5f} of the PNG's")


def phase_native(model, seg, device, gen, smi, packages, phases):
    """Phase 13: the native tier. Build the engine and the runner, take the
    full-depth stylize program and SegFormer-B4's segment-render packaged
    at 512x512 for the card with a cold Inductor cache (Packages, joined
    before phase 7), and hold the engine and the runner, a process without
    Python, against the eager programs."""
    import tempfile

    from vstnet_tpu_torch.runtime import native

    try:
        import triton
        tri = f"triton {triton.__version__}"
    except ImportError:
        tri = "no triton"
    t0 = time.perf_counter()
    lib, binary = native.build()
    t_build = time.perf_counter() - t0
    _ldd_check([lib, binary])
    print(f"native build: {binary.parent.name} in {t_build:.1f} s (g++ "
          f"against torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{tri}); ldd: libtorch_cuda, no libpython")
    with tempfile.TemporaryDirectory(prefix="vstnet_native_") as tmp:
        _native_stylize(native, binary, model, device, gen, tmp, smi,
                        packages, phases)
        _native_segment(native, binary, seg.net, device, gen, tmp, smi,
                        packages, phases)
    print(f"phase native: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 14: row (spatial) sharding (parallel/halo.py, spatial=True)
# ---------------------------------------------------------------------------

# shards of a data row; the gate of tests/test_parallel.py's spatial program
# against the unsharded one; timed calls a program (phase 8's 4K content
# takes ~0.6 s a float32 stylize); the round trip's float32 bar (phase 4)
SPATIAL_S = (2, 4)
SPATIAL_TOL = 1e-4
SPATIAL_ITERS = 2
SPATIAL_ROUND_TRIP_DB = 100.0


class _HaloProbe:
    """Within the block, the bytes of every halo row that parallel/halo.py
    takes from a neighbour shard (copied to the shard's card where the two
    lie on two cards)."""

    def __enter__(self):
        from vstnet_tpu_torch.parallel import halo

        self.halo = halo
        self.saved = halo._neighbour_rows
        self.bytes = 0

        def run(x, rows, device):
            out = self.saved(x, rows, device)
            self.bytes += out.numel() * out.element_size()
            return out

        halo._neighbour_rows = run
        return self

    def __exit__(self, *exc):
        self.halo._neighbour_rows = self.saved


def _spatial_grid(s):
    """(a (1, s) mesh, whether its devices are distinct cards): s cards
    where the host has them, else s replicas on cuda:0."""
    from vstnet_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() >= s:
        return make_mesh(s, ("data", "spatial"), spatial=s), True
    return ((torch.device("cuda:0"),) * s,), False


def _call_peak(fn, devices):
    """fn()'s result and each device's peak memory during it, in GiB above
    what the device held before the call."""
    devices = list(dict.fromkeys(devices))
    base = {}
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
        base[d] = torch.cuda.memory_allocated(d)
    out = fn()
    for d in devices:
        torch.cuda.synchronize(d)
    return out, {d: (torch.cuda.max_memory_allocated(d) - base[d]) / 2**30
                 for d in devices}


def _spatial_times(name, fn, devices):
    """wall ms of one call (host clock, synchronised), device ms a call
    (CUDA events on each device, the longest), the host's enqueue ms and
    the calls that made the host wait for a device."""
    devices = list(dict.fromkeys(devices))
    syncs = _host_syncs(fn)
    for d in devices:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    fn()
    for d in devices:
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    dev_ms, enq = _par_ms(fn, devices, SPATIAL_ITERS)
    return f"{name} wall {wall * 1e3:.1f} ms, device {dev_ms:.1f} ms, " \
        f"enqueue {enq:.1f} ms a call (calls that wait for the device: " \
        f"{syncs or 'none'})"


def phase_spatial(ops, model, device, gen, smi):
    """Phase 14: parallel_stylize and parallel_stylize_factored with
    spatial=True on a (1, S) mesh for S = 2 and 4, full-depth PHOTO_CONFIG
    in float32 (TF32 off) on phase 8's 3840x2160 content and 1024x576
    style, against the single-device programs; the round trip through
    the row shards; halo bytes, times and peak memory."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.parallel import (
        decode_rows,
        encode_rows,
        gather,
        parallel_stylize,
        parallel_stylize_factored,
        replicate,
        shard_batch,
    )

    t0 = time.perf_counter()
    cfg, net = model.cfg, model.net
    h, w = ULTRA_HW
    content = _frames(gen, 1, ULTRA_HW, device)
    style = _frames(gen, 1, ULTRA_STYLE, device)
    ops.reset_launch_counts()
    whole, peak_whole = _call_peak(lambda: model.stylize(content, style),
                                   [device])
    ls, mu = cwct.style_factors(net.encode(style))
    one_fac = parallel_stylize_factored((device,), cfg)
    fac = gather(one_fac(net, content, ls, mu))
    print(f"spatial single device {w}x{h} float32: "
          + _spatial_times("stylize", lambda: model.stylize(content, style),
                           [device])
          + "; " + _spatial_times("factored", lambda: one_fac(
              net, content, ls, mu), [device])
          + f"; stylize peak {peak_whole[device]:.2f} GiB [{smi}]")
    for s in SPATIAL_S:
        grid, distinct = _spatial_grid(s)
        devices = grid[0]
        if not distinct:
            print(f"spatial S={s}: one card on this host: {s} replicas on "
                  f"it, so no halo row crosses a link, the shards run one "
                  f"after another on one stream, and the peak and the time "
                  f"say nothing about scaling over cards")
        plain = parallel_stylize(grid, cfg, spatial=True)
        factored = parallel_stylize_factored(grid, cfg, spatial=True)
        with _HaloProbe() as probe:
            out, peak = _call_peak(lambda: gather(plain(net, content, style),
                                                  device), devices)
        err = _max_err(out, whole)
        del out
        out = gather(factored(net, content, ls, mu), device)
        err_f = _max_err(out, fac)
        del out
        print(f"gate spatial S={s} {w}x{h} float32: parallel_stylize vs "
              f"model.stylize max abs err {err:.3e}, "
              f"parallel_stylize_factored vs the single-device factored "
              f"program {err_f:.3e} (<= {SPATIAL_TOL})")
        if not (err <= SPATIAL_TOL and err_f <= SPATIAL_TOL):
            raise AssertionError(f"spatial S={s}: errors {err}, {err_f}")
        nets = replicate(devices, net)
        zs = encode_rows(nets, shard_batch(grid, content, spatial=True)[0])
        back = gather([decode_rows(nets, zs)], device)
        p = _psnr(back, content)
        del zs, back
        print(f"gate spatial S={s} round trip decode_rows(encode_rows(x)): "
              f"PSNR {p:.2f} dB (> {SPATIAL_ROUND_TRIP_DB})")
        if not p > SPATIAL_ROUND_TRIP_DB:
            raise AssertionError(f"spatial S={s} round trip {p}")
        print(f"spatial S={s} on {', '.join(map(str, devices))}: "
              + _spatial_times("stylize", lambda: plain(net, content, style),
                               devices)
              + "; " + _spatial_times("factored", lambda: factored(
                  net, content, ls, mu), devices)
              + f"; halo {probe.bytes} bytes a stylize call ("
              f"{probe.bytes / 2**20:.1f} MiB); stylize peak "
              + ", ".join(f"{d} {g:.2f} GiB" for d, g in peak.items())
              + f" beside {peak_whole[device]:.2f} GiB on one device "
              f"[{smi}]")
    launched = _nonzero(ops.launch_counts())
    if launched:
        raise AssertionError(f"spatial: the standard path launched "
                             f"{launched}")
    print(f"phase spatial: {time.perf_counter() - t0:.1f} s; no kernel of "
          f"the port on this path (launches {launched or 'none'})")



# ---------------------------------------------------------------------------
# Phase 15: the row-sharded training step
# ---------------------------------------------------------------------------

# One training step, full-depth PHOTO_CONFIG with remat (the trainer's
# default) in float32 (TF32 off), the trainer's loss weights, a 1024x1024
# content and style at B=1, image and temporal phase, through
# parallel_train_step(rows=...) on a (1, S) mesh against train_step on the
# whole image on one device, with the unsharded loss_and_grads in float64
# as the reference. Gates set from the first card run (H100 80GB HBM3,
# 700 W; the ranges below are of three runs): the gradient's cosine
# against the unsharded one above SPT_COS (measured 0.9999987-0.9999999)
# and its relative L2 distance below SPT_REL_L2 (4.7e-4 to 1.7e-3 while
# the card summed the cWCT's statistics in float32, 4.4e-5 to 6.7e-5 since
# they are summed in float64 there; phase 10's float32-vs-float64 gates).
# Each tensor's max |dg| / max |g| against the unsharded step, the CPU
# test's metric (1e-4 there, at SMALL's depth), is printed, not gated: at
# full depth it reached 1.75e-2 (8.3e-4 with the float64 statistics),
# because float32 itself lies far from float64 on tensors whose gradient
# the cycle term's cancellation dominates (the unsharded float32 step:
# 1.7e-3 to 9.7e-3 of some tensor's max with float32 statistics, 1.4e-3
# to 3.4e-3 with float64 ones, where ReLU and L1 decisions that float32
# cannot make are what is left). So the gate on tensors is against
# float64: over the tensors, the row form's largest max |g - g64| / max
# |g64| within SPT_F64_FACTOR times the unsharded float32 step's, plus
# SPT_REL (measured: 0.30-1.34 times it; 1.04-1.21 with the float64
# statistics). Each aux loss term within rtol / atol
# (loss_rec, zero in exact arithmetic, is roundoff: up to 1.3e-7 apart
# on 5.1e-4). The parameters after the step: Adam's first step is
# -lr * g / (|g| + eps), so a near-zero gradient whose sign the summation
# order flips moves by 2 lr; the largest difference within SPT_PARAM_LRS
# lr (measured 2.0e-4), the mean within SPT_PARAM_MEAN (5.4e-8 to
# 1.04e-7). The bf16 route against the unsharded bf16 call: cosine above
# SPT_BF16_COS (0.9960-0.9989).
SPT_HW = 1024
SPT_SEED = 15
SPT_COS = 0.99999
SPT_REL_L2 = 1e-2
SPT_F64_FACTOR = 2.0
SPT_REL = 1e-4
SPT_AUX_RTOL = 1e-4
SPT_AUX_ATOL = 2e-5
SPT_PARAM_LRS = 3
SPT_PARAM_MEAN = 1e-6
SPT_BF16_COS = 0.99


def _spt_step(step, devices):
    """One training step by step(): (aux, its gradients and parameters
    after it on the host, device ms by CUDA events on each device (the
    longest), host enqueue ms, each device's peak GiB above what it held
    before, the calls that made the host wait for a device)."""
    import collections
    import os
    import warnings

    devices = list(dict.fromkeys(devices))
    base = {}
    ev = {}
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
        base[d] = torch.cuda.memory_allocated(d)
        with torch.cuda.device(d):
            ev[d] = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
            ev[d][0].record()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            aux, net = step()
            enqueue = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for d, (_, e) in ev.items():
        with torch.cuda.device(d):
            e.record()
    for _, e in ev.values():
        e.synchronize()
    ms = max(b.elapsed_time(e) for b, e in ev.values())
    peak = {d: (torch.cuda.max_memory_allocated(d) - base[d]) / 2 ** 30
            for d in devices}
    syncs = dict(collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in rec
        if "synchroniz" in str(w.message)))
    grads = [p.grad.detach().double().cpu() for p in net.parameters()]
    params = [p.detach().double().cpu() for p in net.parameters()]
    return aux, grads, params, ms, enqueue, peak, syncs


def _spt_compare(label, aux, grads, params, ref, g64, lr):
    """Gates of one row-sharded step against the unsharded one (ref: its
    aux, gradients and parameters after the step) and the unsharded
    float64 gradient g64."""
    from vstnet_tpu_torch.train.losses import AUX_KEYS

    aux_w, grads_w, params_w = ref

    def rel(xs, ys):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(xs, ys))

    rw, r64, w64 = rel(grads, grads_w), rel(grads, g64), rel(grads_w, g64)
    g, w = torch.cat([x.flatten() for x in grads]), torch.cat(
        [x.flatten() for x in grads_w])
    cos = float(g @ w / (g.norm() * w.norm()))
    l2 = float((g - w).norm() / w.norm())
    bad = [k for k in AUX_KEYS[:-1] if abs(float(aux[k]) - float(aux_w[k]))
           > SPT_AUX_ATOL + SPT_AUX_RTOL * abs(float(aux_w[k]))]
    pd = torch.cat([(p - q).abs().flatten()
                    for p, q in zip(params, params_w)])
    f64_bound = SPT_F64_FACTOR * w64 + SPT_REL
    print(f"gate {label}: grad cosine {cos:.9f} (> {SPT_COS}), rel L2 "
          f"{l2:.3e} (< {SPT_REL_L2}); max over tensors of max |g - g64| / "
          f"max |g64| from the float64 unsharded gradient: row form "
          f"{r64:.3e} (<= {SPT_F64_FACTOR} x unsharded + {SPT_REL} = "
          f"{f64_bound:.3e}), unsharded float32 {w64:.3e}; row form vs "
          f"unsharded {rw:.3e} (printed); aux "
          + ", ".join(f"{k} {float(aux[k]):.6g}/{float(aux_w[k]):.6g}"
                      for k in AUX_KEYS)
          + f" (each term rtol {SPT_AUX_RTOL}, atol {SPT_AUX_ATOL}), "
          f"params after the step max {float(pd.max()):.3e} (<= "
          f"{SPT_PARAM_LRS} lr = {SPT_PARAM_LRS * lr:.0e}), mean "
          f"{float(pd.mean()):.3e} (< {SPT_PARAM_MEAN})")
    if not (cos > SPT_COS and l2 < SPT_REL_L2 and r64 <= f64_bound
            and not bad and float(pd.max()) <= SPT_PARAM_LRS * lr
            and float(pd.mean()) < SPT_PARAM_MEAN):
        raise AssertionError(f"{label}: cos {cos}, rel L2 {l2}, float64 "
                             f"{r64} > {f64_bound}, aux {bad}, params "
                             f"{float(pd.max())}")


def spt_references(device):
    """Phase 15's inputs and its unsharded float64 gradients, computed
    before phase 7 beside the package compiles (they print nothing): the
    network (seed 0) and VGG (seed 42), a batch from its own generator
    (SPT_SEED; independent of the phases that draw before phase 15), and
    loss_and_grads in float64 for the image and the temporal phase, its
    gradients kept on the host. -> (net, vgg, batch, {temporal:
    [gradients]})."""
    import copy

    from vstnet_tpu_torch.config import PHOTO_CONFIG
    from vstnet_tpu_torch.models.revresnet import RevResNet
    from vstnet_tpu_torch.models.vgg import init_vgg
    from vstnet_tpu_torch.train import trainer as tr
    from vstnet_tpu_torch.train.losses import loss_and_grads

    net = RevResNet(PHOTO_CONFIG.with_remat(), device=device)
    net.init_weights(torch.Generator().manual_seed(0))
    vgg = init_vgg(torch.Generator().manual_seed(42), device=device)
    batch = _train_batch(torch.Generator().manual_seed(SPT_SEED), 1, SPT_HW,
                         device)
    tc = tr.TrainConfig()
    g64 = {}
    with tr._no_tf32():
        for temporal in (False, True):
            net64 = copy.deepcopy(net).double()
            vgg64 = copy.deepcopy(vgg).double()
            g, _ = loss_and_grads(net64, vgg64, *(
                x.double() for x in batch[:2]), tc.weights, batch[2],
                batch[3].double(), temporal, precision="f64")
            g64[temporal] = [x.detach().cpu() for x in g.values()]
            del net64, vgg64, g
    return net, vgg, batch, g64


def phase_spatial_train(ops, device, smi, refs):
    """Phase 15: parallel_train_step(rows=...) on a (1, S) mesh, S = 2 and
    4, full-depth PHOTO_CONFIG with remat, float32 (TF32 off), one
    1024x1024 content and style at B=1, image and temporal phase, against
    train_step on one device: gradients, aux, parameters after the step;
    ms a step, host enqueue ms, peak memory a device; then the bf16 route
    against the unsharded bf16 call (cosine). refs: spt_references()."""
    import copy

    from vstnet_tpu_torch.parallel import parallel_train_step, shard_batch
    from vstnet_tpu_torch.train import trainer as tr
    from vstnet_tpu_torch.train.losses import loss_and_grads, \
        loss_and_grads_rows

    t0 = time.perf_counter()
    net, vgg, batch, refs64 = refs
    tc = tr.TrainConfig()
    grids = {s: _spatial_grid(s) for s in SPATIAL_S}
    for s, (_, distinct) in grids.items():
        if not distinct:
            print(f"spatial train S={s}: one card on this host: {s} "
                  f"replicas on it, so no halo row crosses a link, the "
                  f"shards run one after another on one stream, and the "
                  f"peak and the time say nothing about scaling over "
                  f"cards")
    ops.reset_launch_counts()
    with tr._no_tf32():
        for temporal in (False, True):
            phase = "temporal" if temporal else "image"

            def stepper(rows):
                state = tr.init_train_state(tc, device, copy.deepcopy(net))

                def step():
                    if rows is None:
                        aux = tr.train_step(state, vgg, *batch[:2], tc,
                                            *batch[2:], temporal)
                    else:
                        aux = parallel_train_step(
                            state, vgg, *batch[:2], tc, *batch[2:],
                            temporal, rows=rows)
                    return aux, state.net
                return step

            g64 = refs64[temporal]
            runs = {}
            for s in (1,) + SPATIAL_S:
                rows = None if s == 1 else grids[s][0][0]
                step = stepper(rows)
                devices = [device] if rows is None else list(rows)
                aux, grads, params, ms, enq, peak, _ = _spt_step(step,
                                                                 devices)
                if s == 1:
                    ref = (aux, grads, params)
                else:
                    _spt_compare(f"spatial train S={s} {SPT_HW}x{SPT_HW} "
                                 f"float32 {phase} vs train_step on one "
                                 f"device", aux, grads, params, ref, g64,
                                 tc.lr)
                del grads, params
                _, _, _, ms2, enq2, _, syncs = _spt_step(step, devices)
                runs[s] = (ms, enq, ms2, enq2, peak, syncs)
            for s, (ms, enq, ms2, enq2, peak, syncs) in runs.items():
                where = "one device" if s == 1 else (
                    f"S={s} on {', '.join(map(str, grids[s][0][0]))}")
                print(f"time spatial train {phase} PHOTO_CONFIG "
                      f"{SPT_HW}x{SPT_HW} B=1 float32 remat, {where}: "
                      f"{ms2:.1f} ms a step (first step {ms:.1f}), host "
                      f"enqueue {enq2:.1f} ms (first {enq:.1f}; calls "
                      f"that wait for the device: {syncs or 'none'}), peak "
                      + ", ".join(f"{d} {g:.2f} GiB" for d, g in peak.items())
                      + (f" beside {runs[1][4][device]:.2f} GiB on one "
                         f"device" if s != 1 else "") + f" [{smi}]")
        a, b, flow, noise = (x.to(torch.float32) for x in batch)
        for temporal in (False, True):
            ref, _ = loss_and_grads(net, vgg, a, b, tc.weights, flow, noise,
                                    temporal, precision="bf16")
            ref = _flat_grads(ref)
            for s in SPATIAL_S:
                grid = grids[s][0]
                rows = [shard_batch(grid, x, spatial=True)[0]
                        for x in (a, b, flow, noise)]
                g, _ = loss_and_grads_rows(net, vgg, *rows[:2], tc.weights,
                                           *rows[2:], temporal,
                                           precision="bf16")
                g = _flat_grads(g)
                cos = float(g @ ref / (g.norm() * ref.norm()))
                print(f"gate spatial train S={s} {SPT_HW}x{SPT_HW} bf16 "
                      f"{'temporal' if temporal else 'image'} vs the "
                      f"unsharded bf16 loss_and_grads: grad cosine "
                      f"{cos:.6f} (> {SPT_BF16_COS}) [{smi}]")
                if not (bool(torch.isfinite(g).all())
                        and cos > SPT_BF16_COS):
                    raise AssertionError(f"spatial train bf16 S={s}: {cos}")
    launched = _nonzero(ops.launch_counts())
    if launched:
        raise AssertionError(f"spatial train: the training path launched "
                             f"{launched}")
    print(f"phase spatial train: {time.perf_counter() - t0:.1f} s; no "
          f"kernel of the port on this path (launches "
          f"{launched or 'none'}; cuDNN and cuBLAS)")


def main():
    import os
    import tempfile

    smi = _require_card()
    from vstnet_tpu_torch import ops
    from vstnet_tpu_torch.models.pipeline import StyleModel
    from vstnet_tpu_torch.models.segformer import Segmenter
    from vstnet_tpu_torch.ops import _build
    from vstnet_tpu_torch.ops import attention as att
    from vstnet_tpu_torch.ops import coupling_fused as cf
    from vstnet_tpu_torch.ops import dwconv as dw

    print(f"device: {torch.cuda.get_device_name(0)}")
    print(smi)
    print(f"host: os.cpu_count() {os.cpu_count()}")
    device = torch.device("cuda:0")

    phases = Phases()

    def build():
        t0 = time.perf_counter()
        path, compile_s = _build.build()
        _build.load()
        print(f"build: {path.name} (nvcc {compile_s:.1f} s, total "
              f"{time.perf_counter() - t0:.1f} s)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    phases.run("build", build)
    tmp = tempfile.TemporaryDirectory(prefix="vstnet_smoke_")
    packages = None
    try:
        # phase 4's model and phase 5's segmenter, made from their seeds
        # before phase 3 so that phase 13's packages compile beside phases
        # 3-5
        model = StyleModel.random_init(seed=0, device=device)
        seg = Segmenter.load(None, seed=0, device=device)
        packages = phases.run("export", Packages, model, seg, device,
                              tmp.name)
        gen = torch.Generator().manual_seed(0)
        worst = phases.run("kernels", phase_kernels, cf, att, dw, device,
                           gen)
        # launches of the main paths only: every count is set to 0 just
        # before a path is driven and read just after
        total = dict.fromkeys(KERNELS, 0)
        style = phases.run("global", phase_global, ops, model, device, gen,
                           total)
        region, plan = phases.run("masked", phase_masked, ops, model, seg,
                                  style, device, gen, total)
        spt = phases.run("spatial train f64", spt_references, device)
        # no compile runs beside a phase that prints a host clock
        phases.run("package join", packages.join)
        phases.run("cli", phase_cli, ops, model, device, gen, total, smi)
        phases.run("ultra", phase_ultra, ops, model, device, gen, total,
                   smi)
        phases.run("serve", phase_serve, ops, model, device, gen, total,
                   smi)
        phases.run("train", phase_train, device, gen, smi)
        phases.run("tools", phase_tools, ops, model, seg, device, gen,
                   total, smi, packages.exported)
        phases.run("parallel", phase_parallel, ops, model, style, seg,
                   region, plan, gen, total, smi)
        phases.run("native", phase_native, model, seg, device, gen, smi,
                   packages, phases)
    finally:
        if packages is not None:
            packages.close()
        tmp.cleanup()
    phases.run("spatial", phase_spatial, ops, model, device, gen, smi)
    phases.run("spatial train", phase_spatial_train, ops, device, smi, spt)
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{missing}")
    rec = phases.run("timings", phase_timings, cf, att, dw, device, gen)
    region_worst, region_rec = phases.run("regions", phase_regions, ops,
                                          device, gen)
    worst.update(region_worst)
    rec.update(region_rec)
    phases.run("programs", phase_programs, model, style, seg, region, plan,
               device, gen)
    print(phases.line())

    record = {"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": total[k],
         "max_abs_err": worst[k], **rec[k]} for k in KERNELS]}
    print("kernels: launches are those of the main paths' runs (global 2 "
          "bf16 batches and 1 float32 batch at 512x512 and 1 float32 batch "
          "at 640x360, masked 2 batches, seg 256 and 640x360 one each, "
          "phase 7's CLI runs and photo_pipeline, phase 8's fused tiled "
          "runs at 3840x2160, phase 9's fused service, phase 11's three "
          "GGUF stylizes, phase 12's parallel programs, CLI and service; "
          "the smoke CLI's child processes count their own); ms, "
          "plain_ms, "
          "bound_ms and library_ms are sums over the launches of one "
          "encode at B=8 (coupling_mma 30 "
          "and transition_mma 2 in bf16 at 512x512, transition_half_mma 2 "
          "in bf16 at 640x360; coupling, transition and transition_half, "
          "the float32 route's kernels, 30, 2 and 2 in float32 at the same "
          "sizes) or of one segment call at 512x512 B=8 in bf16 "
          "(attention 3, dwconv_gelu 41, attention_sdpa 38, "
          "upsample_argmax 1; dwconv_gelu's ms by CUDA-graph "
          "replay, the others' eagerly) or of one call at the auto-seg "
          "cell's batch, 8 x 1280x720, C=32, K=16 (region_moments, "
          "region_apply); bound_ms sums each launch's "
          "bound and bound_by names the kind that holds the larger share; "
          "max_abs_err is the largest kernel-vs-plain error of phase 3, in "
          "bf16 (coupling, transition, transition_half: in float32; "
          "region_moments: the phase regions' largest distance of the "
          "plain float64 sums' max, region_apply its abs err; "
          "upsample_argmax: the most pixels of one check whose class "
          "differs from resize_bilinear + argmax)")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
