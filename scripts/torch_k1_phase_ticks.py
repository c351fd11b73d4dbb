"""Where a block of the tensor-core conv kernels spends its cycles: the
coupling kernel (K1), the stride-2 transition kernel (K2, K3) and the
depthwise conv + GELU kernel (K5).

    python3 scripts/torch_k1_phase_ticks.py        (one CUDA card, nvcc)

Adds -DVST_PHASE_TICKS to the flags of ops/_build.py before the first
build, so the port's own build and wrappers run a library (named by its own
hash) in which every warp of csrc/coupling_mma.cu and
csrc/transition_mma.cu records clock64() at its phase boundaries. Runs
fused_coupling at the main path's three shapes (C=256 128x128, C=64
256x256, C=16 512x512) and fused_transition / fused_transition_half,
forward and inverse, at its two (T1 C=16 512x512, T2 C=64 256x256), all in
bf16 at batch 8; checks each output against the plain version and prints
the kernel's time (CUDA events, with the recording off) and the mean cycles
per phase over all warps of all blocks. Cycles are the SM clock's; the
phases of a warp include the time it waits at the block's barriers. At
C=256 (the warpgroup kernel) the consumers' phases (conv1, h1's store,
conv2, conv3, the epilogue, and their waits for data) and the producer
warps' (the weight ring's and x2's staging, with their waits) are
reported apart.

K5 (csrc/dwconv.cu) at the four MixFFN shapes of 512x512 frames: its blocks
are persistent, so it reports per block the wait for the first tile, the
first tile's math, the waits for the later tiles (load latency that the
double buffer did not hide) and the rest, the tiles a block took and how
unevenly the SMs' shares of them end (the last block's end against the
mean).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vstnet_tpu_torch.ops import _build  # noqa: E402
from vstnet_tpu_torch.ops import coupling_fused as cf  # noqa: E402
from vstnet_tpu_torch.ops import dwconv as dw  # noqa: E402
from vstnet_tpu_torch.ops.coupling import pixel_unshuffle  # noqa: E402

WIDE = ("stage first x chunk", "conv1 (stages the other chunks)",
        "store h1", "conv2 + store h2", "conv3 + output")
# C=256 (coupling_mma_wg_kernel): warps 0-11 consume, 12 streams the
# weights, 13-15 stage x2's window. A consumer's ticks 1-4 close conv1's
# products, h1's store, conv2 with h2's store and conv3 with the epilogue;
# 5, 6 and 7 are the cycles it waited for data, spent in the epilogue and,
# of those, waited for x1. The weight warp's 1 closes the issue of the
# last piece and 2 is its cycles waited for room; a staging warp's 1
# closes the window's last chunk and 2 is its cycles waited for copies
# and for room
WG = "wg"
NARROW = ("stage x window, load weights", "conv1 + store h1",
          "conv2 + store h2", "conv3 + output")
TRANSITION = ("stage first x chunk (with its pass-through)",
              "conv1 (stages the other chunks)", "store h1",
              "conv2 + store h2", "conv3 + output")
K1_SHAPES = ((256, 128, WG), (64, 256, WIDE), (16, 512, NARROW))
K2_SHAPES = (("T1", 16, 512), ("T2", 64, 256))
K5_SHAPES = ((256, 128), (512, 64), (1280, 32), (2048, 16))
BATCH = 8
# the buffer's row per block (csrc/conv_mma.cuh: VST_TICKS_END) and the
# smallest tile of any kernel, for an upper bound on the blocks
ROW = (16, 8)
MIN_TILE = 16


def _branch(gen, dev, widths):
    return tuple(
        ((torch.randn((co, ci, 3, 3), generator=gen) * 0.05).to(dev),
         (torch.randn((co,), generator=gen) * 0.1).to(dev))
        for ci, co in widths)


def _record(label, run, plain, set_ticks, launches, hw):
    """Time run(), then one launch of it with the recording on; `launches`
    reads the count of the tensor-core kernel that run() must take.
    Returns (ms, the ticks of the blocks that wrote, max abs err)."""
    dev = torch.device("cuda:0")
    for _ in range(3):
        run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 10

    # rows the kernel does not write stay at -1
    most = BATCH * (-(-hw // MIN_TILE)) ** 2
    ticks = torch.full((most, *ROW), -1, dtype=torch.int64, device=dev)
    set_ticks(ticks.data_ptr())
    before = launches()
    out = run()
    torch.cuda.synchronize()
    set_ticks(None)
    if launches() != before + 1:
        sys.exit(f"{label}: not routed to the tensor-core kernel")
    err = float((out.float() - plain().float()).abs().max())
    return ms, ticks[ticks[:, 0, 1] >= 0], err


def _report(label, run, plain, set_ticks, launches, hw, phases):
    ms, used, err = _record(label, run, plain, set_ticks, launches, hw)
    last = len(phases)
    warps = int((used[0, :, last] >= 0).sum())
    mean = used[:, :warps, :last + 1].double().mean(dim=(0, 1)).tolist()
    print(f"{label} B={BATCH} bf16: {ms:.3f} ms, {used.shape[0]} blocks of "
          f"{warps} warps, {mean[last]:.0f} cycles a block, max abs err vs "
          f"plain {err:.3e}")
    for name, t0, t1 in zip(phases, mean[:-1], mean[1:]):
        print(f"  {name}: {t1 - t0:.0f} cycles "
              f"({100 * (t1 - t0) / mean[last]:.1f} %)")


def _report_wg(label, run, plain, set_ticks, launches, hw):
    """coupling_mma_wg_kernel: the consumers' phases (mean over warps 0-11
    of all blocks) and the producer's (warps 12-15)."""
    ms, used, err = _record(label, run, plain, set_ticks, launches, hw)
    cons = used[:, :12, :8].double().mean(dim=(0, 1)).tolist()
    wring = used[:, 12, :3].double().mean(dim=0).tolist()
    stage = used[:, 13:, :3].double().mean(dim=(0, 1)).tolist()
    total = cons[4]
    print(f"{label} B={BATCH} bf16: {ms:.3f} ms, {used.shape[0]} blocks of "
          f"16 warps, {total:.0f} cycles a block (consumers), max abs err vs "
          f"plain {err:.3e}")
    conv3 = cons[4] - cons[3] - cons[6]
    for name, cyc in (("conv1's products", cons[1]),
                      ("store h1", cons[2] - cons[1]),
                      ("conv2 + store h2", cons[3] - cons[2]),
                      ("conv3's products", conv3),
                      ("epilogue (x1 read, out written)", cons[6]),
                      ("  of which waited for x1", cons[7])):
        print(f"  {name}: {cyc:.0f} cycles ({100 * cyc / total:.1f} %)")
    print(f"  consumers waited for x2 chunks and weight pieces: "
          f"{cons[5]:.0f} cycles ({100 * cons[5] / total:.1f} %, inside "
          f"the phases above)")
    print(f"  producer: last weight piece issued after {wring[1]:.0f} "
          f"cycles (waited for room {wring[2]:.0f}); x2's window staged "
          f"after {stage[1]:.0f} (waited for copies and room "
          f"{stage[2]:.0f})")


def _report_k5(lib, dev, gen):
    """K5's persistent blocks: ticks 1-3 are the first tile staged, the
    first tile computed and every tile done; 4 the cycles waited for tiles
    after the first, 5 the block's tile count (csrc/dwconv.cu)."""
    lib.vst_dwconv_set_ticks.argtypes = [ctypes.c_void_p]
    for c, hw in K5_SHAPES:
        x = torch.randn((BATCH, hw, hw, c), generator=gen).to(dev,
                                                               torch.bfloat16)
        taps = (torch.randn((3, 3, c), generator=gen) / 3).to(dev)
        bias = (torch.randn((c,), generator=gen) * 0.1).to(dev)
        for _ in range(3):
            dw.dwconv3x3_bias_gelu(x, taps, bias)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            dw.dwconv3x3_bias_gelu(x, taps, bias)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 10
        ticks = torch.full((132 * 16, *ROW), -1, dtype=torch.int64,
                           device=dev)
        lib.vst_dwconv_set_ticks(ticks.data_ptr())
        out = dw.dwconv3x3_bias_gelu(x, taps, bias)
        torch.cuda.synchronize()
        lib.vst_dwconv_set_ticks(None)
        err = float((out.float() - dw.dwconv3x3_bias_gelu_plain(
            x, taps, bias).float()).abs().max())
        used = ticks[ticks[:, 0, 5] >= 0]
        warps = int((used[0, :, 5] >= 0).sum())
        t = used[:, :warps].double().mean(dim=1)   # per block, over warps
        first, math1, total = t[:, 1], t[:, 2] - t[:, 1], t[:, 3]
        waited, tiles = t[:, 4], t[:, 5]
        rest = total - first - waited
        print(f"K5 C={c} {hw}x{hw} B={BATCH} bf16: {ms:.4f} ms (eager), "
              f"{used.shape[0]} blocks of {warps} warps, "
              f"{float(tiles.mean()):.2f} tiles a block (min "
              f"{float(tiles.min()):.0f}, max {float(tiles.max()):.0f}), "
              f"max abs err vs plain {err:.3e}")
        print(f"  per block: first tile staged {float(first.mean()):.0f} "
              f"cycles, first tile's math {float(math1.mean()):.0f}, later "
              f"waits {float(waited.mean()):.0f}, math of every tile "
              f"{float(rest.mean()):.0f} ({float((rest / tiles).mean()):.0f} "
              f"a tile), whole block {float(total.mean()):.0f} (max "
              f"{float(total.max()):.0f})")


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DVST_PHASE_TICKS")
    lib = _build.load()
    for name in ("vst_coupling_mma_set_ticks", "vst_transition_mma_set_ticks"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def pair(c, hw):
        return tuple(torch.randn((BATCH, c, hw, hw), generator=gen).to(dev, bf)
                     for _ in range(2))

    for c, hw, phases in K1_SHAPES:
        m = c // 4
        wp = cf.pack_coupling_weights(
            _branch(gen, dev, ((c, m), (m, m), (m, c))), bf)
        x1, x2 = pair(c, hw)
        args = (f"K1 C={c} {hw}x{hw}",
                lambda: cf.fused_coupling(x1, x2, wp),
                lambda: cf.coupling_block_plain(x1, x2, wp),
                lib.vst_coupling_mma_set_ticks)
        if phases == WG:
            _report_wg(*args, lambda: cf.fused_coupling.wg_launches, hw)
        else:
            _report(*args, lambda: cf.fused_coupling.mma_launches, hw,
                    phases)

    for name, c, hw in K2_SHAPES:
        wp = cf.pack_transition_weights(
            _branch(gen, dev, ((c, c), (c, c), (c, 4 * c))), bf)
        x1, x2 = pair(c, hw)
        a_u = pixel_unshuffle(x1).contiguous()
        b_u = pixel_unshuffle(x2).contiguous()
        # [1] of a forward and [0] of an inverse is the computed stream
        for what, fn, plain, args, inverse in (
                ("K2 forward", cf.fused_transition,
                 cf.transition_block_plain, (x1, x2), False),
                ("K2 inverse", cf.fused_transition,
                 cf.transition_block_plain, (a_u, b_u), True),
                ("K3 forward", cf.fused_transition_half,
                 cf.transition_half_plain, (a_u, b_u), False),
                ("K3 inverse", cf.fused_transition_half,
                 cf.transition_half_plain, (a_u, b_u), True)):
            _report(f"{what} {name} C={c} {hw}x{hw}",
                    lambda: fn(*args, wp, inverse=inverse)[not inverse],
                    lambda: plain(*args, wp, inverse=inverse)[not inverse],
                    lib.vst_transition_mma_set_ticks,
                    lambda: fn.mma_launches, hw, TRANSITION)
    _report_k5(lib, dev, gen)


if __name__ == "__main__":
    main()
