"""Where a block of the tensor-core coupling kernel (K1) spends its cycles.

    python3 scripts/torch_k1_phase_ticks.py        (one CUDA card, nvcc)

Adds -DVST_PHASE_TICKS to the flags of ops/_build.py before the first
build, so the port's own build and wrapper run a library (named by its own
hash) in which every warp of csrc/coupling_mma.cu records clock64() at its
phase boundaries. Runs fused_coupling at the main path's three shapes
(C=256 128x128, C=64 256x256, C=16 512x512, bf16, batch 8), checks the
output against the plain version and prints the kernel's time (CUDA events,
with the recording off) and the mean cycles per phase over all warps of all
blocks. Cycles are the SM clock's; the phases of a warp include the time it
waits at the block's barriers.
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

WIDE = ("stage first x chunk", "conv1 (stages the other chunks)",
        "store h1", "conv2 + store h2", "conv3 + output")
NARROW = ("stage x window, load weights", "conv1 + store h1",
          "conv2 + store h2", "conv3 + output")
SHAPES = ((256, 128, WIDE), (64, 256, WIDE), (16, 512, NARROW))
BATCH = 8
# the buffer's row per block (csrc/coupling_mma.cu: VST_TICKS_END) and the
# smallest tile of any width, for an upper bound on the blocks
ROW = (16, 8)
MIN_TILE = 16


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DVST_PHASE_TICKS")
    lib = _build.load()
    lib.vst_coupling_mma_set_ticks.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    for c, hw, phases in SHAPES:
        m = c // 4
        branch = tuple(
            ((torch.randn((co, ci, 3, 3), generator=gen) * 0.05).to(dev),
             (torch.randn((co,), generator=gen) * 0.1).to(dev))
            for ci, co in ((c, m), (m, m), (m, c)))
        wp = cf.pack_coupling_weights(branch, bf)
        x1, x2 = (torch.randn((BATCH, c, hw, hw), generator=gen).to(dev, bf)
                  for _ in range(2))

        for _ in range(3):
            cf.fused_coupling(x1, x2, wp)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            cf.fused_coupling(x1, x2, wp)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 10

        # rows the kernel does not write stay at -1
        most = BATCH * (-(-hw // MIN_TILE)) ** 2
        ticks = torch.full((most, *ROW), -1, dtype=torch.int64, device=dev)
        lib.vst_coupling_mma_set_ticks(ticks.data_ptr())
        before = cf.fused_coupling.mma_launches
        out = cf.fused_coupling(x1, x2, wp)
        torch.cuda.synchronize()
        lib.vst_coupling_mma_set_ticks(None)
        if cf.fused_coupling.mma_launches != before + 1:
            sys.exit(f"C={c}: not routed to the tensor-core kernel")
        ref = cf.coupling_block_plain(x1, x2, wp)
        err = float((out.float() - ref.float()).abs().max())
        last = len(phases)
        used = ticks[ticks[:, 0, last] >= 0]
        warps = int((used[0, :, last] >= 0).sum())
        mean = used[:, :warps, :last + 1].double().mean(dim=(0, 1)).tolist()
        print(f"K1 C={c} {hw}x{hw} B={BATCH} bf16: {ms:.3f} ms, "
              f"{used.shape[0]} blocks of {warps} warps, {mean[last]:.0f} "
              f"cycles a block, max abs err vs plain {err:.3e}")
        for name, t0, t1 in zip(phases, mean[:-1], mean[1:]):
            print(f"  {name}: {t1 - t0:.0f} cycles "
                  f"({100 * (t1 - t0) / mean[last]:.1f} %)")


if __name__ == "__main__":
    main()
