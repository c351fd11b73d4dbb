"""Phase 11 of chip_smoke.py (the tools) alone, on one CUDA card.

    python3 scripts/torch_tools_phase.py        (from the repo root)

Builds the kernels, makes the random PHOTO_CONFIG model and SegFormer-B4
from seed 0 as the whole script does, clears TF32, and runs
chip_smoke.phase_tools: GGUF weights through the fused path, the smoke
CLI in child processes (its photo test under --profile, whose trace must
name the kernels) and the five torch.export artifacts at 512x512 against
the eager functions. Prints the launches the phase counted. Exits
non-zero without a card or when a gate fails.
"""

from __future__ import annotations

import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def main():
    smi = chip_smoke._require_card()
    print(smi, torch.__version__, torch.version.cuda)
    from vstnet_tpu_torch import ops
    from vstnet_tpu_torch.models.pipeline import StyleModel
    from vstnet_tpu_torch.models.segformer import Segmenter
    from vstnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, compile_s = _build.build()
    _build.load()
    print(f"build: {path.name} (nvcc {compile_s:.1f} s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    model = StyleModel.random_init(seed=0, device=device)
    seg = Segmenter.load(None, seed=0, device=device)
    total = dict.fromkeys(chip_smoke.KERNELS, 0)
    chip_smoke.phase_tools(ops, model, seg, device,
                           torch.Generator().manual_seed(0), total, smi, {})
    print(f"launches {total}; phase tools done in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
