"""Phase 13 of chip_smoke.py (the native tier) alone, on one CUDA card.

    python3 scripts/torch_native_phase.py        (from the repo root)

Makes the random PHOTO_CONFIG model and SegFormer-B4 from seed 0 as the
whole script does, clears TF32, and runs chip_smoke.phase_native: the
engine and the runner built with g++ against torch's CUDA libraries, the
full-depth stylize program and the segment-render program packaged at
512x512 by AOTInductor on the card, and both held against the eager
float32 programs through NativeEngine and through vstnet-torch-native.
No CUDA kernel of the port lies on this path, so none is built. Exits
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
    from vstnet_tpu_torch.models.pipeline import StyleModel
    from vstnet_tpu_torch.models.segformer import Segmenter

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    model = StyleModel.random_init(seed=0, device=device)
    seg = Segmenter.load(None, seed=0, device=device)
    chip_smoke.phase_native(model, seg, device,
                            torch.Generator().manual_seed(0), smi)
    print(f"phase native done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
