"""Phase 10 of chip_smoke.py (training) alone, on one CUDA card.

    python3 scripts/torch_train_phase.py        (from the repo root)

Runs chip_smoke.phase_train with TF32 cleared, as the whole script does
after its build: the train CLI's two phases and a resume at full depth,
float32 against float64 and bf16 against float32, a resumed step against
the uninterrupted one, and the step timings at 256x256 B=2. It needs no
kernel build (no kernel of the port lies on the training path), so it is
the quick way to measure a change to the trainer. Exits non-zero without
a card or when a gate fails.
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    chip_smoke.phase_train(torch.device("cuda:0"),
                           torch.Generator().manual_seed(0), smi)
    print(f"phase train done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
