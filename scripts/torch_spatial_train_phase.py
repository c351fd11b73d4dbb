"""Phase 15 of chip_smoke.py (the row-sharded training step) alone, on
the card(s).

    python3 scripts/torch_spatial_train_phase.py        (from the repo root)

Runs chip_smoke.spt_references (the unsharded float64 gradients, which
the whole script computes beside its package compiles) and
chip_smoke.phase_spatial_train: one training step of the random
full-depth PHOTO_CONFIG (remat on, float32 with TF32 off) on a 1024x1024
content and style at B=1, image and temporal phase, through
parallel_train_step(rows=...) on a (1, S) mesh, S = 2 and 4, against
train_step on one device (gradients, aux losses, parameters after the
step), ms a step, host enqueue ms and peak memory a device; then the bf16
route against the unsharded bf16 call. Over S cards where the host has
them, else over S replicas on cuda:0. No kernel of the port lies on this
path, so nothing is built. Exits non-zero without a card or when a gate
fails.
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

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    refs = chip_smoke.spt_references(device)
    print(f"float64 references in {time.perf_counter() - t0:.1f} s")
    chip_smoke.phase_spatial_train(ops, device, smi, refs)
    print(f"phase spatial train done at {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
