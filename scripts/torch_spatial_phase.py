"""Phase 14 of chip_smoke.py (row sharding) alone, on the card(s).

    python3 scripts/torch_spatial_phase.py        (from the repo root)

Makes the random full-depth PHOTO_CONFIG model from seed 0 and runs
chip_smoke.phase_spatial: parallel_stylize and parallel_stylize_factored
with spatial=True on a (1, S) mesh, S = 2 and 4, in float32 with TF32 off
at 3840x2160 against the single-device programs, the round trip through
the row shards, halo bytes, times and peak memory; over S cards where the
host has them, else over S replicas on cuda:0. No kernel of the port lies
on this path, so nothing is built. Exits non-zero without a card or when
a gate fails.
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

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    model = StyleModel.random_init(seed=0, device=device)
    chip_smoke.phase_spatial(ops, model, device, gen, smi)
    print(f"phase spatial done at {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
