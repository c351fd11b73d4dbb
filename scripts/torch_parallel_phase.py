"""Phases 3 and 12 of chip_smoke.py (the kernels against their plain
versions, then the data-parallel layer) alone, on the card(s).

    python3 scripts/torch_parallel_phase.py        (from the repo root)

Builds the kernels, checks each against its plain version (phase 3), makes
what phases 4 and 5 hand phase 12 (the random PHOTO_CONFIG model from seed
0, a 512x512 style, SegFormer-B4 and the masked program's per-video
state) and runs chip_smoke.phase_parallel: the three sharded programs,
data-parallel training over spawned ranks, the video CLI and a service
burst over every card, or over two replicas on cuda:0 where the host has
one card. Exits non-zero without a card or when a gate fails.
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
    from vstnet_tpu_torch.models import segformer as sf
    from vstnet_tpu_torch.models.pipeline import (
        StyleModel,
        prepare_masked_style,
    )
    from vstnet_tpu_torch.ops import _build
    from vstnet_tpu_torch.ops import attention as att
    from vstnet_tpu_torch.ops import coupling_fused as cf
    from vstnet_tpu_torch.ops import dwconv as dw

    t0 = time.perf_counter()
    path, compile_s = _build.build()
    print(f"build: {path.name} (nvcc {compile_s:.1f} s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    chip_smoke.phase_kernels(cf, att, dw, device, gen)
    print(f"phase kernels done at {time.perf_counter() - t0:.1f} s")
    model = StyleModel.random_init(seed=0, device=device)
    style = chip_smoke._frames(gen, 1, 512, device)
    seg = sf.Segmenter.load(None, seed=0, device=device)
    region, plan, _ = prepare_masked_style(model.fast_params, seg, style,
                                           model.cfg)
    total = dict.fromkeys(chip_smoke.KERNELS, 0)
    chip_smoke.phase_parallel(ops, model, style, seg, region, plan, gen,
                              total, smi)
    print(f"phase parallel done at {time.perf_counter() - t0:.1f} s; "
          f"launches {chip_smoke._nonzero(total)}")


if __name__ == "__main__":
    main()
