"""Phase 13 of chip_smoke.py (the native tier) alone, with what runs
beside its package compiles, on one CUDA card.

    python3 scripts/torch_native_phase.py        (from the repo root)

Builds the kernels, makes the random PHOTO_CONFIG model and SegFormer-B4
from seed 0 as the whole script does, clears TF32, exports the full-depth
stylize program and the segment-render program at 512x512 and starts
their AOTInductor compiles in two child processes (chip_smoke.Packages,
each with a cold Inductor cache); runs phases 3-5 (kernels, global,
masked) beside them, as the whole script does, joins them, and runs
chip_smoke.phase_native: the engine and the runner built with g++
against torch's CUDA libraries, both packages held against the eager
float32 programs through NativeEngine and through vstnet-torch-native.
Exits non-zero without a card, when a child fails or when a gate fails.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

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
    from vstnet_tpu_torch.ops import attention as att
    from vstnet_tpu_torch.ops import coupling_fused as cf
    from vstnet_tpu_torch.ops import dwconv as dw

    phases = chip_smoke.Phases()
    path, compile_s = _build.build()
    _build.load()
    print(f"build: {path.name} (nvcc {compile_s:.1f} s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    model = StyleModel.random_init(seed=0, device=device)
    seg = Segmenter.load(None, seed=0, device=device)
    gen = torch.Generator().manual_seed(0)
    total = dict.fromkeys(chip_smoke.KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="vstnet_smoke_") as tmp:
        packages = phases.run("export", chip_smoke.Packages, model, seg,
                              device, tmp)
        try:
            phases.run("kernels", chip_smoke.phase_kernels, cf, att, dw,
                       device, gen)
            style = phases.run("global", chip_smoke.phase_global, ops,
                               model, device, gen, total)
            phases.run("masked", chip_smoke.phase_masked, ops, model, seg,
                       style, device, gen, total)
            phases.run("package join", packages.join)
            phases.run("native", chip_smoke.phase_native, model, seg,
                       device, gen, smi, packages, phases)
        finally:
            packages.close()
    print(phases.line())


if __name__ == "__main__":
    main()
