"""Pass 1 of the global 4K tiler (models/ultra.py's _content_stats) of an
earlier version of models/ultra.py and models/cwct.py against the current
one, on one CUDA card:

    git archive <commit> vstnet_tpu_torch/models | tar -x -C DIR
    python3 scripts/torch_tiler_parent.py DIR

Loads DIR's cwct.py and ultra.py as modules of their own and swaps them
in while the earlier version runs (scripts/torch_region_parent.py's
_version and _swapped). On PHOTO_CONFIG at full depth (weights from seed
0) and smooth frames (chip_smoke._frames from seed 0: a 3840x2160 content
and a 1024x576 style; tile 1024, overlap 128), for each version and each
route (fused: bf16 K1/K2 tile encodes, the latent cast up; float32: the
standard path):

  * the distances from float64 of the same owned latent rows that
    tests/test_torch_cuda.py::
    test_tiled_global_statistics_on_card_match_float64 gates
    (chip_smoke.tiler_global_distances);
  * pass 1's device ms (CUDA events around _content_stats), in turns
    (earlier, current, current, earlier, twice);
  * the peak memory above what was held before, of pass 1 and of the
    whole ultra.stylize_tiled call (torch.cuda.max_memory_allocated).

Prints only; gates nothing.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

# this script's directory is sys.path[0]
import torch_region_parent as trp  # noqa: E402

chip_smoke = trp.chip_smoke
TURNS = ("earlier", "current", "current", "earlier") * 2


def _device_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main():
    tree = Path(sys.argv[1]).resolve()
    smi = chip_smoke._require_card()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    from vstnet_tpu_torch.models import cwct, ultra
    from vstnet_tpu_torch.models.pipeline import StyleModel

    versions = {"earlier": trp._version(tree, "earlier"),
                "current": {"cwct": cwct, "ultra": ultra}}
    model = StyleModel.random_init(seed=0, device=dev)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(0)
    content = chip_smoke._frames(gen, 1, chip_smoke.ULTRA_HW, dev)
    style = chip_smoke._frames(gen, 1, chip_smoke.ULTRA_STYLE, dev)
    routes = {"fused": (model.fast_params, True),
              "float32": (model.net, False)}
    tile, overlap = chip_smoke.ULTRA_TILE, chip_smoke.ULTRA_OVERLAP

    def pass1(mods, weights, fast):
        u = mods["ultra"]
        g = u._TileGrid(*chip_smoke.ULTRA_HW, cfg, tile, overlap)
        return lambda: u._content_stats(g, weights, content, cfg, fast,
                                        u.TILE_BATCH)

    def whole(mods, weights, fast):
        kw = {"fast_params": weights} if fast else {}
        return lambda: mods["ultra"].stylize_tiled(
            model.net, content, style, cfg, tile=tile, overlap=overlap, **kw)

    with torch.no_grad():
        for name, mods in versions.items():
            with trp._swapped(mods):
                for route, (w, fast) in routes.items():
                    with chip_smoke._TilerGlobalProbe() as probe:
                        pass1(mods, w, fast)()
                    cov, tr = chip_smoke.tiler_global_distances(
                        probe, mods["ultra"]._enc(w, style, cfg, fast))
                    del probe
                    print(f"{name}: global tiler pass 1, {route} route, "
                          f"vs float64: covariance {cov:.3e}, transfer "
                          f"{tr:.3e}")
        for route, (w, fast) in routes.items():
            ms = {n: [] for n in versions}
            for n in TURNS:
                ms[n].append(_device_ms(pass1(versions[n], w, fast)))
            peak = {n: (trp._peak(pass1(m, w, fast)),
                        trp._peak(whole(m, w, fast)))
                    for n, m in versions.items()}
            print(f"global tiler pass 1, {route} route, 4K on {smi} (device "
                  f"ms in turns {', '.join(TURNS)}): " + "; ".join(
                      f"{n} {', '.join(f'{v:.1f}' for v in ms[n])} ms, "
                      f"peak {peak[n][0]:.1f} MiB (whole stylize_tiled "
                      f"{peak[n][1]:.1f} MiB)" for n in versions))


if __name__ == "__main__":
    main()
