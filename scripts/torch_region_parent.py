"""The regional cWCT of an earlier version of models/cwct.py and
models/ultra.py against the current one, on one CUDA card:

    git archive <commit> vstnet_tpu_torch/models | tar -x -C DIR
    python3 scripts/torch_region_parent.py DIR

Loads DIR's vstnet_tpu_torch/models/cwct.py and ultra.py as modules of
their own (the rest of the package is the current one) and swaps them in
for the package's while the earlier version runs. A third version,
"blocked", is the current cwct with region_moments in another form
(blocked_region_moments below: float32 partial sums over blocks of
BLOCK rows, added in float64), and two more are float64 forms with
fewer launches a chunk (addmm_region_moments) or a batched product over
blocks of rows (bmm64_region_moments). On PHOTO_CONFIG at full depth (weights
from seed 0), smooth frames (chip_smoke._frames) and synthetic label
maps (chip_smoke.region_masks), for each version:

  * the distances from float64 that the card test
    test_region_statistics_on_card_match_float64 gates
    (chip_smoke.region_distances on the masked video program's bf16
    latents at 512x512 B=8 cast up, capacities 8 and 32;
    chip_smoke.tiler_region_distances on the 4K tiler's pass 1);
  * the masked video program's regional cWCT (transfer_masked_factored on
    the bf16 latent at 512x512 B=8, capacities 8, 16 and 32) by CUDA
    events, and one call of it under torch.profiler: the device's busy
    time against the call's wall time, and the kernels that take most;
  * the 4K tiled masked stylize (fused route, 3840x2160 content,
    1024x576 style) by the host clock around a synchronised call; both
    timed in turns (earlier, current, blocked, blocked, current, earlier), with
    each one's peak memory above what was held before it.

Prints only; gates nothing.
"""

from __future__ import annotations

import contextlib
import importlib.util
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from vstnet_tpu_torch import models  # noqa: E402
from vstnet_tpu_torch.models import cwct, ultra  # noqa: E402

BATCH = 8
# rows a float32 partial sum of blocked_region_moments runs over
BLOCK = 256


def blocked_region_moments(x, m, labels, chunk=None):
    """cwct.region_moments' counts, sums and Gram on a CUDA card in
    another form: per chunk of cwct.REGION_CHUNK rows, float32 partial
    sums over blocks of BLOCK rows (one bmm), the partials added in
    float64 (the tail block padded with rows of no label)."""
    c = x.shape[-1]
    x, m = x.reshape(-1, c), m.reshape(-1)
    k = labels.shape[0]
    f64 = torch.float64
    chunk = chunk or cwct.REGION_CHUNK
    cnt = torch.zeros((k,), dtype=f64, device=x.device)
    sm = torch.zeros((k, c), dtype=f64, device=x.device)
    gm = torch.zeros((k * c, c), dtype=f64, device=x.device)
    with cwct.true_f32_matmul():
        for lo, hi in cwct._chunks(x.shape[0], chunk):
            xf, mm = x[lo:hi].float(), m[lo:hi]
            pad = -(hi - lo) % BLOCK
            if pad:
                xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
                mm = torch.nn.functional.pad(mm, (0, pad), value=-3)
            nb = xf.shape[0] // BLOCK
            w = (mm[:, None] == labels[None, :]).float()
            cnt += w.sum(dim=0)
            xb = xf.view(nb, BLOCK, c)
            sm += torch.bmm(w.view(nb, BLOCK, k).transpose(1, 2), xb).sum(
                dim=0, dtype=f64)
            xw = (w[:, :, None] * xf[:, None, :]).view(nb, BLOCK, k * c)
            gm += torch.bmm(xw.transpose(1, 2), xb).sum(dim=0, dtype=f64)
    return cnt, sm, gm.reshape(k, c, c)


def addmm_region_moments(x, m, labels, chunk=None):
    """cwct.region_moments in float64 in chunks of REGION_CHUNK / 2 rows,
    each chunk's sums added by addmm_ into the accumulators (two launches
    a chunk fewer)."""
    c = x.shape[-1]
    x, m = x.reshape(-1, c), m.reshape(-1)
    k = labels.shape[0]
    f64 = torch.float64
    cnt = torch.zeros((k,), dtype=f64, device=x.device)
    sm = torch.zeros((k, c), dtype=f64, device=x.device)
    gm = torch.zeros((k * c, c), dtype=f64, device=x.device)
    with cwct.true_f32_matmul():
        for lo, hi in cwct._chunks(x.shape[0], chunk or
                                   cwct.REGION_CHUNK // 2):
            xf = x[lo:hi].to(f64)
            w = (m[lo:hi, None] == labels[None, :]).to(f64)
            cnt += w.sum(dim=0)
            sm.addmm_(w.t(), xf)
            gm.addmm_((w[:, :, None] * xf[:, None, :]).reshape(
                hi - lo, k * c).t(), xf)
    return cnt, sm, gm.reshape(k, c, c)


def bmm64_region_moments(x, m, labels, chunk=None):
    """blocked_region_moments with float64 partials: blocks of 4 * BLOCK
    rows in float64 (one bmm, more blocks of the output for the card to
    spread), chunks of REGION_CHUNK / 2 rows."""
    c = x.shape[-1]
    x, m = x.reshape(-1, c), m.reshape(-1)
    k = labels.shape[0]
    f64 = torch.float64
    rows = 4 * BLOCK
    cnt = torch.zeros((k,), dtype=f64, device=x.device)
    sm = torch.zeros((k, c), dtype=f64, device=x.device)
    gm = torch.zeros((k * c, c), dtype=f64, device=x.device)
    for lo, hi in cwct._chunks(x.shape[0], chunk or cwct.REGION_CHUNK // 2):
        xf, mm = x[lo:hi].to(f64), m[lo:hi]
        pad = -(hi - lo) % rows
        if pad:
            xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
            mm = torch.nn.functional.pad(mm, (0, pad), value=-3)
        nb = xf.shape[0] // rows
        w = (mm[:, None] == labels[None, :]).to(f64)
        cnt += w.sum(dim=0)
        xb = xf.view(nb, rows, c)
        sm += torch.bmm(w.view(nb, rows, k).transpose(1, 2), xb).sum(dim=0)
        xw = (w[:, :, None] * xf[:, None, :]).view(nb, rows, k * c)
        gm += torch.bmm(xw.transpose(1, 2), xb).sum(dim=0)
    return cnt, sm, gm.reshape(k, c, c)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _swapped(mods):
    """The package's cwct and ultra replaced by `mods` within the block,
    for `from vstnet_tpu_torch.models import ...` and sys.modules."""
    saved = {n: getattr(models, n) for n in mods}
    for n, mod in mods.items():
        setattr(models, n, mod)
        sys.modules[f"vstnet_tpu_torch.models.{n}"] = mod
    try:
        yield
    finally:
        for n, mod in saved.items():
            setattr(models, n, mod)
            sys.modules[f"vstnet_tpu_torch.models.{n}"] = mod


def _version(tree: Path, name: str, moments=None):
    """cwct and ultra loaded from tree's files, cwct's region_moments
    replaced by `moments` when one is given."""
    src = tree / "vstnet_tpu_torch" / "models"
    mods = {"cwct": _load(src / "cwct.py", f"{name}_cwct")}
    if moments is not None:
        mods["cwct"].region_moments = moments
    with _swapped(mods):
        # its `from vstnet_tpu_torch.models import cwct` binds this cwct
        mods["ultra"] = _load(src / "ultra.py", f"{name}_ultra")
    return mods


def _peak(fn):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile(fn, what):
    """One fn() call under torch.profiler: the device kernels' summed time
    against the call's wall time, and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = _wall_ms(fn)
    rows = sorted(((getattr(e, "self_device_time_total", 0.0) / 1e3,
                    e.count, e.key) for e in prof.key_averages()),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{what}: device kernels {busy:.2f} ms of a {wall:.2f} ms call "
          f"(device idle {100 * (1 - busy / wall):.1f} %), "
          f"{sum(r[1] for r in rows)} launches; most: "
          + ", ".join(f"{k[:40]} x{n} {t:.2f} ms" for t, n, k in rows[:5]))


def main():
    tree = Path(sys.argv[1]).resolve()
    smi = chip_smoke._require_card()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.models.pipeline import StyleModel

    versions = {"earlier": _version(tree, "earlier"),
                "current": {"cwct": cwct, "ultra": ultra},
                "blocked": _version(ROOT, "blocked", blocked_region_moments),
                "f64 addmm": _version(ROOT, "addmm", addmm_region_moments),
                "f64 bmm": _version(ROOT, "bmm64", bmm64_region_moments)}
    model = StyleModel.random_init(seed=0, device=dev)
    cfg, fp = model.cfg, model.fast_params
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        frames = chip_smoke._frames(gen, BATCH, 512, dev)
        style = chip_smoke._frames(gen, 1, 512, dev)
        zc = rf.encode_fast(fp, frames.to(torch.bfloat16), cfg)
        zs = rf.encode_fast(fp, style.to(torch.bfloat16), cfg)
        content4k = chip_smoke._frames(gen, 1, chip_smoke.ULTRA_HW, dev)
        style4k = chip_smoke._frames(gen, 1, chip_smoke.ULTRA_STYLE, dev)
    maps = {k: (chip_smoke.region_masks(1, k, *zc.shape[:3]).to(dev),
                chip_smoke.region_masks(2, k, *zs.shape[:3]).to(dev))
            for k in (8, 16, 32)}
    cm4k = chip_smoke.region_masks(3, 32, 1, *chip_smoke.ULTRA_HW).to(dev)
    sm4k = chip_smoke.region_masks(4, 32, 1, *chip_smoke.ULTRA_STYLE).to(dev)

    for name, mods in versions.items():
        with _swapped(mods):
            for k, (cm, sm) in maps.items():
                if k == 16:
                    continue
                d = chip_smoke.region_distances(zc.float(), zs.float(), cm,
                                                sm, k)
                print(f"{name}: regional statistics 512x512 B={BATCH} K={k} "
                      f"(bf16 latent cast up): covariance {d[0]:.3e}, "
                      f"transfer_masked {d[1]:.3e}, factored {d[2]:.3e}")
            d = chip_smoke.tiler_region_distances(model, content4k, style4k,
                                                  cm4k, sm4k)
            print(f"{name}: regional statistics 4K tiler pass 1 K=32: "
                  f"covariance {d[0]:.3e}, transfer {d[1]:.3e}")

    def regional(mods, k):
        region = mods["cwct"].style_region_factors(zs, maps[k][1], k)
        return lambda: mods["cwct"].transfer_masked_factored(
            zc, maps[k][0], *region)

    def tiled(mods):
        def run():
            with _swapped(mods):
                mods["ultra"].stylize_tiled_masked(
                    model.net, content4k, style4k, cm4k, sm4k, cfg,
                    max_labels=32, fast_params=fp)
        return run

    order = tuple(versions) + tuple(reversed(versions))
    for k in (8, 16, 32):
        fns = {n: regional(m, k) for n, m in versions.items()}
        ms = {n: [] for n in versions}
        for n in order:
            ms[n].append(chip_smoke._time_ms(fns[n], iters=5, warmup=2))
        peak = {n: _peak(fns[n]) for n in versions}
        for n, fn in fns.items():
            _profile(fn, f"{n}: regional cWCT 512x512 bf16 B={BATCH} K={k}")
        print(f"regional cWCT 512x512 bf16 B={BATCH} K={k} on {smi} (ms in "
              f"turns {', '.join(order)}): "
              + "; ".join(f"{n} {', '.join(f'{v:.2f}' for v in ms[n])} ms, "
                          f"peak {peak[n]:.1f} MiB" for n in versions))
    fns = {n: tiled(m) for n, m in versions.items()}
    for fn in fns.values():
        fn()                                          # warm-up
    ms = {n: [] for n in versions}
    for n in order:
        ms[n].append(_wall_ms(fns[n]))
    peak = {n: _peak(fns[n]) for n in versions}
    print(f"4K tiled masked stylize (fused, K=32) on {smi} (ms in turns "
          f"{', '.join(order)}): "
          + "; ".join(f"{n} {', '.join(f'{v:.1f}' for v in ms[n])} ms, peak "
                      f"{peak[n]:.1f} MiB" for n in versions))


if __name__ == "__main__":
    main()
