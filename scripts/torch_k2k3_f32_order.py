"""Where the float32 stride-2 transition kernel (csrc/transition.cu, K2 and
its half-res entry K3) and its plain version part bit for bit, on one CUDA
card:

    python3 scripts/torch_k2k3_f32_order.py

The kernel sums every output in one fixed order (ci, then ky, then kx,
one fmaf each). cuDNN picks an algorithm, and with it an order of the
float32 sums, by the shape; at the 640x360 frame's T2 shape it takes an
FFT for the second conv. So the plain version
(ops/coupling_fused.py:transition_block_plain) runs its float32 convs on
a card with cuDNN off, through PyTorch's own conv. For each float32 shape
of the video paths (512x512, 640x360 and 1280x720 frames) the script
prints, forward and inverse:

  * the kernel against the plain version: max abs error and bit identity;
  * the cuDNN kernels each of the three convs runs with cuDNN on (one
    call under torch.profiler);
  * the branch with cuDNN on or off per conv, for every subset: which
    ones equal the kernel, whether they equal the plain version, and what
    they cost at batch 8 (CUDA events).
"""

from __future__ import annotations

import itertools
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import _rand_branch, _time_ms  # noqa: E402
from vstnet_tpu_torch.ops import _build  # noqa: E402
from vstnet_tpu_torch.ops import coupling_fused as cf  # noqa: E402
from vstnet_tpu_torch.ops.coupling import (  # noqa: E402
    pixel_shuffle,
    pixel_unshuffle,
)

# (name, C, full-res H, W) of the float32 transition at the video paths'
# frame sizes: 512x512, 640x360 and 1280x720
SHAPES = [("T1 512", 16, 512, 512), ("T2 512", 64, 256, 256),
          ("T1 640x360", 16, 360, 640), ("T2 640x360", 64, 180, 320),
          ("T1 1280x720", 16, 720, 1280), ("T2 1280x720", 64, 360, 640)]


def _conv(x, w, b, stride, cudnn):
    with torch.backends.cudnn.flags(enabled=cudnn, deterministic=False,
                                    benchmark=False, allow_tf32=False):
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w, b,
                        stride=stride)


def _branch(x, wts, cudnn):
    """residual_branch_nchw in float32 with cuDNN on or off per conv."""
    (w1, b1), (w2, b2), (w3, b3) = wts
    h = F.relu(_conv(x, w1, b1, 2, cudnn[0]))
    h = F.relu(_conv(h, w2, b2, 1, cudnn[1]))
    return _conv(h, w3, b3, 1, cudnn[2])


def _plain(a, b, wts, inverse, cudnn):
    if not inverse:
        return pixel_unshuffle(a) + _branch(b, wts, cudnn)
    return pixel_shuffle(a - _branch(pixel_shuffle(b), wts, cudnn))


def _cudnn_kernels(x, wts):
    """Names of the device kernels each conv of the branch launches."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    h = x
    for i, (w, b) in enumerate(wts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = _conv(h, w, b, 2 if i == 0 else 1, True)
            torch.cuda.synchronize()
        ks = sorted({e.key for e in prof.key_averages()
                     if getattr(e, "self_device_time_total", 0) > 0
                     and "pad" not in e.key.lower()})
        names.append(" | ".join(k[:90] for k in ks) or "not seen")
        h = F.relu(out)
    return names


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_k2k3_f32_order: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
          f"{torch.backends.cudnn.version()}")
    _build.build()
    _build.load()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    for name, c, h, w in SHAPES:
        branch = _rand_branch(gen, c, c, 4 * c, dev)
        wp = cf.pack_transition_weights(branch, torch.float32)
        wts = [(wt.float(), bs.float()) for wt, bs in branch]
        x1 = torch.randn((2, c, h, w), generator=gen).to(dev)
        x2 = torch.randn((2, c, h, w), generator=gen).to(dev)
        g0, g1 = cf.fused_transition(x1, x2, wp)
        i0, _ = cf.fused_transition(g1, g0, wp, inverse=True)
        r1 = cf.transition_block_plain(x1, x2, wp)[1]
        j0 = cf.transition_block_plain(g1, g0, wp, inverse=True)[0]
        torch.cuda.synchronize()
        print(f"{name} C={c} {h}x{w} float32: kernel vs plain forward "
              f"{float((g1 - r1).abs().max()):.3e} (equal {torch.equal(g1, r1)}),"
              f" inverse {float((i0 - j0).abs().max()):.3e} "
              f"(equal {torch.equal(i0, j0)})")
        for i, k in enumerate(_cudnn_kernels(x2, wts)):
            print(f"  conv{i + 1} cuDNN kernels: {k}")
        xb1 = torch.randn((8, c, h, w), generator=gen).to(dev)
        xb2 = torch.randn((8, c, h, w), generator=gen).to(dev)
        for cudnn in itertools.product((True, False), repeat=3):
            fwd = _plain(x1, x2, wts, False, cudnn)
            inv = _plain(g1, g0, wts, True, cudnn)
            ms = _time_ms(lambda: _plain(xb1, xb2, wts, False, cudnn),
                          iters=3, warmup=1)
            tag = ",".join("cudnn" if on else "native" for on in cudnn)
            print(f"  plain [{tag}]: equals kernel forward "
                  f"{torch.equal(fwd, g1)} (err "
                  f"{float((fwd - g1).abs().max()):.3e}), inverse "
                  f"{torch.equal(inv, i0)}; equals the shipped plain "
                  f"version {torch.equal(fwd, r1)}; {ms:.3f} ms at B=8")


if __name__ == "__main__":
    main()
