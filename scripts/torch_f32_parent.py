"""The float32 CUDA-core coupling (K1) and transition (K2, K3) kernels
against an earlier version of themselves, on one CUDA card:

    git archive <commit> vstnet_tpu_torch/csrc | tar -x -C DIR
    python3 scripts/torch_f32_parent.py DIR

Builds DIR's vstnet_tpu_torch/csrc/coupling.cu and transition.cu (with
DIR's headers) with nvcc (the flags of ops/_build.py) into a library of
their own, loaded with ctypes through the same C interface (vst_coupling,
vst_transition, vst_transition_half), and the current kernels through the
port's wrappers. First prints what `nvcc -Xptxas -v` reports for each
float32 kernel of both versions (registers, spills, shared memory). Then
checks the two versions bit for bit at ragged shapes (RAGGED), printing
beside each whether the plain version (ops/coupling_fused.py) gives the
same bits with cuDNN on and off. Then,
at the float32 shapes of the 512x512 encode at batch 8 (K1 at its three
widths, K2 at both stride-2 blocks) and of 640x360 frames (K3), forward and
inverse: checks that the two versions give the same bits, and times both
by CUDA-graph replay (device time, without the host's enqueue) in turns:
earlier, current, current, earlier; the smaller of each pair, beside the
bound (chip_smoke.bound_coupling / bound_transition at the float32 peak)
and the share of it.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    K1_SHAPES,
    K2_SHAPES,
    K3_SHAPES,
    PEAK_F32,
    _graph_ms,
    _rand_branch,
    bound_coupling,
    bound_transition,
)
from vstnet_tpu_torch.ops import _build  # noqa: E402
from vstnet_tpu_torch.ops import coupling_fused as cf  # noqa: E402
from vstnet_tpu_torch.ops.coupling import pixel_unshuffle  # noqa: E402

BATCH = 8
SOURCES = ("coupling.cu", "transition.cu")
# (kernel, C, full-res H, W, B) checked for bits only: planes that no 16x16
# tile divides, below one tile, the smallest a reflect pad allows, at B=1
# and 3, small (where cuBLAS and cuDNN sum a conv in another order than the
# kernels) and larger
RAGGED = [("K1", 16, 70, 33, 3), ("K1", 16, 2, 2, 1), ("K1", 16, 260, 250, 1),
          ("K1", 64, 9, 50, 3), ("K1", 64, 3, 17, 1), ("K1", 64, 150, 90, 3),
          ("K1", 256, 20, 36, 3), ("K1", 256, 7, 45, 1),
          ("K1", 256, 45, 80, 3), ("K1", 256, 100, 140, 1),
          ("K1", 256, 130, 150, 3), ("K2", 16, 100, 136, 3),
          ("K2", 16, 4, 4, 1), ("K2", 16, 250, 300, 1),
          ("K2", 16, 130, 270, 3), ("K2", 64, 100, 136, 1),
          ("K2", 64, 6, 90, 3), ("K2", 64, 170, 130, 3),
          ("K2", 64, 260, 200, 1)]


def _ptxas(csrc: Path, work: str, tag: str):
    """Registers, spills and shared memory of each float32 kernel of csrc's
    two sources, as ptxas reports them."""
    for src in SOURCES:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(csrc), "-c", str(csrc / src), "-o",
             str(Path(work) / f"{tag}_{src}.o")],
            capture_output=True, text=True, check=True).stderr
        name = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            elif name and "bfloat" not in name and (
                    "registers" in line or "spill" in line):
                print(f"ptxas {tag} {src} {name}: {line.strip()}")


def _earlier(csrc: Path, work: str):
    lib_path = Path(work) / "f32_earlier.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(csrc), "-o", str(lib_path),
                    *[str(csrc / s) for s in SOURCES]], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("vst_coupling", "vst_transition", "vst_transition_half"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(err, what):
    if err:
        raise RuntimeError(f"earlier {what}: CUDA error {err}")


def _coupling(lib, x1, x2, wp, inverse):
    out = torch.empty_like(x1)
    b, c, h, w = x1.shape
    _check(lib.vst_coupling(x1.data_ptr(), x2.data_ptr(),
                            wp["flat"].data_ptr(), out.data_ptr(), b, c,
                            wp["mid"], h, w, int(inverse), 0, _stream()),
           "K1")
    return out


def _transition(lib, a, b, wp, inverse):
    bsz, c = a.shape[0], wp["cin"]
    if inverse:
        h, w = a.shape[2], a.shape[3]
        shape = (bsz, c, 2 * h, 2 * w)
    else:
        h, w = a.shape[2] // 2, a.shape[3] // 2
        shape = (bsz, 4 * c, h, w)
    out0 = torch.empty(shape, dtype=a.dtype, device=a.device)
    out1 = torch.empty_like(out0)
    _check(lib.vst_transition(a.data_ptr(), b.data_ptr(),
                              wp["flat"].data_ptr(), out0.data_ptr(),
                              out1.data_ptr(), bsz, c, wp["mid"], h, w,
                              int(inverse), 0, _stream()), "K2")
    return out0, out1


def _transition_half(lib, a_u, b_u, wp, inverse):
    out = torch.empty_like(a_u)
    bsz, _, h, w = a_u.shape
    _check(lib.vst_transition_half(a_u.data_ptr(), b_u.data_ptr(),
                                   wp["flat"].data_ptr(), out.data_ptr(),
                                   bsz, wp["cin"], wp["mid"], h, w,
                                   int(inverse), 0, _stream()), "K3")
    return (out, b_u) if inverse else (b_u, out)


def _compare(label, old, new, bound):
    """Same bits either way, then the times in turns."""
    same = all(torch.equal(a, b) for a, b in zip(old(), new()))
    o0, n0, n1, o1 = _graph_ms(old), _graph_ms(new), _graph_ms(new), \
        _graph_ms(old)
    bms, by = bound
    tn, to = min(n0, n1), min(o0, o1)
    print(f"{label} float32: earlier {to:.4f} ms ({o0:.4f}, {o1:.4f}), "
          f"current {tn:.4f} ms ({n0:.4f}, {n1:.4f}) by graph replay; "
          f"bound {bms:.4f} ms ({by}): earlier {100 * bms / to:.1f} %, "
          f"current {100 * bms / tn:.1f} % of it; {to / tn:.2f}x; "
          f"same bits: {same}")
    if not same:
        raise AssertionError(f"{label}: the versions differ")


def _plain_same(fn, want):
    """Whether the plain version gives want's bits with cuDNN on and off."""
    out = []
    for on in (True, False):
        with torch.backends.cudnn.flags(enabled=on):
            out.append(torch.equal(fn(), want))
    return out


def _ragged(lib, dev, gen):
    """The two versions bit for bit at RAGGED, forward and inverse (K2 and
    K3 on the same frames), beside whether the plain version gives the same
    bits with cuDNN on / off."""
    f32 = torch.float32
    for kind, c, h, w, b in RAGGED:
        x1, x2 = (torch.randn((b, c, h, w), generator=gen).to(dev)
                  for _ in range(2))
        if kind == "K1":
            wp = cf.pack_coupling_weights(
                _rand_branch(gen, c, c // 4, c, dev), f32)
            y = cf.fused_coupling(x1, x2, wp)
            back = cf.fused_coupling(y, x2, wp, inverse=True)
            same = (torch.equal(y, _coupling(lib, x1, x2, wp, False))
                    and torch.equal(back, _coupling(lib, y, x2, wp, True)))
            plain = _plain_same(lambda: cf.coupling_block_plain(x1, x2, wp),
                                y)
        else:
            wp = cf.pack_transition_weights(
                _rand_branch(gen, c, c, 4 * c, dev), f32)
            g = cf.fused_transition(x1, x2, wp)
            i = cf.fused_transition(g[1], g[0], wp, inverse=True)
            a_u = pixel_unshuffle(x1).contiguous()
            b_u = pixel_unshuffle(x2).contiguous()
            k = cf.fused_transition_half(a_u, b_u, wp)
            m = cf.fused_transition_half(k[1], k[0], wp, inverse=True)
            same = all(torch.equal(p, q) for p, q in zip(
                g + i + k + m,
                _transition(lib, x1, x2, wp, False)
                + _transition(lib, g[1], g[0], wp, True)
                + _transition_half(lib, a_u, b_u, wp, False)
                + _transition_half(lib, k[1], k[0], wp, True)))
            plain = _plain_same(
                lambda: cf.transition_block_plain(x1, x2, wp)[1], g[1])
        print(f"ragged {kind} C={c} {h}x{w} B={b} float32: earlier == "
              f"current, forward and inverse{' (K2 and K3)' * (kind == 'K2')}"
              f": {same}; plain version the same bits, cuDNN on / off: "
              f"{plain[0]} / {plain[1]}")
        if not same:
            raise AssertionError(f"ragged {kind} C={c} {h}x{w} B={b}: the "
                                 f"versions differ")


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit(__doc__)
    csrc = Path(sys.argv[1]) / "vstnet_tpu_torch" / "csrc"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    f32 = torch.float32
    with tempfile.TemporaryDirectory() as work:
        _ptxas(csrc, work, "earlier")
        _ptxas(_build.CSRC, work, "current")
        lib = _earlier(csrc, work)
        _ragged(lib, dev, gen)
        for name, c, h, w, _ in K1_SHAPES[:3]:
            wp = cf.pack_coupling_weights(
                _rand_branch(gen, c, c // 4, c, dev), f32)
            x1, x2 = (torch.randn((BATCH, c, h, w), generator=gen).to(dev)
                      for _ in range(2))
            for inv in (False, True):
                _compare(
                    f"K1 {name} C={c} {h}x{w} B={BATCH} "
                    f"{'inv' if inv else 'fwd'}",
                    lambda: (_coupling(lib, x1, x2, wp, inv),),
                    lambda: (cf.fused_coupling(x1, x2, wp, inverse=inv),),
                    bound_coupling(BATCH, c, h, w, esize=4, peak=PEAK_F32))
        for shapes, half in ((K2_SHAPES, False), (K3_SHAPES, True)):
            for name, c, h, w, _ in shapes:
                wp = cf.pack_transition_weights(
                    _rand_branch(gen, c, c, 4 * c, dev), f32)
                x1, x2 = (torch.randn((BATCH, c, h, w),
                                      generator=gen).to(dev)
                          for _ in range(2))
                bound = bound_transition(BATCH, c, h, w, 3 if half else 4,
                                         esize=4, peak=PEAK_F32)
                if half:
                    a_u = pixel_unshuffle(x1).contiguous()
                    b_u = pixel_unshuffle(x2).contiguous()
                    ins = ((a_u, b_u),
                           cf.fused_transition_half(a_u, b_u, wp)[::-1])
                    old_fn, new_fn, tag = (_transition_half,
                                           cf.fused_transition_half, "K3")
                    shape = f"C_u={4 * c} {h // 2}x{w // 2}"
                else:
                    ins = ((x1, x2), cf.fused_transition(x1, x2, wp)[::-1])
                    old_fn, new_fn, tag = (_transition, cf.fused_transition,
                                           "K2")
                    shape = f"C={c} {h}x{w}"
                for inv, (a, b) in zip((False, True), ins):
                    _compare(
                        f"{tag} {name} {shape} B={BATCH} "
                        f"{'inv' if inv else 'fwd'}",
                        lambda: old_fn(lib, a, b, wp, inv),
                        lambda: new_fn(a, b, wp, inverse=inv), bound)


if __name__ == "__main__":
    main()
