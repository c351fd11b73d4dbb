"""The depthwise conv + GELU kernel (K5) against an earlier version of
itself, on one CUDA card:

    git archive <commit> vstnet_tpu_torch/csrc | tar -x -C DIR
    python3 scripts/torch_k5_parent.py DIR

Builds DIR's vstnet_tpu_torch/csrc/dwconv.cu alone with nvcc (the flags of
ops/_build.py) into a library of its own, loaded with ctypes through the
same C interface (vst_dwconv_gelu), and the current kernel through the
port's wrapper. At the MixFFN shapes of 512x512 frames (batch 8) and of
1024x1024 frames (batch 1) it checks that the two give the same bits and
times both by CUDA-graph replay (device time, without the host's enqueue),
in turns: earlier, current, current, earlier; the smaller of each pair.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import K5_BIG, K5_SHAPES, _graph_ms  # noqa: E402
from vstnet_tpu_torch.ops import _build  # noqa: E402
from vstnet_tpu_torch.ops import dwconv as dw  # noqa: E402


def _earlier(csrc: Path, work: str):
    lib_path = Path(work) / "dwconv_earlier.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(csrc), "-o", str(lib_path), str(csrc / "dwconv.cu")],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vst_dwconv_gelu.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.vst_dwconv_gelu.restype = i

    def run(x, taps, bias, out):
        b, h, w, c = x.shape
        err = lib.vst_dwconv_gelu(x.data_ptr(), taps.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(), b, h, w,
                                  c, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier K5: CUDA error {err}")
        return out
    return run


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit(__doc__)
    csrc = Path(sys.argv[1]) / "vstnet_tpu_torch" / "csrc"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory() as work:
        earlier = _earlier(csrc, work)
        for b, name, c, h, w in ([(8,) + k[:4] for k in K5_SHAPES]
                                 + [(1,) + k for k in K5_BIG]):
            x = torch.randn((b, h, w, c), generator=gen).to(dev,
                                                           torch.bfloat16)
            taps = (torch.randn((3, 3, c), generator=gen) / 3).to(dev)
            bias = (torch.randn((c,), generator=gen) * 0.1).to(dev)
            out = torch.empty_like(x)
            same = torch.equal(earlier(x, taps, bias, out),
                               dw.dwconv3x3_bias_gelu(x, taps, bias))

            def old():
                return earlier(x, taps, bias, out)

            def new():
                return dw.dwconv3x3_bias_gelu(x, taps, bias)

            o0, n0, n1, o1 = (_graph_ms(old), _graph_ms(new), _graph_ms(new),
                              _graph_ms(old))
            print(f"K5 {name} C={c} {h}x{w} B={b} bf16: earlier "
                  f"{min(o0, o1):.4f} ms ({o0:.4f}, {o1:.4f}), current "
                  f"{min(n0, n1):.4f} ms ({n0:.4f}, {n1:.4f}) by graph "
                  f"replay; same bits: {same}")


if __name__ == "__main__":
    main()
