"""Build and load the hand-written CUDA kernels of csrc/.

`nvcc` compiles every `csrc/*.cu` to an object file, all sources at once
in parallel processes, and links them into one shared library with a plain
C interface, which is loaded with ctypes. The library lives in
`vstnet_tpu_torch/_build/` (git-ignored) and is named by a hash of the
sources and flags, so a stale build is never loaded. The build runs at
first use, never at import: importing the package needs no CUDA toolkit.

Every C entry point returns its `cudaGetLastError()`; callers raise on a
non-zero code (`check`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# name -> argtypes; every pointer and the stream are c_void_p, ints c_int,
# element strides c_longlong
_SIGNATURES = {
    # x1, x2, weights, out, B, C, M, H, W, inverse, is_bf16, stream
    "vst_coupling": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x1, x2, bf16 pieces, b1 in the float32 weights, out, B, C, M, H, W,
    # inverse, stream
    "vst_coupling_mma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # a, b, weights, out0, out1, B, C, M, h, w, inverse, is_bf16, stream
    "vst_transition": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P],
    # a, b, weights, out, B, C, M, h, w, inverse, is_bf16, stream
    "vst_transition_half": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # a, b, bf16 pieces, b1 in the float32 weights, out0, out1, B, C, M, h,
    # w, inverse, stream
    "vst_transition_mma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _P],
    # a, b, bf16 pieces, b1 in the float32 weights, out, B, C, M, h, w,
    # inverse, stream
    "vst_transition_half_mma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P],
    # q, k, v, o, B, H, N, M, D, scale, (b, h, n) strides of q, k, v, o,
    # stream
    "vst_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F] + [_L] * 12
                     + [_P],
    # x, w, bias, out, B, H, W, C, stream
    "vst_dwconv_gelu": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, m, labels, label stride, partial, touched, out, B, N, C, K, P, R,
    # is_bf16, stream
    "vst_region_moments": [_P, _P, _P, _I, _P, _P, _P, _I, _L, _I, _I, _I,
                           _I, _I, _P],
    # x, m, labels, label stride, ts, bs, valid, out, B, N, C, K, P, R,
    # is_bf16, stream
    "vst_region_apply": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _L, _I, _I, _I,
                         _I, _I, _P],
    # logits, out, B, h, w, C, H, W, stream
    "vst_upsample_argmax": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"vstnet_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> tuple[Path, float]:
    """Compile the library if it is missing. Returns (path, seconds spent
    compiling; 0.0 when the build already existed)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # one nvcc per source, all started together; link under a private
    # name, then rename: concurrent builds never load a half-written library
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [(src, os.path.join(work, src.stem + ".o"))
                for src in sorted(CSRC.glob("*.cu"))]
        procs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src, obj in objs]
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
             *[obj for _, obj in objs]], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, path)
    return path, time.perf_counter() - t0


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vst_error_string.argtypes = [ctypes.c_int]
    lib.vst_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        name = load().vst_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({name}, {code})")
