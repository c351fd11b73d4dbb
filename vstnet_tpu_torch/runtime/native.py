"""The native tier: AOTInductor packages, a C++ engine and the standalone
runner `vstnet-torch-native`, with no Python at run time.

Counterpart of vstnet_tpu/runtime/native.py and the JAX package's
native/ (a PJRT engine over StableHLO and the vstnet-native binary):

  * package_program(ep_or_pt2, path) compiles a torch.export program of
    runtime/export.py (export_stylize, export_segment_render, ...) into an
    AOTInductor package (`.pt2`) for one device. It is the compile step of
    the PJRT engine (engine_compile), moved ahead of time and into Python,
    where Inductor runs. The package's metadata records what the runner
    needs: its inputs' shapes and dtypes, its output's shape, the number of
    inputs (2 for stylize, 1 for segment-render), `what`, the torch version.
  * build() compiles native/engine.cc (a C ABI over
    torch::inductor::AOTIModelPackageLoader), native/image_io.cc (PNG, PPM,
    bilinear resize) and native/main.cc (the runner) with g++ (or $CXX)
    against libtorch, at first use and never at import, into the
    git-ignored vstnet_tpu_torch/_build/. The outputs are named by a hash
    of the sources, the flags and the torch build, and land there by one
    rename, so two processes may build at once.
  * NativeEngine is the engine through ctypes: load(package), execute,
    close.

Device rule of the port: the CUDA card unless the caller asks for the
CPU. NativeEngine() and the runner without --device take the card and fail
without one; the CPU is used only with device="cpu" / --device cpu. The
engine clears TF32 for cuDNN and cuBLAS in ATen's global context (in a
Python process too: it is one libtorch), so float32 runs are true float32.

The programs are the float32 standard route: none of the port's CUDA
kernels (csrc/) lies on it; on the card Inductor emits its own kernels.
"""

from __future__ import annotations

import copy
import ctypes
import functools
import hashlib
import io
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from vstnet_tpu_torch.device import resolve_device
from vstnet_tpu_torch.models.segformer import true_f32
from vstnet_tpu_torch.runtime.export import signature_inputs

_PKG = Path(__file__).resolve().parent.parent
NATIVE = _PKG / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("engine.cc", "image_io.cc", "main.cc")
HEADERS = ("engine.h", "image_io.h")
ENGINE_NAME = "libvstnet_torch_engine.so"
BINARY_NAME = "vstnet-torch-native"
# metadata keys of a package (read by native/engine.cc)
META_KEYS = ("vstnet_what", "vstnet_n_inputs", "vstnet_input_shapes",
             "vstnet_input_dtypes", "vstnet_output_shape",
             "vstnet_output_dtype", "vstnet_torch_version")


# ---------------------------------------------------------------------------
# Packages
# ---------------------------------------------------------------------------

def _shape(t) -> str:
    return "x".join(str(int(d)) for d in t.shape)


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _user_outputs(ep):
    from torch.export.graph_signature import OutputKind

    node = next(n for n in ep.graph.nodes if n.op == "output")
    return [v.meta["val"] for v, s in zip(node.args[0],
                                          ep.graph_signature.output_specs)
            if s.kind == OutputKind.USER_OUTPUT]


def _on_device(ep, device) -> bool:
    tensors = [*ep.state_dict.values(),
               *(v for v in ep.constants.values()
                 if isinstance(v, torch.Tensor))]
    return all(t.device == device for t in tensors)


@functools.cache
def _openmp_cxx() -> str:
    """The C++ compiler for Inductor's AOT compile, which links OpenMP:
    $CXX (Inductor's own default) if it can, else g++ on PATH. A host may
    set CXX to a compiler without OpenMP's spec file."""
    tried = []
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "omp.cc"
        src.write_text("int main() { return 0; }\n")
        for cxx in dict.fromkeys(c for c in (os.environ.get("CXX"), "g++")
                                 if c):
            try:
                r = subprocess.run([cxx, "-fopenmp", str(src), "-o",
                                    str(Path(tmp) / "omp")],
                                   capture_output=True, text=True)
            except OSError as e:
                tried.append(f"{cxx}: {e}")
                continue
            if r.returncode == 0:
                return cxx
            tried.append(f"{cxx}: {r.stdout}{r.stderr}")
    raise RuntimeError("no C++ compiler with OpenMP for Inductor's AOT "
                       "compile:\n" + "\n".join(tried))


def package_program(ep_or_pt2, path, device=None, what: str | None = None):
    """Compile a torch.export program (an ExportedProgram, a `.pt2` path or
    its bytes) into an AOTInductor package at `path` for `device` (None: the
    CUDA card, device.resolve_device; raises without one). The program is
    moved to the device (a given ExportedProgram is copied first, not
    changed) and compiled with TF32 off (true_f32), by a C++ compiler
    that links OpenMP (_openmp_cxx). `what` names the
    program in the metadata (default: "stylize" for two inputs, else
    "program"). Returns the package's path."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    if isinstance(ep_or_pt2, torch.export.ExportedProgram):
        ep = ep_or_pt2
        if not _on_device(ep, device):
            ep = move_to_device_pass(copy.deepcopy(ep), device)
    else:
        src = ep_or_pt2
        if isinstance(src, (bytes, bytearray)):
            src = io.BytesIO(src)
        ep = move_to_device_pass(torch.export.load(src), device)
    args, kwargs = signature_inputs(ep, device)
    inputs = torch.utils._pytree.tree_leaves((args, kwargs))
    outputs = _user_outputs(ep)
    if len(outputs) != 1:
        raise ValueError(f"package_program takes a program with one output, "
                         f"this one has {len(outputs)}")
    meta = dict(zip(META_KEYS, (
        what or ("stylize" if len(inputs) == 2 else "program"),
        str(len(inputs)),
        ";".join(_shape(t) for t in inputs),
        ";".join(_dtype(t) for t in inputs),
        _shape(outputs[0]), _dtype(outputs[0]), torch.__version__)))
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    saved = ep.example_inputs
    ep.example_inputs = (args, kwargs)
    try:
        with torch.no_grad(), true_f32(), torch._inductor.config.patch(
                {"cpp.cxx": (_openmp_cxx(),)}):
            return torch._inductor.aoti_compile_and_package(
                ep, package_path=path,
                inductor_configs={"aot_inductor.metadata": meta})
    finally:
        ep.example_inputs = saved


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) against this process's torch."""
    from torch.utils import cpp_extension

    lib = Path(torch.__file__).resolve().parent / "lib"
    cflags = ["-std=c++17", "-O2", "-fPIC",
              f"-D_GLIBCXX_USE_CXX11_ABI="
              f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
              *(f"-I{p}" for p in cpp_extension.include_paths())]
    libs = [f"-L{lib}", f"-Wl,-rpath,{lib}", "-ltorch", "-ltorch_cpu",
            "-lc10"]
    if torch.version.cuda:
        # without --no-as-needed the linker may drop libtorch_cuda, and the
        # CUDA backend is then never registered
        libs += ["-Wl,--no-as-needed", "-ltorch_cuda", "-lc10_cuda",
                 "-Wl,--as-needed"]
    return cflags, libs + ["-lz", "-ldl"]


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def build_dir() -> Path:
    """Where build() puts this torch's engine and runner: named by a hash
    of the sources, the compiler, the flags, torch.__version__,
    torch.version.cuda and the C++ ABI."""
    cflags, libs = _flags()
    h = hashlib.sha256(" ".join([_cxx(), *cflags, *libs, torch.__version__,
                                 str(torch.version.cuda),
                                 str(torch._C._GLIBCXX_USE_CXX11_ABI)])
                       .encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    return BUILD_DIR / f"native_{h.hexdigest()[:16]}"


def _run_all(cmds):
    """Run the commands at once; raise with the compiler's output of every
    one that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(map(str, cmd))}\n"
                          f"({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))


def build() -> tuple[Path, Path]:
    """-> (engine library, runner binary), compiled if missing: the three
    sources at once, then the two links at once."""
    out = build_dir()
    lib, binary = out / ENGINE_NAME, out / BINARY_NAME
    if lib.exists() and binary.exists():
        return lib, binary
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = _cxx()
    cflags, libs = _flags()
    work = Path(tempfile.mkdtemp(prefix=".native_", dir=BUILD_DIR))
    try:
        obj = {s: work / (Path(s).stem + ".o") for s in SOURCES}
        _run_all([[cxx, *cflags, "-c", str(NATIVE / s), "-o", str(o)]
                  for s, o in obj.items()])
        _run_all([
            [cxx, "-shared", "-o", str(work / ENGINE_NAME),
             str(obj["engine.cc"]), *libs],
            [cxx, "-o", str(work / BINARY_NAME), str(obj["main.cc"]),
             str(obj["image_io.cc"]), str(obj["engine.cc"]), *libs]])
        for o in obj.values():
            o.unlink()
        try:
            os.rename(work, out)  # one step: no half-built directory
        except OSError:
            if not (lib.exists() and binary.exists()):
                raise  # another process did not win the race either
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib, binary


# ---------------------------------------------------------------------------
# The engine through ctypes
# ---------------------------------------------------------------------------

@functools.cache
def _load() -> ctypes.CDLL:
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    sigs = {
        "engine_create": (P, [ctypes.c_char_p]),
        "engine_ok": (I32, [P]),
        "engine_last_error": (ctypes.c_char_p, [P]),
        "engine_device_info": (ctypes.c_char_p, [P]),
        "engine_load": (I32, [P, ctypes.c_char_p]),
        "engine_n_inputs": (I32, [P]),
        "engine_input_shape": (I32, [P, I32, ctypes.POINTER(I64), I32]),
        "engine_output_shape": (I32, [P, ctypes.POINTER(I64), I32]),
        "engine_metadata": (ctypes.c_char_p, [P, ctypes.c_char_p]),
        "engine_execute": (I32, [P, I64, ctypes.POINTER(fp),
                                 ctypes.POINTER(I32), ctypes.POINTER(I64),
                                 I64, ctypes.POINTER(fp),
                                 ctypes.POINTER(I64)]),
        "engine_destroy": (None, [P]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


class NativeEngine:
    """One AOTInductor package on one device through the C++ engine.
    device=None: the CUDA card (RuntimeError without one); "cpu" only when
    asked for. A package compiled for another device type is refused."""

    def __init__(self, device=None):
        self.device = str(resolve_device(device))
        self._lib = _load()
        self._h = self._lib.engine_create(self.device.encode())
        if not self._lib.engine_ok(self._h):
            err = self._error()
            self._lib.engine_destroy(self._h)
            self._h = None
            raise RuntimeError(f"native engine: {err}")

    def _error(self) -> str:
        return self._lib.engine_last_error(self._h).decode()

    def load(self, package_path):
        if self._lib.engine_load(self._h, os.fspath(package_path).encode()):
            raise RuntimeError(f"native engine: {self._error()}")

    def _dims(self, fn, *args):
        buf = (ctypes.c_int64 * 8)()
        n = fn(self._h, *args, buf, 8)
        if n < 0:
            raise RuntimeError("native engine: no package loaded")
        return tuple(buf[:n])

    @property
    def n_inputs(self) -> int:
        return self._lib.engine_n_inputs(self._h)

    @property
    def input_shapes(self) -> list[tuple[int, ...]]:
        return [self._dims(self._lib.engine_input_shape, i)
                for i in range(self.n_inputs)]

    @property
    def output_shape(self) -> tuple[int, ...]:
        return self._dims(self._lib.engine_output_shape)

    def metadata(self, key: str) -> str:
        return self._lib.engine_metadata(self._h, key.encode()).decode()

    @property
    def device_info(self) -> str:
        return self._lib.engine_device_info(self._h).decode()

    def execute(self, inputs, out_shapes=None) -> list[np.ndarray]:
        """float32 host arrays in (the package's input shapes) -> float32
        host arrays of `out_shapes` (default: the package's output)."""
        fp = ctypes.POINTER(ctypes.c_float)
        ins = [np.ascontiguousarray(x, np.float32) for x in inputs]
        outs = [np.empty(s, np.float32)
                for s in (out_shapes or [self.output_shape])]
        dims = [d for x in ins for d in x.shape]
        rc = self._lib.engine_execute(
            self._h, len(ins),
            (fp * len(ins))(*[x.ctypes.data_as(fp) for x in ins]),
            (ctypes.c_int32 * len(ins))(*[x.ndim for x in ins]),
            (ctypes.c_int64 * len(dims))(*dims), len(outs),
            (fp * len(outs))(*[x.ctypes.data_as(fp) for x in outs]),
            (ctypes.c_int64 * len(outs))(*[x.size for x in outs]))
        if rc != 0:
            raise RuntimeError(f"native engine: {self._error()}")
        return outs

    def close(self):
        if self._h:
            self._lib.engine_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def main(argv=None):
    """vstnet-torch-native: build the runner at first use, then replace
    this process with it (so no Python remains in the running process)."""
    _, binary = build()
    argv = sys.argv[1:] if argv is None else list(argv)
    os.execv(binary, [str(binary), *argv])


if __name__ == "__main__":
    main()
