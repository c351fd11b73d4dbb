"""The port's tools: runtime/profiling.py, the smoke CLI (cli/smoke.py) on
the CPU, and the rule that no module of the port imports jax or
vstnet_tpu.

The smoke CLI runs at 32-64 px with --device cpu, where the kernels'
wrappers run their plain versions: its parity gate then holds the CPU
against itself, so its failure path is driven directly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vstnet_tpu_torch.cli import smoke
from vstnet_tpu_torch.runtime import profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace_files(logdir):
    return [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        torch.nn.functional.conv2d(torch.ones(1, 3, 16, 16),
                                   torch.ones(4, 3, 3, 3))
    (name,) = _trace_files(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


def test_trace_reader_counts_kernels_and_the_idle_share(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "void vst::k<16>(int)",
         "ts": 100, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void vst::k<16>(int)",
         "ts": 105, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 130,
         "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0,
         "dur": 500},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 120},
    ]
    with open(tmp_path / "a.pt.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    assert profiling.kernel_counts(str(tmp_path)) == {
        "void vst::k<16>(int)": 2}
    # window 100-140 us, busy 15 + 10 us of it
    summary = profiling.summarize_trace(str(tmp_path), top=1)
    assert ("3 device events, window 0.040 ms, busy 0.025 ms, idle 37.5 %"
            in summary)
    assert "void vst::k<16>(int)" in summary and "Memcpy" not in summary
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        profiling.kernel_counts(str(empty))


def test_trace_summary_divides_by_the_traced_window_and_lists_spans(
        tmp_path):
    """Idle time before the first device event counts, within trace()'s
    vst.traced window; a span's device time is that of the work launched
    inside it (the runtime call of the same correlation id)."""
    def ev(name, cat, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("vst.traced", "user_annotation", 0, 1000),
        ev("vst.encode", "user_annotation", 100, 200),
        ev("vst.decode", "user_annotation", 700, 100),
        ev("cudaLaunchKernel", "cuda_runtime", 150, 5, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 750, 5, corr=2),
        ev("cudaMemcpyAsync", "cuda_runtime", 900, 5, corr=3),
        ev("void vst::k<16>(int)", "kernel", 600, 300, corr=1),
        ev("void vst::k<16>(int)", "kernel", 900, 50, corr=2),
        ev("Memcpy DtoH", "gpu_memcpy", 950, 100, corr=3),
    ]
    with open(tmp_path / "a.pt.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    summary = profiling.summarize_trace(str(tmp_path))
    # busy [600, 1000] of the window [0, 1000]: the first 600 us idle
    assert ("3 device events, window 1.000 ms, busy 0.400 ms, idle 60.0 %"
            in summary)
    assert "span vst.encode: 1x, host 0.200 ms, device 0.300 ms" in summary
    assert "span vst.decode: 1x, host 0.100 ms, device 0.050 ms" in summary
    assert "vst.traced:" not in summary

    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        torch.ones(4).sum()
    (name,) = _trace_files(logdir)
    with open(os.path.join(logdir, name)) as f:
        windows = [e for e in json.load(f)["traceEvents"]
                   if e.get("name") == "vst.traced"]
    assert len(windows) == 1 and windows[0]["cat"] == "user_annotation"


def test_memory_reports_on_the_cpu():
    assert profiling.device_memory_stats("cpu") is None
    assert profiling.call_memory_analysis(torch.ones, 4, device="cpu") is None
    assert profiling.format_memory_report(
        torch.ones, (4,), device="cpu") == "  (no memory stats available)"


def test_smoke_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    # the CLI clears TF32 for its process: restore the flags afterwards
    for mod in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(mod, "allow_tf32", mod.allow_tf32)
    smoke.main(["--test", "all", "--size", "32", "--n_shapes", "2",
                "--batch", "2", "--iters", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "parity gate, cpu against the CPU" in out and "PASS" in out
    assert "shape sweep OK" in out
    for stage in ("encode", "decode", "cwct"):
        assert f"  {stage}" in out

    logdir = str(tmp_path / "prof")
    smoke.main(["--test", "photo", "--size", "64", "--iters", "1",
                "--device", "cpu", "--profile", logdir])
    out = capsys.readouterr().out
    assert "full photo pipeline @64^2 fast" in out
    assert "kernel launches per fast call: {}" in out    # plain versions
    assert f"profile trace written to {logdir}" in out
    assert "no device events" in out
    assert len(_trace_files(logdir)) == 1

    smoke.main(["--test", "train", "--size", "32", "--iters", "1",
                "--device", "cpu"])
    assert "full step (5-pass + losses + adam)" in capsys.readouterr().out


def test_smoke_parity_fails_loudly(tmp_path):
    with pytest.raises(SystemExit) as exc:
        smoke.main(["--test", "parity", "--size", "32", "--device", "cpu",
                    "--reference", str(tmp_path / "missing")])
    assert exc.value.code not in (0, None)
    ref = np.random.default_rng(0).uniform(size=(1, 8, 8, 3))
    smoke._gate("same", ref, ref)
    with pytest.raises(SystemExit) as exc:
        smoke._gate("perturbed", ref + 0.05, ref)
    assert exc.value.code == 1


def test_the_port_imports_neither_jax_nor_vstnet_tpu():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import vstnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(vstnet_tpu_torch.__path__,\n"
        "                               'vstnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'vstnet_tpu'))\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('vstnet_tpu_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) > 40
