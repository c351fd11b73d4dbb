"""The result line's keys, the import check, and a run without a card."""

import json
import os
import subprocess
import sys
import time

from conftest import ROOT


def test_the_import_check_compares_whole_top_level_names():
    from benchmark.core.session import forbidden_modules

    assert forbidden_modules(["vstnet_tpu_torch", "vstnet_tpu_torch.ops",
                              "torch", "jax_like", "flaxen"]) == []
    assert forbidden_modules(["vstnet_tpu.models", "jax.numpy", "jaxlib",
                              "flax", "optax.x"]) == [
        "flax", "jax", "jaxlib", "optax", "vstnet_tpu"]


def test_a_run_holds_no_jax_and_its_line_has_the_keys(tiny_root, cpu):
    from benchmark.core import session, spec

    cell = spec.load_cell("photo-image1280-f32", tiny_root)
    r = session.run(cell, 2 ** 31 + 99, 0.2, False, cpu, time.time(),
                    bench_dir=os.path.join(tiny_root, "benchmark"))
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(r["metrics"]) == {"image_ms", "setup_s"}
    json.dumps(r)
    assert session.forbidden_modules() == []


def test_the_traced_line_adds_busy_window_and_breakdown(tiny_root, cpu):
    from benchmark.core import session, spec

    cell = spec.load_cell("photo-video720-global", tiny_root)
    r = session.run(cell, 5, 0.2, True, cpu, time.time(),
                    bench_dir=os.path.join(tiny_root, "benchmark"))
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "frames_per_s" not in r["metrics"]
    assert "enqueue_ms.video" in r["metrics"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        return
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "photo-image1280-f32", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_without_the_program_the_command_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and benchmark/."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "photo-image1280-f32", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0
    assert "{" not in p.stdout
