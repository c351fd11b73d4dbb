"""The benchmark's CPU tests: run with `python -m pytest benchmark/tests`
from the repository's root (the repository's own `pytest tests/` does not
collect them)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cell's mix at a size the CPU runs in seconds; nothing else changes
TINY = {
    "video_loop": dict(height=64, width=96, batch=2, pool_frames=4,
                       style_height=48, style_width=64, warm_batches=1),
    "standard": dict(height=48, width=64, pool_images=2, style_height=32,
                     style_width=48, warm_images=1),
    "tiled": dict(height=64, width=96, pool_images=2, style_height=32,
                  style_width=48, tile=48, overlap=8, warm_images=1),
}


def make_tiny_root(dst):
    """A copy of BENCHMARK.json and benchmark/ under dst whose traffic
    mixes are cut to TINY's sizes."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    tdir = os.path.join(dst, "benchmark", "traffic")
    for name in os.listdir(tdir):
        if not name.endswith(".json"):
            continue
        path = os.path.join(tdir, name)
        with open(path) as f:
            mix = json.load(f)
        mix.update(TINY[mix.get("route", mix["loop"])])
        with open(path, "w") as f:
            json.dump(mix, f)
    return str(dst)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")


BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:       # readings.py, as the tests import it
    sys.path.insert(1, BENCH)
