"""`correct` against its controls, at a small size on the CPU.

The control (readings.py: the reference in the precision below the
cell's, in the program's place) has to come out not correct, and so has
a run whose timed path is broken underneath, once for each fault the
cell can have: half of a batch left out (its second half a copy of the
first), and an answer altered where it is produced. The cells run on one
card with no exchange and keep no state from step to step, so the other
faults of the contract do not arise. Limits are the cells' own
(benchmark/workloads)."""

import os
import time

import pytest
import torch

CELLS = ["photo-video720-global", "photo-seg-video720-masked",
         "photo-image1280-f32", "photo-ultra4k-fused"]


def _run(tiny_root, name):
    from benchmark.core import session, spec

    cell = spec.load_cell(name, tiny_root)
    return session.run(cell, 2 ** 31 + 5, 0.3, False, torch.device("cpu"),
                       time.time(),
                       bench_dir=os.path.join(tiny_root, "benchmark"))


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct_and_its_control_is_not(tiny_root, name):
    import readings

    from benchmark.core import session, spec

    assert _run(tiny_root, name)["correct"] is True
    cell = spec.load_cell(name, tiny_root)
    numbers = readings.control_readings(
        cell, 7, torch.device("cpu"),
        bench_dir=os.path.join(tiny_root, "benchmark"))
    assert session.judge(numbers, cell.workload["limits"])[0] is False


def _half(out):
    h = out.shape[0] // 2
    return torch.cat([out[:h], out[:out.shape[0] - h]])


def _alter(out):
    out = out.clone()
    out[0] = out[0].flip(0)
    return out


def _patch_video(monkeypatch, fault):
    from vstnet_tpu_torch.models import revresnet_fast as rf

    real = rf.decode_fast
    monkeypatch.setattr(rf, "decode_fast",
                        lambda *a, **k: fault(real(*a, **k)))


@pytest.mark.parametrize("fault", [_half, _alter])
@pytest.mark.parametrize("name", CELLS[:2])
def test_a_broken_video_program_is_not_correct(tiny_root, monkeypatch, name,
                                               fault):
    _patch_video(monkeypatch, fault)
    assert _run(tiny_root, name)["correct"] is False


def test_altered_masks_are_not_correct(tiny_root, monkeypatch):
    from vstnet_tpu_torch.models import pipeline

    real = pipeline.video_remap
    monkeypatch.setattr(pipeline, "video_remap",
                        lambda *a, **k: _alter(real(*a, **k)))
    r = _run(tiny_root, "photo-seg-video720-masked")
    assert r["correct"] is False
    assert r["checks"]["worst_clear_mask_mismatch"]["value"] > r["checks"][
        "worst_clear_mask_mismatch"]["limit"]


def test_an_altered_standard_image_is_not_correct(tiny_root, monkeypatch):
    from vstnet_tpu_torch.models.revresnet import RevResNet

    real = RevResNet.decode
    monkeypatch.setattr(RevResNet, "decode",
                        lambda self, z: _alter(real(self, z)))
    assert _run(tiny_root, "photo-image1280-f32")["correct"] is False


@pytest.mark.parametrize("fault", [_half, _alter])
def test_a_broken_tiler_is_not_correct(tiny_root, monkeypatch, fault):
    from vstnet_tpu_torch.models import ultra

    real = ultra._dec
    monkeypatch.setattr(ultra, "_dec", lambda *a: fault(real(*a)))
    assert _run(tiny_root, "photo-ultra4k-fused")["correct"] is False
