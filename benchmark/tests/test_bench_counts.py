"""The counts against PERF.md's bounds at 512x512, batch 8."""

import json
import os

import pytest

from conftest import ROOT


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name)) as f:
        return json.load(f)


def _counts(name):
    from benchmark.core import spec

    return spec.load_module("counts", name)


def test_k1_and_k2_bounds_at_512_batch_8():
    from benchmark.core import peaks

    rn = _counts("revresnet")
    launches = rn.launches(_cfg("cap-vstnet-photo.json"), 8, 512, 512)
    kinds = [l.kernel for l in launches]
    assert kinds.count("k1") == 30 and kinds.count("k2") == 2
    k1 = [l for l in launches if l.kernel == "k1"]
    ms = [1e3 * peaks.bound_s(l.flop, l.nbytes) for l in launches]
    assert ms[0] == pytest.approx(0.0601, abs=5e-5)          # C=16, bytes
    assert 1e3 * peaks.bound_s(k1[-1].flop, k1[-1].nbytes) == \
        pytest.approx(0.0879, abs=5e-5)                      # C=256, flops
    k2 = [m for l, m in zip(launches, ms) if l.kernel == "k2"]
    assert k2[0] == pytest.approx(0.0801, abs=5e-5)          # T1, bytes


def test_k1_operations_per_pixel_and_k3_at_720p():
    rn = _counts("revresnet")
    cfg = _cfg("cap-vstnet-photo.json")
    k1 = [l for l in rn.launches(cfg, 1, 512, 512) if l.kernel == "k1"]
    assert sum(l.flop for l in k1) / 512 ** 2 == 575424
    kinds = [l.kernel for l in rn.launches(cfg, 8, 720, 1280)]
    assert kinds.count("k2") == 1 and kinds.count("k3") == 1


def test_segformer_routes_at_720p():
    sf = _counts("segformer")
    cfg = _cfg("cap-vstnet-photo-segformer-b4.json")["segformer"]
    assert sf.grids(cfg, 720, 1280)[:2] == [(180, 320, 880), (90, 160, 880)]
    assert len(sf.attention_launches(cfg, 8, 720, 1280)) == 11
    assert len(sf.dwconv_launches(cfg, 8, 720, 1280)) == 41
    # SegFormer-B4 at 512x512: the paper's 95.7 G counts multiply-adds,
    # 2 operations each here
    assert sf.flop(cfg, 1, 512, 512) / 2 == pytest.approx(95.7e9, rel=0.01)
