"""The plain reference: it imports nothing of the program or of JAX, and
its frozen copies still compute what the port's plain paths compute, at a
small size on the CPU."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT

REF = os.path.join(ROOT, "benchmark", "reference")


def test_the_reference_imports_neither_the_program_nor_jax():
    banned = {"vstnet_tpu_torch", "vstnet_tpu", "jax", "jaxlib", "flax",
              "optax"}
    for name in os.listdir(REF):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REF, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & banned, (name, tops)


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def photo():
    from benchmark.core import program, synth

    cfg = _cfg("cap-vstnet-photo.json")
    model, w = program.style_model(cfg, 3, torch.device("cpu"))
    x = synth.clip(3, "clip", 2, 32, 48, "cpu").float() / 255
    s = synth.clip(3, "style", 1, 24, 32, "cpu").float() / 255
    return cfg, model, w, x, s


def test_revresnet_matches_the_port(photo):
    from benchmark.reference import revresnet as rn

    cfg, model, w, x, _ = photo
    z = rn.encode(w, cfg, x)
    assert torch.allclose(z, model.net.encode(x), atol=1e-5, rtol=1e-5)
    assert torch.allclose(rn.decode(w, cfg, z), model.net.decode(z),
                          atol=1e-5, rtol=1e-5)


def test_global_cwct_matches_the_port(photo):
    from vstnet_tpu_torch.models import cwct as port

    from benchmark.reference import cwct

    cfg, model, w, x, s = photo
    z_c, z_s = model.net.encode(x), model.net.encode(s)
    want = port.transfer(z_c, z_s)
    got = cwct.transfer_global(z_c, *cwct.style_factor(z_s[0]))
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4)


def test_regional_cwct_matches_the_port(photo):
    from vstnet_tpu_torch.models import cwct as port

    from benchmark.reference import cwct

    cfg, model, w, x, s = photo
    z_c, z_s = model.net.encode(x[:1]), model.net.encode(s)
    cm = (torch.arange(32 * 48).reshape(1, 32, 48) // 400) % 3
    sm = (torch.arange(24 * 32).reshape(1, 24, 32) // 200) % 3
    labels, ns, mean_s, cov_s = port.style_region_factors(z_s, sm, 8)
    want = port.transfer_masked_factored(z_c, cm, labels, ns, mean_s, cov_s)
    got = cwct.transfer_regional(z_c[0], cm[0],
                                 cwct.style_regions(z_s[0], sm[0]))
    assert torch.allclose(got, want[0], atol=2e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def seg():
    from benchmark.core import program

    cfg = _cfg("cap-vstnet-photo-segformer-b4.json")["segformer"]
    s, w = program.segmenter(cfg, 4, torch.device("cpu"), 0.02)
    return cfg, s, w


def test_segformer_matches_the_port(seg):
    from vstnet_tpu_torch.models.segformer import segment_logits

    from benchmark.core import synth
    from benchmark.reference import segformer as rs
    from benchmark.reference.resize import resize_bilinear

    cfg, s, w = seg
    x = synth.clip(4, "clip", 2, 64, 96, "cpu").float() / 255
    want = segment_logits(s.net, x, half=False)
    got = resize_bilinear(rs._Net(w, cfg, rs.Exact()).logits(x), 64, 96)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    masks, clear = rs.segment(w, cfg, x)
    same = masks == want.argmax(-1)
    assert same.float().mean() > 0.999 and bool(same[clear].all())


def test_remaps_match_the_port(seg):
    from vstnet_tpu_torch.models import remapping as port

    from benchmark.reference import remap

    _, s, _ = seg
    table = torch.from_numpy(np.load(os.path.join(
        REF, "ade20k_semantic_rel.npy")))
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 12, (3, 20, 30), generator=g)
    frames[:, :10] = 40 + frames[:, :10] % 2
    style = torch.randint(30, 45, (1, 20, 30), generator=g)
    in_style, cross = port.video_remap_plan(style, s.label_mapping)
    want = port.video_remap(frames, in_style, cross, s.label_mapping, 0.02)
    for i in range(3):
        got = remap.cross_remap(remap.self_remap(frames[i], table, 0.02),
                                remap.present(style), table)
        assert torch.equal(got, want[i].to(got.dtype))


def test_the_tiler_matches_the_port(photo):
    from vstnet_tpu_torch.models import ultra

    from benchmark.core import synth
    from benchmark.reference import tiler

    cfg, model, w, _, s = photo
    c = synth.clip(3, "photos", 1, 64, 96, "cpu").float() / 255
    want = ultra.stylize_tiled(model.net, c, s, model.cfg, tile=48,
                               overlap=8)
    got = tiler.stylize_tiled(w, cfg, c, s, 48, 8)
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4)
