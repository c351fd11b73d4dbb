"""The port's segment-render package through the native runner
(vstnet-torch-native, one input), against the JAX package, on the CPU.

The SegFormer at the smallest depth it takes (one block a stage, weights
from vstnet_tpu's init_segformer) at 32x32, exported by
export_segment_render and compiled for the CPU by package_program (its own
file, so that pytest-xdist compiles it beside tests/test_torch_native.py's
package). The runner's PNG is held against vstnet_tpu's segment ->
self-remap -> palette -> blend with the gates of
tests/test_native_driver.py: every pixel a 50/50 blend of the input and a
palette colour within 0.015 (uint8 rounding of the PNGs), and the recovered
colours equal to the JAX mask's on >= 95 % of the pixels (random weights
leave near-tied logits, and one flip can relabel a region through the
remapping's area thresholds). The engine's float output is also held
within 1e-6 of the eager program on the same input.
"""

import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vstnet_tpu.models import remapping as jremap
from vstnet_tpu.models import segformer as jsf
from vstnet_tpu_torch.io.checkpoint import segformer_params_from_jax
from vstnet_tpu_torch.models import segformer as sf
from vstnet_tpu_torch.runtime import export as ex
from vstnet_tpu_torch.runtime import native

torch.set_num_threads(2)

TINY = (1, 1, 1, 1)
HW = 32


@pytest.fixture(scope="module")
def seg():
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jsf.init_segformer(k, TINY))(jax.random.PRNGKey(4)))
    net = sf.SegFormer(TINY, device="cpu")
    net.load_state_dict(segformer_params_from_jax(params))
    return params, net.eval()


@pytest.fixture(scope="module")
def package(seg, tmp_path_factory):
    native.build()
    ep, _ = ex.export_segment_render(seg[1], HW, HW, blend=0.5,
                                     device="cpu")
    path = tmp_path_factory.mktemp("pkg") / f"segment_render_{HW}x{HW}.pt2"
    return ep, native.package_program(ep, path, device="cpu",
                                      what="segment-render")


def test_runner_segment_render_matches_jax(seg, package, tmp_path, rng):
    params, _ = seg
    _, pkg = package
    c8 = (rng.uniform(size=(HW, HW, 3)) * 255).astype(np.uint8)
    Image.fromarray(c8).save(tmp_path / "scene.png")
    r = subprocess.run(
        [str(native.build()[1]), "--artifact", str(pkg), "--device", "cpu",
         "-o", str(tmp_path / "out"), str(tmp_path / "scene.png")],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "(segment-render)" in r.stdout
    out = np.asarray(Image.open(tmp_path / "out" / "scene_seg.png"),
                     np.float32) / 255.0

    x = c8[None].astype(np.float32) / 255.0
    m = jremap.self_remapping(jsf.segment_mask(params, jnp.asarray(x)),
                              jremap.load_label_mapping(), 0.02)
    pal = np.asarray(jremap.ade20k_palette(), np.float32) / 255.0
    cand = 0.5 * pal[None, None, :, :] + 0.5 * x[0][:, :, None, :]
    err = np.abs(np.clip(cand, 0.0, 1.0) - out[:, :, None, :]).max(-1)
    rec = err.argmin(-1)
    assert err.min(-1).max() < 0.015, (
        f"pixels that are no palette blend: worst {err.min(-1).max()}")
    ref_m = np.asarray(m)[0]
    # compare rendered colours (argmin can land on a duplicate palette row)
    agree = (pal[rec] == pal[np.clip(ref_m, 0, len(pal) - 1)]).all(-1).mean()
    assert agree >= 0.95, f"mask agreement {agree:.3f} < 0.95"


def test_engine_matches_eager_program(package, rng):
    ep, pkg = package
    x = rng.uniform(size=(1, HW, HW, 3)).astype(np.float32)
    eng = native.NativeEngine("cpu")
    eng.load(pkg)
    assert eng.n_inputs == 1 and eng.input_shapes == [(1, HW, HW, 3)]
    assert eng.metadata("vstnet_what") == "segment-render"
    (got,) = eng.execute([x])
    with torch.no_grad():
        want = ep.module()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_runner_rejects_style_for_one_input(package, tmp_path):
    _, pkg = package
    img = tmp_path / "x.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(img)
    r = subprocess.run(
        [str(native.build()[1]), "--artifact", str(pkg), "--style",
         str(img), "--device", "cpu", "-o", str(tmp_path), str(img)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert "ONE input" in r.stderr
