"""The port's native tier (vstnet_tpu_torch/runtime/native.py, native/)
against the JAX package's stylize program, on the CPU.

One build of the engine and the runner, and one AOTInductor package of
the whole stylize program a module: the tiny RevResNet (one block a
stage, weights from vstnet_tpu's init_revresnet) at 32x32, compiled for
the CPU. Gates:

  * the package through NativeEngine("cpu"): within 1e-4 of vstnet_tpu's
    decode(transfer(encode, encode)) (float32 roundoff through the network
    and the 32x32 Cholesky; 6e-07 measured) and within 1e-6 of the port's
    eager stylize (Inductor reorders float32 sums);
  * the runner on seeded PNGs: within 0.015 of the JAX program, the gate of
    tests/test_native_driver.py (the reference's cross-backend tolerance
    plus the uint8 rounding of the PNGs), also on a content and a style of
    other sizes than the package's, which go through both resizes
    (bilinear, half-pixel centres: F.interpolate with align_corners=False);
  * the argument errors, the metadata, the device rule (no card here: the
    default device fails, nothing runs on the CPU unless asked) and an
    `ldd` of the runner that names no libpython.

The segment-render package is tests/test_torch_native_seg.py, so that
pytest-xdist compiles the two packages on two workers.
"""

import subprocess

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models import cwct as jcwct
from vstnet_tpu.models import revresnet as jrev
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import params_from_jax
from vstnet_tpu_torch.models.pipeline import stylize
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.runtime import export as ex
from vstnet_tpu_torch.runtime import native

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(1, 1, 1))
JSMALL = JaxConfig(n_blocks=(1, 1, 1))
HW = 32

_jstylize = jax.jit(lambda p, c, s: jrev.decode(p, jcwct.transfer(
    jrev.encode(p, c, JSMALL), jrev.encode(p, s, JSMALL)), JSMALL))


@pytest.fixture(scope="module")
def built():
    return native.build()


@pytest.fixture(scope="module")
def rev():
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jrev.init_revresnet(k, JSMALL))(jax.random.PRNGKey(0)))
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(params_from_jax(params))
    return params, net.eval()


@pytest.fixture(scope="module")
def package(rev, built, tmp_path_factory):
    ep, _ = ex.export_stylize(rev[1], SMALL, HW, HW, device="cpu")
    path = tmp_path_factory.mktemp("pkg") / f"stylize_{HW}x{HW}.aoti.pt2"
    return native.package_program(ep, path, device="cpu", what="stylize")


def _run(binary, *args):
    return subprocess.run([str(binary), *map(str, args)],
                          capture_output=True, text=True, timeout=300)


def _png(path, gen, h, w):
    img = (gen.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(path)
    return img.astype(np.float32)[None] / 255.0


def _resize(x, h, w):
    t = torch.tensor(x).permute(0, 3, 1, 2)
    return F.interpolate(t, size=(h, w), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1).numpy()


def test_build_is_hashed_and_links_no_python(built):
    lib, binary = built
    assert lib.parent == binary.parent == native.build_dir()
    assert native.build() == built  # a second call finds the build
    for f in built:
        deps = subprocess.run(["ldd", str(f)], capture_output=True,
                              text=True, check=True).stdout
        assert "libtorch_cpu" in deps and "not found" not in deps, deps
        assert "libpython" not in deps, deps
    assert "libz" in deps  # the runner's PNG codec


def test_engine_matches_jax_and_eager(rev, package, rng):
    params, net = rev
    c = rng.uniform(size=(1, HW, HW, 3)).astype(np.float32)
    s = rng.uniform(size=(1, HW, HW, 3)).astype(np.float32)
    eng = native.NativeEngine("cpu")
    eng.load(package)
    (got,) = eng.execute([c, s])
    eng.close()
    assert got.shape == (1, HW, HW, 3)
    np.testing.assert_allclose(got, np.asarray(_jstylize(params, c, s)),
                               rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        eager = stylize(net, torch.from_numpy(c), torch.from_numpy(s))
    np.testing.assert_allclose(got, eager.numpy(), rtol=0, atol=1e-6)


def test_metadata_round_trip(package):
    eng = native.NativeEngine("cpu")
    eng.load(package)
    shape = (1, HW, HW, 3)
    assert eng.n_inputs == 2
    assert eng.input_shapes == [shape, shape]
    assert eng.output_shape == shape
    want = {"vstnet_what": "stylize", "vstnet_n_inputs": "2",
            "vstnet_input_shapes": f"1x{HW}x{HW}x3;1x{HW}x{HW}x3",
            "vstnet_input_dtypes": "float32;float32",
            "vstnet_output_shape": f"1x{HW}x{HW}x3",
            "vstnet_output_dtype": "float32",
            "vstnet_torch_version": torch.__version__,
            "AOTI_DEVICE_KEY": "cpu"}
    assert {k: eng.metadata(k) for k in want} == want
    assert eng.metadata("no such key") == ""
    assert eng.device_info == "cpu"
    # the same keys through PyTorch's own loader
    meta = torch._inductor.aoti_load_package(str(package)).get_metadata()
    assert {k: meta[k] for k in want} == want
    with pytest.raises(RuntimeError, match="shape differs"):
        eng.execute([np.zeros((1, 8, 8, 3), np.float32)] * 2)
    with pytest.raises(RuntimeError, match="takes 2 inputs"):
        eng.execute([np.zeros(shape, np.float32)])


def test_runner_png_matches_jax(rev, package, built, tmp_path, rng):
    params, _ = rev
    c = _png(tmp_path / "content.png", rng, HW, HW)
    s = _png(tmp_path / "style.png", rng, HW, HW)
    r = _run(built[1], "--artifact", package, "--style",
             tmp_path / "style.png", "--device", "cpu", "-o",
             tmp_path / "out", tmp_path / "content.png")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "device: cpu" in r.stdout and "mean" in r.stdout
    out = np.asarray(Image.open(tmp_path / "out" / "content_style.png"),
                     np.float32) / 255.0
    ref = np.clip(np.asarray(_jstylize(params, c, s))[0], 0.0, 1.0)
    np.testing.assert_allclose(out, ref, atol=0.015)


def test_runner_resizes_other_sizes(rev, package, built, tmp_path, rng):
    """A 40x52 content and a 24x20 style: both resized to the package's
    32x32, the output resized back to 40x52; two contents, one of which
    fails to load, so the exit code is 1 and the other is written."""
    params, _ = rev
    c = _png(tmp_path / "wide.png", rng, 40, 52)
    s = _png(tmp_path / "small.png", rng, 24, 20)
    (tmp_path / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nnot-really")
    r = _run(built[1], "--artifact", package, "--style",
             tmp_path / "small.png", "--device", "cpu", "-o",
             tmp_path / "out", tmp_path / "broken.png", tmp_path / "wide.png")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "broken.png" in r.stderr and "wrote" in r.stdout
    out = np.asarray(Image.open(tmp_path / "out" / "wide_small.png"),
                     np.float32) / 255.0
    assert out.shape == (40, 52, 3)
    ref = np.asarray(_jstylize(params, _resize(c, HW, HW),
                               _resize(s, HW, HW)))
    ref = np.clip(_resize(ref, 40, 52)[0], 0.0, 1.0)
    np.testing.assert_allclose(out, ref, atol=0.015)


def test_runner_argument_errors(package, built, tmp_path):
    img = tmp_path / "x.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(img)
    r = _run(built[1], "--artifact", package, "--device", "cpu", "-o",
             tmp_path, img)
    assert r.returncode == 2 and "needs --style" in r.stderr
    r = _run(built[1], "--device", "cpu", img)  # no --artifact
    assert r.returncode == 2 and "usage" in r.stderr
    r = _run(built[1], "--artifact", tmp_path / "missing.pt2", "--device",
             "cpu", img)
    assert r.returncode == 1 and "error: package" in r.stderr


def test_no_card_no_fallback(package, built, tmp_path):
    """On a host without a card the defaults fail; nothing runs on the CPU
    unless asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        native.NativeEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        native.NativeEngine("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        native.package_program(package, tmp_path / "x.pt2")
    img = tmp_path / "x.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(img)
    r = _run(built[1], "--artifact", package, "--style", img, "-o",
             tmp_path / "out", img)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "out").exists()


def test_export_cli_native(monkeypatch, tmp_path):
    """--native writes each artifact's package beside it through
    package_program on --device (stubbed: the compile is the fixture's)."""
    from vstnet_tpu_torch.cli import export as cli
    from vstnet_tpu_torch.models import pipeline

    calls = []

    def fake(src, path, device=None, what=None):
        calls.append((src, path, str(device), what))
        return path

    monkeypatch.setattr(pipeline, "PHOTO_CONFIG", SMALL)
    monkeypatch.setattr(native, "package_program", fake)
    written = cli.main(["--what", "stylize", "--height", "16", "--width",
                        "16", "--device", "cpu", "--native", "-o",
                        str(tmp_path)])
    pt2 = str(tmp_path / "stylize_16x16.pt2")
    pkg = str(tmp_path / "stylize_16x16.aoti.pt2")
    assert written == [pt2, pkg]
    assert calls == [(pt2, pkg, "cpu", "stylize")]
