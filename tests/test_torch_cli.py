"""The port's video and image CLIs against the JAX package's CLIs.

Both CLIs run on the same checkpoint (a tiny RevResNet, 1 block a stage,
made by vstnet_tpu's init_revresnet and written once with
save_torch_checkpoint), the same segmenter weights (SegFormer at depths
1/1/1/1: vstnet_tpu's seeded init, carried across with
segformer_params_from_jax, patched into both packages' Segmenter.load) and
the same inputs: a 6-frame 32x32 clip as a frame directory, 32x32 images.
The frames each CLI hands its video writers are recorded through patched
writers, so JPEG loss does not enter the comparison. The port runs with
--device cpu, where its kernels' wrappers run their plain versions; on the
CPU the JAX video CLI takes its float32 standard path for either
--precision, so it is run in f32 and the reference of both port routes.

Tolerances:
  * port f32 against JAX f32: uint8 frames within 1 level (float32
    roundoff moves a value that lies near a .5 boundary to either side).
  * port bf16 (the fused route) against JAX f32: PSNR >= 40 dB, the
    fidelity gate of BASELINE.md.
  * auto-seg label frames: equal on >= 99 % of the pixels (a near-tie in
    the logits may break either way).

The port's segmenter runs in float32 here on every route, bf16 and --fast
included. The random tiny SegFormer's best class leads its runner-up by
less than bf16's rounding at a few per cent of the pixels, so a bf16
segmenter moves whole regions and the frames with them; trained weights do
not tie so. The bf16 segmenter is held to the float32 one where its masks
are decided (tests/test_torch_masked.py, chip_smoke.py); here the bf16
routes' stylize path is what is compared.
"""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.io.checkpoint import save_torch_checkpoint
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import segformer_params_from_jax

torch.set_num_threads(2)

JSMALL = JaxConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
SMALL = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
TINY = (1, 1, 1, 1)
N_FRAMES = 6


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) / 255.0
                         - np.asarray(b, np.float64) / 255.0) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _smooth(rng, h, w):
    small = rng.uniform(size=(1, h // 8, w // 8, 3)).astype(np.float32)
    x = np.asarray(jax.image.resize(small, (1, h, w, 3), "linear"))[0]
    x = x + 0.05 * rng.uniform(size=x.shape)
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


class _Recorder:
    """A video writer that keeps the frames it is given."""

    def __init__(self, store, path, fps=25.0):
        self.frames = store.setdefault(os.path.basename(path), [])

    def write(self, frame):
        self.frames.append(np.array(frame))

    def close(self):
        return None


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The shared inputs: checkpoint, segmenter weights, clip, images."""
    from PIL import Image

    import vstnet_tpu.models.segformer as jsf

    root = tmp_path_factory.mktemp("cli")
    params = jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(0))
    ckpt = str(root / "photo_small.pt")
    save_torch_checkpoint(params, ckpt)
    seg_params = jax.jit(lambda k: jsf.init_segformer(k, TINY))(
        jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    clip = root / "clip"
    clip.mkdir()
    for i in range(N_FRAMES):
        Image.fromarray(_smooth(rng, 32, 32)).save(clip / f"{i:03d}.png")
    for name in ("content", "style", "style2"):
        Image.fromarray(_smooth(rng, 32, 32)).save(root / f"{name}.png")
    return {"root": root, "ckpt": ckpt, "seg_params": seg_params,
            "seg_sd": segformer_params_from_jax(
                jax.tree.map(np.asarray, seg_params)),
            "clip": str(clip)}


def _patched(mp, world, store):
    """Both packages on the tiny config, the tiny segmenter and recording
    writers."""
    import vstnet_tpu.io.video as jvideo
    import vstnet_tpu.models.pipeline as jpipe
    import vstnet_tpu.models.remapping as jremap
    import vstnet_tpu.models.segformer as jsf
    import vstnet_tpu_torch.io.video as tvideo
    import vstnet_tpu_torch.models.pipeline as tpipe
    import vstnet_tpu_torch.models.remapping as tremap
    import vstnet_tpu_torch.models.segformer as tsf

    mp.setattr(jpipe, "PHOTO_CONFIG", JSMALL)
    mp.setattr(tpipe, "PHOTO_CONFIG", SMALL)

    def jax_seg(checkpoint=None, min_ratio=0.01, label_mapping=None,
                half=False, **_):
        return jsf.Segmenter(params=world["seg_params"], min_ratio=min_ratio,
                             label_mapping=jremap.load_label_mapping(
                                 label_mapping), half=half)

    def torch_seg(checkpoint=None, min_ratio=0.01, label_mapping=None,
                  half=False, device=None, **_):
        net = tsf.SegFormer(TINY, device=device)
        net.load_state_dict(world["seg_sd"])
        return tsf.Segmenter(net=net, min_ratio=min_ratio,
                             label_mapping=tremap.load_label_mapping(
                                 label_mapping, device=device))

    mp.setattr(jsf.Segmenter, "load", jax_seg)
    mp.setattr(tsf.Segmenter, "load", torch_seg)
    mp.setattr(tpipe, "segment_mask",
               lambda net, x, half=False: tsf.segment_mask(net, x))
    for mod in (jvideo, tvideo):
        mp.setattr(mod, "make_video_writer",
                   lambda path, fps=25.0: _Recorder(store, path, fps))
        mp.setattr(mod, "AviWriter",
                   lambda path, fps=25.0: _Recorder(store, path, fps))


@pytest.fixture(scope="module")
def run_cli(world):
    """run_cli(package, cli, *flags) -> what the run wrote: video writers'
    frames by file name, or the saved PNG (and segmentation PNGs) as
    arrays. Each distinct run happens once per module."""
    from PIL import Image

    cache = {}

    def run(package, cli, *flags):
        key = (package, cli) + flags
        if key in cache:
            return cache[key]
        out_dir = world["root"] / f"out{len(cache)}"
        store = {}
        with pytest.MonkeyPatch.context() as mp:
            _patched(mp, world, store)
            mod = __import__(f"{package}.cli.{cli}", fromlist=["main"])
            printed = io.StringIO()
            argv = ["--ckpoint", world["ckpt"], "--out_dir", str(out_dir),
                    "--max_size", "32", *flags]
            if package == "vstnet_tpu_torch":
                argv += ["--device", "cpu"]
            if cli == "video_transfer":
                mod.main(["--video", world["clip"], "--style",
                          str(world["root"] / "style.png"), *argv])
            else:
                with contextlib.redirect_stdout(printed):
                    path = mod.main(["--content",
                                     str(world["root"] / "content.png"),
                                     *argv])
                store["stdout"] = printed.getvalue()
                store["image"] = np.asarray(Image.open(path))
                seg = out_dir / "segmentation" / "content_seg_label.png"
                if seg.exists():
                    store["label"] = np.asarray(Image.open(seg))
        cache[key] = store
        return store

    return run


VIDEO_MODES = {"global": (), "alpha_c": ("--alpha_c", "0.6"),
               "auto_seg": ("--auto_seg",)}


def _video(store):
    (name,) = [k for k in store if "_style." in k]
    return np.stack(store[name])


@pytest.mark.parametrize("mode", list(VIDEO_MODES))
def test_video_cli_f32_matches_jax(run_cli, mode):
    flags = VIDEO_MODES[mode]
    want = run_cli("vstnet_tpu", "video_transfer", "--precision", "f32",
                   "--batch", "1", *flags)
    got = run_cli("vstnet_tpu_torch", "video_transfer", "--precision", "f32",
                  "--batch", "4", *flags)
    assert set(got) == set(want)
    a, b = _video(got), _video(want)
    assert a.shape == b.shape == (N_FRAMES, 32, 32, 3)
    assert a.dtype == np.uint8
    np.testing.assert_allclose(a.astype(np.int32), b.astype(np.int32),
                               atol=1)


@pytest.mark.parametrize("mode", list(VIDEO_MODES))
def test_video_cli_bf16_vs_jax_f32(run_cli, mode):
    flags = VIDEO_MODES[mode]
    want = _video(run_cli("vstnet_tpu", "video_transfer", "--precision",
                          "f32", "--batch", "1", *flags))
    got = _video(run_cli("vstnet_tpu_torch", "video_transfer",
                         "--precision", "bf16", "--batch", "4", *flags))
    assert got.shape == want.shape
    assert _psnr(got, want) >= 40.0


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_video_cli_seg_videos_match_jax(run_cli, precision):
    want = run_cli("vstnet_tpu", "video_transfer", "--precision", "f32",
                   "--batch", "1", "--auto_seg")
    got = run_cli("vstnet_tpu_torch", "video_transfer", "--precision",
                  precision, "--batch", "4", "--auto_seg")
    for name in ("content_seg_label.avi", "content_seg_color.avi"):
        a, b = np.stack(got[name]), np.stack(want[name])
        assert a.shape == b.shape == (N_FRAMES, 32, 32, 3)
        assert (a == b).all(axis=-1).mean() >= 0.99


IMAGE_MODES = {"global": (), "alpha_c": ("--alpha_c", "0.3"),
               "auto_seg": ("--auto_seg",),
               "styles": ("--styles", "STYLE", "STYLE2", "--alpha_s", "0.3",
                          "0.7")}


def _image_flags(world, mode):
    flags = [str(world["root"] / "style.png") if f == "STYLE"
             else str(world["root"] / "style2.png") if f == "STYLE2" else f
             for f in IMAGE_MODES[mode]]
    if mode != "styles":
        flags += ["--style", str(world["root"] / "style.png")]
    return tuple(flags)


@pytest.mark.parametrize("mode", list(IMAGE_MODES))
def test_image_cli_matches_jax(world, run_cli, mode):
    flags = _image_flags(world, mode)
    want = run_cli("vstnet_tpu", "image_transfer", *flags)
    got = run_cli("vstnet_tpu_torch", "image_transfer", *flags)
    fast = run_cli("vstnet_tpu_torch", "image_transfer", "--fast", *flags)
    assert got["image"].shape == want["image"].shape == (32, 32, 3)
    np.testing.assert_allclose(got["image"].astype(np.int32),
                               want["image"].astype(np.int32), atol=1)
    assert _psnr(fast["image"], want["image"]) >= 40.0
    if mode == "auto_seg":
        assert (got["label"] == want["label"]).mean() >= 0.99


# the tiled ultra-resolution branch on the 32x32 content: 3x3 tiles of 16
# px, three batches of TILE_BATCH = 4 (the last padded)
ULTRA = ("--ultra_threshold", "16", "--tile", "16", "--overlap", "4")


@pytest.mark.parametrize("mode", ["global", "alpha_c", "auto_seg",
                                  "styles"])
def test_image_cli_ultra_matches_jax(world, run_cli, mode):
    """Above --ultra_threshold both CLIs tile (models/ultra.py): the port's
    float32 output within 1 level of the JAX CLI's, --fast >= 40 dB."""
    flags = _image_flags(world, mode) + ULTRA
    want = run_cli("vstnet_tpu", "image_transfer", *flags)
    got = run_cli("vstnet_tpu_torch", "image_transfer", *flags)
    fast = run_cli("vstnet_tpu_torch", "image_transfer", "--fast", *flags)
    line = "ultra-res: tiling 32x32 (tile=16, overlap=4"
    assert line in want["stdout"] and line in got["stdout"]
    assert line + ", fused bf16)" in fast["stdout"]
    assert got["image"].shape == want["image"].shape == (32, 32, 3)
    np.testing.assert_allclose(got["image"].astype(np.int32),
                               want["image"].astype(np.int32), atol=1)
    assert _psnr(fast["image"], want["image"]) >= 40.0


def test_image_cli_output_name(world):
    """<content>_<style+style...>.png in --out_dir, as the JAX CLI names
    it."""
    from vstnet_tpu_torch.cli.image_transfer import main

    with pytest.MonkeyPatch.context() as mp:
        _patched(mp, world, {})
        out = main(["--ckpoint", world["ckpt"], "--content",
                    str(world["root"] / "content.png"), *_image_flags(
                        world, "styles"), "--out_dir",
                    str(world["root"] / "named"), "--max_size", "32",
                    "--device", "cpu"])
    assert os.path.basename(out) == "content_style+style2.png"


def test_image_cli_refusals(world, tmp_path):
    """With bad --styles/--alpha_s/--alpha_c flags, and without a device
    where there is no card, the image CLI exits non-zero and writes
    nothing."""
    from vstnet_tpu_torch.cli.image_transfer import main

    base = ["--content", str(world["root"] / "content.png"), "--style",
            str(world["root"] / "style.png"), "--out_dir", str(tmp_path),
            "--max_size", "32"]
    bad = [["--styles", "a.png", "b.png", "--alpha_s", "1", "--device",
            "cpu"],
           ["--alpha_s", "1", "--device", "cpu"],
           ["--styles", "a.png", "b.png", "--auto_seg", "--device", "cpu"],
           ["--alpha_c", "1.5", "--device", "cpu"]]
    if not torch.cuda.is_available():
        bad.append([])
    for flags in bad:
        with pytest.raises(SystemExit) as exc:
            main(base + flags)
        assert exc.value.code not in (0, None), flags
    assert not any(p.suffix == ".png" for p in tmp_path.rglob("*"))


def test_video_cli_needs_a_device(world, tmp_path):
    """Without --device and with no card, the video CLI exits with an
    error that names the flag."""
    from vstnet_tpu_torch.cli.video_transfer import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(SystemExit) as exc:
        main(["--video", world["clip"], "--style",
              str(world["root"] / "style.png"), "--out_dir", str(tmp_path)])
    assert "--device cpu" in str(exc.value.code)
