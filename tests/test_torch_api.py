"""The port's package API against the JAX package's: multi-style
interpolation, the Lab colour conversions, the photo pipeline, the
tolerant checkpoint loader, the float64 Cholesky retry and the package
entry points.

Inputs come from numpy seeds; RevResNet weights are made by vstnet_tpu's
init_revresnet and carried across with params_from_jax. The port runs on
the CPU, where its kernels' wrappers run their plain versions.

Tolerances:
  * cwct.interpolation, stylize_interp, photo_forward, the float64 retry:
    1e-4 in float32 (the 32x32 covariances sum in another order, and
    Lc^{-1} amplifies that roundoff by the factor's condition number; on
    the latents below the measured error is ~4e-6).
  * rgb2lab / lab2rgb: 1e-5 (the same float32 formulas, a 3x3 product in
    another order).
  * nearest resize: exact.
  * photo_pipeline(fast=True) against the JAX float32 photo_pipeline:
    PSNR >= 40 dB, the fidelity gate of BASELINE.md.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.io import checkpoint as jckpt
from vstnet_tpu.models import cwct as jcwct
from vstnet_tpu.models import pipeline as jpipe
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu.ops import color as jcolor
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io import checkpoint as ckpt
from vstnet_tpu_torch.io.checkpoint import params_from_jax
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models import pipeline
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.ops import color
from vstnet_tpu_torch.ops.resize import resize_nearest

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(1, 1, 1))
JSMALL = JaxConfig(n_blocks=(1, 1, 1))


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.fixture(scope="module")
def pair():
    params = jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(0))
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, net


def _smooth(rng, n, h, w):
    small = rng.uniform(size=(n, h // 8, w // 8, 3)).astype(np.float32)
    x = np.asarray(jax.image.resize(jnp.asarray(small), (n, h, w, 3),
                                    "linear"))
    x = x + 0.05 * rng.uniform(size=x.shape).astype(np.float32)
    return np.clip(x, 0, 1).astype(np.float32)


def _latent(rng, b, h, w, c=32):
    """An NHWC latent with correlated channels and a well-conditioned
    covariance (identity plus a random mix): a random mix alone can leave
    the covariance's condition number near 1e5, where Lc^{-1} lifts the
    two packages' float32 roundoff to ~1e-2."""
    mix = (np.eye(c, dtype=np.float32) + 0.5 * rng.standard_normal(
        (c, c)).astype(np.float32) / np.sqrt(c))
    x = rng.standard_normal((b, h * w, c)).astype(np.float32) @ mix.T
    x = x + rng.standard_normal((1, 1, c)).astype(np.float32)
    return x.reshape(b, h, w, c).astype(np.float32)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_count,alpha_c,style_batch",
                         [(1, 0.0, 2), (1, 0.4, 1), (2, 0.0, 1),
                          (2, 0.3, 2)],
                         ids=["S1", "S1-alpha_c", "S2", "S2-alpha_c"])
def test_interpolation_matches_jax(rng, s_count, alpha_c, style_batch):
    zc = _latent(rng, 2, 8, 12)
    zs = np.stack([_latent(rng, style_batch, 8, 8)
                   for _ in range(s_count)])
    a_s = rng.uniform(0.2, 1.0, size=s_count).astype(np.float32)
    a_s /= a_s.sum()
    want = jcwct.interpolation(jnp.asarray(zc), jnp.asarray(zs),
                               jnp.asarray(a_s), alpha_c=alpha_c)
    got = cwct.interpolation(torch.from_numpy(zc), torch.from_numpy(zs),
                             a_s.tolist(), alpha_c=alpha_c)
    assert got.shape == zc.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # a list of styles is the same call
    lst = cwct.interpolation(torch.from_numpy(zc),
                             [torch.from_numpy(z) for z in zs],
                             a_s.tolist(), alpha_c=alpha_c)
    assert torch.equal(lst, got)


@pytest.mark.parametrize("s_count,alpha_c", [(1, 0.0), (2, 0.25)],
                         ids=["S1", "S2-alpha_c"])
def test_stylize_interp_matches_jax(rng, pair, s_count, alpha_c):
    params, net = pair
    c = _smooth(rng, 1, 32, 32)
    styles = np.stack([_smooth(rng, 1, 32, 32) for _ in range(s_count)])
    a_s = [1.0] if s_count == 1 else [0.3, 0.7]
    want = jpipe.stylize_interp(params, jnp.asarray(c), jnp.asarray(styles),
                                jnp.asarray(a_s), JSMALL, alpha_c=alpha_c)
    got = pipeline.stylize_interp(net, torch.from_numpy(c),
                                  torch.from_numpy(styles), a_s,
                                  alpha_c=alpha_c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_style_model_interp_routes(rng, pair):
    """StyleModel.stylize's interpolated route is stylize_interp at S=1;
    stylize_multi in float32 is stylize_interp, and its fused route (the
    mixed packed factors) stays within 40 dB of it."""
    params, net = pair
    model = pipeline.StyleModel(cfg=SMALL, net=net)
    c = torch.from_numpy(_smooth(rng, 1, 32, 32))
    styles = torch.from_numpy(_smooth(rng, 2, 32, 32))
    one = model.stylize(c, styles[:1], alpha_c=0.5)
    assert torch.equal(one, pipeline.stylize_interp(net, c, styles[:1][None],
                                                    [1.0], alpha_c=0.5))
    multi = model.stylize_multi(c, styles, [0.3, 0.7], alpha_c=0.2)
    want = jpipe.stylize_interp(params, jnp.asarray(c.numpy()),
                                jnp.asarray(styles.numpy())[:, None],
                                jnp.asarray([0.3, 0.7]), JSMALL,
                                alpha_c=0.2)
    np.testing.assert_allclose(multi.numpy(), np.asarray(want), atol=1e-4)
    fast = model.stylize_multi(c, styles, [0.3, 0.7], alpha_c=0.2,
                               fast=True)
    assert fast.dtype == torch.float32 and fast.shape == c.shape
    assert _psnr(fast.numpy(), np.asarray(want)) >= 40.0


# ---------------------------------------------------------------------------
# The float64 retry of the Cholesky
# ---------------------------------------------------------------------------

def test_use_double_rescues_a_float32_failure():
    """Hilbert(10) is positive definite, but its float32 Cholesky fails
    (a pivot goes negative from rounding); attempts=1 leaves no jitter, so
    the float64 retry itself is tested."""
    n = 10
    hil = np.array([[1.0 / (i + j + 1) for j in range(n)]
                    for i in range(n)], np.float32)
    l32 = cwct.robust_cholesky(torch.from_numpy(hil), attempts=1)
    assert torch.isnan(l32).all()
    got = cwct.robust_cholesky(torch.from_numpy(hil), attempts=1,
                               use_double=True)
    want = np.asarray(jcwct.robust_cholesky(jnp.asarray(hil), attempts=1,
                                            use_double=True))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # a healthy covariance never reaches the retry
    a = np.random.default_rng(1).standard_normal((6, 40)).astype(np.float32)
    cov = torch.from_numpy(a @ a.T / 39)
    assert torch.equal(cwct.robust_cholesky(cov),
                       cwct.robust_cholesky(cov, use_double=True))
    # no factor at all: still NaN
    bad = cov.clone()
    bad[0, 0] = float("nan")
    assert torch.isnan(cwct.robust_cholesky(bad, use_double=True)).all()


def test_transfer_use_double_matches_jax(rng):
    zc = _latent(rng, 1, 8, 8, 4)
    zs = _latent(rng, 1, 8, 8, 4)
    want = jcwct.transfer(jnp.asarray(zc), jnp.asarray(zs), use_double=True)
    got = cwct.transfer(torch.from_numpy(zc), torch.from_numpy(zs),
                        use_double=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert torch.equal(got, cwct.transfer(torch.from_numpy(zc),
                                          torch.from_numpy(zs)))


@pytest.mark.parametrize("shards", [1, 2], ids=["whole", "rows"])
def test_card_statistics_are_summed_in_float64(rng, monkeypatch, shards):
    """cwct._accumulate: a float32 latent's statistics are summed in
    float64 on a CUDA card, whose float32 Gram lies ~20x further from
    float64 than the CPU's, and in float32 on the CPU. With the card's
    rule applied here, _stats and row_stats of a float32 latent equal the
    float64 statistics of the same values rounded once, bit for bit, and
    JAX's _feat_stats within float32's rounding; the CPU's own rule
    leaves them float32 sums."""
    from types import SimpleNamespace

    card = SimpleNamespace(dtype=torch.float32, device=torch.device("cuda"))
    assert cwct._accumulate(card) == torch.float64
    assert cwct._accumulate(torch.zeros(1)) == torch.float32
    assert cwct._accumulate(torch.zeros(1, dtype=torch.float64)) == \
        torch.float64
    z = torch.from_numpy(_latent(rng, 2, 16, 16))

    def stats(x):
        if shards == 1:
            return cwct._stats(cwct._nhwc_as_gcn(x))
        return cwct.row_stats(list(x.chunk(shards, dim=1)))

    plain = stats(z)
    monkeypatch.setattr(cwct, "_accumulate", lambda x: (
        torch.float64 if x.dtype == torch.float32 else x.dtype))
    got = stats(z)
    for g, w, p in zip(got, stats(z.double()), plain):
        assert g.dtype == torch.float32 and torch.equal(g, w.float())
        assert not torch.equal(g, p)
    mean, cov = jax.vmap(jcwct._feat_stats)(jnp.asarray(z.numpy()).reshape(
        2, -1, 32))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(mean), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(cov), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Colour, resize, the photo pipeline
# ---------------------------------------------------------------------------

def test_lab_conversions_match_jax(rng):
    rgb = rng.uniform(size=(2, 9, 11, 3)).astype(np.float32)
    rgb[0, 0, :3] = [[0, 0, 0], [1, 1, 1], [0.04045, 0.003, 0.5]]
    lab = color.rgb2lab(torch.from_numpy(rgb))
    want = np.asarray(jcolor.rgb2lab(jnp.asarray(rgb)))
    np.testing.assert_allclose(lab.numpy(), want, atol=1e-5)
    back = color.lab2rgb(lab)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jcolor.lab2rgb(jnp.asarray(want))),
                               atol=1e-5)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-4)


@pytest.mark.parametrize("hw_in,hw_out", [((24, 20), (50, 37)),
                                          ((50, 37), (24, 20))],
                         ids=["up", "down"])
def test_resize_nearest_matches_jax_image_resize(rng, hw_in, hw_out):
    """The image CLI's mask resample: the port's resize_nearest against
    jax.image.resize(..., "nearest") at non-integer ratios."""
    m = rng.integers(0, 150, size=(1, *hw_in)).astype(np.int32)
    want = jax.image.resize(jnp.asarray(m), (1, *hw_out), method="nearest")
    got = resize_nearest(torch.from_numpy(m), *hw_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_masks", [False, True],
                         ids=["global", "masked"])
def test_photo_forward_matches_jax(rng, pair, use_masks):
    params, net = pair
    c = _smooth(rng, 1, 32, 32)
    s = _smooth(rng, 1, 32, 32) if use_masks else _smooth(rng, 1, 24, 40)
    cm = np.zeros((1, 32, 32), np.int32)
    cm[:, :, 16:] = 3
    sm = np.zeros(s.shape[:3], np.int32)
    sm[:, 12:] = 3
    want = jpipe.photo_forward(params, jnp.asarray(c), jnp.asarray(s),
                               jnp.asarray(cm), jnp.asarray(sm), JSMALL,
                               max_labels=8, use_masks=use_masks)
    got = pipeline.photo_forward(net, torch.from_numpy(c),
                                 torch.from_numpy(s), torch.from_numpy(cm),
                                 torch.from_numpy(sm), max_labels=8,
                                 use_masks=use_masks)
    assert got.shape == c.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_photo_pipeline_matches_jax(rng, pair):
    """Unpadded 30x26 images: pad, stylize, resize back, Lab blend; the
    float32 route within 1e-4 of the JAX one and the fused route within
    40 dB of it."""
    params, net = pair
    c = _smooth(rng, 1, 32, 32)[:, :30, :26]
    s = _smooth(rng, 1, 32, 32)[:, :30, :26]
    jmodel = jpipe.StyleModel(cfg=JSMALL, params=params)
    want = np.asarray(jmodel.photo_pipeline(jnp.asarray(c), jnp.asarray(s)))
    model = pipeline.StyleModel(cfg=SMALL, net=net)
    got = model.photo_pipeline(torch.from_numpy(c), torch.from_numpy(s))
    assert got.shape == c.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    fast = model.photo_pipeline(torch.from_numpy(c), torch.from_numpy(s),
                                fast=True)
    assert _psnr(fast.numpy(), want) >= 40.0


# ---------------------------------------------------------------------------
# Checkpoints and the package entry points
# ---------------------------------------------------------------------------

def test_tolerant_state_dict_matches_jax(tmp_path, pair):
    """A foreign checkpoint with one missing, one misshapen and one extra
    tensor: both packages warn about the same keys, the present tensors
    load as they are, the others keep seeded initial values."""
    params, _ = pair
    sd = {k: torch.from_numpy(np.array(v, copy=True))
          for k, v in jckpt.revresnet_to_torch(params).items()}
    del sd["stack.0.conv.1.weight"]
    sd["stack.1.conv.4.bias"] = torch.zeros(999)
    sd["optimizer.step_count"] = torch.zeros(3)
    path = str(tmp_path / "foreign.pt")
    torch.save({"state_dict": sd}, path)

    def warned(fn):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = fn()
        return out, sorted(str(w.message).replace(path, "")
                           for w in rec if path in str(w.message))

    with pytest.raises(RuntimeError):
        RevResNet(SMALL, device="cpu").load_state_dict(
            ckpt.load_revresnet(path))
    got, msgs = warned(lambda: ckpt.load_revresnet(path, strict=False,
                                                   cfg=SMALL, seed=7))
    _, jmsgs = warned(lambda: jckpt.load_revresnet(path, strict=False,
                                                   cfg=JSMALL, seed=7))
    assert len(msgs) == 3 and msgs == jmsgs
    for key in ("stack.2.conv.1.weight", "stack.1.conv.4.weight"):
        assert torch.equal(got[key], sd[key])
    seeded = RevResNet(SMALL, device="cpu").init_weights(
        torch.Generator().manual_seed(7)).state_dict()
    for key in ("stack.0.conv.1.weight", "stack.1.conv.4.bias"):
        assert torch.equal(got[key], seeded[key])
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(got)
    with pytest.raises(ValueError):
        ckpt.load_revresnet(path, strict=False)


def test_package_entry_points(rng, tmp_path, monkeypatch):
    """get_segment_model's (segment_fn, device) pair and
    image_photo_predict's triptychs, against a glob and a list, on the
    CPU; both raise without a device where there is no card."""
    from PIL import Image

    import vstnet_tpu_torch as vt
    import vstnet_tpu_torch.models.segformer as tsf

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            vt.get_segment_model()
        with pytest.raises(RuntimeError):
            vt.image_photo_predict([], "x.png", str(tmp_path))
    orig = tsf.Segmenter.load

    def tiny(checkpoint=None, **kw):
        return orig(checkpoint, depths=(1, 1, 1, 1), **kw)

    monkeypatch.setattr(tsf.Segmenter, "load", tiny)
    seg_fn, dev = vt.get_segment_model(device="cpu")
    assert dev == torch.device("cpu")
    mask = seg_fn(torch.from_numpy(_smooth(rng, 1, 32, 32)))
    assert mask.shape == (1, 32, 32) and mask.dtype == torch.int32

    monkeypatch.setattr(pipeline, "PHOTO_CONFIG", SMALL)
    for i in range(2):
        Image.fromarray((_smooth(rng, 1, 32, 32)[0] * 255).astype(np.uint8)
                        ).save(tmp_path / f"c{i}.png")
    Image.fromarray((_smooth(rng, 1, 32, 32)[0] * 255).astype(np.uint8)
                    ).save(tmp_path / "s.png")
    out = vt.image_photo_predict(str(tmp_path / "c*.png"),
                                 str(tmp_path / "s.png"),
                                 str(tmp_path / "out"), device="cpu")
    assert [p.rsplit("/", 1)[-1] for p in out] == ["c0.png", "c1.png"]
    assert Image.open(out[0]).size == (96, 32)
    out = vt.image_photo_predict([str(tmp_path / "c1.png")],
                                 str(tmp_path / "s.png"),
                                 str(tmp_path / "out2"), device="cpu")
    assert len(out) == 1
    with pytest.raises(FileNotFoundError):
        vt.image_photo_predict(str(tmp_path / "none*.png"),
                               str(tmp_path / "s.png"), str(tmp_path),
                               device="cpu")
