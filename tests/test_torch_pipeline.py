"""The port's cWCT and global stylize path against the JAX package's.

Inputs come from numpy seeds; weights are made by vstnet_tpu's
init_revresnet and carried across with params_from_jax. The JAX fast path
runs its Pallas kernels in interpret mode (patch_interpret_fused); the
port's runs its kernels' plain versions on the CPU.

Tolerances:
  * cWCT statistics, factors and transfers: atol 1e-4 in float32. The
    32x32 covariance sums 1024 products per entry in another order, and
    Lc^{-1} amplifies that roundoff by the factor's condition number.
  * the float32 video program: atol 1e-4 on [0,1] frames (the cWCT's
    roundoff carried through the decoder); its uint8 form within 1 code
    (a value that lies on a .5 boundary may round either way).
  * bf16 fast path vs the JAX float32 standard path: PSNR >= 40 dB, the
    fidelity gate of BASELINE.md.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vstnet_tpu.models.revresnet_fast as jrf
from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models import cwct as jcwct
from vstnet_tpu.models import pipeline as jpipe
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import params_from_jax
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models import pipeline
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.ops.coupling import pixel_shuffle

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(2, 2, 2))
JSMALL = JaxConfig(n_blocks=(2, 2, 2))


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _pair(cfg, jcfg, seed):
    params = jax.jit(lambda k: init_revresnet(k, jcfg))(
        jax.random.PRNGKey(seed))
    net = RevResNet(cfg, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, net


@pytest.fixture(scope="module")
def pair():
    return _pair(SMALL, JSMALL, 0)


@pytest.fixture
def _interpret(monkeypatch):
    from tests.conftest import patch_interpret_fused

    patch_interpret_fused(monkeypatch)


def _latent(rng, b, g, c, h, w):
    """A packed latent with correlated channels, (b, g*c, h, w)."""
    mix = rng.standard_normal((c, c)).astype(np.float32) / np.sqrt(c)
    x = rng.standard_normal((b, g, c, h * w)).astype(np.float32)
    x = np.einsum("dc,bgcn->bgdn", mix, x) + rng.standard_normal(
        (1, 1, c, 1)).astype(np.float32)
    return x.reshape(b, g * c, h, w)


def test_package_never_imports_jax():
    """The port imports neither jax nor vstnet_tpu: with both blocked, the
    whole package imports and runs a small stylization."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['vstnet_tpu'] = None\n"
        "import torch, vstnet_tpu_torch\n"
        "from vstnet_tpu_torch.models import pipeline, cwct, revresnet_fast\n"
        "from vstnet_tpu_torch.ops import _build, coupling_fused\n"
        "from vstnet_tpu_torch.io import checkpoint\n"
        "from vstnet_tpu_torch.models.revresnet import RevResNet\n"
        "cfg = vstnet_tpu_torch.RevResNetConfig(n_blocks=(1, 1, 1))\n"
        "net = RevResNet(cfg, device='cpu').init_weights(\n"
        "    torch.Generator().manual_seed(0))\n"
        "x = torch.rand(1, 16, 16, 3)\n"
        "assert pipeline.stylize(net, x, x).shape == x.shape\n"
        "assert not [m for m in sys.modules if m.startswith('jax')\n"
        "            and sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_robust_cholesky_matches_jax(rng):
    a = rng.standard_normal((4, 32, 48)).astype(np.float32)
    covs = np.einsum("bcn,bdn->bcd", a, a) / 47
    covs[1] = np.outer(a[1, :, 0], a[1, :, 0])   # rank 1: needs jitter
    covs[2, 0, 0] = np.nan                       # no factor exists
    got = cwct.robust_cholesky(torch.from_numpy(covs)).numpy()
    want = np.asarray(jax.vmap(jcwct.robust_cholesky)(jnp.asarray(covs)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]).all() and np.isfinite(got[[0, 1, 3]]).all()
    ok = [0, 1, 3]
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-4)
    with pytest.raises(FloatingPointError):
        cwct.host_check_finite(torch.from_numpy(got))
    cwct.host_check_finite(torch.from_numpy(got[ok]))


def test_packed_cwct_matches_jax(rng):
    c = 32
    zp = _latent(rng, 2, 16, c, 8, 8)
    zs = _latent(rng, 1, 16, c, 8, 8)
    ls_j, mu_j = jcwct.style_factors_packed(jnp.asarray(zs), c)
    ls, mu = cwct.style_factors_packed(torch.from_numpy(zs), c)
    np.testing.assert_allclose(ls.numpy(), np.asarray(ls_j), atol=1e-4)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-4)

    got = cwct.transfer_with_factors_packed(torch.from_numpy(zp), ls, mu, c)
    want = jcwct.transfer_with_factors_packed(jnp.asarray(zp), ls_j, mu_j, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for a in (0.0, 0.35, 1.0):
        got = cwct.interp_with_factors_packed(torch.from_numpy(zp), ls, mu,
                                              a, c)
        want = jcwct.interp_with_factors_packed(
            jnp.asarray(zp), ls_j, mu_j, jnp.float32(a), c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_unpacked_transfer_matches_jax(rng):
    c = 32
    zc = _latent(rng, 2, 1, c, 8, 12).transpose(0, 2, 3, 1).copy()
    zs = _latent(rng, 2, 1, c, 8, 12).transpose(0, 2, 3, 1).copy()
    got = cwct.transfer(torch.from_numpy(zc), torch.from_numpy(zs))
    want = jcwct.transfer(jnp.asarray(zc), jnp.asarray(zs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_packed_equals_unpacked(rng, pair):
    """The global cWCT commutes with the latent's pixel shuffles: the
    packed functions on the packed latent equal the NHWC functions on
    the shuffled latent."""
    _, net = pair
    fast = rf.pack_revresnet(net)
    c = SMALL.latent_channels
    x = torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(size=(1, 32, 32, 3)).astype(np.float32))
    zp = rf.encode_fast(fast, x, SMALL, packed_latent=True)
    zsp = rf.encode_fast(fast, s, SMALL, packed_latent=True)
    z = rf.encode_fast(fast, x, SMALL)
    zs = rf.encode_fast(fast, s, SMALL)
    ls_p, mu_p = cwct.style_factors_packed(zsp, c)
    ls, mu = cwct.style_factors(zs)
    np.testing.assert_allclose(ls_p.numpy(), ls.numpy(), atol=1e-5)
    np.testing.assert_allclose(mu_p.numpy(), mu.numpy(), atol=1e-5)
    yp = cwct.transfer_with_factors_packed(zp, ls_p, mu_p, c)
    for _ in range(SMALL.sp_steps):
        yp = pixel_shuffle(yp)
    y = cwct.transfer_with_factors(z, ls, mu)
    np.testing.assert_allclose(yp.permute(0, 2, 3, 1).numpy(), y.numpy(),
                               atol=1e-4)
    yi = cwct.interp_with_factors(z, ls, mu, 0.0)
    np.testing.assert_allclose(yi.numpy(), y.numpy(), atol=1e-5)


def test_video_program_matches_jax(rng, pair, _interpret):
    params, net = pair
    jfast = jrf.pack_revresnet(params, JSMALL)
    fast = rf.pack_revresnet(net)
    c = SMALL.latent_channels
    frames = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    style = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    ls_j, mu_j = jcwct.style_factors_packed(
        jrf.encode_fast(jfast, jnp.asarray(style), JSMALL,
                        packed_latent=True), c)
    ls, mu = cwct.style_factors_packed(
        rf.encode_fast(fast, torch.from_numpy(style), SMALL,
                       packed_latent=True), c)
    np.testing.assert_allclose(ls.numpy(), np.asarray(ls_j), atol=1e-4)
    fr_t, fr_j = torch.from_numpy(frames), jnp.asarray(frames)

    want = jpipe.make_fused_video_fn(JSMALL)(jfast, fr_j, ls_j, mu_j)
    got = pipeline.make_fused_video_fn(SMALL)(fast, fr_t, ls, mu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    want = jpipe.make_fused_video_fn(JSMALL, out_u8=True)(jfast, fr_j, ls_j,
                                                         mu_j)
    got = pipeline.make_fused_video_fn(SMALL, out_u8=True)(fast, fr_t, ls,
                                                           mu)
    assert got.dtype == torch.uint8 and got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy().astype(np.int32),
                               np.asarray(want).astype(np.int32), atol=1)

    want = jpipe.make_fused_video_fn(JSMALL, interp=True)(
        jfast, fr_j, ls_j, mu_j, jnp.float32(0.5))
    got = pipeline.make_fused_video_fn(SMALL, interp=True)(fast, fr_t, ls,
                                                           mu, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("hidden,sp", [(16, 2), (64, 1)],
                         ids=["photo", "artistic"])
def test_bf16_fast_stylize_vs_jax_f32(rng, hidden, sp):
    cfg = RevResNetConfig(n_blocks=(2, 2, 2), hidden_dim=hidden, sp_steps=sp)
    jcfg = JaxConfig(n_blocks=(2, 2, 2), hidden_dim=hidden, sp_steps=sp)
    params, net = _pair(cfg, jcfg, 1)
    c = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    s = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jpipe.stylize(params, jnp.asarray(c), jnp.asarray(s),
                                   jcfg))
    fast = rf.pack_revresnet(net, torch.bfloat16)
    got = pipeline.stylize_fast(fast, torch.from_numpy(c),
                                torch.from_numpy(s), cfg)
    assert got.dtype == torch.float32 and got.shape == c.shape
    assert _psnr(got.numpy(), ref) >= 40.0
    # the port's own float32 standard path is the JAX one to roundoff
    std = pipeline.stylize(net, torch.from_numpy(c), torch.from_numpy(s))
    np.testing.assert_allclose(std.numpy(), ref, atol=1e-4)


def test_style_model_api(rng, tmp_path):
    """StyleModel and the package factories at full PHOTO depth, tiny
    frames: every route returns finite frames of the input's shape."""
    import vstnet_tpu_torch as vt

    model = vt.get_photo_style_model(device="cpu", seed=3)
    assert model.cfg.block_plan() == vt.PHOTO_CONFIG.block_plan()
    c = torch.from_numpy(rng.uniform(size=(1, 16, 16, 3)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(size=(1, 16, 16, 3)).astype(np.float32))
    outs = [model.stylize(c, s), model.stylize(c, s, fast=True),
            model.stylize(c, s, alpha_c=0.5),
            model.stylize(c, s, alpha_c=0.5, fast=True)]
    for out in outs:
        assert out.shape == c.shape and out.dtype == torch.float32
        cwct.host_check_finite(out)
    assert _psnr(outs[1].numpy(), outs[0].numpy()) >= 40.0
    assert model.fast_params is model.fast_params  # packed once

    path = tmp_path / "photo.pt"
    torch.save({"state_dict": model.net.state_dict()}, path)
    loaded = vt.get_photo_style_model(str(path), device="cpu")
    assert torch.equal(loaded.stylize(c, s), outs[0])

    enc, dev = vt.get_vstnet_encoder_model(str(path), device="cpu")
    dec, _ = vt.get_vstnet_decoder_model(str(path), device="cpu")
    assert dev == torch.device("cpu")
    z = enc(c)
    assert z.shape == (1, 16, 16, vt.PHOTO_CONFIG.latent_channels)
    assert float((dec(z) - c).abs().max()) < 1e-4
    art = vt.get_artist_style_model(seed=1, device="cpu")
    assert art.cfg.latent_channels == 128
    assert art.stylize(c, s, fast=True).shape == c.shape
