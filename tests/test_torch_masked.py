"""The port's label remapping, regional cWCT and masked (auto-seg) video
program against the JAX package's.

Inputs come from numpy seeds; RevResNet weights are made by vstnet_tpu's
init_revresnet and carried across with params_from_jax, SegFormer weights
with segformer_params_from_jax. The JAX fast path runs its Pallas kernels
in interpret mode (patch_interpret_fused); the port's runs its kernels'
plain versions on the CPU. At these frame sizes (half-res widths 32 and
16) both packages take the half-res transition entry (K3), so the program
test is also K3's test on a whole path.

Tolerances:
  * remapping: integer-equal (counts and table lookups are exact).
  * regional cWCT moments, statistics and transfers: atol 1e-4 in float32
    (the per-label grams sum up to a few hundred products per entry in
    another order, and Lc^{-1} amplifies that roundoff, so the test
    latents are kept well conditioned: see _latent); moments of a bf16
    latent equal the float32 moments of the same values to 1e-3 relative
    of the largest entry (exact products, float32 sums in another order).
  * the float32 masked video program: masks equal the JAX masks on at
    least 0.999 of the pixels (a near-tie in the logits may break either
    way), and with the JAX masks injected the frames agree within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vstnet_tpu.models.revresnet_fast as jrf
from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models import cwct as jcwct
from vstnet_tpu.models import pipeline as jpipe
from vstnet_tpu.models import remapping as jremap
from vstnet_tpu.models import segformer as jsf
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import (
    params_from_jax,
    segformer_params_from_jax,
)
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models import pipeline
from vstnet_tpu_torch.models import remapping as remap
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models import segformer as sf
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.ops import coupling_fused as cf

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(2, 2, 2))
JSMALL = JaxConfig(n_blocks=(2, 2, 2))
TINY = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def mappings():
    return remap.load_label_mapping(), jremap.load_label_mapping()


def _seg(rng, labels, shape, probs=None):
    return rng.choice(np.asarray(labels), size=shape, p=probs).astype(
        np.int32)


# ---------------------------------------------------------------------------
# Remapping
# ---------------------------------------------------------------------------

def test_tables_are_the_packages_own_copies(mappings):
    mt, mj = mappings
    assert mt.dtype == torch.int64 and mt.shape == (150, 150)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(remap.ade20k_palette(),
                                  jremap.ade20k_palette())
    assert "vstnet_tpu_torch" in remap._DATA_DIR


# frames: varied labels with small ones; a frame with a single label; a
# frame whose labels the style lacks altogether
_FRAMES = {
    "mixed": lambda r: _seg(r, [3, 17, 52, 93, 121, 140], (3, 48, 48),
                            [0.4, 0.3, 0.2, 0.06, 0.03, 0.01]),
    "one-label": lambda r: np.full((2, 40, 40), 21, np.int32),
    "style-lacks-all": lambda r: _seg(r, [2, 4, 9, 16], (2, 40, 40)),
    "uniform-150": lambda r: r.integers(0, 150, (2, 32, 32)).astype(np.int32),
}


@pytest.mark.parametrize("kind", list(_FRAMES))
@pytest.mark.parametrize("min_ratio", [0.02, 0.05])
def test_remapping_matches_jax(mappings, kind, min_ratio):
    """label_counts, self_remapping, cross_remapping, video_remap_plan and
    video_remap, integer-equal to the JAX functions."""
    mt, mj = mappings
    r = np.random.default_rng(11)
    cm = _FRAMES[kind](r)
    sm = _seg(r, [3, 52, 76], (1, *cm.shape[1:]))
    cm_t, sm_t = torch.from_numpy(cm), torch.from_numpy(sm)
    cm_j, sm_j = jnp.asarray(cm), jnp.asarray(sm)

    np.testing.assert_array_equal(remap.label_counts(cm_t).numpy(),
                                  np.asarray(jremap.label_counts(cm_j)))
    selfed = remap.self_remapping(cm_t, mt, min_ratio)
    assert selfed.dtype == torch.int32
    selfed_j = jremap.self_remapping(cm_j, mj, min_ratio)
    np.testing.assert_array_equal(selfed.numpy(), np.asarray(selfed_j))
    # a single (H, W) map takes the same route
    np.testing.assert_array_equal(
        remap.self_remapping(cm_t[0], mt, min_ratio).numpy(),
        np.asarray(selfed_j[0]))

    sm_b = np.broadcast_to(sm, cm.shape)
    crossed = remap.cross_remapping(selfed, torch.from_numpy(sm_b.copy()),
                                    mt)
    crossed_j = jremap.cross_remapping(selfed_j, jnp.asarray(sm_b), mj)
    np.testing.assert_array_equal(crossed.numpy(), np.asarray(crossed_j))

    in_style, cross_tab = remap.video_remap_plan(sm_t, mt)
    in_style_j, cross_tab_j = jremap.video_remap_plan(sm_j, mj)
    np.testing.assert_array_equal(in_style.numpy(), np.asarray(in_style_j))
    np.testing.assert_array_equal(cross_tab.numpy(), np.asarray(cross_tab_j))
    fused = remap.video_remap(cm_t, in_style, cross_tab, mt, min_ratio)
    np.testing.assert_array_equal(
        fused.numpy(), np.asarray(jremap.video_remap(
            cm_j, in_style_j, cross_tab_j, mj, min_ratio)))
    # composed == sequential; every label left is one the style has
    assert torch.equal(fused, crossed)
    assert set(np.unique(fused.numpy())) <= {3, 52, 76}
    np.testing.assert_array_equal(
        remap.remove_small_holes(cm_t, mt).numpy(),
        np.asarray(jremap.remove_small_holes(cm_j, mj)))


def test_first_qualifying_takes_the_first_true_row():
    """argmax over booleans must return the first True candidate, and the
    fallback where none qualifies."""
    mapping = torch.tensor([[2, 0, 1], [1, 2, 0], [0, 1, 2]])
    qualifies = torch.tensor([False, True, True] + [False] * 147)
    got = remap._first_qualifying(mapping, qualifies, torch.arange(3))
    assert got.tolist() == [2, 2, 1]
    none = torch.zeros(150, dtype=torch.bool)
    assert remap._first_qualifying(mapping, none,
                                   torch.arange(3)).tolist() == [0, 1, 2]


# ---------------------------------------------------------------------------
# Regional cWCT
# ---------------------------------------------------------------------------

def _latent(rng, b, h, w, c):
    """Correlated channels whose covariance stays well conditioned (about
    10) for regions of a few hundred pixels: with a plain Gaussian mix the
    condition number is near 2000, and both packages then sit 1e-3 from a
    float64 evaluation, the JAX one further than the port."""
    mix = (np.eye(c) + 0.5 * rng.standard_normal((c, c))
           / np.sqrt(c)).astype(np.float32)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32) @ mix
    return x + rng.standard_normal((1, 1, 1, c)).astype(np.float32)


def _blocky(rng, labels, b, h, w, cell=8):
    """Label maps made of cell x cell blocks, so regions have area."""
    small = rng.choice(np.asarray(labels), size=(b, h // cell, w // cell))
    return np.repeat(np.repeat(small, cell, 1), cell, 2).astype(np.int32)


def test_label_capacity_and_padded_labels(rng):
    m = _blocky(rng, [5, 9, 40, 41, 77, 90, 100, 120, 149], 2, 32, 32, 4)
    assert cwct.label_capacity(torch.from_numpy(m)) == \
        jcwct.label_capacity(m) == 16
    assert cwct.label_capacity(torch.from_numpy(m[:, :4, :4]), None) == 8
    got = cwct._padded_labels(torch.from_numpy(m[0]), 16)
    want = jnp.unique(jnp.asarray(m[0]), size=16, fill_value=jnp.int32(-1))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # more labels than capacity: the first K sorted ones
    np.testing.assert_array_equal(
        cwct._padded_labels(torch.from_numpy(m[0]), 4).numpy(),
        np.unique(m[0])[:4])


@pytest.mark.parametrize("chunk", [cwct.REGION_CHUNK, 100])
def test_region_moments_match_jax(rng, chunk):
    c, k = 32, 8
    x = _latent(rng, 1, 24, 32, c).reshape(-1, c)
    m = _blocky(rng, [4, 7, 30], 1, 24, 32).reshape(-1)
    labels = np.array([4, 7, 30, 99, -1, -1, -1, -1], np.int32)
    want = jcwct.region_moments(jnp.asarray(x), jnp.asarray(m),
                                jnp.asarray(labels))
    got = cwct.region_moments(torch.from_numpy(x), torch.from_numpy(m),
                              torch.from_numpy(labels), chunk=chunk)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].shape == (k, c) and got[2].shape == (k, c, c)
    scale = float(np.abs(np.asarray(want[2])).max())
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5 * scale)
    for g, w in zip(cwct.stats_from_moments(*got),
                    jcwct.stats_from_moments(*want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)

    # a bf16 latent: exact products, float32 sums
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got_b = cwct.region_moments(xb, torch.from_numpy(m),
                                torch.from_numpy(labels), chunk=chunk)
    ref_b = cwct.region_moments(xb.float(), torch.from_numpy(m),
                                torch.from_numpy(labels), chunk=chunk)
    for g, w in zip(got_b, ref_b):
        assert g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())


def _masked_case(rng):
    c = 32
    zc = _latent(rng, 2, 32, 32, c)
    zs = _latent(rng, 1, 32, 32, c) * np.float32(1.5) + np.float32(0.3)
    cm = _blocky(rng, [3, 52, 76], 2, 32, 32)
    sm = _blocky(rng, [3, 52, 76], 1, 32, 32)
    cm[:, :8, :8], sm[:, :8, :8] = 3, 3        # every label on both sides
    cm[:, 8:16, :8], sm[:, 8:16, :8] = 52, 52
    cm[:, 16:24, :8], sm[:, 16:24, :8] = 76, 76
    return zc, zs, cm, sm


def test_transfer_masked_matches_jax(rng):
    zc, zs, cm, sm = _masked_case(rng)
    zs2 = np.concatenate([zs, zs * np.float32(0.8)])
    sm2 = np.concatenate([sm, sm])
    want = jcwct.transfer_masked(jnp.asarray(zc), jnp.asarray(zs2),
                                 jnp.asarray(cm), jnp.asarray(sm2),
                                 max_labels=8)
    got = cwct.transfer_masked(torch.from_numpy(zc), torch.from_numpy(zs2),
                               torch.from_numpy(cm), torch.from_numpy(sm2),
                               max_labels=8)
    assert got.shape == zc.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(np.abs(got.numpy() - zc).max()) > 0.1   # it did transfer


def test_factored_transfer_matches_jax_and_unfactored(rng):
    zc, zs, cm, sm = _masked_case(rng)
    fac_j = jcwct.style_region_factors(jnp.asarray(zs), jnp.asarray(sm),
                                       max_labels=8)
    fac = cwct.style_region_factors(torch.from_numpy(zs),
                                    torch.from_numpy(sm), max_labels=8)
    assert fac[0].tolist() == [3, 52, 76, -1, -1, -1, -1, -1]
    for g, w in zip(fac, fac_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    want = jcwct.transfer_masked_factored(jnp.asarray(zc), jnp.asarray(cm),
                                          *fac_j)
    got = cwct.transfer_masked_factored(torch.from_numpy(zc),
                                        torch.from_numpy(cm), *fac)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # factored == unfactored when every content label is a style label
    unf = cwct.transfer_masked(
        torch.from_numpy(zc), torch.from_numpy(np.concatenate([zs, zs])),
        torch.from_numpy(cm), torch.from_numpy(np.concatenate([sm, sm])),
        max_labels=8)
    np.testing.assert_allclose(got.numpy(), unf.numpy(), atol=1e-5)


def test_invalid_regions_pass_content_through(rng):
    """A label the style lacks, a region of fewer than MIN_PIXELS pixels
    and a region whose area ratio is out of bounds keep their content."""
    zc, zs, cm, sm = _masked_case(rng)
    cm[:, 24:, 24:] = 120                # the style has no 120
    cm[0, 0, :4] = 99                    # 4 pixels
    sm[0, 31, :4] = 99
    fac = cwct.style_region_factors(torch.from_numpy(zs),
                                    torch.from_numpy(sm), max_labels=8)
    got = cwct.transfer_masked_factored(torch.from_numpy(zc),
                                        torch.from_numpy(cm), *fac).numpy()
    want = np.asarray(jcwct.transfer_masked_factored(
        jnp.asarray(zc), jnp.asarray(cm),
        *jcwct.style_region_factors(jnp.asarray(zs), jnp.asarray(sm),
                                    max_labels=8)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    keep = (cm == 120) | (cm == 99)
    np.testing.assert_array_equal(got[keep], zc[keep])
    assert float(np.abs(got[~keep] - zc[~keep]).max()) > 0.1
    # the ratio rule, through region_transforms
    labels = torch.tensor([3, 52, -1], dtype=torch.int32)
    eye = torch.eye(4).expand(3, 4, 4).contiguous()
    zero = torch.zeros(3, 4)
    _, _, valid = cwct.region_transforms(
        labels, torch.tensor([500.0, 20.0, 500.0]), zero, eye,
        torch.tensor([400.0, 5000.0, 400.0]), zero, eye)
    assert valid.tolist() == [True, False, False]


def test_bf16_regional_transfer_tracks_float32(rng):
    zc, zs, cm, sm = _masked_case(rng)
    fac = cwct.style_region_factors(torch.from_numpy(zs),
                                    torch.from_numpy(sm), max_labels=8)
    ref = cwct.transfer_masked_factored(torch.from_numpy(zc),
                                        torch.from_numpy(cm), *fac)
    got = cwct.transfer_masked_factored(
        torch.from_numpy(zc).to(torch.bfloat16), torch.from_numpy(cm), *fac)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - ref).abs().max())
    assert err <= 0.05 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# The masked video program
# ---------------------------------------------------------------------------

@pytest.fixture
def _interpret(monkeypatch):
    from tests.conftest import patch_interpret_fused

    patch_interpret_fused(monkeypatch)


@pytest.fixture(scope="module")
def models():
    params = jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(0))
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    seg_params = jax.jit(lambda k: jsf.init_segformer(k, TINY))(
        jax.random.PRNGKey(2))
    seg_net = sf.SegFormer(TINY, device="cpu")
    seg_net.load_state_dict(
        segformer_params_from_jax(jax.tree.map(np.asarray, seg_params)))
    return params, net, seg_params, seg_net


def _smooth(rng, n, size):
    """Image-like frames in [0, 1]: upsampled noise plus a little grain."""
    small = rng.uniform(size=(n, size // 8, size // 8, 3)).astype(np.float32)
    x = np.asarray(jax.image.resize(jnp.asarray(small), (n, size, size, 3),
                                    "linear"))
    x = x + 0.05 * rng.uniform(size=x.shape).astype(np.float32)
    return np.clip(x, 0, 1).astype(np.float32)


@pytest.mark.parametrize("seg_hw", [None, (32, 32)], ids=["native", "seg32"])
def test_masked_video_program_matches_jax(rng, models, _interpret, seg_hw):
    params, net, seg_params, seg_net = models
    min_ratio = 0.02
    frames = _smooth(rng, 2, 64)
    style = _smooth(rng, 1, 64)

    # the JAX package's per-video set-up, as its video CLI does it
    jseg = jsf.Segmenter(params=seg_params,
                         label_mapping=jremap.load_label_mapping())
    jfast = jrf.pack_revresnet(params, JSMALL)
    smask_j = jremap.self_remapping(jseg.segment(jnp.asarray(style)),
                                    jseg.label_mapping, min_ratio)
    z_s = jrf.encode_fast(jfast, jnp.asarray(style), JSMALL)
    sm_lat = jpipe._mask_to_latent(smask_j, z_s.shape)
    region_j = jcwct.style_region_factors(
        z_s, sm_lat, max_labels=jcwct.label_capacity(sm_lat))
    plan_j = jremap.video_remap_plan(smask_j, jseg.label_mapping)
    want, masks_j = jpipe.make_masked_fused_video_fn(
        JSMALL, min_ratio=min_ratio, seg_hw=seg_hw, seg_half=False)(
        jfast, seg_params, jseg.label_mapping, region_j, plan_j,
        jnp.asarray(frames))

    # the port
    seg = sf.Segmenter(net=seg_net,
                       label_mapping=remap.load_label_mapping())
    fast = rf.pack_revresnet(net)
    cf.reset_launches()
    region, plan, smask = pipeline.prepare_masked_style(
        fast, seg, torch.from_numpy(style), SMALL, min_ratio)
    assert (smask.numpy() == np.asarray(smask_j)).mean() >= 0.999
    assert region[0].shape == region_j[0].shape
    np.testing.assert_array_equal(plan[0].numpy(), np.asarray(plan_j[0]))
    np.testing.assert_array_equal(plan[1].numpy(), np.asarray(plan_j[1]))
    fn = pipeline.make_masked_fused_video_fn(
        SMALL, min_ratio=min_ratio, seg_hw=seg_hw, seg_half=False)
    got, masks = fn(fast, seg_net, seg.label_mapping, region, plan,
                    torch.from_numpy(frames))
    assert cf.fused_coupling.launches == 0           # CPU: plain versions
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    assert masks.shape == (2, 64, 64) and masks.dtype == torch.int32
    agree = (masks.numpy() == np.asarray(masks_j)).mean()
    assert agree >= 0.999, f"masks agree on {agree:.5f}"
    style_labels = set(np.unique(smask.numpy()))
    assert set(np.unique(masks.numpy())) <= style_labels

    # frames, with the JAX masks injected into the port's program
    if agree < 1.0:
        saved = pipeline.video_remap
        pipeline.video_remap = lambda *a, **k: torch.from_numpy(
            np.asarray(jax.image.resize(
                masks_j, (2, *(seg_hw or (64, 64))), "nearest")))
        try:
            got, _ = fn(fast, seg_net, seg.label_mapping, region, plan,
                        torch.from_numpy(frames))
        finally:
            pipeline.video_remap = saved
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(np.abs(got.numpy() - frames).max()) > 0.02

    got8, _ = pipeline.make_masked_fused_video_fn(
        SMALL, min_ratio=min_ratio, out_u8=True, seg_hw=seg_hw,
        seg_half=False)(fast, seg_net, seg.label_mapping, region, plan,
                        torch.from_numpy(frames))
    assert got8.dtype == torch.uint8
    if agree == 1.0:
        assert np.abs(got8.numpy().astype(np.int32)
                      - np.round(np.asarray(want) * 255)).max() <= 1


def test_masked_program_bf16_route_and_style_model(rng, models):
    """seg_half=True with bf16 packed weights (the deployed form): finite
    frames close to the float32 program's when both get the same masks;
    StyleModel carries a segmenter and routes masks to the regional
    transfer."""
    _, net, _, seg_net = models
    seg = sf.Segmenter(net=seg_net, label_mapping=remap.load_label_mapping())
    frames = torch.from_numpy(_smooth(rng, 2, 64))
    style = torch.from_numpy(_smooth(rng, 1, 64))
    fast32, fast16 = rf.pack_revresnet(net), rf.pack_revresnet(
        net, torch.bfloat16)
    region, plan, smask = pipeline.prepare_masked_style(fast32, seg, style,
                                                        SMALL)
    ref, masks = pipeline.make_masked_fused_video_fn(SMALL, seg_half=False)(
        fast32, seg_net, seg.label_mapping, region, plan, frames)
    saved = pipeline.video_remap
    pipeline.video_remap = lambda *a, **k: masks
    try:
        got, _ = pipeline.make_masked_fused_video_fn(SMALL)(
            fast16, seg_net, seg.label_mapping, region, plan, frames)
    finally:
        pipeline.video_remap = saved
    cwct.host_check_finite(got)
    mse = float(((got - ref) ** 2).mean())
    assert 10 * np.log10(1.0 / mse) >= 35.0

    model = pipeline.StyleModel(cfg=SMALL, net=net, segmenter=seg)
    assert model.segmenter is seg
    sm = smask.expand(2, -1, -1)
    out = model.stylize(frames, style.expand(2, -1, -1, -1), cmask=masks,
                        smask=sm)
    want = pipeline.stylize_masked(net, frames, style.expand(2, -1, -1, -1),
                                   masks, sm,
                                   max_labels=cwct.label_capacity(masks))
    assert torch.equal(out, want)
    fast = model.stylize(frames, style.expand(2, -1, -1, -1), cmask=masks,
                         smask=sm, fast=True)
    assert fast.dtype == torch.float32 and fast.shape == frames.shape
    assert 10 * np.log10(1.0 / float(((fast - out) ** 2).mean())) >= 35.0
