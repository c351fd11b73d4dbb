"""The port's ultra-resolution tiler (vstnet_tpu_torch/models/ultra.py)
against the JAX package's (vstnet_tpu/models/ultra.py).

Both packages run the same weights (vstnet_tpu's init_revresnet at the
tiny config of tests/test_ultra.py, carried across with params_from_jax)
on the same seeded inputs: a 192x160 content, 96x96 styles, blocky label
masks. The port runs on the CPU, where its kernels' wrappers run their
plain versions.

Tolerances:
  * tile geometry (receptive field, starts, ramps, ownership masks, blend
    weights): exact, since both are the same numpy arithmetic.
  * port float32 tiled against JAX float32 tiled, in each mode at the
    exact overlap (>= the receptive field) and at a practical one (tile
    96, overlap 24): 1e-4 max abs (the covariances sum in another order
    and Lc^{-1} lifts that roundoff; measured at most 1.5e-6).
  * the fused route's tile latents at the exact overlap against the
    whole image's fused latent, on the pixels each tile owns: bit for bit
    (a pixel's value does not depend on where a tile starts).
  * port tiled against port whole-image: > 55 dB at the exact overlap and
    > 30 dB at the practical one, the gates of tests/test_ultra.py.
  * the fused route (bf16 plain versions) against float32 tiled: >= 40
    dB, the fidelity gate of BASELINE.md.
"""

import jax
import numpy as np
import pytest
import torch

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models import ultra as jultra
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu_torch.config import PHOTO_CONFIG, RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import params_from_jax
from vstnet_tpu_torch.models import pipeline, ultra
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models.revresnet import RevResNet

torch.set_num_threads(2)

JTINY = JaxConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
TINY = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
H, W = 192, 160
EXACT = ultra.receptive_field(TINY) + (-ultra.receptive_field(TINY)) % 4
# (tile, overlap) of the exact regime and of the practical one
OVERLAPS = {"exact": (160, EXACT), "practical": (96, 24)}
GATES = {"exact": 55.0, "practical": 30.0}
ALPHA_S, ALPHA_C = (0.35, 0.65), 0.3


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.fixture(scope="module")
def world():
    """Weights in both packages and the seeded inputs, as numpy."""
    params = jax.jit(lambda k: init_revresnet(k, JTINY))(
        jax.random.PRNGKey(0))
    net = RevResNet(TINY, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(0)
    cm = np.add.outer(np.arange(H) // 96, np.arange(W) // 80)[None]
    sm = np.add.outer(np.arange(96) // 48, np.arange(96) // 48)[None]
    return {
        "params": params, "net": net,
        "content": rng.uniform(size=(1, H, W, 3)).astype(np.float32),
        "styles": [rng.uniform(size=(1, 96, 96, 3)).astype(np.float32)
                   for _ in ALPHA_S],
        "cmask": cm.astype(np.int32), "smask": sm.astype(np.int32),
        "cache": {}}


def _run(world, package, mode, regime, fast=False):
    """One tiled run, as a numpy (1, H, W, 3) array; each once a module."""
    key = (package, mode, regime, fast)
    if key in world["cache"]:
        return world["cache"][key]
    tile, overlap = OVERLAPS[regime]
    c, s = world["content"], world["styles"]
    if package == "jax":
        import jax.numpy as jnp

        mod, w, cfg, put = jultra, world["params"], JTINY, jnp.asarray
        kw = {}
    else:
        mod, w, cfg, put = ultra, world["net"], TINY, torch.from_numpy
        kw = ({"fast_params": rf.pack_revresnet(w, torch.bfloat16)}
              if fast else {})
    if mode == "global":
        out = mod.stylize_tiled(w, put(c), put(s[0]), cfg, tile=tile,
                                overlap=overlap, **kw)
    elif mode == "masked":
        out = mod.stylize_tiled_masked(
            w, put(c), put(s[0]), put(world["cmask"]), put(world["smask"]),
            cfg, tile=tile, overlap=overlap, max_labels=4, **kw)
    else:
        out = mod.stylize_tiled_interp(
            w, put(c), [put(x) for x in s], list(ALPHA_S), cfg,
            alpha_c=ALPHA_C, tile=tile, overlap=overlap, **kw)
    world["cache"][key] = np.asarray(out)
    return world["cache"][key]


def _whole(world, mode):
    """The port's whole-image pipeline in the same mode."""
    net = world["net"]
    c = torch.from_numpy(world["content"])
    s = [torch.from_numpy(x) for x in world["styles"]]
    if mode == "global":
        out = pipeline.stylize(net, c, s[0])
    elif mode == "masked":
        out = pipeline.stylize_masked(
            net, c, s[0], torch.from_numpy(world["cmask"]),
            torch.from_numpy(world["smask"]), max_labels=4)
    else:
        out = pipeline.stylize_interp(net, c, torch.stack(s), list(ALPHA_S),
                                      alpha_c=ALPHA_C)
    return out.numpy()


def test_receptive_field_matches_jax():
    for cfg, jcfg in ((TINY, JTINY), (PHOTO_CONFIG, JaxConfig())):
        assert ultra.receptive_field(cfg) == jultra.receptive_field(jcfg)
    assert ultra.receptive_field(PHOTO_CONFIG) == 234


@pytest.mark.parametrize("h,w,tile,overlap", [
    (H, W, 160, EXACT), (H, W, 96, 24), (256, 256, 128, 32),
    (200, 152, 96, 24), (128, 320, 128, 16), (2160, 3840, 1024, 128),
])
def test_tile_geometry_matches_jax(h, w, tile, overlap):
    """Starts, ramps and tiles equal the JAX module's; the ownership masks
    and blend weights that the port builds on the device equal its stacked
    canvases, chunk by chunk, the padded tail included."""
    for total, t, s in ((h, tile, tile - 2 * overlap), (w, 96, 40),
                        (64, 64, 8)):
        assert ultra._starts(total, t, s) == jultra._starts(total, t, s)
    for lo in (False, True):
        for hi in (False, True):
            np.testing.assert_array_equal(ultra._ramp(tile, overlap, lo, hi),
                                          jultra._ramp(tile, overlap, lo, hi))
    g = ultra._TileGrid(h, w, TINY, tile, overlap)
    jg = jultra._TileGrid(h, w, JTINY, tile, overlap)
    for a in ("ys", "xs", "th", "tw", "overlap", "sc", "h", "w"):
        assert getattr(g, a) == getattr(jg, a), a
    assert list(g.tiles()) == list(jg.tiles())
    if h * w > 512 * 512:
        return      # the 4K grid: starts only, no full-size canvases
    for need, k in (("own", 2), ("wt", 3)):
        for mine, theirs in zip(g.chunks(3, need), jg.chunks(3, need)):
            assert mine[:2] == (list(np.asarray(theirs[0])),
                                list(np.asarray(theirs[1])))
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(theirs[k]))


@pytest.mark.parametrize("h,w,tile,overlap", [
    (256, 256, 128, 32), (200, 152, 96, 24), (128, 320, 128, 16),
])
def test_ownership_exactly_once(h, w, tile, overlap):
    assert ultra.ownership_check(h, w, TINY, tile, overlap)
    assert jultra.ownership_check(h, w, JTINY, tile, overlap)


@pytest.mark.parametrize("regime", list(OVERLAPS))
@pytest.mark.parametrize("mode", ["global", "masked", "interp"])
def test_tiled_matches_jax(world, mode, regime):
    """Port float32 tiled against JAX float32 tiled within 1e-4, and
    against the port's whole-image pipeline above the JAX tests' gate."""
    got = _run(world, "torch", mode, regime)
    want = _run(world, "jax", mode, regime)
    assert got.shape == want.shape == (1, H, W, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    p = _psnr(got, _whole(world, mode))
    assert p > GATES[regime], f"{mode} {regime}: tiled vs whole {p:.1f} dB"


@pytest.mark.parametrize("mode", ["global", "masked", "interp"])
def test_fast_route_vs_f32(world, mode):
    """The fused route in bf16 (plain versions on the CPU) against the
    float32 tiled result on the same grid."""
    got = _run(world, "torch", mode, "practical", fast=True)
    p = _psnr(got, _run(world, "torch", mode, "practical"))
    assert p >= 40.0, f"{mode}: fast vs float32 {p:.1f} dB"


def test_tile_latents_equal_whole_image(world):
    """At the exact overlap the tiles' owned latent pixels, put together,
    are the whole image's latent bit for bit on the fused route."""
    net = world["net"]
    fp = rf.pack_revresnet(net, torch.bfloat16)
    c = torch.from_numpy(world["content"]).to(torch.bfloat16)
    g = ultra._TileGrid(H, W, TINY, *OVERLAPS["exact"])
    whole = rf.encode_fast(fp, c, TINY)
    got = torch.full_like(whole, float("nan"))
    items = list(g.tiles())
    z = rf.encode_fast(fp, ultra._slice_tiles(
        c, [it[1] for it in items], [it[3] for it in items], g.th, g.tw),
        TINY)
    for i, it in enumerate(items):
        oy0, oy1, ox0, ox1 = g.own_bounds(*it)
        y0, x0 = it[1] // g.sc, it[3] // g.sc
        got[0, y0 + oy0:y0 + oy1, x0 + ox0:x0 + ox1] = z[i, oy0:oy1, ox0:ox1]
    assert len(items) > 1 and torch.equal(got, whole)


def test_tiled_masked_label_overflow_raises(world):
    """More distinct content labels than max_labels fails loudly."""
    rng = np.random.default_rng(1)
    c = torch.from_numpy(rng.uniform(size=(1, 64, 64, 3)).astype(np.float32))
    cm = torch.from_numpy(np.arange(64 * 64).reshape(1, 64, 64) % 7)
    sm = torch.zeros((1, 64, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="distinct labels"):
        ultra.stylize_tiled_masked(world["net"], c, c, cm, sm, TINY,
                                   tile=64, overlap=0, max_labels=4)


def _float32_content_stats(batches):
    """Pass 1's statistics in float32, as the JAX package forms them and
    the port does on the CPU, spelled out: per tile batch (z (T, h, w, C),
    owns (T, h, w)), zm = z * owns, n += sum(owns), s1 += sum(zm),
    s2 += zm^T z (one addmm_); then mean = s1 / n and cov = (s2 - n
    mean mean^T) / (n - 1)."""
    c = batches[0][0].shape[-1]
    n, s1, s2 = torch.zeros(()), torch.zeros(c), torch.zeros(c, c)
    for z, owns in batches:
        zm = (z * owns[..., None]).reshape(-1, c)
        n += owns.sum()
        s1 += zm.sum(dim=0)
        s2.addmm_(zm.t(), z.reshape(-1, c))
    mean = s1 / n
    return mean, (s2 - n * torch.outer(mean, mean)) / (n - 1.0)


@pytest.mark.parametrize("fast", [False, True])
def test_content_stats_follow_the_accumulate_rule(world, monkeypatch, fast):
    """ultra._content_stats (pass 1 of stylize_tiled and
    stylize_tiled_interp) at the practical regime (9 tiles in 3 batches,
    the tail padded), each batch's latent recorded. With the CPU's own
    cwct._accumulate rule the statistics equal _float32_content_stats of
    the same latents bit for bit; with the card's rule applied here
    (float64 for a float32 latent, summed one tile at a time), the
    float64 mean and centred Gram / (n - 1) of the same owned rows,
    rounded once to float32, bit for bit. The two differ."""
    from vstnet_tpu_torch.models import cwct

    net = world["net"]
    weights = rf.pack_revresnet(net, torch.bfloat16) if fast else net
    content = torch.from_numpy(world["content"])
    g = ultra._TileGrid(H, W, TINY, *OVERLAPS["practical"])
    owns = [o for _, _, o, _ in g.chunks(ultra.TILE_BATCH, "own")]
    assert len(owns) == 3 and not bool(owns[-1][-1].any())
    enc = ultra._enc

    def run():
        latents = []

        def record(*args, **kw):
            latents.append(enc(*args, **kw))
            return latents[-1]

        monkeypatch.setattr(ultra, "_enc", record)
        got = ultra._content_stats(g, weights, content, TINY, fast,
                                   ultra.TILE_BATCH)
        monkeypatch.setattr(ultra, "_enc", enc)
        return got, list(zip(latents, owns, strict=True))

    plain, batches = run()
    for g_, w in zip(plain, _float32_content_stats(batches)):
        assert g_.dtype == torch.float32 and torch.equal(g_, w)

    monkeypatch.setattr(cwct, "_accumulate", lambda x: (
        torch.float64 if x.dtype == torch.float32 else x.dtype))
    got, batches = run()
    rows = torch.cat([z.reshape(-1, z.shape[-1])[o.reshape(-1) > 0]
                      for z, o in batches]).double()
    assert rows.shape[0] == H * W // TINY.latent_scale ** 2
    mean = rows.mean(dim=0)
    xc = rows - mean
    for g_, w, p in zip(got, (mean, xc.t() @ xc / (rows.shape[0] - 1)),
                        plain):
        assert g_.dtype == torch.float32 and torch.equal(g_, w.float())
        assert not torch.equal(g_, p)
