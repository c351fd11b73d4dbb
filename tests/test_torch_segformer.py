"""The port's SegFormer, its two kernel modules and its resize ops against
the JAX package's.

vstnet_tpu_torch/ops/attention.py (K4) and ops/dwconv.py (K5) hold CUDA
kernels with plain PyTorch versions beside them; on the CPU the wrappers
run the plain versions, which are held here against the Pallas kernels they
replace (sr_attention_flash, dwconv3x3_bias_gelu) in interpret mode, as
tests/test_segformer.py runs them. Inputs come from numpy seeds; SegFormer
weights are a vstnet_tpu init_segformer pytree with numpy-seeded values,
carried across with segformer_params_from_jax.

Tolerances:
  * K5 in bf16: one bf16 ulp at the output's scale. Both sides sum the
    nine taps in float32 and round once; the erf forms differ by < 2e-6,
    so a value next to a rounding boundary may land one ulp apart.
  * K4 in bf16: atol = rtol = 2e-2, the JAX package's own bound for its
    kernel against the einsum form (tests/test_segformer.py).
  * resize: 1e-5 in float32 (the same weights in another order); nearest
    and the replicate pad are exact.
  * SegFormer float32 features, head logits and upsampled logits: 1e-4
    (float32 roundoff through the blocks; activations are O(1)).
  * SegFormer bf16 route: cosine > 0.99 against the float32 logits, the
    JAX package's own gate for its bf16 route.

tests/test_torch_cuda.py compares the CUDA kernels themselves with their
plain versions on a card.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstnet_tpu.models import segformer as jsf
from vstnet_tpu.ops import attention as jatt
from vstnet_tpu.ops import dwconv as jdw
from vstnet_tpu.ops import resize as jresize
from vstnet_tpu_torch.io.checkpoint import (
    load_segformer,
    segformer_params_from_jax,
)
from vstnet_tpu_torch.models import segformer as sf
from vstnet_tpu_torch.ops import attention as att
from vstnet_tpu_torch.ops import dwconv as dw
from vstnet_tpu_torch.ops import resize
from vstnet_tpu_torch.ops import upsample_argmax as ua

torch.set_num_threads(2)

TINY = (1, 1, 1, 1)


def _bf16(a):
    """numpy float32 -> torch bf16 and the same values as a jax bf16."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(t):
    return t.float().numpy()


_BASE = []


def _jax_params(depths, seed):
    """A JAX SegFormer pytree of the given depths with numpy-seeded values.
    The structure comes from one init_segformer at depth 1 per stage (a
    deeper init costs many seconds of tiny dispatches); every matrix is
    redrawn U(+-its init bound), and every bias, norm gain and BatchNorm
    statistic is moved off its 0/1 init value so that each is exercised."""
    if not _BASE:
        _BASE.append(jax.tree.map(np.asarray, jax.jit(
            lambda k: jsf.init_segformer(k, TINY))(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(seed)

    def draw(path, a, lead=()):
        shape = lead + a.shape
        if a.ndim >= 2:
            bound = float(np.abs(a).max())
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if path and getattr(path[-1], "key", None) == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (a + 0.05 * rng.standard_normal(shape)).astype(np.float32)

    base = _BASE[0]
    tree = jax.tree_util.tree_map_with_path(draw, base)
    for s, depth in enumerate(depths):
        tree["stages"][s]["blocks"] = jax.tree_util.tree_map_with_path(
            lambda p, a: draw(p, a[0], (depth,)),
            base["stages"][s]["blocks"])
    return jax.tree.map(jnp.asarray, tree)


def _pair(depths, seed):
    params = _jax_params(depths, seed)
    net = sf.SegFormer(depths, device="cpu")
    net.load_state_dict(
        segformer_params_from_jax(jax.tree.map(np.asarray, params)))
    return params, net


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair(TINY, 0)


# ---------------------------------------------------------------------------
# K5 and K4: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,c", [(1, 8, 8, 128), (2, 12, 16, 256),
                                     (1, 1, 5, 256), (2, 6, 1, 128),
                                     (1, 9, 11, 200), (2, 5, 7, 8)])
def test_dwconv_gelu_plain_matches_jax_kernel(rng, b, h, w, c):
    x_t, x_j = _bf16(rng.standard_normal((b, h, w, c)).astype(np.float32))
    taps = (rng.standard_normal((3, 3, 1, c)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    want = np.asarray(jdw.dwconv3x3_bias_gelu(
        x_j, jnp.asarray(taps), jnp.asarray(bias), interpret=True),
        np.float32)
    before = dw.dwconv3x3_bias_gelu.launches
    got = dw.dwconv3x3_bias_gelu(x_t, torch.from_numpy(taps),
                                 torch.from_numpy(bias))
    assert dw.dwconv3x3_bias_gelu.launches == before   # CPU: plain version
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, c)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(_np(got) - want).max() <= ulp
    # (3, 3, C) taps are the same function
    assert torch.equal(got, dw.dwconv3x3_bias_gelu_plain(
        x_t, torch.from_numpy(taps[:, :, 0]), torch.from_numpy(bias)))


def test_dwconv_gelu_plain_float32_matches_jax_kernel(rng):
    x = rng.standard_normal((1, 10, 6, 128)).astype(np.float32)
    taps = (rng.standard_normal((3, 3, 128)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal((128,)) * 0.1).astype(np.float32)
    want = jdw.dwconv3x3_bias_gelu(jnp.asarray(x), jnp.asarray(taps),
                                   jnp.asarray(bias), interpret=True)
    got = dw.dwconv3x3_bias_gelu_plain(
        torch.from_numpy(x), torch.from_numpy(taps), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)
    with pytest.raises(ValueError):
        dw.dwconv3x3_bias_gelu_plain(torch.from_numpy(x),
                                     torch.from_numpy(taps[:, :, :64]),
                                     torch.from_numpy(bias))


@pytest.mark.parametrize("g,n,m", [(1, 64, 16), (2, 48, 48), (5, 128, 32)])
def test_attention_plain_matches_jax_kernel(rng, g, n, m):
    q_t, q_j = _bf16(rng.standard_normal((g, n, 64)).astype(np.float32))
    k_t, k_j = _bf16(rng.standard_normal((g, m, 64)).astype(np.float32))
    v_t, v_j = _bf16(rng.standard_normal((g, m, 64)).astype(np.float32))
    want = np.asarray(jatt.sr_attention_flash(q_j, k_j, v_j, 0.125,
                                              interpret=True), np.float32)
    before = att.sr_attention.launches
    got = att.sr_attention(q_t, k_t, v_t, 0.125)
    assert att.sr_attention.launches == before          # CPU: plain version
    assert got.shape == (g, n, 64) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, atol=2e-2, rtol=2e-2)


def test_attention_plain_takes_the_model_layout(rng):
    """q (B, N, heads, D) with k, v the two halves of one (B, M, 2, heads,
    D) projection give what the (G, N, D) layout gives."""
    b, n, m, h = 2, 40, 12, 2
    q = torch.from_numpy(rng.standard_normal((b, n, h, 64)).astype(
        np.float32)).to(torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal((b, m, 2, h, 64)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    got = att.sr_attention_plain(q, k, v, 0.125)
    flat = att.sr_attention_plain(
        q.permute(0, 2, 1, 3).reshape(b * h, n, 64),
        k.permute(0, 2, 1, 3).reshape(b * h, m, 64),
        v.permute(0, 2, 1, 3).reshape(b * h, m, 64), 0.125)
    assert got.shape == (b, n, h, 64)
    assert torch.equal(got, flat.reshape(b, h, n, 64).permute(0, 2, 1, 3))
    with pytest.raises(ValueError):
        att.sr_attention_plain(q[0, 0], k, v, 0.125)


@pytest.mark.parametrize("n,m,dt,ok", [
    (16384, 256, torch.bfloat16, True), (65536, 1024, torch.bfloat16, True),
    (4096, 1024, torch.bfloat16, False), (16384, 16384, torch.bfloat16, False),
    (16384, 256, torch.float32, False)])
def test_attention_routing_is_the_jax_routing(n, m, dt, ok):
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    assert att.flash_ok(n, m, dt) is ok
    assert bool(jatt.flash_ok(n, m, jdt)) is ok


def _stage_grids(h, w):
    """[(N, M)] of SegFormer-B4's four stages on an h x w image: each patch
    embed pads k // 2 and strides, the spatial reduction floors."""
    out = []
    for k, st, sr in zip((7, 3, 3, 3), (4, 2, 2, 2), sf.SR_RATIOS):
        h = (h + 2 * (k // 2) - k) // st + 1
        w = (w + 2 * (k // 2) - k) // st + 1
        out.append((h * w, (h // sr) * (w // sr)))
    return out


def _stand_in(is_cuda, dtype, shape):
    """What the routes read of a tensor, for a card this machine lacks."""
    return types.SimpleNamespace(
        is_cuda=is_cuda, dtype=dtype, shape=shape, dim=lambda: len(shape),
        device=torch.device("cuda" if is_cuda else "cpu"))


@pytest.mark.parametrize("hw,routes", [
    ((512, 512), ("k4", "sdpa", "sdpa", "sdpa")),
    ((720, 1280), ("k4", "k4", "sdpa", "sdpa")),
    ((1024, 1024), ("k4", "k4", "sdpa", "sdpa"))])
def test_attention_route_by_stage(hw, routes):
    """A bf16 CUDA tensor: K4 where flash_ok (the JAX package's routing,
    unchanged), flash SDPA at every other stage (at 720x1280, 27 + 3
    blocks of stages 3 and 4); a CPU tensor and float32 on a card keep the
    plain version wherever K4 is not routed."""
    for s, ((n, m), want) in enumerate(zip(_stage_grids(*hw), routes)):
        q = (1, n, sf.NUM_HEADS[s], att.HEAD_DIM)
        assert att.route(n, m, _stand_in(True, torch.bfloat16, q)) == want
        assert (want == "k4") is att.flash_ok(n, m, torch.bfloat16)
        cpu = att.route(n, m, _stand_in(False, torch.bfloat16, q))
        assert cpu == ("k4" if want == "k4" else "plain")
        assert att.route(n, m, _stand_in(True, torch.float32, q)) == "plain"
    if hw == (720, 1280):
        sdpa = [d for d, r in zip(sf.DEPTHS, routes) if r == "sdpa"]
        assert sdpa == [27, 3]


def test_new_routes_stay_off_in_an_export_trace():
    """Inside a torch.export trace the SDPA route and the fused upsample
    and argmax are never taken, even for tensors on a card."""
    q = _stand_in(True, torch.bfloat16, (8, 3600, 5, att.HEAD_DIM))
    logits = _stand_in(True, torch.float32, (8, 180, 320, 150))
    seen = {}

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen["attention"] = att.route(3600, 880, q)
            seen["mask"] = sf.fused_mask(logits)
            return x + 1

    assert att.route(3600, 880, q) == "sdpa"
    assert sf.fused_mask(logits)
    torch.export.export(Probe(), (torch.zeros(2),))
    assert seen == {"attention": "plain", "mask": False}


def test_fused_mask_route_needs_a_card_float32_and_growth():
    """segment_mask takes the fused upsample and argmax for logits on a
    card, and the CPU keeps resize_bilinear + argmax; on a card the kernel
    raises, rather than fall back, for logits that are not float32 or do
    not grow at least twofold on both axes (the head's grow fourfold)."""
    shape = (8, 180, 320, 150)
    assert sf.fused_mask(_stand_in(True, torch.float32, shape))
    assert not sf.fused_mask(_stand_in(False, torch.float32, shape))
    for dtype, h, w in ((torch.bfloat16, 720, 1280),
                        (torch.float32, 359, 1280),
                        (torch.float32, 720, 639),
                        (torch.float32, 180, 320)):
        with pytest.raises(ValueError):
            ua.upsample_argmax(_stand_in(True, dtype, shape), h, w)


def test_cpu_segment_takes_the_plain_routes(rng, tiny_pair, monkeypatch):
    """On the CPU a bf16 segment call never reaches the SDPA route or the
    fused upsample and argmax, and its mask is segment_logits' argmax."""
    _, net = tiny_pair

    def refuse(*args):
        raise AssertionError("a card-only route was taken on the CPU")

    monkeypatch.setattr(sf, "sr_attention_sdpa", refuse)
    monkeypatch.setattr(sf, "upsample_argmax", refuse)
    x = torch.from_numpy(rng.uniform(size=(1, 32, 48, 3)).astype(np.float32))
    for half in (False, True):
        mask = sf.segment_mask(net, x, half=half)
        want = sf.segment_logits(net, x, half=half).argmax(-1)
        assert mask.dtype == torch.int32 and torch.equal(mask, want.int())
    assert torch.equal(ua.upsample_argmax(x, 64, 96),
                       resize.resize_bilinear(x, 64, 96).argmax(-1).int())


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """Neither CPU nor CUDA: the wrappers raise instead of falling back."""
    x = torch.empty((1, 4, 4, 128), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dw.dwconv3x3_bias_gelu(x, torch.empty((3, 3, 128), device="meta"),
                               torch.empty((128,), device="meta"))
    q = torch.empty((1, 16, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        att.sr_attention(q, q, q, 0.125)
    with pytest.raises(ValueError):
        ua.upsample_argmax(torch.empty((1, 4, 4, 150), device="meta"), 16, 16)


# ---------------------------------------------------------------------------
# Resizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw_in,hw_out", [
    ((16, 20), (32, 40)), ((32, 40), (16, 20)), ((24, 24), (10, 36)),
    ((8, 8), (8, 8)), ((30, 18), (12, 7))])
def test_resize_bilinear_matches_jax(rng, hw_in, hw_out):
    x = rng.standard_normal((2, *hw_in, 3)).astype(np.float32)
    want = jresize.resize_bilinear(jnp.asarray(x), *hw_out)
    got = resize.resize_bilinear(torch.from_numpy(x), *hw_out)
    assert got.shape == (2, *hw_out, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("hw_in,hw_out", [
    ((16, 20), (32, 40)), ((32, 40), (8, 10)), ((24, 24), (10, 36)),
    ((30, 18), (12, 7)), ((7, 5), (28, 20))])
def test_resize_nearest_matches_jax(rng, hw_in, hw_out):
    m = rng.integers(0, 150, size=(2, *hw_in)).astype(np.int32)
    want = jresize.resize_nearest(jnp.asarray(m), *hw_out)
    got = resize.resize_nearest(torch.from_numpy(m), *hw_out)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.standard_normal((1, *hw_in, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        resize.resize_nearest(torch.from_numpy(x), *hw_out).numpy(),
        np.asarray(jresize.resize_nearest(jnp.asarray(x), *hw_out)))


@pytest.mark.parametrize("h,w", [(50, 62), (8, 12), (13, 16)])
def test_pad_to_multiple_matches_jax(rng, h, w):
    x = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        resize.pad_to_multiple(torch.from_numpy(x), 4).numpy(),
        np.asarray(jresize.pad_to_multiple(jnp.asarray(x), 4)))


# ---------------------------------------------------------------------------
# SegFormer
# ---------------------------------------------------------------------------

def test_weights_carry_both_ways(tiny_pair):
    """segformer_params_from_jax gives the keys and values that the JAX
    package's own segformer_to_torch writes, and those load strictly."""
    params, net = tiny_pair
    ref = jsf.segformer_to_torch(params)
    ours = segformer_params_from_jax(jax.tree.map(np.asarray, params))
    assert set(ref) == set(ours) == set(net.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), k)
    fresh = sf.SegFormer(TINY, device="cpu")
    fresh.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in ref.items()}, strict=True)
    assert sf.infer_depths(ref) == TINY == jsf.infer_depths(ref)


def test_backbone_and_head_match_jax(rng, tiny_pair):
    params, net = tiny_pair
    x = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    want = jsf.backbone_features(params, jnp.asarray(x))
    with torch.no_grad():
        got = net.features(torch.from_numpy(x))
        logits = net.head(got)
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, 16 >> s, 16 >> s, sf.EMBED_DIMS[s])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=f"stage {s + 1}")
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jsf.decode_head(params, want)),
                               atol=1e-4)


@pytest.mark.parametrize("depths,hw", [(TINY, (64, 64)), (TINY, (32, 48)),
                                       (sf.DEPTHS, (64, 64))],
                         ids=["tiny-64", "tiny-32x48", "b4-64"])
def test_segment_logits_match_jax(rng, depths, hw):
    params, net = _pair(depths, 1)
    x = rng.uniform(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jsf.segment_logits(params, jnp.asarray(x)))
    got = sf.segment_logits(net, torch.from_numpy(x))
    assert got.shape == (2, *hw, 150) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    mask = sf.segment_mask(net, torch.from_numpy(x))
    assert mask.dtype == torch.int32
    agree = (mask.numpy() == want.argmax(-1)).mean()
    assert agree >= 0.999      # a near-tie in the logits may break either way


def test_bf16_route_stays_bf16_and_tracks_float32(rng, tiny_pair):
    """half=True: every stage's features and the head's logits are bf16
    (an uncast bias or norm would promote them), the upsampled logits are
    float32, and they keep the JAX package's cosine gate against float32,
    on both sides."""
    params, net = tiny_pair
    x = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    half = net.half_copy()
    assert half is net.half_copy()                      # made once
    with torch.no_grad():
        feats = half.features(sf._normalize(torch.from_numpy(x)).to(
            torch.bfloat16))
        for s, f in enumerate(feats):
            assert f.dtype == torch.bfloat16, f"stage {s + 1} left bf16"
        assert half.head(feats).dtype == torch.bfloat16
    lo32 = sf.segment_logits(net, torch.from_numpy(x)).numpy().ravel()
    lo16 = sf.segment_logits(net, torch.from_numpy(x), half=True)
    assert lo16.dtype == torch.float32
    lo16 = lo16.numpy().ravel()
    jlo16 = np.asarray(jsf.segment_logits(params, jnp.asarray(x),
                                          half=True)).ravel()

    def cos(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

    assert cos(lo16, lo32) > 0.99
    assert cos(lo16, jlo16) > 0.99
    m = sf.segment_mask(net, torch.from_numpy(x), half=True)
    assert m.shape == (1, 64, 64) and m.dtype == torch.int32


def test_bf16_mixffn_takes_the_fused_wrapper(rng, tiny_pair, monkeypatch):
    """bf16 activations with a hidden width that is a multiple of 128 go
    through dwconv3x3_bias_gelu (every MixFFN of B4 and B5); float32 does
    not."""
    _, net = tiny_pair
    calls = []
    orig = sf.dwconv3x3_bias_gelu

    def spy(x, w, b):
        calls.append(tuple(x.shape))
        return orig(x, w, b)

    monkeypatch.setattr(sf, "dwconv3x3_bias_gelu", spy)
    x = torch.from_numpy(rng.uniform(size=(1, 32, 32, 3)).astype(np.float32))
    sf.segment_logits(net, x)
    assert not calls
    sf.segment_logits(net, x, half=True)
    assert calls == [(1, 8, 8, 256), (1, 4, 4, 512), (1, 2, 2, 1280),
                     (1, 1, 1, 2048)]


def test_mixffn_taps_are_laid_out_once(rng, monkeypatch):
    """The bf16 route hands K5 contiguous float32 (3, 3, C) taps equal to
    the permuted depthwise weight, the same tensors on every call (no copy
    per call), laid out anew after load_state_dict; the logits are those
    of taps laid out at every call."""
    net = sf.SegFormer(TINY, device="cpu").init_weights(
        torch.Generator().manual_seed(4))
    seen = []
    orig = sf.dwconv3x3_bias_gelu

    def recorder(x, w, b):
        seen.append(w)
        return orig(x, w, b)

    monkeypatch.setattr(sf, "dwconv3x3_bias_gelu", recorder)
    x = torch.from_numpy(rng.uniform(size=(1, 32, 32, 3)).astype(np.float32))

    def taps_of(model):
        return [blk.mlp.dwconv.dwconv.weight.reshape(-1, 3, 3).permute(1, 2, 0)
                for s in range(1, 5)
                for blk in getattr(model.backbone, f"block{s}")]

    logits = sf.segment_logits(net, x, half=True)
    first, seen[:] = list(seen), []
    assert len(first) == 4
    for got, want in zip(first, taps_of(net)):
        assert got.is_contiguous() and got.dtype == torch.float32
        assert torch.equal(got, want)
    assert torch.equal(sf.segment_logits(net, x, half=True), logits)
    assert all(a is b for a, b in zip(seen, first))     # made once

    # the same logits as taps laid out at every call (the twin without them)
    for mod in net.half_copy().modules():
        if isinstance(mod, sf.MixFFN):
            mod.taps = None
    seen[:] = []
    assert torch.equal(sf.segment_logits(net, x, half=True), logits)
    assert all(a is not b for a, b in zip(seen, first))

    state = {k: v * 2 if k.endswith("dwconv.dwconv.weight") else v
             for k, v in net.state_dict().items()}
    net.load_state_dict(state)
    seen[:] = []
    sf.segment_logits(net, x, half=True)
    for got, old, want in zip(seen, first, taps_of(net)):
        assert got.is_contiguous() and torch.equal(got, want)
        assert torch.equal(got, 2 * old)


def test_segmenter_pads_crops_and_remaps(rng, tmp_path):
    seg = sf.Segmenter.load(None, depths=TINY, seed=3, device="cpu")
    img = torch.from_numpy(rng.uniform(size=(1, 50, 62, 3)).astype(
        np.float32))
    mask = seg.segment(img)
    assert mask.shape == (1, 50, 62) and mask.dtype == torch.int32
    assert 0 <= int(mask.min()) and int(mask.max()) < 150
    cm = rng.integers(0, 150, size=(4, 16, 16)).astype(np.int32)
    sm = np.broadcast_to(rng.integers(0, 150, size=(1, 16, 16)).astype(
        np.int32), (4, 16, 16)).copy()
    out_cm, out_sm = seg.remap(torch.from_numpy(cm), torch.from_numpy(sm))
    for i in range(4):
        assert set(np.unique(out_cm[i].numpy())) <= set(
            np.unique(out_sm[i].numpy()))
    # a checkpoint in the reference format: depths read from its keys
    sd = dict(seg.net.state_dict())
    sd["decode_head.linear_fuse.bn.num_batches_tracked"] = torch.tensor(0)
    path = tmp_path / "seg.pth"
    torch.save({"state_dict": sd}, path)
    assert "decode_head.linear_fuse.bn.num_batches_tracked" not in \
        load_segformer(str(path))
    loaded = sf.Segmenter.load(str(path), device="cpu")
    assert loaded.net.depths == TINY
    assert torch.equal(loaded.segment(img), mask)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    """device=None means the CUDA card: without one every factory and
    constructor raises, and builds nothing on the CPU."""
    import vstnet_tpu_torch as vt
    from vstnet_tpu_torch.models.pipeline import StyleModel
    from vstnet_tpu_torch.models.revresnet import RevResNet

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    small = vt.RevResNetConfig(n_blocks=(1, 1, 1))
    for build in (
            lambda: sf.Segmenter.load(None, depths=TINY),
            lambda: vt.get_segmenter(None, depths=TINY),
            lambda: sf.SegFormer(TINY),
            lambda: RevResNet(small),
            lambda: StyleModel.random_init(),
            lambda: vt.get_photo_style_model(),
            lambda: vt.get_artist_style_model(),
            lambda: vt.get_vstnet_encoder_model(),
            lambda: vt.get_vstnet_decoder_model()):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            build()
    assert vt.resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# The segmenter-resolution gate
# ---------------------------------------------------------------------------

def test_mask_quality_and_seg_hw_rule():
    a = np.zeros((1, 8, 8), np.int32)
    a[:, :, 4:] = 1
    b = a.copy()
    b[:, 0, :] = 2
    for x, y in ((a, a), (a, b)):
        got = sf.mask_quality(torch.from_numpy(x), torch.from_numpy(y))
        want = jsf.mask_quality(x, y)
        assert got == pytest.approx(want)
    for h, w, s in ((512, 512, 256), (512, 256, 256), (200, 100, 256),
                    (512, 512, 0), (500, 300, 256), (360, 640, 384)):
        assert sf.seg_hw_for(h, w, s) == jsf.seg_hw_for(h, w, s)


def test_pick_seg_size(rng):
    frames = torch.from_numpy(rng.uniform(size=(2, 64, 64, 3)).astype(
        np.float32))

    def coarse(x, hw):
        h, w = (x.shape[1], x.shape[2]) if hw is None else hw
        yy = np.add.outer(np.arange(h) * 2 // h, np.arange(w) * 2 // w)
        return torch.from_numpy(np.broadcast_to(
            yy[None], (x.shape[0], h, w)).astype(np.int32))

    noise = np.random.default_rng(3)

    def noisy(x, hw):
        h, w = (x.shape[1], x.shape[2]) if hw is None else hw
        return torch.from_numpy(noise.integers(
            0, 150, size=(x.shape[0], h, w)).astype(np.int32))

    assert sf.pick_seg_size(None, frames, candidates=(32, 48),
                            segment_fn=coarse) == 32
    assert sf.pick_seg_size(None, frames, candidates=(32,),
                            segment_fn=noisy) == 0
    # with a real network: a legal answer, through the default segment_fn
    net = sf.SegFormer(TINY, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    assert sf.pick_seg_size(net, frames[:1], candidates=(32,)) in (0, 32)
