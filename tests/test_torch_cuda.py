"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor vstnet_tpu, so it also runs where only PyTorch is
installed: `python -m pytest tests/test_torch_cuda.py --noconftest -q`.

Shapes are small and ragged (tiles cut by the image edge, the smallest
image a reflect pad allows) to exercise the kernels' edge handling;
chip_smoke.py covers the main path's 512x512 shapes.

Tolerances: float32 within 1e-4 of the output's scale (the kernel and
cuDNN may sum in different orders); bf16 within 2 bf16 ulps of the
output's scale (one h1/h2 rounding flip plus the final rounding); the
float32 round trip through a kernel within 1e-5 of the output's scale.
The attention kernel (K4) rounds its probabilities to bf16 before P.V, so
a probability near a rounding boundary may flip; with M keys of weight
<= 1/M each that moves the output by far less than one bf16 ulp of its
scale, and 2 ulps are allowed. The depthwise conv + GELU kernel (K5)
rounds once: 1 bf16 ulp of the output's scale.
"""

import numpy as np
import pytest
import torch

from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.ops import attention as att
from vstnet_tpu_torch.ops import coupling_fused as cf
from vstnet_tpu_torch.ops import dwconv as dw
from vstnet_tpu_torch.ops.coupling import pixel_shuffle, pixel_unshuffle

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # true float32 plain convs
    yield torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _weights(gen, cin, mid, cout, device):
    return tuple(
        (torch.from_numpy((gen.standard_normal((co, ci, 3, 3)) * 0.2
                           * np.sqrt(16 / (9 * ci))).astype(np.float32)
                          ).to(device),
         torch.from_numpy((gen.standard_normal(co) * 0.1).astype(
             np.float32)).to(device))
        for ci, co in ((cin, mid), (mid, mid), (mid, cout)))


def _tol(ref, dt):
    scale = max(float(ref.float().abs().max()), 1.0)
    return 1e-4 * scale if dt == torch.float32 else 2 * 2.0 ** (
        np.floor(np.log2(scale)) - 7)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w", [(16, 40, 36), (64, 24, 20),
                                   (256, 16, 12), (16, 2, 34)])
def test_coupling_kernel_matches_plain(dev, gen, dt, c, h, w):
    wp = cf.pack_coupling_weights(_weights(gen, c, c // 4, c, dev), dt)
    x1 = torch.randn((2, c, h, w), device=dev).to(dt)
    x2 = torch.randn((2, c, h, w), device=dev).to(dt)
    before = cf.fused_coupling.launches
    for inverse in (False, True):
        got = cf.fused_coupling(x1, x2, wp, inverse)
        ref = cf.coupling_block_plain(x1, x2, wp, inverse)
        assert _err(got, ref) <= _tol(ref, dt)
    assert cf.fused_coupling.launches == before + 2
    if dt == torch.float32:
        y = cf.fused_coupling(x1, x2, wp)
        back = cf.fused_coupling(y, x2, wp, inverse=True)
        assert _err(back, x1) <= 1e-5 * max(float(y.abs().max()), 1.0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w", [(16, 36, 44), (64, 20, 24), (4, 4, 4)])
def test_transition_kernel_matches_plain(dev, gen, dt, c, h, w):
    wp = cf.pack_transition_weights(_weights(gen, c, c, 4 * c, dev), dt)
    x1 = torch.randn((2, c, h, w), device=dev).to(dt)
    x2 = torch.randn((2, c, h, w), device=dev).to(dt)
    g0, g1 = cf.fused_transition(x1, x2, wp)
    r0, r1 = cf.transition_block_plain(x1, x2, wp)
    assert torch.equal(g0, r0)
    assert _err(g1, r1) <= _tol(r1, dt)
    i0, i1 = cf.fused_transition(g1, g0, wp, inverse=True)
    j0, j1 = cf.transition_block_plain(g1, g0, wp, inverse=True)
    assert torch.equal(i1, x2) and torch.equal(j1, x2)
    assert _err(i0, j0) <= _tol(j0, dt)
    if dt == torch.float32:
        assert _err(i0, x1) <= 1e-5 * max(float(g1.abs().max()), 1.0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w", [(16, 36, 44), (64, 20, 24), (4, 4, 4)])
def test_half_res_transition_kernel(dev, gen, dt, c, h, w):
    """K3 against its plain version, and bit for bit against K2 on the
    same frames: K2(x1, x2) == K3(u(x1), u(x2)), forward and inverse."""
    wp = cf.pack_transition_weights(_weights(gen, c, c, 4 * c, dev), dt)
    x1 = torch.randn((2, c, h, w), device=dev).to(dt)
    x2 = torch.randn((2, c, h, w), device=dev).to(dt)
    a_u = pixel_unshuffle(x1).contiguous()
    b_u = pixel_unshuffle(x2).contiguous()
    before = cf.fused_transition_half.launches
    g0, g1 = cf.fused_transition_half(a_u, b_u, wp)
    r0, r1 = cf.transition_half_plain(a_u, b_u, wp)
    assert g0 is b_u and torch.equal(r0, b_u)
    assert _err(g1, r1) <= _tol(r1, dt)
    k0, k1 = cf.fused_transition(x1, x2, wp)
    assert torch.equal(k0, g0) and torch.equal(k1, g1)
    i0, i1 = cf.fused_transition_half(g1, g0, wp, inverse=True)
    j0, _ = cf.transition_half_plain(g1, g0, wp, inverse=True)
    assert i1 is g0
    assert _err(i0, j0) <= _tol(j0, dt)
    f0, f1 = cf.fused_transition(k1, k0, wp, inverse=True)
    assert torch.equal(pixel_shuffle(i0), f0) and torch.equal(f1, x2)
    assert cf.fused_transition_half.launches == before + 2
    if dt == torch.float32:
        assert _err(i0, a_u) <= 1e-5 * max(float(g1.abs().max()), 1.0)


@pytest.mark.parametrize("g,n,m", [(2, 200, 64), (3, 70, 36), (1, 130, 600),
                                   (1, 40, 1100), (1, 9, 8192)])
def test_attention_kernel_matches_plain(dev, g, n, m):
    """K4 at ragged shapes: N no multiple of the query tile, M no multiple
    of the key chunk, and every query-tile size from 64 rows down to 4."""
    gen = torch.Generator().manual_seed(g * 1000 + n + m)
    q, k, v = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
               for s in ((g, n, 64), (g, m, 64), (g, m, 64)))
    before = att.sr_attention.launches
    got = att.sr_attention(q, k, v, 0.125)
    ref = att.sr_attention_plain(q, k, v, 0.125)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _err(got, ref) <= _tol(ref, torch.bfloat16)
    assert att.sr_attention.launches == before + 1


def test_attention_kernel_reads_strided_views(dev):
    """The model's layout: q (B, N, heads, D) and k, v as the two halves
    of one (B, M, 2, heads, D) projection, read in place."""
    gen = torch.Generator().manual_seed(5)
    b, n, m, h = 2, 150, 40, 2
    q = torch.randn((b, n, h, 64), generator=gen).to(dev, torch.bfloat16)
    kv = torch.randn((b, m, 2, h, 64), generator=gen).to(dev, torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    got = att.sr_attention(q, k, v, 0.125)
    ref = att.sr_attention_plain(q, k, v, 0.125)
    assert got.shape == (b, n, h, 64) and got.is_contiguous()
    assert _err(got, ref) <= _tol(ref, torch.bfloat16)
    flat = att.sr_attention(
        q.permute(0, 2, 1, 3).reshape(b * h, n, 64).contiguous(),
        k.permute(0, 2, 1, 3).reshape(b * h, m, 64).contiguous(),
        v.permute(0, 2, 1, 3).reshape(b * h, m, 64).contiguous(), 0.125)
    assert torch.equal(flat.reshape(b, h, n, 64).permute(0, 2, 1, 3), got)
    with pytest.raises(ValueError):    # float32 is not routed to the kernel
        att.sr_attention(q.float(), k.float(), v.float(), 0.125)
    with pytest.raises(ValueError):    # head dim other than 64
        att.sr_attention(q[..., :32], k[..., :32], v[..., :32], 0.125)


@pytest.mark.parametrize("b,h,w,c", [(2, 9, 7, 128), (1, 1, 5, 256),
                                     (2, 16, 16, 2048), (1, 33, 20, 8)])
def test_dwconv_gelu_kernel_matches_plain(dev, b, h, w, c):
    gen = torch.Generator().manual_seed(c + h)
    x = torch.randn((b, h, w, c), generator=gen).to(dev, torch.bfloat16)
    taps = (torch.randn((3, 3, c), generator=gen) / 3).to(dev)
    bias = (torch.randn((c,), generator=gen) * 0.1).to(dev)
    before = dw.dwconv3x3_bias_gelu.launches
    got = dw.dwconv3x3_bias_gelu(x, taps, bias)
    ref = dw.dwconv3x3_bias_gelu_plain(x, taps, bias)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert _err(got, ref) <= _tol(ref, torch.bfloat16) / 2
    assert dw.dwconv3x3_bias_gelu.launches == before + 1
    assert torch.equal(dw.dwconv3x3_bias_gelu(x, taps[:, :, None], bias), got)
    with pytest.raises(ValueError):    # float32 is not routed to the kernel
        dw.dwconv3x3_bias_gelu(x.float(), taps, bias)


def test_segformer_kernel_route_matches_plain_route(dev):
    """SegFormer (depth 1 per stage) in bf16 at 384x384, where stage 1 has
    9216 queries and takes K4: the kernel route against the same network
    with both kernels swapped for their plain versions."""
    from vstnet_tpu_torch.models import segformer as sf

    net = sf.SegFormer((1, 1, 1, 1), device=dev).init_weights(
        torch.Generator().manual_seed(0))
    x = torch.rand((1, 384, 384, 3),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    k4, k5 = att.sr_attention.launches, dw.dwconv3x3_bias_gelu.launches
    got = sf.segment_logits(net, x, half=True)
    assert att.sr_attention.launches == k4 + 1
    assert dw.dwconv3x3_bias_gelu.launches == k5 + 4
    saved = sf.sr_attention, sf.dwconv3x3_bias_gelu
    sf.sr_attention = att.sr_attention_plain
    sf.dwconv3x3_bias_gelu = dw.dwconv3x3_bias_gelu_plain
    try:
        ref = sf.segment_logits(net, x, half=True)
    finally:
        sf.sr_attention, sf.dwconv3x3_bias_gelu = saved
    assert att.sr_attention.launches == k4 + 1
    scale = float(ref.abs().max())
    assert _err(got, ref) <= 0.05 * scale
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    assert agree >= 0.98


def test_wrappers_reject_bad_inputs(dev, gen):
    wp = cf.pack_coupling_weights(_weights(gen, 16, 4, 16, dev))
    x = torch.randn((1, 16, 8, 8), device=dev)
    with pytest.raises(ValueError):  # not contiguous
        cf.fused_coupling(x.transpose(2, 3), x.transpose(2, 3), wp)
    with pytest.raises(ValueError):  # weights packed for another dtype
        cf.fused_coupling(x.bfloat16(), x.bfloat16(), wp)
    with pytest.raises(ValueError):  # weights on another device
        cf.fused_coupling(x, x, cf.pack_coupling_weights(
            _weights(gen, 16, 4, 16, "cpu")))
    with pytest.raises(ValueError):  # odd full-res size for a transition
        cf.fused_transition(
            torch.randn((1, 16, 9, 8), device=dev),
            torch.randn((1, 16, 9, 8), device=dev),
            cf.pack_transition_weights(_weights(gen, 16, 16, 64, dev)))


@pytest.mark.parametrize("w", [32, 56])
def test_fast_path_on_card_matches_standard_path(dev, w):
    cfg = RevResNetConfig(n_blocks=(2, 2, 2))
    net = RevResNet(cfg, device=dev).init_weights(
        torch.Generator().manual_seed(0))
    fast = rf.pack_revresnet(net)
    x = torch.rand((2, 32, w, 3), generator=torch.Generator().manual_seed(1))
    x = x.to(dev)
    cf.reset_launches()
    z = rf.encode_fast(fast, x, cfg)
    # half-res widths 16 and 8 (or 28 and 14) are no multiples of 128: both
    # stride-2 blocks take the half-res entry (K3)
    assert (cf.fused_coupling.launches, cf.fused_transition.launches,
            cf.fused_transition_half.launches) == (6, 0, 2)
    assert _err(z, net.encode(x)) <= 1e-5
    back = rf.decode_fast(fast, z, cfg)
    assert cf.fused_transition_half.launches == 4
    assert _err(back, x) <= 1e-5
    assert _err(back, net.decode(z)) <= 1e-5
