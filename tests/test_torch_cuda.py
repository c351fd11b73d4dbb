"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor vstnet_tpu, so it also runs where only PyTorch is
installed: `python -m pytest tests/test_torch_cuda.py --noconftest -q`.

Shapes are small and ragged (tiles cut by the image edge, the smallest
image a reflect pad allows) to exercise the kernels' edge handling;
chip_smoke.py covers the main path's 512x512 shapes.

Tolerances: float32 within 1e-4 of the output's scale (the kernel and
cuDNN may sum in different orders); bf16 within 2 bf16 ulps of the
output's scale (one h1/h2 rounding flip plus the final rounding; the
tensor-core kernels sum in another order than the plain versions, so bit
identity is not expected); the float32 round trip through a kernel within
1e-5 of the output's scale; the bf16 round trip through the tensor-core
coupling kernel within 2 bf16 ulps of the stream's scale (F cancels bit
for bit, the two roundings of y and x1 remain); the same for the
tensor-core transition kernel.
The attention kernel (K4), and the SDPA route at the stages K4 is not
routed to, round their probabilities to bf16 before P.V, so
a probability near a rounding boundary may flip; with M keys of weight
<= 1/M each that moves the output by far less than one bf16 ulp of its
scale, and 2 ulps are allowed. The depthwise conv + GELU kernel (K5)
rounds once: 1 bf16 ulp of the output's scale. The regional moments
kernel sums exact products in float64 in another order than the plain
loops: within 1e-12 of the plain float64 sums' max; the regional apply
sums in float32 in another order and rounds once: 2 ulps of the latent's
dtype at the output's scale.
"""

import numpy as np
import pytest
import torch

from chip_smoke import F32_TAILS
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
                                   (256, 16, 12), (16, 2, 34),
                                   (256, 20, 36), (256, 7, 45), (64, 40, 36),
                                   (64, 2, 2), (64, 33, 5), (16, 70, 33),
                                   (16, 5, 100), (32, 20, 24),
                                   (256, 180, 320), (256, 256, 256),
                                   (256, 24, 72), (256, 2, 40),
                                   (256, 10, 24)])
def test_coupling_kernel_matches_plain(dev, gen, dt, c, h, w):
    """Both K1 routes (bf16 at C=256, C=64 and C=16 is a tensor-core kernel;
    float32 and C=32 the CUDA-core one) at sizes with tails and with H or W
    below the tile. At C=256 the 720p stage-3 plane, a 4K tile's, a width
    no 32-column tile divides, H=2, and both sides below the 12x32 tile of
    the warpgroup kernel, whose own count rises with every C=256 bf16
    launch and with no other."""
    wp = cf.pack_coupling_weights(_weights(gen, c, c // 4, c, dev), dt)
    x1 = torch.randn((2, c, h, w), device=dev).to(dt)
    x2 = torch.randn((2, c, h, w), device=dev).to(dt)
    before = cf.coupling_launches()
    mma_before = cf.fused_coupling.mma_launches
    fma_before = cf.fused_coupling.fma_launches
    wg_before = cf.fused_coupling.wg_launches
    for inverse in (False, True):
        got = cf.fused_coupling(x1, x2, wp, inverse)
        ref = cf.coupling_block_plain(x1, x2, wp, inverse)
        assert _err(got, ref) <= _tol(ref, dt)
    assert cf.coupling_launches() == before + 2
    mma = cf.coupling_route(dt, c, c // 4) == "mma"
    assert (cf.fused_coupling.mma_launches - mma_before,
            cf.fused_coupling.fma_launches - fma_before) == (
                (2, 0) if mma else (0, 2))
    assert cf.fused_coupling.wg_launches - wg_before == (
        2 if mma and (c, c // 4) == cf.MMA_WG else 0)
    if dt == torch.float32:
        y = cf.fused_coupling(x1, x2, wp)
        back = cf.fused_coupling(y, x2, wp, inverse=True)
        assert _err(back, x1) <= 1e-5 * max(float(y.abs().max()), 1.0)


@pytest.mark.parametrize("c,h,w", [(256, 20, 36), (64, 40, 36), (64, 9, 50),
                                   (16, 70, 33), (16, 32, 64),
                                   (256, 180, 320), (256, 256, 256),
                                   (256, 24, 72), (256, 2, 40),
                                   (256, 10, 24)])
def test_coupling_mma_forward_then_inverse(dev, gen, c, h, w):
    """The tensor-core route in bf16: inverse(forward(x1)) against x1. The
    inverse recomputes F bit for bit, so only the roundings of y and of
    the restored x1 remain; and the launch is deterministic."""
    bf = torch.bfloat16
    assert cf.coupling_route(bf, c, c // 4) == "mma"
    wp = cf.pack_coupling_weights(_weights(gen, c, c // 4, c, dev), bf)
    x1 = torch.randn((2, c, h, w), device=dev).to(bf)
    x2 = torch.randn((2, c, h, w), device=dev).to(bf)
    y = cf.fused_coupling(x1, x2, wp)
    assert torch.equal(y, cf.fused_coupling(x1, x2, wp))
    back = cf.fused_coupling(y, x2, wp, inverse=True)
    assert _err(back, x1) <= _tol(y, bf)
    # F itself is the same bits both ways: y - x1' and y - x1 share it
    f_fwd = cf.fused_coupling(torch.zeros_like(x1), x2, wp)
    f_inv = cf.fused_coupling(torch.zeros_like(x1), x2, wp, inverse=True)
    assert torch.equal(f_fwd, -f_inv)


# (kernel, C, H, W, B, cuDNN) of the CUDA-core kernels' exactness checks:
# chip_smoke.py's float32 F32_TAILS (the shapes and why cuDNN is on or off
# are explained there) and bf16 at C=32, a width the tensor-core kernels
# are not built for, through the same file
_FMA_CASES = [*F32_TAILS, ("K1", 32, 20, 24, 1, True)]


@pytest.mark.parametrize("kind,c,h,w,b,cudnn", _FMA_CASES,
                         ids=[f"{k}-C{c}-{h}x{w}-B{b}"
                              for k, c, h, w, b, _ in _FMA_CASES])
def test_cuda_core_kernels_equal_plain(dev, gen, kind, c, h, w, b, cudnn):
    """float32 K1, K2 and K3 (csrc/coupling.cu, csrc/transition.cu) equal
    their plain versions bit for bit (each output sums ci, then ky, then
    kx from 0, as the plain convs do at these shapes), forward and
    inverse, and the round trip restores the input within 1e-5 of the
    output's scale; K2(x1, x2) == K3(u(x1), u(x2)). bf16 at C=32 within
    2 ulps of the output's scale."""
    dt = torch.float32 if c != 32 else torch.bfloat16
    exact = dt == torch.float32
    x1 = torch.randn((b, c, h, w), device=dev).to(dt)
    x2 = torch.randn((b, c, h, w), device=dev).to(dt)

    def same(got, ref):
        assert torch.equal(got, ref) if exact else (
            _err(got, ref) <= _tol(ref, dt))

    if kind == "K1":
        wp = cf.pack_coupling_weights(_weights(gen, c, c // 4, c, dev), dt)
        assert cf.coupling_route(dt, c, c // 4) == "fma"
        y = cf.fused_coupling(x1, x2, wp)
        back = cf.fused_coupling(y, x2, wp, inverse=True)
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            same(y, cf.coupling_block_plain(x1, x2, wp))
            same(back, cf.coupling_block_plain(y, x2, wp, inverse=True))
        assert _err(back, x1) <= (1e-5 * max(float(y.abs().max()), 1.0)
                                  if exact else _tol(y, dt))
        return
    wp = cf.pack_transition_weights(_weights(gen, c, c, 4 * c, dev), dt)
    assert cf.transition_route(dt, c, c) == "fma"
    g0, g1 = cf.fused_transition(x1, x2, wp)
    r0, r1 = cf.transition_block_plain(x1, x2, wp)
    assert torch.equal(g0, r0)
    same(g1, r1)
    i0, i1 = cf.fused_transition(g1, g0, wp, inverse=True)
    same(i0, cf.transition_block_plain(g1, g0, wp, inverse=True)[0])
    assert torch.equal(i1, x2)
    assert _err(i0, x1) <= 1e-5 * max(float(g1.abs().max()), 1.0)
    a_u = pixel_unshuffle(x1).contiguous()
    b_u = pixel_unshuffle(x2).contiguous()
    h0, h1 = cf.fused_transition_half(a_u, b_u, wp)
    same(h1, cf.transition_half_plain(a_u, b_u, wp)[1])
    assert h0 is b_u and torch.equal(h1, g1)
    m0, _ = cf.fused_transition_half(h1, h0, wp, inverse=True)
    same(m0, cf.transition_half_plain(h1, h0, wp, inverse=True)[0])
    assert torch.equal(pixel_shuffle(m0), i0)


def _transition_counts():
    """Launches of K2's and K3's kernels: (K2 CUDA cores, K2 tensor cores,
    K3 CUDA cores, K3 tensor cores)."""
    return [cf.fused_transition.fma_launches,
            cf.fused_transition.mma_launches,
            cf.fused_transition_half.fma_launches,
            cf.fused_transition_half.mma_launches]


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
    before = _transition_counts()
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
    # two launches of each entry, all on the kernel the route names
    mma = cf.transition_route(dt, c, c) == "mma"
    assert [n - b for n, b in zip(_transition_counts(), before)] == (
        [0, 2, 0, 2] if mma else [2, 0, 2, 0])
    if dt == torch.float32:
        assert _err(i0, a_u) <= 1e-5 * max(float(g1.abs().max()), 1.0)


@pytest.mark.parametrize("c", [64, 16])
@pytest.mark.parametrize("h,w", [(100, 136), (4, 4), (34, 70), (6, 90),
                                 (64, 32), (36, 4)])
def test_transition_mma_kernel(dev, gen, c, h, w):
    """The tensor-core transition kernel (bf16, C = M = 64 and 16) at sizes
    whose half-res planes cut the 16x16 tile on both axes, fit it exactly or
    lie below it: K2 forward and inverse against the plain version, the
    pass-through streams exact, K2 == K3 on unshuffled streams bit for bit,
    every launch counted on the tensor-core kernel, the launch
    deterministic, and inverse(forward(x1)) back at x1 within the roundings
    of y and x1 (F is recomputed bit for bit)."""
    bf = torch.bfloat16
    assert cf.transition_route(bf, c, c) == "mma"
    wp = cf.pack_transition_weights(_weights(gen, c, c, 4 * c, dev), bf)
    x1 = torch.randn((2, c, h, w), device=dev).to(bf)
    x2 = torch.randn((2, c, h, w), device=dev).to(bf)
    before = _transition_counts()
    g0, g1 = cf.fused_transition(x1, x2, wp)
    r0, r1 = cf.transition_block_plain(x1, x2, wp)
    assert torch.equal(g0, r0)
    assert _err(g1, r1) <= _tol(r1, bf)
    i0, i1 = cf.fused_transition(r1, r0, wp, inverse=True)
    j0, j1 = cf.transition_block_plain(r1, r0, wp, inverse=True)
    assert torch.equal(i1, j1) and torch.equal(i1, x2)
    assert _err(i0, j0) <= _tol(j0, bf)
    assert torch.equal(g1, cf.fused_transition(x1, x2, wp)[1])
    back, x2_back = cf.fused_transition(g1, g0, wp, inverse=True)
    assert torch.equal(x2_back, x2)
    assert _err(back, x1) <= _tol(g1, bf)
    a_u = pixel_unshuffle(x1).contiguous()
    b_u = pixel_unshuffle(x2).contiguous()
    k0, k1 = cf.fused_transition_half(a_u, b_u, wp)
    assert k0 is b_u and torch.equal(k1, g1)
    assert _err(k1, cf.transition_half_plain(a_u, b_u, wp)[1]) <= _tol(r1, bf)
    m0, m1 = cf.fused_transition_half(g1, g0, wp, inverse=True)
    assert m1 is g0 and torch.equal(pixel_shuffle(m0), back)
    assert [n - b for n, b in zip(_transition_counts(), before)] == [
        0, 4, 0, 2]
    # F itself is the same bits both ways
    zero = torch.zeros_like(a_u)
    assert torch.equal(cf.fused_transition_half(zero, b_u, wp)[1],
                       -cf.fused_transition_half(zero, b_u, wp,
                                                 inverse=True)[0])


def test_transition_mma_widths_and_float32_stay_on_cuda_cores(dev, gen):
    """bf16 at a width the tensor-core kernel is not built for, and float32
    at one it is, launch csrc/transition.cu."""
    for dt, c in ((torch.bfloat16, 32), (torch.float32, 64)):
        wp = cf.pack_transition_weights(_weights(gen, c, c, 4 * c, dev), dt)
        assert "mma" not in wp
        x1 = torch.randn((1, c, 12, 20), device=dev).to(dt)
        x2 = torch.randn((1, c, 12, 20), device=dev).to(dt)
        before = _transition_counts()
        _, g1 = cf.fused_transition(x1, x2, wp)
        assert _err(g1, cf.transition_block_plain(x1, x2, wp)[1]) <= _tol(
            g1, dt)
        assert [n - b for n, b in zip(_transition_counts(), before)] == [
            1, 0, 0, 0]


@pytest.mark.parametrize("g,n,m", [(2, 200, 64), (3, 70, 36), (1, 130, 600),
                                   (1, 40, 1100), (1, 9, 8192),
                                   (2, 257, 33), (1, 128, 1), (2, 300, 97),
                                   (1, 513, 4096)])
def test_attention_kernel_matches_plain(dev, g, n, m):
    """K4 at ragged shapes: N no multiple of the 128-row query tile, M no
    multiple of 16, of the 32-key score tile or of the 64-key stage, M
    below one tile and M at the largest the wrapper takes."""
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


def _model_views(dev, seed, b, heads, n, m):
    """q a (B, N, heads, 64) view of a q projection, k and v views of one
    (B, M, 2, heads, 64) kv projection, bf16, drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, n, heads * 64), generator=gen, device=dev,
                    dtype=torch.bfloat16).view(b, n, heads, 64)
    kv = torch.randn((b, m, 2 * heads * 64), generator=gen, device=dev,
                     dtype=torch.bfloat16).view(b, m, 2, heads, 64)
    return q, kv[:, :, 0], kv[:, :, 1]


@pytest.mark.parametrize("b,heads,n,m", [(8, 5, 3600, 880),
                                         (8, 8, 920, 920), (2, 2, 130, 33)],
                         ids=["stage3-720p", "stage4-720p", "ragged"])
def test_attention_sdpa_route_matches_plain(dev, b, heads, n, m):
    """The SDPA route (flash) in the model's views at the auto-seg cell's
    stage-3 and stage-4 shapes, and a ragged one, against the plain
    version within K4's two bf16 ulps, taken at the output's own largest
    magnitude (no floor at 1.0): one counted call, no K4 launch. On an
    H100 the route lies 0.5 to 1 ulp from the plain version at these
    shapes; dropping one key moves the output by 25 ulps or more, and
    a scale 1 % off by 3 or more."""
    q, k, v = _model_views(dev, n + m, b, heads, n, m)
    k4, before = att.sr_attention.launches, att.sr_attention_sdpa.launches
    got = att.sr_attention_sdpa(q, k, v, 0.125)
    ref = att.sr_attention_plain(q, k, v, 0.125)
    tol = 2 * 2.0 ** (np.floor(np.log2(float(ref.float().abs().max()))) - 7)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _err(got, ref) <= tol
    assert att.sr_attention_sdpa.launches == before + 1
    assert att.sr_attention.launches == k4
    flat = att.sr_attention_sdpa(
        *(t.permute(0, 2, 1, 3).reshape(b * heads, -1, 64).contiguous()
          for t in (q, k, v)), 0.125)
    assert _err(flat.reshape(b, heads, n, 64).permute(0, 2, 1, 3),
                ref) <= tol


def test_segment_720p_keeps_k4_and_takes_the_new_routes(dev):
    """One bf16 segment call of SegFormer-B4 at 1280x720: K4's launches
    are those of stages 1 and 2 (3 + 8, as before), the SDPA route's those
    of stages 3 and 4 (27 + 3), K5 one a block, one fused upsample and
    argmax; its mask equals the plain upsample and argmax of its logits."""
    from vstnet_tpu_torch import ops
    from vstnet_tpu_torch.models import segformer as sf

    net = sf.SegFormer(device=dev).init_weights(
        torch.Generator().manual_seed(0))
    x = torch.rand((2, 720, 1280, 3), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(1))
    before = ops.launch_counts()
    mask = sf.segment_mask(net, x, half=True)
    after = ops.launch_counts()
    assert {k: v - before[k] for k, v in after.items() if v != before[k]} \
        == {"attention": 3 + 8, "attention_sdpa": 27 + 3,
            "dwconv_gelu": 41, "upsample_argmax": 1}
    want = sf.segment_logits(net, x, half=True).argmax(-1)
    assert mask.dtype == torch.int32 and torch.equal(mask, want.int())


def _near_ties(dev, b, h, w):
    """Logits whose classes 0 and 1 lie within an ulp of each other at
    every pixel and above the rest: the blend's rounding decides."""
    gen = torch.Generator(device=dev).manual_seed(h * w)
    base = torch.randn((b, h, w, 1), generator=gen, device=dev) + 3.0
    step = torch.randint(-1, 2, base.shape, generator=gen, device=dev)
    near = torch.nextafter(base, base + step.float())
    rest = torch.full((b, h, w, 148), -10.0, device=dev)
    return torch.cat([base, near, rest], dim=-1)


@pytest.mark.parametrize("b,h,w,big_h,big_w,ties", [
    (8, 180, 320, 720, 1280, False), (8, 180, 320, 720, 1280, True),
    (2, 17, 23, 67, 91, False), (2, 45, 80, 100, 170, True),
    (1, 45, 80, 90, 160, False), (3, 1, 1, 4, 4, False),
    (1, 7, 130, 28, 520, False)],
    ids=["720p", "720p-ties", "ragged", "ragged-ties", "twofold", "one",
         "wide"])
def test_upsample_argmax_matches_resize_argmax(dev, b, h, w, big_h, big_w,
                                               ties):
    """The fused upsample and argmax against resize_bilinear(...).argmax
    on seeded logits: the masks are integer-equal, or every pixel that
    differs has its two largest upsampled logits within one float32 ulp
    (the count is printed). One launch."""
    from vstnet_tpu_torch.ops import upsample_argmax as ua
    from vstnet_tpu_torch.ops.resize import resize_bilinear

    if ties:
        logits = _near_ties(dev, b, h, w)
    else:
        logits = torch.randn((b, h, w, 150), device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(b * h * w)) * 4
    before = ua.upsample_argmax.launches
    got = ua.upsample_argmax(logits, big_h, big_w)
    assert ua.upsample_argmax.launches == before + 1
    up = resize_bilinear(logits, big_h, big_w)
    ref = up.argmax(-1).to(torch.int32)
    assert got.shape == ref.shape and got.dtype == torch.int32
    off = got != ref
    top2 = up[off].topk(2, dim=-1).values
    ulp = torch.nextafter(top2[:, 0], top2[:, 0] + 1) - top2[:, 0]
    print(f"upsample_argmax {tuple(logits.shape)} -> {big_h}x{big_w}: "
          f"{int(off.sum())} of {off.numel()} pixels differ")
    assert bool((top2[:, 0] - top2[:, 1] <= ulp).all())


@pytest.mark.parametrize("b,h,w,c", [
    (2, 9, 7, 128), (1, 1, 5, 256), (2, 16, 16, 2048), (1, 33, 20, 8),
    # the MixFFN shapes of 512x512 frames, and of 1024x1024 frames
    (2, 128, 128, 256), (2, 64, 64, 512), (2, 32, 32, 1280),
    (1, 256, 256, 256), (1, 128, 128, 512), (1, 64, 64, 1280),
    (1, 32, 32, 2048),
    # tiles cut by the image on both axes, one row, one column, one pixel
    (3, 45, 80, 256), (1, 7, 129, 512), (2, 23, 17, 1280), (1, 1, 1, 256),
    (2, 13, 1, 128), (1, 12, 9, 2048),
    # C a multiple of 8 but not of the kernel's channel slab
    (1, 17, 40, 200), (2, 11, 9, 8), (1, 20, 6, 72)])
def test_dwconv_gelu_kernel_matches_plain(dev, b, h, w, c):
    """K5 against its plain version: within one bf16 ulp of the output's
    scale, and bit for bit, since both sum the nine taps in (ky, kx) order
    with fused multiply-adds from 0 and take the same erff."""
    gen = torch.Generator().manual_seed(c + h)
    x = torch.randn((b, h, w, c), generator=gen).to(dev, torch.bfloat16)
    taps = (torch.randn((3, 3, c), generator=gen) / 3).to(dev)
    bias = (torch.randn((c,), generator=gen) * 0.1).to(dev)
    before = dw.dwconv3x3_bias_gelu.launches
    got = dw.dwconv3x3_bias_gelu(x, taps, bias)
    ref = dw.dwconv3x3_bias_gelu_plain(x, taps, bias)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert _err(got, ref) <= _tol(ref, torch.bfloat16) / 2
    assert torch.equal(got, ref)
    assert dw.dwconv3x3_bias_gelu.launches == before + 1
    assert torch.equal(dw.dwconv3x3_bias_gelu(x, taps[:, :, None], bias), got)
    with pytest.raises(ValueError):    # float32 is not routed to the kernel
        dw.dwconv3x3_bias_gelu(x.float(), taps, bias)


def test_segformer_kernel_route_matches_plain_route(dev):
    """SegFormer (depth 1 per stage) in bf16 at 384x384, where stage 1 has
    9216 queries and takes K4 and stages 2-4 take the SDPA route: the
    kernel route against the same network with K4, the SDPA route and K5
    swapped for their plain versions."""
    from vstnet_tpu_torch.models import segformer as sf

    net = sf.SegFormer((1, 1, 1, 1), device=dev).init_weights(
        torch.Generator().manual_seed(0))
    x = torch.rand((1, 384, 384, 3),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    k4, k5 = att.sr_attention.launches, dw.dwconv3x3_bias_gelu.launches
    sdpa = att.sr_attention_sdpa.launches
    got = sf.segment_logits(net, x, half=True)
    assert att.sr_attention.launches == k4 + 1
    assert dw.dwconv3x3_bias_gelu.launches == k5 + 4
    assert att.sr_attention_sdpa.launches == sdpa + 3
    saved = sf.sr_attention, sf.sr_attention_sdpa, sf.dwconv3x3_bias_gelu
    sf.sr_attention = att.sr_attention_plain
    sf.sr_attention_sdpa = att.sr_attention_plain
    sf.dwconv3x3_bias_gelu = dw.dwconv3x3_bias_gelu_plain
    try:
        ref = sf.segment_logits(net, x, half=True)
    finally:
        (sf.sr_attention, sf.sr_attention_sdpa,
         sf.dwconv3x3_bias_gelu) = saved
    assert att.sr_attention.launches == k4 + 1
    assert att.sr_attention_sdpa.launches == sdpa + 3
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
    flat = torch.randn(1 + 4 * 4 * 8, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):  # not 16-byte aligned: no TMA copy
        dw.dwconv3x3_bias_gelu(flat[1:].view(1, 4, 4, 8),
                               torch.ones((3, 3, 8), device=dev),
                               torch.zeros((8,), device=dev))


@pytest.mark.parametrize("w", [32, 56, 512])
def test_fast_path_on_card_matches_standard_path(dev, w):
    """Float32 fast path against the standard path. Half-res widths 16 and 8
    (or 28 and 14) are no multiples of 128, so both stride-2 blocks take the
    half-res entry (K3); at w = 512 (256 and 128) both take K2."""
    cfg = RevResNetConfig(n_blocks=(2, 2, 2))
    net = RevResNet(cfg, device=dev).init_weights(
        torch.Generator().manual_seed(0))
    fast = rf.pack_revresnet(net)
    x = torch.rand((2, 32, w, 3), generator=torch.Generator().manual_seed(1))
    x = x.to(dev)
    enc, dec = (([2, 0, 0, 0], [4, 0, 0, 0]) if w == 512
                else ([0, 0, 2, 0], [0, 0, 4, 0]))
    cf.reset_launches()
    z = rf.encode_fast(fast, x, cfg)
    assert cf.fused_coupling.fma_launches == 6
    assert _transition_counts() == enc
    assert _err(z, net.encode(x)) <= 1e-5
    back = rf.decode_fast(fast, z, cfg)
    assert _transition_counts() == dec
    assert _err(back, x) <= 1e-5
    assert _err(back, net.decode(z)) <= 1e-5


@pytest.mark.parametrize("w,want", [(104, [0, 0, 0, 4]),
                                    (512, [0, 4, 0, 0])])
def test_fast_path_bf16_takes_the_tensor_core_kernels(dev, w, want):
    """PHOTO widths at depth 1 in bf16: every block of encode and decode
    runs on a tensor-core kernel, through the stride-2 entry the frame's
    width selects (K3 at w = 104, K2 at w = 512)."""
    cfg = RevResNetConfig(n_blocks=(1, 1, 1))
    net = RevResNet(cfg, device=dev).init_weights(
        torch.Generator().manual_seed(0))
    x = torch.rand((2, 72, w, 3),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    fast = rf.pack_revresnet(net, torch.bfloat16)
    cf.reset_launches()
    z = rf.encode_fast(fast, x.bfloat16(), cfg)
    back = rf.decode_fast(fast, z, cfg)
    assert _transition_counts() == want
    assert cf.fused_coupling.fma_launches == 0
    assert cf.fused_coupling.mma_launches > 0
    mse = float(((back.float() - x) ** 2).mean())
    assert 10 * np.log10(1.0 / mse) > 45.0


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_float32_transition_sums_in_its_plain_versions_order(dev, gen,
                                                             inverse):
    """The 640x360 frame's T2 block (C=64, full-res 180x320, half-res width
    160) in float32, where cuDNN would take an FFT for the plain version's
    second conv: the plain version runs PyTorch's own conv there, which
    sums in the kernel's order, so K2 and K3 equal it bit for bit."""
    wp = cf.pack_transition_weights(_weights(gen, 64, 64, 256, dev),
                                    torch.float32)
    x1, x2 = (torch.from_numpy(gen.standard_normal(
        (2, 64, 180, 320)).astype(np.float32)).to(dev) for _ in range(2))
    if inverse:
        x1, x2 = cf.transition_block_plain(x1, x2, wp)[::-1]
    got = cf.fused_transition(x1, x2, wp, inverse=inverse)
    want = cf.transition_block_plain(x1, x2, wp, inverse=inverse)
    assert all(torch.equal(g, r) for g, r in zip(got, want))
    a_u, b_u = (pixel_unshuffle(x).contiguous() for x in (x1, x2))
    if inverse:
        a_u, b_u = x1, x2
    got = cf.fused_transition_half(a_u, b_u, wp, inverse=inverse)
    want = cf.transition_half_plain(a_u, b_u, wp, inverse=inverse)
    assert all(torch.equal(g, r) for g, r in zip(got, want))


def test_photo_forward_fast_on_card_matches_float32(dev):
    """photo_forward_fast through the bf16 kernels against the float32
    photo_forward at 64x64, global and under masks: >= 40 dB."""
    from vstnet_tpu_torch.models import pipeline

    cfg = RevResNetConfig(n_blocks=(1, 1, 1))
    net = RevResNet(cfg, device=dev).init_weights(
        torch.Generator().manual_seed(0))
    fast = rf.pack_revresnet(net, torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    small = torch.rand((2, 3, 8, 8), generator=g)
    img = torch.nn.functional.interpolate(small, size=(64, 64),
                                          mode="bilinear").permute(0, 2, 3, 1)
    c, s = img[:1].contiguous().to(dev), img[1:].contiguous().to(dev)
    mask = torch.zeros((1, 64, 64), dtype=torch.int32)
    mask[:, :, 32:] = 3
    mask = mask.to(dev)
    for use_masks in (False, True):
        cf.reset_launches()
        got = pipeline.photo_forward_fast(fast, c, s, mask, mask, cfg,
                                          max_labels=8, use_masks=use_masks)
        assert cf.fused_coupling.mma_launches > 0
        want = pipeline.photo_forward(net, c, s, mask, mask, max_labels=8,
                                      use_masks=use_masks)
        mse = float(((got - want) ** 2).mean())
        assert 10 * np.log10(1.0 / mse) >= 40.0


def test_interpolation_float64_retry_on_card(dev):
    """robust_cholesky(use_double=True) retries on the card in float64: a
    covariance whose float32 factorisation fails every jitter gets a
    finite factor equal to the CPU's; interpolation with the retry stays
    finite."""
    from vstnet_tpu_torch.models import cwct

    n = 10
    hil = torch.tensor([[1.0 / (i + j + 1) for j in range(n)]
                        for i in range(n)], dtype=torch.float32)
    assert torch.isnan(cwct.robust_cholesky(hil.to(dev), attempts=1)).all()
    got = cwct.robust_cholesky(hil.to(dev), attempts=1, use_double=True)
    assert got.is_cuda and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    want = cwct.robust_cholesky(hil, attempts=1, use_double=True)
    assert _err(got.cpu(), want) <= 1e-5
    z = torch.from_numpy(_latent(4, 8, 8, 32)).to(dev)
    zs = torch.from_numpy(_latent(2, 8, 8, 32)).reshape(2, 1, 8, 8, 32)
    out = cwct.interpolation(z, zs.to(dev), [0.4, 0.6], alpha_c=0.2,
                             use_double=True)
    assert out.shape == z.shape and torch.isfinite(out).all()
    ref = cwct.interpolation(z.cpu(), zs, [0.4, 0.6], alpha_c=0.2,
                             use_double=True)
    assert _err(out.cpu(), ref) <= 1e-4 * max(float(ref.abs().max()), 1.0)


def _latent(b, h, w, c):
    """An NHWC latent with correlated channels, from a fixed seed."""
    rng = np.random.default_rng(b)
    mix = rng.standard_normal((c, c)) / np.sqrt(c)
    x = rng.standard_normal((b, h * w, c)) @ mix.T
    return (x + rng.standard_normal((1, 1, c))).reshape(b, h, w, c).astype(
        np.float32)


def test_segmenter_replica_runs_k5_on_a_second_card(dev):
    """A Segmenter replicated to cuda:1 (parallel/sharding.replicate) lays
    out its bf16 twin and K5 taps there and launches K5 there; its masks
    equal those of the original on cuda:0."""
    from vstnet_tpu_torch.models import segformer as sf
    from vstnet_tpu_torch.parallel import replicate

    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    second = torch.device("cuda:1")
    seg = sf.Segmenter.load(None, depths=(1, 1, 1, 1), seed=3, device=dev)
    x = torch.rand((2, 128, 128, 3),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    want = sf.segment_mask(seg.net, x, half=True)
    _, rep = replicate((dev, second), seg)
    before = dw.dwconv3x3_bias_gelu.device_launches[("launches", 1)]
    got = sf.segment_mask(rep.net, x.to(second), half=True)
    assert dw.dwconv3x3_bias_gelu.device_launches[("launches", 1)] \
        == before + 4
    for m in rep.net.half_copy().modules():
        if isinstance(m, sf.MixFFN):
            assert m.taps.device == second
    assert torch.equal(got.cpu(), want.cpu())


def test_fused_program_over_two_replicas_on_one_card(dev):
    """parallel_stylize_fused over two replicas on cuda:0: every shard
    equals the single-device program on it, bit for bit, and the launches
    are twice one call's."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models.pipeline import make_fused_video_fn
    from vstnet_tpu_torch import ops
    from vstnet_tpu_torch.parallel import gather, parallel_stylize_fused

    cfg = RevResNetConfig(n_blocks=(1, 1, 1))
    net = RevResNet(cfg, device=dev).init_weights(
        torch.Generator().manual_seed(0))
    fast = rf.pack_revresnet(net, torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    frames = torch.rand((4, 64, 128, 3), generator=g).to(dev)
    style = torch.rand((1, 64, 64, 3), generator=g).to(dev)
    zs = rf.encode_fast(fast, style.to(torch.bfloat16), cfg,
                        packed_latent=True)
    ls, mu = cwct.style_factors_packed(zs, cfg.latent_channels)
    one = make_fused_video_fn(cfg, out_u8=True)
    ops.reset_launch_counts()
    ref = [one(fast, frames[i:i + 2], ls, mu) for i in (0, 2)]
    single = ops.launch_counts(dev)
    ops.reset_launch_counts()
    shards = parallel_stylize_fused((dev, dev), cfg, out_u8=True)(
        fast, frames, ls, mu)
    assert ops.launch_counts(dev) == single
    assert sum(single.values()) > 0
    for s, r in zip(shards, ref):
        assert torch.equal(s, r)
    assert gather(shards).shape == (4, 64, 128, 3)


@pytest.mark.parametrize("interp", [False, True], ids=["global", "alpha_c"])
def test_video_program_enqueues_without_waiting_for_the_card(dev, interp):
    """The global and alpha_c video programs never make the host wait for
    the device (torch.cuda's sync debug mode raises at such a call): a
    sharded call enqueues every card's shard before the first is done."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models.pipeline import make_fused_video_fn

    cfg = RevResNetConfig(n_blocks=(1, 1, 1))
    net = RevResNet(cfg, device=dev).init_weights(
        torch.Generator().manual_seed(0))
    fast = rf.pack_revresnet(net, torch.bfloat16)
    frames = torch.rand((2, 64, 64, 3),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    zs = rf.encode_fast(fast, frames[:1].to(torch.bfloat16), cfg,
                        packed_latent=True)
    ls, mu = cwct.style_factors_packed(zs, cfg.latent_channels)
    fn = make_fused_video_fn(cfg, out_u8=True, interp=interp)
    extra = (0.5,) if interp else ()
    fn(fast, frames, ls, mu, *extra)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(fast, frames, ls, mu, *extra)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_native_engine_on_card_matches_eager(dev, tmp_path):
    """The native tier on the card: a tiny stylize program packaged for
    CUDA runs through NativeEngine() (the card by default) within 1e-4 of
    the eager float32 program under true_f32; the CPU engine refuses the
    CUDA package rather than move it."""
    from vstnet_tpu_torch.models.pipeline import stylize
    from vstnet_tpu_torch.models.segformer import true_f32
    from vstnet_tpu_torch.runtime import export as ex
    from vstnet_tpu_torch.runtime import native

    cfg = RevResNetConfig(n_blocks=(1, 1, 1))
    net = RevResNet(cfg, device=dev).init_weights(
        torch.Generator().manual_seed(0)).eval()
    ep, _ = ex.export_stylize(net, cfg, 32, 48, device=dev)
    pkg = native.package_program(ep, tmp_path / "stylize.aoti.pt2")
    g = torch.Generator().manual_seed(1)
    c, s = (torch.rand((1, 32, 48, 3), generator=g) for _ in range(2))
    eng = native.NativeEngine()
    eng.load(pkg)
    assert eng.metadata("AOTI_DEVICE_KEY") == "cuda"
    assert "primary context active" in eng.device_info
    (got,) = eng.execute([c.numpy(), s.numpy()])
    eng.close()
    with torch.no_grad(), true_f32():
        want = stylize(net, c.to(dev), s.to(dev)).cpu().numpy()
    assert np.abs(got - want).max() <= 1e-4
    cpu = native.NativeEngine("cpu")
    with pytest.raises(RuntimeError, match="compiled for cuda"):
        cpu.load(pkg)


def test_row_sharded_train_step_on_card_matches_unsharded(dev):
    """parallel_train_step(rows=((cuda:0,) * 2)): one step of the temporal
    phase in float32 (TF32 off) with the image's rows over two replicas
    on the card, against train_step on the whole batch: parameters within
    3 lr of each other at the max and 1e-6 in the mean (Adam's first
    step turns a gradient sign flipped by the reduction order into a
    step of 2 lr), aux rtol 1e-4 / atol 2e-5."""
    from vstnet_tpu_torch.models.vgg import VGG
    from vstnet_tpu_torch.ops.warp import generate_fake_flow
    from vstnet_tpu_torch.parallel import parallel_train_step
    from vstnet_tpu_torch.train import trainer as tr
    from vstnet_tpu_torch.train.losses import LossWeights

    cfg = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
    tc = tr.TrainConfig(weights=LossWeights(lap=10.0))
    net = RevResNet(cfg, device=dev).init_weights(
        torch.Generator().manual_seed(0))
    vgg = VGG(device=dev).init_weights(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    a, s = (torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(
        np.float32)).to(dev) for _ in range(2))
    flow = torch.from_numpy(np.stack([generate_fake_flow(rng, 32, 32)
                                      for _ in range(2)])).to(dev)
    noise = torch.from_numpy((rng.normal(size=(2, 32, 32, 3)) * 1e-3)
                             .astype(np.float32)).to(dev)
    states = [tr.init_train_state(tc, dev, RevResNet(cfg, device=dev))
              for _ in range(2)]
    for st in states:
        st.net.load_state_dict(net.state_dict())
    with tr._no_tf32():
        want = tr.train_step(states[0], vgg, a, s, tc, flow, noise, True)
        got = parallel_train_step(states[1], vgg, a, s, tc, flow, noise,
                                  True, rows=(dev, dev))
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
    diff = torch.cat([(p - q).detach().abs().flatten() for p, q in zip(
        states[1].net.parameters(), states[0].net.parameters())])
    assert float(diff.max()) <= 3 * tc.lr
    assert float(diff.mean()) < 1e-6


def test_cwct_statistics_on_card_match_float64(dev):
    """The float32 cWCT on the card against float64, on the latents of
    chip_smoke.py's float32-vs-float64 training batch (PHOTO_CONFIG at full
    depth, weights from seed 0, _train_batch with seed 0 at 128x128 B=2;
    the covariances' condition numbers 5e3-6e3): the covariances of the
    whole latent and of two row shards within 5e-7 of their max, the
    transfer within 2e-5 of its max. Summed in float32 by cuBLAS, the
    covariances lay 4.2e-6 off (the CPU's float32 sums 2.0e-7) and the
    transfer 1.0e-4 (the CPU's 5.1e-6), which took the training step's
    gradient 1.04e-2 of a tensor's max from float64 (ROADMAP §3)."""
    from chip_smoke import _train_batch
    from vstnet_tpu_torch.config import PHOTO_CONFIG
    from vstnet_tpu_torch.models import cwct

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    net = RevResNet(PHOTO_CONFIG, device=dev).init_weights(
        torch.Generator().manual_seed(0)).double()
    a, s, _, _ = _train_batch(torch.Generator().manual_seed(0), 2, 128, dev)
    with torch.no_grad():
        zc, zs = net(a.double()), net(s.double())
    for z in (zc, zs):
        _, want = cwct._stats(cwct._nhwc_as_gcn(z))
        _, whole = cwct._stats(cwct._nhwc_as_gcn(z.float()))
        _, rows = cwct.row_stats(list(z.float().chunk(2, dim=1)))
        assert whole.dtype == rows.dtype == torch.float32
        assert rel(whole, want) <= 5e-7 and rel(rows, want) <= 5e-7
    got = cwct.transfer(zc.float(), zs.float())
    assert got.dtype == torch.float32
    assert rel(got, cwct.transfer(zc, zs)) <= 2e-5


def _region_rows(gen, b, n, c, k, dt, dev):
    """Rows (b, n, c) of a skewed latent in dt and their labels (b, n) in
    runs of 1-96 rows, on dev, with a label table of k slots: the sorted
    real labels, then -1 pads (three at k = 8). The last real label lies in
    no frame (an empty region), the one before it on one row a frame (a
    single pixel); runs of -2 (in no slot) lie between the others, one in
    the middle of every frame."""
    real = np.sort(gen.choice(150, size=max(2, k - 3), replace=False))
    table = np.concatenate([real, -np.ones(k - real.size, np.int64)])
    pool = np.concatenate([real[:-2], [-2]]) if real.size > 2 else [-2]
    m = np.empty((b, n), np.int32)
    for i in range(b):
        pos = 0
        while pos < n:
            run = int(gen.integers(1, 97))
            m[i, pos:pos + run] = gen.choice(pool)
            pos += run
        m[i, n // 2:n // 2 + 40] = -2
        m[i, gen.integers(n)] = real[-2]
    mix = gen.standard_normal((c, c)) / np.sqrt(c)
    x = gen.standard_normal((b, n, c)) @ mix + gen.standard_normal(c)
    return (torch.from_numpy(x.astype(np.float32)).to(dev, dt),
            torch.from_numpy(m).to(dev),
            torch.from_numpy(table.astype(np.int32)).to(dev))


def _region_cases():
    cases = [(32, k, dt, rows) for k in (8, 16, 32, 150)
             for dt in (torch.bfloat16, torch.float32) for rows in (None, 32)]
    return cases + [(128, k, dt, None) for k in (8, 32)
                    for dt in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("c,k,dt,rows", _region_cases())
def test_region_moments_kernel_matches_plain(dev, gen, c, k, dt, rows):
    """ops.regions.region_moments on a batch of 3 frames against
    cwct.region_moments_plain (float64 on the card) frame by frame: counts
    equal, sums and Gram within 1e-12 of the plain sums' max; an empty and
    a single-pixel region, -1 pad slots, rows labelled -2; rows=32 cuts a
    frame into chunks of one tile, so runs cross chunks. Two runs give the
    same bits, and the Gram is symmetric bit for bit."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.ops import regions

    x, m, labels = _region_rows(gen, 3, 5000, c, k, dt, dev)
    got = regions.region_moments(x, m, labels, rows=rows)
    again = regions.region_moments(x, m, labels, rows=rows)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    assert torch.equal(got[2], got[2].transpose(-1, -2))
    for i in range(3):
        want = cwct.region_moments_plain(x[i], m[i], labels)
        assert want[0].dtype == torch.float64
        assert torch.equal(got[0][i], want[0])
        for g, w in zip(got[1:], want[1:]):
            assert _err(g[i], w) <= 1e-12 * float(w.abs().max())
    real = int((labels >= 0).sum())
    for cnt in got[0]:
        assert float(cnt[real - 1]) == 0.0                  # empty region
        assert float(cnt[real - 2]) == 1.0                  # single pixel
        assert not cnt[labels < 0].any()


@pytest.mark.parametrize("c,k,dt,rows", _region_cases())
def test_region_apply_kernel_matches_plain(dev, gen, c, k, dt, rows):
    """ops.regions.apply_regions on a batch of 3 frames, each with its own
    transforms and a slot marked invalid, against cwct.apply_regions_plain
    frame by frame: within 2 ulps of x's dtype at the output's scale, and
    rows with no valid slot (the invalid region, -2, pads) equal to x."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.ops import regions

    x, m, labels = _region_rows(gen, 3, 5000, c, k, dt, dev)
    ts = torch.from_numpy((gen.standard_normal((3, k, c, c)) / np.sqrt(c))
                          .astype(np.float32)).to(dev)
    bs = torch.from_numpy(gen.standard_normal((3, k, c)).astype(
        np.float32)).to(dev)
    valids = (labels >= 0).expand(3, k).clone()
    valids[:, 0] = False
    got = regions.apply_regions(x, m, labels, ts, bs, valids, rows=rows)
    assert got.dtype == dt
    ulp = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -23
    for i in range(3):
        want = cwct.apply_regions_plain(x[i], m[i], labels, ts[i], bs[i],
                                        valids[i])
        scale = float(want.float().abs().max())
        assert _err(got[i], want) <= 2 * ulp * 2.0 ** np.floor(np.log2(scale))
        keep = ~((m[i, :, None] == labels) & valids[i]).any(dim=1)
        assert keep.any() and torch.equal(got[i][keep], x[i][keep])


def test_region_kernels_take_a_label_table_a_frame(dev, gen):
    """labels (B, K), one table a frame (transfer_masked's): each frame's
    moments and apply equal those with its own table alone."""
    from vstnet_tpu_torch.ops import regions

    x, m, labels = _region_rows(gen, 2, 3000, 32, 16, torch.bfloat16, dev)
    table = torch.stack([labels, labels.roll(3)])
    ts = torch.randn((2, 16, 32, 32), device=dev) / 6
    bs = torch.randn((2, 16, 32), device=dev)
    valids = table >= 0
    got = regions.region_moments(x, m, table)
    out = regions.apply_regions(x, m, table, ts, bs, valids)
    for i in range(2):
        one = regions.region_moments(x[i:i + 1], m[i:i + 1], table[i])
        for g, w in zip(got, one):
            assert torch.equal(g[i], w[0])
        assert torch.equal(out[i], regions.apply_regions(
            x[i:i + 1], m[i:i + 1], table[i], ts[i:i + 1], bs[i:i + 1],
            valids[i:i + 1])[0])


def test_masked_transfer_on_card_launches_each_kernel_once(dev, gen,
                                                          monkeypatch):
    """transfer_masked_factored on a bf16 batch of 8 frames: one launch of
    each regional kernel whatever K is, and the output within 2 bf16 ulps
    of its scale of the plain loops' (regions.takes False)."""
    from vstnet_tpu_torch import ops
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.ops import regions

    for k in (8, 32):
        x, m, labels = _region_rows(gen, 8, 64 * 96, 32, k, torch.bfloat16,
                                    dev)
        xs, ms, _ = _region_rows(gen, 1, 48 * 64, 32, k, torch.bfloat16,
                                 dev)
        real = int((labels >= 0).sum())
        ms[ms == -2] = labels[0]
        ms[0, :real] = labels[:real]        # the style holds every label
        region = cwct.style_region_factors(xs.reshape(1, 48, 64, 32),
                                           ms.reshape(1, 48, 64), k)
        feat, mask = x.reshape(8, 64, 96, 32), m.reshape(8, 64, 96)
        ops.reset_launch_counts()
        got = cwct.transfer_masked_factored(feat, mask, *region)
        counts = ops.launch_counts()
        assert (counts["region_moments"], counts["region_apply"]) == (1, 1)
        monkeypatch.setattr(regions, "takes", lambda x: False)
        want = cwct.transfer_masked_factored(feat, mask, *region)
        monkeypatch.undo()
        assert ops.launch_counts() == counts
        assert _err(got, want) <= _tol(want, torch.bfloat16)


def _tiler_on_cpu(probe):
    """The tiler's regional pass 1 replayed on the CPU from a
    chip_smoke._TilerRegionProbe's rows: the style's moments, each tile
    batch's owned rows' moments added up, the statistics, the transform
    and its apply, as models/ultra.py runs them, in the CPU's float32.
    Returns the same distances as chip_smoke.tiler_region_distances."""
    from chip_smoke import _cov_worst, _rel, region_f64, region_transfer_f64
    from vstnet_tpu_torch.models import cwct

    labels = probe.labels.cpu()
    rows = [(x.cpu(), m.cpu()) for x, m in probe.moments]
    st = cwct.stats_from_moments(*cwct.region_moments(*rows[0], labels))
    acc = None
    for x, m in rows[1:]:
        d = cwct.region_moments(x, m, labels)
        acc = d if acc is None else tuple(a + b for a, b in zip(acc, d))
    sc = cwct.stats_from_moments(*acc)
    xc = torch.cat([x for x, _ in rows[1:]])
    mc = torch.cat([m for _, m in rows[1:]])
    ref_s, ref_c = region_f64(*rows[0], labels), region_f64(xc, mc, labels)
    worst = max(_cov_worst(st, ref_s, ref_c, labels),
                _cov_worst(sc, ref_c, ref_s, labels))
    tsb = cwct.region_transforms(labels, *sc, *st)
    got = cwct.apply_regions(xc, mc, labels, *tsb)
    return worst, _rel(got, region_transfer_f64(xc, mc, ref_c, ref_s))


def test_region_statistics_on_card_match_float64(dev):
    """The regional cWCT's float32 statistics on the card against float64
    of the same values, on PHOTO_CONFIG at full depth (weights from seed
    0) and smooth frames (chip_smoke._frames), under synthetic label maps
    (chip_smoke.region_masks) at the capacity buckets 8 and 32, each with
    a 400-pixel region: the masked video program's bf16 latents at 512x512
    B=8 cast up to float32, the photo pipeline's float32 standard-path
    latent at 1024x1024 B=1 (style 512x512), and pass 1 of the 4K tiler
    (3840x2160 content, 1024x576 style, fused route). Each valid region's
    covariance within 5e-7 of its own max, transfer_masked's,
    transfer_masked_factored's and the tiler's transfer within 2e-5 of the
    float64 transfer's max, as the global cWCT's statistics. Every
    distance is printed beside the CPU's float32 one on the same values
    (run with -s to see them). On the card the moments and the apply run
    in the regional kernels (ops/regions.py), whose launches are checked."""
    from chip_smoke import (
        REGION_COV_GATE,
        REGION_TRANSFER_GATE,
        ULTRA_HW,
        ULTRA_STYLE,
        _frames,
        region_distances,
        region_masks,
        tiler_region_distances,
    )
    from vstnet_tpu_torch import ops
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models.pipeline import StyleModel

    model = StyleModel.random_init(seed=0, device=dev)
    cfg, fp = model.cfg, model.fast_params
    gen = torch.Generator().manual_seed(0)
    ops.reset_launch_counts()
    with torch.no_grad():
        frames, style = _frames(gen, 8, 512, dev), _frames(gen, 1, 512, dev)
        big = _frames(gen, 1, 1024, dev)
        cases = {
            "masked program 512x512 B=8 (bf16 latent)": tuple(
                rf.encode_fast(fp, x.to(torch.bfloat16), cfg).float()
                for x in (frames, style)),
            "photo pipeline 1024x1024 B=1 (float32 latent)": (
                model.net.encode(big), model.net.encode(style))}
        content4k = _frames(gen, 1, ULTRA_HW, dev)
        style4k = _frames(gen, 1, ULTRA_STYLE, dev)
    rows = []
    for what, (zc, zs) in cases.items():
        for k in (8, 32):
            cm = region_masks(1, k, *zc.shape[:3])
            sm = region_masks(2, k, *zs.shape[:3])
            assert cwct.label_capacity(cm, sm) == k
            card = region_distances(zc, zs, cm.to(dev), sm.to(dev), k)
            cpu = region_distances(zc.cpu(), zs.cpu(), cm, sm, k)
            rows.append((f"{what} K={k}", card[0], card[1:], cpu[0],
                         cpu[1:]))
    cm = region_masks(3, 32, 1, *ULTRA_HW).to(dev)
    sm = region_masks(4, 32, 1, *ULTRA_STYLE).to(dev)
    worst, tr, probe = tiler_region_distances(model, content4k, style4k, cm,
                                              sm)
    cpu = _tiler_on_cpu(probe)
    rows.append(("4K tiler pass 1 K=32 (bf16 latent)", worst, (tr,), cpu[0],
                 cpu[1:]))
    for what, cov, trs, cov_cpu, trs_cpu in rows:
        print(f"regional statistics {what} on {torch.cuda.get_device_name(0)}"
              f": covariance {cov:.3e} (CPU {cov_cpu:.3e}), transfer "
              + ", ".join(f"{a:.3e} (CPU {b:.3e})"
                          for a, b in zip(trs, trs_cpu)))
    for what, cov, trs, _, _ in rows:
        assert cov <= REGION_COV_GATE, what
        assert max(trs) <= REGION_TRANSFER_GATE, what
    counts = ops.launch_counts(dev)          # the card's sums: the kernels
    assert counts["region_moments"] and counts["region_apply"]


def _tiler_global_on_cpu(probe, z_style):
    """The global tiler's pass 1 replayed on the CPU from a
    chip_smoke._TilerGlobalProbe's rows: each tile batch's owned rows
    summed in float32 as models/ultra.py sums a batch on the CPU (the
    count, the sums, one addmm_ into the Gram), the statistics formed as
    Gram - n mean mean^T in float32, and the transfer against the CPU's
    style factors. Returns the same distances as
    chip_smoke.tiler_global_distances."""
    from types import SimpleNamespace

    from chip_smoke import tiler_global_distances

    rows = [x.cpu() for x in probe.rows]
    c = rows[0].shape[-1]
    n, s1, s2 = torch.zeros(()), torch.zeros(c), torch.zeros(c, c)
    for x in rows:
        n += x.shape[0]
        s1 += x.sum(dim=0)
        s2.addmm_(x.t(), x)
    mean = s1 / n
    cov = (s2 - n * torch.outer(mean, mean)) / (n - 1.0)
    return tiler_global_distances(
        SimpleNamespace(rows=rows, stats=[(mean, cov)]), z_style.cpu())


def test_tiled_global_statistics_on_card_match_float64(dev):
    """Pass 1 of the global 4K tiler (ultra._content_stats, as
    stylize_tiled and stylize_tiled_interp run it) against float64 of the
    same owned latent rows: PHOTO_CONFIG at full depth (weights from seed
    0), smooth frames (chip_smoke._frames), 3840x2160 content, 1024x576
    style, tile 1024, overlap 128, on the fused route (bf16 K1/K2 tile
    encodes, the latent cast up) and on the float32 standard route. The
    covariance within 5e-7 of its max and the transfer
    (transform_from_stats against the style's factors, applied to the
    rows) within 2e-5 of the float64 transfer's max, the bounds of the
    global and the regional cWCT. Every distance is printed beside the
    CPU's float32 one on the same rows (run with -s to see them)."""
    from chip_smoke import (
        REGION_COV_GATE,
        REGION_TRANSFER_GATE,
        ULTRA_HW,
        ULTRA_OVERLAP,
        ULTRA_STYLE,
        ULTRA_TILE,
        _frames,
        _TilerGlobalProbe,
        tiler_global_distances,
    )
    from vstnet_tpu_torch.models import ultra
    from vstnet_tpu_torch.models.pipeline import StyleModel

    model = StyleModel.random_init(seed=0, device=dev)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(0)
    content = _frames(gen, 1, ULTRA_HW, dev)
    style = _frames(gen, 1, ULTRA_STYLE, dev)
    grid = ultra._TileGrid(*ULTRA_HW, cfg, ULTRA_TILE, ULTRA_OVERLAP)
    rows = []
    for route, weights, fast in (("fused", model.fast_params, True),
                                 ("float32", model.net, False)):
        with torch.no_grad(), _TilerGlobalProbe() as probe:
            ultra._content_stats(grid, weights, content, cfg, fast,
                                 ultra.TILE_BATCH)
            zs = ultra._enc(weights, style, cfg, fast)
            card = tiler_global_distances(probe, zs)
            cpu = _tiler_global_on_cpu(probe, zs)
        assert len(probe.rows) == len(range(0, len(list(grid.tiles())),
                                            ultra.TILE_BATCH))
        rows.append((route, card, cpu))
        del probe
    for route, (cov, tr), (cov_cpu, tr_cpu) in rows:
        print(f"global tiler pass 1, {route} route, 4K on "
              f"{torch.cuda.get_device_name(0)}: covariance {cov:.3e} (CPU "
              f"{cov_cpu:.3e}), transfer {tr:.3e} (CPU {tr_cpu:.3e})")
    for route, (cov, tr), _ in rows:
        assert cov <= REGION_COV_GATE, route
        assert tr <= REGION_TRANSFER_GATE, route


def _graph_ops(ep):
    """(target, output dtype) of every call in an exported program."""
    return [(str(n.target), getattr(n.meta.get("val"), "dtype", None))
            for n in ep.graph.nodes if n.op == "call_function"]


def test_program_exported_off_the_card_matches_the_card_export(
        dev, monkeypatch):
    """The full-depth stylize program (PHOTO_CONFIG, weights from seed 0,
    512x512 B=1 float32: phase 13's and the export CLI's shape) traced on
    the CPU and moved to the card by load_exported, against the same
    program traced on the card: within 1e-6 of the card-traced output's
    max, since both sum the cWCT statistics in float64 (cwct._accumulate
    takes float64 for a float32 latent while torch.export traces, as on
    the card). Printed beside it: whether the two are bit-equal, and each
    one's distance from the float64 eager stylize of the same inputs. The
    card-traced graph is the one the card's device rule alone gives: the
    export rule changes no program traced on the card."""
    import copy
    import io

    from chip_smoke import _frames, _rel
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models.pipeline import StyleModel, stylize
    from vstnet_tpu_torch.runtime import export as ex

    model = StyleModel.random_init(seed=0, device=dev)
    net, cfg, hw = model.net, model.cfg, 512
    gen = torch.Generator().manual_seed(0)
    c, s = _frames(gen, 1, hw, dev), _frames(gen, 1, hw, dev)
    eps = {where: ex.export_stylize(net, cfg, hw, hw, device=where)[0]
           for where in ("cpu", dev)}
    out = {}
    for where, ep in eps.items():
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        out[str(where)] = ex.load_exported(buf.getvalue(), device=dev)(c, s)
    with torch.no_grad():
        f64 = stylize(copy.deepcopy(net).double(), c.double(), s.double())
    got, want = out["cpu"], out[str(dev)]
    err = _rel(got, want)
    cpu_f64 = any(d == torch.float64 for _, d in _graph_ops(eps["cpu"]))
    print(f"stylize {hw}x{hw} traced on the CPU, run on "
          f"{torch.cuda.get_device_name(0)}: {err:.3e} of the card-traced "
          f"output's max, bit equal {torch.equal(got, want)}; from float64 "
          f"eager: CPU-traced {_rel(got, f64):.3e}, card-traced "
          f"{_rel(want, f64):.3e}; the CPU-traced graph holds float64: "
          f"{cpu_f64}")
    assert got.shape == want.shape == (1, hw, hw, 3)
    assert err <= 1e-6

    monkeypatch.setattr(cwct, "_accumulate", lambda x: (
        torch.float64 if x.dtype == torch.float32
        and x.device.type == "cuda" else x.dtype))
    card_rule = ex.export_stylize(net, cfg, hw, hw, device=dev)[0]
    assert _graph_ops(card_rule) == _graph_ops(eps[dev])


def test_card_resume_from_opt_msgpack_equals_resume_in_memory(dev, tmp_path,
                                                               monkeypatch):
    """Fused Adam on the card: two updates from seeded gradients, the
    checkpoint (last.pt and last.pt.opt.msgpack), then the next update
    from the live state and from the loaded one: Adam's state on the card
    and the schedule restored bit for bit, and the two updates equal."""
    from vstnet_tpu_torch.train import trainer as tr

    monkeypatch.setattr(tr, "PHOTO_CONFIG",
                        RevResNetConfig(n_blocks=(1, 1, 1)))
    tc = tr.TrainConfig(lr=1e-2, lr_decay=0.5)
    state = tr.init_train_state(tc, dev)
    assert state.opt.defaults["fused"]
    g = torch.Generator().manual_seed(4)
    grads = [[(torch.randn(p.shape, generator=g) * 1e-2).to(dev)
              for p in state.net.parameters()] for _ in range(3)]
    for gs in grads[:2]:
        for p, x in zip(state.net.parameters(), gs):
            p.grad = x.clone()
        tr.apply_gradients(state, tc)
    tr.save_checkpoint(state, str(tmp_path))
    r = tr.load_checkpoint(tc, str(tmp_path), device=dev)
    assert r.step == 2 and r.opt.defaults["fused"]
    assert r.sched.last_epoch == 2
    assert r.sched.get_last_lr() == state.sched.get_last_lr()
    for p, q in zip(state.net.parameters(), r.net.parameters()):
        assert torch.equal(p, q)
        for k, v in state.opt.state[p].items():
            assert r.opt.state[q][k].device == v.device
            assert torch.equal(r.opt.state[q][k], v), k
    for st in (state, r):
        for p, x in zip(st.net.parameters(), grads[2]):
            p.grad = x.clone()
        tr.apply_gradients(st, tc)
    for p, q in zip(state.net.parameters(), r.net.parameters()):
        assert torch.equal(p, q)
