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
"""

import numpy as np
import pytest
import torch

from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.ops import coupling_fused as cf

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
    assert (cf.fused_coupling.launches, cf.fused_transition.launches) == (6, 2)
    assert _err(z, net.encode(x)) <= 1e-5
    back = rf.decode_fast(fast, z, cfg)
    assert _err(back, x) <= 1e-5
    assert _err(back, net.decode(z)) <= 1e-5
