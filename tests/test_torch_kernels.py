"""The port's kernel modules against the JAX package's Pallas kernels.

vstnet_tpu_torch/ops/coupling_fused.py holds the coupling kernel (K1) and
the stride-2 transition kernels (K2 at full resolution, K3 on unshuffled
half-resolution streams) with their plain PyTorch versions. On the CPU the
wrappers run the plain versions; here those are held against the JAX
kernels they replace (fused_coupling_flat, fused_transition_full,
fused_transition_flat), which run in Pallas interpret mode as in
tests/test_fast_path.py. The same inputs, made with numpy from a seed, go
to both.

Tolerances: float32 throughout. atol 2e-5 is float32 roundoff over the
3-conv branch at these widths (0.2-scaled N(0,1) weights, unit inputs);
the two sides sum the 3x3xCin products in different orders. The c=128
shape sums over K = 9*32 at conv3 with O(10) activations, where the JAX
package's own test allows 3e-4 against XLA; it gets 1e-4 here. Layout
helpers (pixel (un)shuffle, pads) must match exactly.

tests/test_torch_cuda.py compares the CUDA kernels themselves with their
plain versions on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstnet_tpu.ops import coupling as jcoup
from vstnet_tpu.ops import coupling_flat as cflat
from vstnet_tpu_torch.ops import coupling as tcoup
from vstnet_tpu_torch.ops import coupling_fused as cf

torch.set_num_threads(2)


def _branch_np(rng, cin, mid, cout):
    """HWIO numpy weights: 0.2 * N(0,1), biases 0.1 * N(0,1)."""
    return {name: {"w": rng.standard_normal((3, 3, ci, co)).astype(
                       np.float32) * 0.2,
                   "b": rng.standard_normal((co,)).astype(np.float32) * 0.1}
            for name, ci, co in (("conv1", cin, mid), ("conv2", mid, mid),
                                 ("conv3", mid, cout))}


def _jax_branch(branch):
    return jax.tree.map(jnp.asarray, branch)


def _torch_weights(branch, device="cpu"):
    """HWIO numpy branch -> ((w1, b1), (w2, b2), (w3, b3)) OIHW tensors."""
    return tuple(
        (torch.from_numpy(branch[n]["w"].transpose(3, 2, 0, 1).copy()).to(
            device),
         torch.from_numpy(branch[n]["b"].copy()).to(device))
        for n in ("conv1", "conv2", "conv3"))


@pytest.mark.parametrize("c,mid,h,w", [
    (16, 4, 32, 48), (8, 2, 16, 20), (16, 4, 16, 128), (128, 32, 16, 128),
])
def test_coupling_plain_matches_jax_kernel(rng, c, mid, h, w):
    branch = _branch_np(rng, c, mid, c)
    packed_j = cflat.pack_branch_weights_flat(_jax_branch(branch))
    x1 = rng.standard_normal((2, c, h, w)).astype(np.float32)
    x2 = rng.standard_normal((2, c, h, w)).astype(np.float32)

    def jax_block(inverse):
        to_flat = lambda a: cflat.nhwc_to_flat(
            jnp.asarray(a.transpose(0, 2, 3, 1)))
        y = cflat.fused_coupling_flat(to_flat(x1), to_flat(x2), packed_j, h,
                                      w, th=h // 2, inverse=inverse,
                                      interpret=True)
        return np.asarray(cflat.flat_to_nhwc(y, h, w)).transpose(0, 3, 1, 2)

    wp = cf.pack_coupling_weights(_torch_weights(branch))
    atol = 2e-5 if c < 128 else 1e-4
    for inverse in (False, True):
        got = cf.coupling_block_plain(torch.from_numpy(x1),
                                      torch.from_numpy(x2), wp, inverse)
        np.testing.assert_allclose(got.numpy(), jax_block(inverse),
                                   atol=atol)


@pytest.mark.parametrize("c,mid,h,w,th", [
    (16, 16, 32, 256, 8), (8, 4, 48, 256, 8), (16, 16, 64, 256, 16),
])
def test_transition_plain_matches_jax_kernel(rng, c, mid, h, w, th):
    branch = _branch_np(rng, c, mid, 4 * c)
    packed_j = cflat.pack_transition_weights_flat(_jax_branch(branch))
    x1 = rng.standard_normal((2, c, h, w)).astype(np.float32)
    x2 = rng.standard_normal((2, c, h, w)).astype(np.float32)
    hh, wh = h // 2, w // 2
    j0, j1 = cflat.fused_transition_full(jnp.asarray(x1), jnp.asarray(x2),
                                         packed_j, hh, wh, th=th,
                                         interpret=True)
    wp = cf.pack_transition_weights(_torch_weights(branch))
    t0, t1 = cf.transition_block_plain(torch.from_numpy(x1),
                                       torch.from_numpy(x2), wp)
    np.testing.assert_array_equal(t0.numpy().reshape(2, 4 * c, -1),
                                  np.asarray(j0))
    np.testing.assert_allclose(t1.numpy().reshape(2, 4 * c, -1),
                               np.asarray(j1), atol=2e-5)

    # inverse: (y2, y1) -> (x1, x2) at full resolution
    i0, i1 = cflat.fused_transition_full(j1, j0, packed_j, hh, wh, th=th,
                                         inverse=True, interpret=True)
    k0, k1 = cf.transition_block_plain(
        torch.from_numpy(np.array(j1).reshape(2, 4 * c, hh, wh)),
        torch.from_numpy(np.array(j0).reshape(2, 4 * c, hh, wh)), wp,
        inverse=True)
    np.testing.assert_allclose(k0.numpy(), np.asarray(i0), atol=2e-5)
    np.testing.assert_array_equal(k1.numpy(), np.asarray(i1))
    np.testing.assert_allclose(k0.numpy(), x1, atol=2e-5)


@pytest.mark.parametrize("c,mid,h,w,padded", [
    (16, 16, 16, 24, True), (4, 2, 32, 20, True), (16, 16, 32, 256, False),
])
def test_half_res_transition_plain_matches_jax_kernel(rng, c, mid, h, w,
                                                      padded):
    """K3's plain version against fused_transition_flat in float32,
    forward and inverse, in the JAX kernel's padded and zero-copy layouts.
    atol 2e-5 as for K2 above: the outputs reach |y| of about 13 at the
    c = mid = 16 shapes, where 1e-5 is ten float32 ulps and the two sides'
    summation orders differ by up to 1.7e-5."""
    branch = _branch_np(rng, c, mid, 4 * c)
    packed_j = cflat.pack_transition_weights_flat(_jax_branch(branch))
    x1 = rng.standard_normal((2, c, h, w)).astype(np.float32)
    x2 = rng.standard_normal((2, c, h, w)).astype(np.float32)
    hh, wh, cu = h // 2, w // 2, 4 * c
    x1u = tcoup.pixel_unshuffle(torch.from_numpy(x1)).contiguous()
    x2u = tcoup.pixel_unshuffle(torch.from_numpy(x2)).contiguous()

    def to_flat(t):
        t = jnp.asarray(t.numpy())
        if padded:
            return cflat.nhwc_to_flat(jnp.transpose(t, (0, 2, 3, 1)))
        return t.reshape(2, cu, hh * wh)

    def from_flat(tf):
        if padded:
            return np.asarray(jnp.transpose(
                cflat.flat_to_nhwc(tf, hh, wh), (0, 3, 1, 2)))
        return np.asarray(tf.reshape(2, cu, hh, wh))

    th = 4 if padded else 8
    wp = cf.pack_transition_weights(_torch_weights(branch))
    before = cf.fused_transition_half.launches
    t0, t1 = cf.fused_transition_half(x1u, x2u, wp)
    assert t0 is x2u and cf.fused_transition_half.launches == before
    want = from_flat(cflat.fused_transition_flat(
        to_flat(x1u), to_flat(x2u), packed_j, hh, wh, th=th, interpret=True,
        padded=padded))
    np.testing.assert_allclose(t1.numpy(), want, atol=2e-5)

    i0, i1 = cf.fused_transition_half(t1, t0, wp, inverse=True)
    want = from_flat(cflat.fused_transition_flat(
        to_flat(t1), to_flat(x2u), packed_j, hh, wh, th=th, inverse=True,
        interpret=True, padded=padded))
    assert i1 is t0
    np.testing.assert_allclose(i0.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(i0.numpy(), x1u.numpy(), atol=2e-5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_full_res_transition_equals_half_res_on_unshuffled(rng, dt):
    """K2 plain(x1, x2) == K3 plain(u(x1), u(x2)) exactly, forward and
    inverse: the two entries are one block."""
    branch = _branch_np(rng, 8, 8, 32)
    wp = cf.pack_transition_weights(_torch_weights(branch), dt)
    x1 = torch.from_numpy(rng.standard_normal((2, 8, 12, 20)).astype(
        np.float32)).to(dt)
    x2 = torch.from_numpy(rng.standard_normal((2, 8, 12, 20)).astype(
        np.float32)).to(dt)
    k0, k1 = cf.transition_block_plain(x1, x2, wp)
    h0, h1 = cf.transition_half_plain(tcoup.pixel_unshuffle(x1),
                                      tcoup.pixel_unshuffle(x2), wp)
    assert torch.equal(k0, h0) and torch.equal(k1, h1)
    f0, f1 = cf.transition_block_plain(k1, k0, wp, inverse=True)
    g0, g1 = cf.transition_half_plain(h1, h0, wp, inverse=True)
    assert torch.equal(f0, tcoup.pixel_shuffle(g0))
    assert torch.equal(f1, tcoup.pixel_shuffle(g1))


@pytest.mark.parametrize("w_half,half", [(16, True), (128, False),
                                         (160, True), (256, False)])
def test_half_res_entry_rule(w_half, half):
    """The fast path takes K3 exactly where the JAX package takes its
    half-res entry: a half-res width that is no multiple of 128."""
    import vstnet_tpu.models.revresnet_fast as jrf
    from vstnet_tpu_torch.models import revresnet_fast as rf

    assert rf._half_res_entry(w_half) is half
    assert (jrf._tr_full_th(64, w_half, 64) is None) is half


@pytest.mark.parametrize("shape", [(2, 8, 4, 6), (1, 12, 8, 2)])
def test_layout_helpers_match_jax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tcoup.pixel_unshuffle(t).numpy(),
        np.asarray(jcoup.pixel_unshuffle_nchw(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tcoup.pixel_shuffle(tcoup.pixel_unshuffle(t)).numpy(), x)
    u = rng.standard_normal((shape[0], 4 * shape[1], 3, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tcoup.pixel_shuffle(torch.from_numpy(u)).numpy(),
        np.asarray(jcoup.pixel_shuffle_nchw(jnp.asarray(u))))
    np.testing.assert_array_equal(
        tcoup.injective_pad(t, 5).numpy(),
        np.asarray(jcoup.injective_pad_nchw(jnp.asarray(x), 5)))
    np.testing.assert_array_equal(
        tcoup.injective_unpad(tcoup.injective_pad(t, 5), 5).numpy(), x)


def test_cpu_dispatch_runs_plain_version(rng):
    """A CPU tensor takes the plain version and launches nothing; the
    kernel layout holds the weights as [ci][ky][kx][co] float32."""
    branch = _torch_weights(_branch_np(rng, 16, 4, 16))
    wp = cf.pack_coupling_weights(branch)
    x1 = torch.from_numpy(rng.standard_normal((1, 16, 8, 12)).astype(
        np.float32))
    x2 = torch.from_numpy(rng.standard_normal((1, 16, 8, 12)).astype(
        np.float32))
    before = cf.fused_coupling.launches
    y = cf.fused_coupling(x1, x2, wp)
    assert torch.equal(y, cf.coupling_block_plain(x1, x2, wp))
    assert cf.fused_coupling.launches == before
    assert wp["flat"].dtype == torch.float32
    w1 = branch[0][0]
    assert torch.equal(wp["flat"][: w1.numel()],
                       w1.permute(1, 2, 3, 0).reshape(-1))
    assert wp["flat"].numel() == sum(w.numel() + b.numel()
                                     for w, b in branch)


def test_non_cuda_device_raises(rng):
    """Neither CPU nor CUDA: the wrapper raises instead of falling back."""
    branch = _torch_weights(_branch_np(rng, 16, 4, 16), device="meta")
    wp = cf.pack_coupling_weights(branch)
    x = torch.empty((1, 16, 8, 8), device="meta")
    with pytest.raises(ValueError):
        cf.fused_coupling(x, x, wp)
    wt = cf.pack_transition_weights(
        _torch_weights(_branch_np(rng, 16, 16, 64), device="meta"))
    with pytest.raises(ValueError):
        cf.fused_transition(x, x, wt)
    xu = torch.empty((1, 64, 4, 4), device="meta")
    with pytest.raises(ValueError):
        cf.fused_transition_half(xu, xu, wt)


def test_pack_rejects_wrong_branch_shapes(rng):
    with pytest.raises(ValueError):
        cf.pack_coupling_weights(_torch_weights(_branch_np(rng, 16, 4, 64)))
    with pytest.raises(ValueError):
        cf.pack_transition_weights(_torch_weights(_branch_np(rng, 16, 4,
                                                             16)))


def test_bf16_pack_rounds_weights(rng):
    wp = cf.pack_coupling_weights(
        _torch_weights(_branch_np(rng, 16, 4, 16)), torch.bfloat16)
    flat = wp["flat"]
    assert flat.dtype == torch.float32
    assert torch.equal(flat, flat.to(torch.bfloat16).float())
