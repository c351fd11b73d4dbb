"""The port's kernel modules against the JAX package's Pallas kernels.

vstnet_tpu_torch/ops/coupling_fused.py holds the coupling kernel (K1) and
the stride-2 transition kernel (K2) with their plain PyTorch versions. On
the CPU the wrappers run the plain versions; here those are held against
the JAX kernels they replace (fused_coupling_flat, fused_transition_full),
which run in Pallas interpret mode as in tests/test_fast_path.py. The same
inputs, made with numpy from a seed, go to both.

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
    with pytest.raises(ValueError):
        cf.fused_transition(x, x, cf.pack_transition_weights(
            _torch_weights(_branch_np(rng, 16, 16, 64), device="meta")))


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
