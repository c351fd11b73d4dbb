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
    before = (cf.fused_transition_half.fma_launches,
              cf.fused_transition_half.mma_launches)
    t0, t1 = cf.fused_transition_half(x1u, x2u, wp)
    assert t0 is x2u and before == (cf.fused_transition_half.fma_launches,
                                    cf.fused_transition_half.mma_launches)
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
    before = cf.coupling_launches()
    y = cf.fused_coupling(x1, x2, wp)
    assert torch.equal(y, cf.coupling_block_plain(x1, x2, wp))
    assert cf.coupling_launches() == before
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


# ---------------------------------------------------------------------------
# The tensor-core route of K1: weight pieces and routing
# ---------------------------------------------------------------------------

def _bf16_branch(rng, c, m):
    """A branch whose values are already bf16-representable, so that the
    JAX kernel (float32) and the bf16 packing hold the same numbers."""
    branch = _branch_np(rng, c, m, c)
    for conv in branch.values():
        for k in conv:
            conv[k] = torch.from_numpy(conv[k]).bfloat16().float().numpy()
    return branch


@pytest.mark.parametrize("c,m", [(256, 64), (64, 16)])
def test_coupling_mma_pack_holds_the_plain_weights(rng, c, m):
    """pack_coupling_mma's bf16 pieces hold exactly the values of _pack's
    "w": at C=64 in [co chunk][ci chunk][tap][ci][co] order, at C=256 (the
    warpgroup kernel) as wgmma's B, [co chunk][ci chunk][tap][co / 8]
    [ci / 8][co % 8][ci % 8] with 16 ci a chunk."""
    wp = cf.pack_coupling_weights(_torch_weights(_branch_np(rng, c, m, c)),
                                  torch.bfloat16)
    pieces = wp["mma"]
    assert pieces.dtype == torch.bfloat16 and pieces.is_contiguous()
    assert pieces.numel() == 9 * m * (2 * c + m)
    unpacked = cf.unpack_coupling_mma(pieces, c, m)
    for got, (want, _) in zip(unpacked, wp["w"]):
        assert got.shape == want.shape
        assert bool((got == want).all())
    w1, w3 = wp["w"][0][0], wp["w"][2][0]
    if c == 256:
        # conv1, second input chunk of 16, tap (1, 2), ci 3 of the chunk,
        # co 13 (core matrix [1][0], row 5, column 3)
        p1 = pieces[: 9 * c * m].float().reshape(c // 16, 9, 8, 2, 8, 8)
        assert float(p1[1, 5, 1, 0, 5, 3]) == float(w1[13, 16 + 3, 1, 2])
        # conv3, last output chunk of 64, last input chunk, tap (2, 1), ci
        # 10 of the chunk, co 9 of the output chunk
        p3 = pieces[9 * m * (c + m):].float().reshape(c // 64, m // 16, 9, 8,
                                                      2, 8, 8)
        assert float(p3[-1, -1, 7, 1, 1, 1, 2]) == float(
            w3[c - 64 + 9, m - 16 + 10, 2, 1])
        return
    # conv1, second input chunk of 32, tap (1, 2), ci 3 of the chunk, co 5
    p1 = pieces[: 9 * c * m].float().reshape(c // 32, 9, 32, m)
    assert float(p1[1, 5, 3, 5]) == float(w1[5, 32 + 3, 1, 2])
    # conv3, last output chunk of 64, last input chunk
    kc = min(32, m)
    p3 = pieces[9 * m * (c + m):].float().reshape(c // 64, m // kc, 9, kc, 64)
    assert float(p3[-1, -1, 7, 2, 9]) == float(
        w3[c - 64 + 9, m - kc + 2, 2, 1])
    # float32 weights and widths the kernel is not built for carry no pieces
    assert "mma" not in cf.pack_coupling_weights(
        _torch_weights(_branch_np(rng, c, m, c)))
    assert "mma" not in cf.pack_coupling_weights(
        _torch_weights(_branch_np(rng, 128, 32, 128)), torch.bfloat16)


@pytest.mark.parametrize("conv", [0, 1, 2])
def test_coupling_mma_wg_pack_is_wgmma_b(rng, conv):
    """At C=256/M=64 every weight lies where coupling_mma_wg_kernel's
    descriptors read it: conv `conv`'s segment is a sequence of pieces
    (co chunk of 64, ci chunk of 16), each nine k-blocks (tap ky * 3 + kx)
    of K-major 8 x 8 core matrices, 128 contiguous bytes each, core
    matrix (co / 8, ci / 8) of the k-block at (co / 8) * 2 + ci / 8, row
    co % 8, column ci % 8 (csrc/wgmma.cuh). The index is computed here
    element by element, apart from the packing's own reshapes."""
    c, m = cf.MMA_WG
    wp = cf.pack_coupling_weights(_torch_weights(_branch_np(rng, c, m, c)),
                                  torch.bfloat16)
    pieces = wp["mma"].float()
    cout, cin = ((m, c), (m, m), (c, m))[conv]
    start = 9 * m * (0, c, c + m)[conv]
    w = wp["w"][conv][0]
    co, ci, ky, kx = (t.reshape(-1) for t in torch.meshgrid(
        *(torch.arange(n) for n in w.shape), indexing="ij"))
    piece = (co // 64) * (cin // 16) + ci // 16
    block = piece * 9 + ky * 3 + kx
    core = (co % 64 // 8) * 2 + ci % 16 // 8
    idx = start + ((block * 16 + core) * 8 + co % 8) * 8 + ci % 8
    assert sorted(idx.tolist()) == list(range(start, start + w.numel()))
    assert torch.equal(pieces[idx], w[co, ci, ky, kx])


def test_coupling_mma_narrow_pack_holds_the_plain_weights(rng):
    """At C=16/M=4 the weights go to the kernel as zero-padded B matrices in
    per-lane fragment order: unpacked they are exactly _pack's "w", the
    padding is zero, and a fragment sits where the kernel reads it."""
    c, m = 16, 4
    wp = cf.pack_coupling_weights(_torch_weights(_branch_np(rng, c, m, c)),
                                  torch.bfloat16)
    frags = wp["mma"]
    assert frags.dtype == torch.bfloat16
    assert frags.numel() == (9 + 5 + 10) * 32 * 4
    for got, (want, _) in zip(cf.unpack_coupling_mma(frags, c, m), wp["w"]):
        assert got.shape == want.shape
        assert bool((got == want).all())
    nonzero = sum(int((w != 0).sum()) for w, _ in wp["w"])
    assert int((frags != 0).sum()) == nonzero
    # conv2 starts after conv1's 9 k-steps; its k-step 1 holds taps 2 and 3.
    # Lane 4g + t, register 1, element 0 is row 2t + 8 = tap 3, ci 2t of
    # column g: w2[co=g, ci=2t, ky=1, kx=0]
    w2 = wp["w"][1][0]
    f2 = frags[9 * 128:].float().reshape(-1, 32, 2, 2)
    g, t = 3, 1
    assert float(f2[1, 4 * g + t, 1, 0]) == float(w2[g, 2 * t, 1, 0])
    # conv3, k-step 4 (tap 8 and the padding tap), n-tile 1: co 8 + g
    w3 = wp["w"][2][0]
    f3 = frags[14 * 128:].float().reshape(5, 2, 32, 2, 2)
    assert float(f3[4, 1, 4 * g + t, 0, 1]) == float(w3[8 + g, 2 * t + 1, 2, 2])
    assert float(f3[4, 1, 4 * g + t, 1, 1]) == 0.0


def test_coupling_mma_unpacked_weights_match_jax_kernel(rng):
    """coupling_block_plain on the weights recovered from the bf16 pieces
    against the JAX kernel on the same (bf16-representable) weights, in
    float32: what the tensor-core kernel is given is what the JAX package
    computes with. atol 1e-4, as test_coupling_plain_matches_jax_kernel
    allows at its wide shape: at C=64 the outputs are O(30) and float32
    roundoff over K = 9*16 products reaches a few 1e-5."""
    c, m, h, w = 64, 16, 16, 128
    branch = _bf16_branch(rng, c, m)
    packed_j = cflat.pack_branch_weights_flat(_jax_branch(branch))
    x1 = rng.standard_normal((2, c, h, w)).astype(np.float32)
    x2 = rng.standard_normal((2, c, h, w)).astype(np.float32)
    wp = cf.pack_coupling_weights(_torch_weights(branch), torch.bfloat16)
    w1, w2, w3 = cf.unpack_coupling_mma(wp["mma"], c, m)
    recovered = dict(wp, w=tuple(
        (wt.contiguous(), b) for wt, (_, b) in zip((w1, w2, w3), wp["w"])))
    to_flat = lambda a: cflat.nhwc_to_flat(
        jnp.asarray(a.transpose(0, 2, 3, 1)))
    for inverse in (False, True):
        y = cflat.fused_coupling_flat(to_flat(x1), to_flat(x2), packed_j, h,
                                      w, th=h // 2, inverse=inverse,
                                      interpret=True)
        want = np.asarray(cflat.flat_to_nhwc(y, h, w)).transpose(0, 3, 1, 2)
        got = cf.coupling_block_plain(torch.from_numpy(x1),
                                      torch.from_numpy(x2), recovered,
                                      inverse)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("dtype,c,m,route", [
    (torch.bfloat16, 256, 64, "mma"), (torch.bfloat16, 64, 16, "mma"),
    (torch.bfloat16, 16, 4, "mma"), (torch.bfloat16, 128, 32, "fma"),
    (torch.bfloat16, 32, 8, "fma"),
    (torch.float32, 256, 64, "fma"), (torch.float32, 64, 16, "fma"),
    (torch.float32, 16, 4, "fma"),
])
def test_coupling_route(dtype, c, m, route):
    """The K1 route is a function of (dtype, C, M) alone: the tensor cores
    for bf16 at the three widths the kernels are built for, the CUDA cores
    for every float32 shape (no TF32) and any other bf16 width."""
    assert cf.coupling_route(dtype, c, m) == route
    assert ((c, m) in cf.MMA_WIDTHS) == (
        cf.coupling_route(torch.bfloat16, c, m) == "mma")


# ---------------------------------------------------------------------------
# The tensor-core route of K2 and K3: weight pieces and routing
# ---------------------------------------------------------------------------

def _bf16_transition_branch(rng, c, m):
    """A stride-2 branch (C -> M -> M -> 4C) of bf16-representable values,
    scaled by fan-in (0.2 at a fan-in of 8 channels) so that C = 64 keeps
    the unit-scale activations the float32 tolerance is stated for."""
    branch = _branch_np(rng, c, m, 4 * c)
    for conv in branch.values():
        cin = conv["w"].shape[2]
        conv["w"] = conv["w"] * np.float32(np.sqrt(8.0 / cin))
        for k in conv:
            conv[k] = torch.from_numpy(conv[k]).bfloat16().float().numpy()
    return branch


@pytest.mark.parametrize("c,m", [(64, 64), (16, 16)])
def test_transition_mma_pack_holds_the_plain_weights(rng, c, m):
    """unpack_transition_mma(pack_transition_mma(w)) is exactly the
    bf16-rounded weights of _pack's "w"; the pieces are [tap][16 ci][co],
    conv1 and conv2 by input chunk, conv3 by output chunk of 64 and then
    input chunk."""
    wp = cf.pack_transition_weights(
        _torch_weights(_branch_np(rng, c, m, 4 * c)), torch.bfloat16)
    pieces = wp["mma"]
    assert pieces.dtype == torch.bfloat16 and pieces.is_contiguous()
    assert pieces.numel() == 9 * m * (c + m + 4 * c)
    unpacked = cf.unpack_transition_mma(pieces, c, m)
    for got, (want, _) in zip(unpacked, wp["w"]):
        assert got.shape == want.shape
        assert bool((got == want).all())
        assert torch.equal(want, want.bfloat16().float())
    assert torch.equal(cf.pack_transition_mma(wp["w"]), pieces)
    # conv1, last input chunk of 16, tap (1, 2), ci 3 of the chunk, co 5
    w1 = wp["w"][0][0]
    p1 = pieces[: 9 * c * m].float().reshape(c // 16, 9, 16, m)
    assert float(p1[-1, 5, 3, 5]) == float(w1[5, c - 16 + 3, 1, 2])
    # conv2 follows conv1: first chunk, tap (2, 0), ci 7, co 1
    w2 = wp["w"][1][0]
    p2 = pieces[9 * c * m: 9 * m * (c + m)].float().reshape(m // 16, 9, 16, m)
    assert float(p2[0, 6, 7, 1]) == float(w2[1, 7, 2, 0])
    # conv3, last output chunk of 64 (phase p = q = 1), last input chunk
    w3 = wp["w"][2][0]
    p3 = pieces[9 * m * (c + m):].float().reshape(4 * c // 64, m // 16, 9,
                                                  16, 64)
    assert float(p3[-1, -1, 7, 2, 9]) == float(
        w3[4 * c - 64 + 9, m - 16 + 2, 2, 1])
    # float32 weights and widths the kernel is not built for carry no pieces
    assert "mma" not in cf.pack_transition_weights(
        _torch_weights(_branch_np(rng, c, m, 4 * c)))
    assert "mma" not in cf.pack_transition_weights(
        _torch_weights(_branch_np(rng, 32, 32, 128)), torch.bfloat16)


@pytest.mark.parametrize("c,m", [(64, 64), (16, 16)])
def test_transition_mma_unpacked_weights_match_jax_kernels(rng, c, m):
    """transition_block_plain and transition_half_plain on the weights
    recovered from the bf16 pieces against fused_transition_full and
    fused_transition_flat of the JAX package on the same
    (bf16-representable) weights, in float32, forward and inverse: what the
    tensor-core kernel is given is what the JAX package computes with.
    atol 2e-5: float32 roundoff of unit-scale outputs summed in another
    order."""
    h, w, th = 32, 256, 8                      # full-res; half-res 16 x 128
    hh, wh, cu = h // 2, w // 2, 4 * c
    branch = _bf16_transition_branch(rng, c, m)
    packed_j = cflat.pack_transition_weights_flat(_jax_branch(branch))
    wp = cf.pack_transition_weights(_torch_weights(branch), torch.bfloat16)
    recovered = dict(wp, w=tuple(
        (wt.contiguous(), b) for wt, (_, b) in zip(
            cf.unpack_transition_mma(wp["mma"], c, m), wp["w"])))
    x1 = rng.standard_normal((1, c, h, w)).astype(np.float32)
    x2 = rng.standard_normal((1, c, h, w)).astype(np.float32)

    # K2: full-res streams in, (u(x2), F(x2) + u(x1)) out, and back
    j0, j1 = cflat.fused_transition_full(jnp.asarray(x1), jnp.asarray(x2),
                                         packed_j, hh, wh, th=th,
                                         interpret=True)
    t0, t1 = cf.transition_block_plain(torch.from_numpy(x1),
                                       torch.from_numpy(x2), recovered)
    np.testing.assert_array_equal(t0.numpy().reshape(1, cu, -1),
                                  np.asarray(j0))
    np.testing.assert_allclose(t1.numpy().reshape(1, cu, -1),
                               np.asarray(j1), atol=2e-5)
    i0, i1 = cflat.fused_transition_full(j1, j0, packed_j, hh, wh, th=th,
                                         inverse=True, interpret=True)
    k0, k1 = cf.transition_block_plain(
        torch.from_numpy(np.array(j1).reshape(1, cu, hh, wh)),
        torch.from_numpy(np.array(j0).reshape(1, cu, hh, wh)), recovered,
        inverse=True)
    np.testing.assert_allclose(k0.numpy(), np.asarray(i0), atol=2e-5)
    np.testing.assert_array_equal(k1.numpy(), np.asarray(i1))

    # K3: the same block on the unshuffled streams (zero-copy layout)
    x1u = tcoup.pixel_unshuffle(torch.from_numpy(x1)).contiguous()
    x2u = tcoup.pixel_unshuffle(torch.from_numpy(x2)).contiguous()
    flat = lambda t: jnp.asarray(t.numpy()).reshape(1, cu, hh * wh)
    u0, u1 = cf.transition_half_plain(x1u, x2u, recovered)
    assert u0 is x2u and torch.equal(u1, t1)
    want = cflat.fused_transition_flat(flat(x1u), flat(x2u), packed_j, hh,
                                       wh, th=th, interpret=True,
                                       padded=False)
    np.testing.assert_allclose(u1.numpy().reshape(1, cu, -1),
                               np.asarray(want), atol=2e-5)
    v0, v1 = cf.transition_half_plain(u1, u0, recovered, inverse=True)
    want = cflat.fused_transition_flat(flat(u1), flat(x2u), packed_j, hh, wh,
                                       th=th, inverse=True, interpret=True,
                                       padded=False)
    assert v1 is u0
    np.testing.assert_allclose(v0.numpy().reshape(1, cu, -1),
                               np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(v0.numpy(), x1u.numpy(), atol=2e-5)


@pytest.mark.parametrize("dtype,c,m,route", [
    (torch.bfloat16, 64, 64, "mma"), (torch.bfloat16, 16, 16, "mma"),
    (torch.bfloat16, 32, 32, "fma"), (torch.bfloat16, 64, 16, "fma"),
    (torch.bfloat16, 16, 4, "fma"), (torch.bfloat16, 4, 4, "fma"),
    (torch.float32, 64, 64, "fma"), (torch.float32, 16, 16, "fma"),
    (torch.float32, 32, 32, "fma"),
])
def test_transition_route(dtype, c, m, route):
    """The K2/K3 route is a function of (dtype, C, M) alone: the tensor
    cores for bf16 at the two widths the kernel is built for, the CUDA
    cores for every float32 shape (no TF32) and any other bf16 width; the
    packing carries the pieces exactly where the route says so."""
    assert cf.transition_route(dtype, c, m) == route
    assert ((c, m) in cf.TRANSITION_MMA_WIDTHS) == (
        cf.transition_route(torch.bfloat16, c, m) == "mma")
    gen = torch.Generator().manual_seed(0)
    weights = tuple((torch.randn((co, ci, 3, 3), generator=gen),
                     torch.randn((co,), generator=gen))
                    for ci, co in ((c, m), (m, m), (m, 4 * c)))
    assert ("mma" in cf.pack_transition_weights(weights, dtype)) == (
        route == "mma")


def test_transition_launch_counts_are_kept_apart():
    """ops.launch_counts names K2's and K3's two kernels apart; the CPU path
    raises none of them, and reset clears all."""
    from vstnet_tpu_torch import ops

    assert {"transition", "transition_mma", "transition_half",
            "transition_half_mma"} <= set(ops.launch_counts())
    cf.fused_transition.mma_launches += 2
    cf.fused_transition_half.fma_launches += 3
    try:
        counts = ops.launch_counts()
        assert (counts["transition_mma"], counts["transition"],
                counts["transition_half"],
                counts["transition_half_mma"]) == (2, 0, 3, 0)
    finally:
        ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())
    cf.fused_transition_half.mma_launches = 1
    cf.reset_launches()
    assert cf.fused_transition_half.mma_launches == 0
