"""Row (spatial) sharding in the port (vstnet_tpu_torch/parallel/halo.py,
cwct's row statistics, the spatial=True programs) against the unsharded
computation and against the JAX package's spatial=True programs, on CPU
replicas.

Tolerances:
  * the sharded branch equals ops/pad_conv.residual_branch_nchw on the
    whole image within 1e-6, at stride 1 and 2: every output row reads the
    same window, halos inside, reflect at the image's top and bottom only;
  * sharded encode and decode within 1e-5 of the unsharded ones (float32
    roundoff through 3+2 small blocks, as tests/test_torch_revresnet.py),
    the round trip > 100 dB PSNR (its float32 bar);
  * the sharded cWCT statistics within 1e-5 of cwct._stats;
  * the spatial programs within 1e-4 of JAX's on a (2, 2) mesh and of the
    port's unsharded programs: tests/test_parallel.py's bound for its
    spatial program against the unsharded one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models import cwct as jcwct
from vstnet_tpu.models.revresnet import encode as jencode
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu.parallel import make_mesh as jmake_mesh
from vstnet_tpu.parallel import shard_batch as jshard
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import params_from_jax
from vstnet_tpu_torch.models import cwct, pipeline
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.ops.pad_conv import residual_branch_nchw
from vstnet_tpu_torch.parallel import (
    decode_rows,
    encode_rows,
    gather,
    make_mesh,
    parallel_stylize,
    parallel_stylize_factored,
    parallel_stylize_fused,
    parallel_stylize_masked_fused,
    shard_batch,
)
from vstnet_tpu_torch.parallel.halo import residual_branch_rows

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
JSMALL = JaxConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
CPU = torch.device("cpu")


def _grid(rows, s):
    return make_mesh(rows * s, ("data", "spatial"), spatial=s,
                     device_type="cpu")


def _images(seed, n, hw):
    return np.random.default_rng(seed).uniform(
        size=(n, hw, hw, 3)).astype(np.float32)


def _rows(x, s, dim=1):
    return list(x.split(x.shape[dim] // s, dim=dim))


def _psnr(a, b):
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.fixture(scope="module")
def weights():
    """(JAX RevResNet params, the port's RevResNet on the same weights)."""
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: init_revresnet(k, JSMALL))(jax.random.PRNGKey(7)))
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(params_from_jax(params))
    return params, net


@pytest.fixture(scope="module")
def jax_spatial(weights):
    """JAX's spatial=True programs on a (2, 2) mesh: (content, style,
    stylized, factored) at 32x32, B=2."""
    from vstnet_tpu.parallel import parallel_stylize as jplain
    from vstnet_tpu.parallel import parallel_stylize_factored as jfactored

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    params, _ = weights
    content, style = _images(0, 2, 32), _images(1, 2, 32)
    mesh = jmake_mesh(4, ("data", "spatial"), spatial=2)
    c_j = jshard(mesh, jnp.asarray(content), spatial=True)
    with mesh:
        out = np.asarray(jplain(mesh, JSMALL, spatial=True)(
            params, c_j, jshard(mesh, jnp.asarray(style), spatial=True)))
    ls, mu = jcwct.style_factors(jencode(params, jnp.asarray(style[:1]),
                                         JSMALL))
    with mesh:
        fac = np.asarray(jfactored(mesh, JSMALL, spatial=True)(
            params, c_j, ls, mu))
    return content, style, out, fac


# ---------------------------------------------------------------------------
# The branch, the walks and the statistics against the whole image
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("s", [2, 4])
@torch.no_grad()
def test_branch_rows_match_whole_image(weights, stride, s):
    """At stride 2 a shard takes one halo row above and none below, and
    the image's bottom reflect row is never read."""
    _, net = weights
    block = next(b for b in net.blocks() if b.stride == stride)
    cin = block.convs()[0].in_channels
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, cin, 16, 12)).astype(np.float32))
    want = residual_branch_nchw(x, block.weights(), stride)
    got = residual_branch_rows(_rows(x, s, 2), [block.weights()] * s, stride)
    assert [g.shape[2] for g in got] == [16 // stride // s] * s
    np.testing.assert_allclose(torch.cat(got, 2).numpy(), want.numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("s,hw", [(2, 16), (2, 32), (4, 32)])
def test_encode_decode_rows_match_whole_image(weights, s, hw):
    """(2, 16) and (4, 32): each shard holds 2 rows at H/4."""
    _, net = weights
    x = torch.from_numpy(_images(3, 2, hw))
    nets = [net] * s
    zs = encode_rows(nets, _rows(x, s))
    z = net.encode(x)
    np.testing.assert_allclose(torch.cat(zs, 1).numpy(), z.numpy(),
                               rtol=0, atol=1e-5)
    back = torch.cat(decode_rows(nets, zs), 1)
    assert _psnr(back, x) > 100.0
    np.testing.assert_allclose(
        torch.cat(decode_rows(nets, _rows(z, s)), 1).numpy(),
        net.decode(z).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("s", [2, 4])
def test_row_stats_match_stats(weights, s):
    _, net = weights
    z = net.encode(torch.from_numpy(_images(4, 2, 32)))
    mean, cov = cwct.row_stats(_rows(z, s))
    want_mean, want_cov = cwct._stats(cwct._nhwc_as_gcn(z))
    np.testing.assert_allclose(mean.numpy(), want_mean.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(cov.numpy(), want_cov.numpy(), rtol=0,
                               atol=1e-5)
    ls, mu = cwct.style_factors_rows(_rows(z, s))
    want_ls, want_mu = cwct.style_factors(z)
    np.testing.assert_allclose(ls.numpy(), want_ls.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(mu.numpy(), want_mu.numpy(), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The spatial programs against JAX's and the unsharded ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,s", [(2, 2), (1, 4)])
def test_spatial_programs_match_jax(weights, jax_spatial, rows, s):
    _, net = weights
    content, style, want, want_fac = jax_spatial
    mesh = _grid(rows, s)
    c, st = torch.from_numpy(content), torch.from_numpy(style)
    shards = parallel_stylize(mesh, SMALL, spatial=True)(net, c, st)
    assert len(shards) == rows and all(len(r) == s for r in shards)
    assert shards[0][0].shape == (2 // rows, 32 // s, 32, 3)
    got = gather(shards)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               pipeline.stylize(net, c, st).numpy(),
                               rtol=1e-4, atol=1e-4)

    ls, mu = cwct.style_factors(net.encode(st[:1]))
    got = gather(parallel_stylize_factored(mesh, SMALL, spatial=True)(
        net, c, ls, mu))
    np.testing.assert_allclose(got.numpy(), want_fac, rtol=1e-4, atol=1e-4)
    one = gather(parallel_stylize_factored((CPU,), SMALL)(net, c, ls, mu))
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_shard_batch_spatial_keeps_order():
    x = torch.arange(2 * 8 * 2 * 1.0).reshape(2, 8, 2, 1)
    mesh = _grid(2, 2)
    shards = shard_batch(mesh, x, spatial=True)
    assert [[s[:, :, 0, 0].tolist() for s in row] for row in shards] == [
        [[[0, 2, 4, 6]], [[8, 10, 12, 14]]],
        [[[16, 18, 20, 22]], [[24, 26, 28, 30]]]]
    assert torch.equal(gather(shards), x)
    assert shard_batch(mesh, shards, spatial=True) == shards
    with pytest.raises(ValueError):
        shard_batch(mesh, x[:, :7], spatial=True)
    with pytest.raises(ValueError):
        shard_batch(mesh, x[:1], spatial=True)
    with pytest.raises(ValueError):
        shard_batch(mesh, x)
    with pytest.raises(ValueError):
        shard_batch(make_mesh(2, device_type="cpu"), x, spatial=True)


def test_bad_heights_raise(weights):
    _, net = weights
    fn = parallel_stylize(_grid(1, 4), SMALL, spatial=True)
    # 16 rows over 4 shards: 1 row each at H/4, where reflect needs 2
    x = torch.rand(1, 16, 16, 3)
    with pytest.raises(ValueError, match="at least 2"):
        fn(net, x, x)
    # 40 rows over 4 shards: 10 rows, no multiple of 4
    x = torch.rand(1, 40, 16, 3)
    with pytest.raises(ValueError, match="multiple of 4"):
        fn(net, x, x)
    # 30 rows do not divide over 4 shards
    with pytest.raises(ValueError, match="height 30"):
        fn(net, torch.rand(1, 30, 16, 3), torch.rand(1, 32, 16, 3))
    with pytest.raises(ValueError, match="at least 2"):
        decode_rows([net] * 4, _rows(torch.rand(1, 16, 16, 32), 4))


def test_fused_programs_refuse_a_2d_mesh():
    mesh = _grid(2, 2)
    for make in (parallel_stylize_fused, parallel_stylize_masked_fused):
        with pytest.raises(ValueError, match="spatial=True"):
            make(mesh, SMALL)
    with pytest.raises(ValueError, match="spatial=True"):
        parallel_stylize(mesh, SMALL)
    with pytest.raises(ValueError, match="2-D"):
        parallel_stylize(make_mesh(2, device_type="cpu"), SMALL,
                         spatial=True)
