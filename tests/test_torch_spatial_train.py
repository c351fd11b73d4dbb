"""The row-sharded (spatial) training step's terms and loss_and_grads_rows
(vstnet_tpu_torch/train/losses.py, parallel/halo.forward_rows and
inverse_rows, models/vgg.features_rows, ops/matting's and ops/warp's row
forms, cwct's row transfer) against the whole-image functions and
against the JAX package's loss_and_grads_flat, on a (1, S) mesh of CPU
replicas (make_mesh(S, ("data", "spatial"), spatial=S,
device_type="cpu")), S = 2 at 32x16 and S = 4 at 64x16 (16 rows a
shard; the whole step on one 64x16 batch at both), B = 2, SMALL.
Weights come from vstnet_tpu's init_revresnet and init_vgg through
params_from_jax and vgg_params_from_jax; images, flow and noise from a
numpy seed. tests/test_torch_spatial_train_grid.py
holds the step itself on a (2, 2) grid of gloo ranks.

Tolerances:
  * each term's row form against the whole-image function, float32:
    values within 1e-5 relative (the VGG losses, the matting loss, the
    transfer), gradients within 1e-5 of each tensor's max |g| (matting:
    1e-6 of the gradient's scale, as tests/test_torch_train.py holds it
    against JAX); the warp and its gradient equal bit for bit, ties at
    .5 included; the walk (forward_rows, inverse_rows) within 1e-5;
  * the same in bf16: the transfer within one bf16 ulp of the output's
    scale and the walk within 2 ulps (a bf16 conv on a shard may round
    an element the other way), the VGG losses within 1e-2 relative,
    every gradient's cosine against the whole image's > 0.99;
  * loss_and_grads_rows against loss_and_grads, float32: per parameter
    tensor max |dg| <= 1e-4 of its max |g| (measured up to 1.2e-5), the
    whole gradient's cosine > 0.99999, aux rtol 1e-4 / atol 2e-5;
    against JAX's loss_and_grads_flat on the whole batch each tensor no
    further than the port's unsharded step plus 1e-4 of its max
    (measured: 4.5e-6 further), cosine > 0.99999, the same aux bounds.
    Not a flat bound against JAX because on this batch the port's
    float32 step, whole or in rows, lies 9.0e-3 (image phase) and
    6.9e-4 (temporal) of stack.0.conv.1.bias's max from its own float64
    step and from JAX's jitted step, where JAX lies 1.3e-5 and 1.2e-5
    from it: one ReLU of the cycle's decode has a pre-activation 2.4e-7
    of its layer's max from zero, which float32 puts on the other side
    than float64. JAX's own float32 step run op by op takes the same
    side and lies as far; with float64's side the port's step is within
    a flat bound of JAX's. tests/test_torch_train_f32.py holds that on
    this batch; it is the unsharded step's, which this file does not
    change. The float64 row form equals the float64
    whole-image step within 1e-10 of each tensor's max (measured
    2.2e-14): the split itself is exact. bf16 route against the
    unsharded bf16 step: cosine > 0.99 (measured 0.99991-0.99994), aux
    rtol 1e-2 / atol 1e-3.

The port's side of loss_and_grads runs in a child process with
MKL_CBWR=COMPATIBLE and oneDNN off, as tests/test_torch_train.py does
and for its reason: the step's cancelling terms need two evaluations of
one conv backward to round alike.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu.models.vgg import init_vgg as jinit_vgg
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import params_from_jax
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.vgg import (
    VGG,
    features_rows,
    vgg_losses,
    vgg_losses_rows,
    vgg_params_from_jax,
)
from vstnet_tpu_torch.ops.matting import (
    matting_loss_and_grad,
    matting_loss_and_grad_rows,
)
from vstnet_tpu_torch.ops.warp import flow_warp_nearest, generate_fake_flow
from vstnet_tpu_torch.parallel import (
    forward_rows,
    inverse_rows,
    make_mesh,
    shard_batch,
)
from vstnet_tpu_torch.train.losses import (
    AUX_KEYS,
    LossWeights,
    loss_and_grads_rows,
)

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
JSMALL = JaxConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
# (S, H): 16 rows a shard, W = 16
CASES = [(2, 32), (4, 64)]
W = 16
# the whole step's batch, split into 32 rows a shard at S = 2 and 16 at
# S = 4: one shape, so that JAX compiles its step once a phase
STEP_H = 64
WEIGHTS = dict(lap=10.0, temporal=60.0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x, dt=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dt)


def _rows(x, s, dim=1):
    return list(x.split(x.shape[dim] // s, dim=dim))


def _batch(seed, h, b=2):
    """(content, style, flow, noise) as numpy float32; the flow is
    generate_fake_flow's (blurred noise plus a global shift of up to
    10 px), so a shard reads rows of its neighbours."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(b, h, W, 3)).astype(np.float32)
    s = rng.uniform(size=(b, h, W, 3)).astype(np.float32)
    flow = np.stack([generate_fake_flow(rng, h, W) for _ in range(b)])
    noise = (rng.normal(size=(b, h, W, 3)) * 1e-3).astype(np.float32)
    return a, s, flow, noise


@pytest.fixture(scope="module")
def weights():
    """(JAX params, JAX VGG params, the port's net and VGG)."""
    params = _np_tree(jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(5)))
    vggp = _np_tree(jax.jit(jinit_vgg)(jax.random.PRNGKey(6)))
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(params_from_jax(params))
    vgg = VGG(device="cpu")
    vgg.load_state_dict(vgg_params_from_jax(vggp))
    return params, vggp, net, vgg


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _bf16_ulp(x):
    return float(x.abs().max()) * 2.0 ** -7


# ---------------------------------------------------------------------------
# The terms' row forms against the whole-image functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,h", CASES)
def test_walk_rows_match_forward_and_inverse(weights, s, h, dt):
    """forward_rows / inverse_rows against RevResNet.forward / inverse,
    values and the weights' gradient of a fixed projection; with remat
    the gradient is the same bit for bit."""
    _, _, net, _ = weights
    x = _t(_batch(1, h)[0], dt)
    proj = _t(np.random.default_rng(2).standard_normal(x.shape), dt)

    def grads(net, fn):
        net.zero_grad(set_to_none=True)
        y = fn(net)
        (y.float() * proj.float()).sum().backward()
        return y.detach(), torch.cat([p.grad.flatten()
                                      for p in net.parameters()])

    def rows(net):
        zs = forward_rows(net, _rows(x, s))
        return torch.cat(inverse_rows(net, [z * 1.5 for z in zs]), 1)

    want, gw = grads(net, lambda n: n.inverse(n(x) * 1.5))
    got, gr = grads(net, rows)
    assert got.dtype == dt and got.shape == want.shape
    if dt == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
        assert _rel(gr, gw) < 1e-5
    else:
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2 * _bf16_ulp(want.float()), err
        assert _cos(gr, gw) > 0.99
    remat = RevResNet(SMALL.with_remat(), device="cpu")
    remat.load_state_dict(net.state_dict())
    assert torch.equal(grads(remat, rows)[1], gr)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,h", CASES)
def test_vgg_losses_rows_match_whole_image(weights, s, h, dt):
    """Content weight 1, so both losses; their gradient in the stylized
    image (the style and content branches carry none)."""
    _, _, _, vgg = weights
    a, st, _, _ = _batch(3, h)
    stylized = _t(np.random.default_rng(4).uniform(size=a.shape), dt)
    a, st = _t(a, dt), _t(st, dt)

    def run(fn, x):
        x = x.detach().requires_grad_(True)
        c, sl = fn(x)
        (c + 100.0 * sl).backward()
        return c.detach(), sl.detach(), x.grad

    c, sl, g = run(lambda x: vgg_losses(vgg, a, st, x, content_weight=1.0),
                   stylized)
    leaves = [x.detach().requires_grad_(True)
              for x in _rows(stylized, s)]
    cr, slr = vgg_losses_rows(vgg, _rows(a, s), _rows(st, s), leaves,
                              content_weight=1.0)
    (cr + 100.0 * slr).backward()
    cr, slr = cr.detach(), slr.detach()
    gr = torch.cat([x.grad for x in leaves], 1)
    assert cr.dtype == slr.dtype == torch.float32
    assert float(sl) > 0 and float(c) > 0
    if dt == torch.float32:
        np.testing.assert_allclose(float(cr), float(c), rtol=1e-5)
        np.testing.assert_allclose(float(slr), float(sl), rtol=1e-5)
        assert _rel(gr, g) < 1e-5
    else:
        np.testing.assert_allclose(float(cr), float(c), rtol=1e-2)
        np.testing.assert_allclose(float(slr), float(sl), rtol=1e-2)
        assert _cos(gr, g) > 0.99
    feats = features_rows(vgg, _rows(a, s), n_layer=4)
    assert [f[0].shape[2] for f in feats] == [h // s, h // s // 2,
                                              h // s // 4, h // s // 8]


@pytest.mark.parametrize("s,h", CASES)
def test_matting_rows_match_whole_image(s, h):
    """The loss and 2 L x / HW; the gradient of the rows around each
    shard boundary (a shard's last 2 rows feed the windows of the shard
    above) is checked apart."""
    rng = np.random.default_rng(5)
    img = _t(rng.uniform(size=(2, h, W, 3)))
    x = _t(rng.uniform(size=(2, h, W, 3)))
    loss, grad = matting_loss_and_grad(img, x)
    loss_r, grads_r = matting_loss_and_grad_rows(_rows(img, s), _rows(x, s))
    np.testing.assert_allclose(loss_r.numpy(), loss.numpy(), rtol=1e-5)
    got = torch.cat(grads_r, 1)
    scale = float(grad.abs().max())
    np.testing.assert_allclose(got.numpy(), grad.numpy(), rtol=0,
                               atol=1e-6 * scale)
    L = h // s
    for k in range(1, s):
        band = slice(k * L - 2, k * L + 2)
        assert float(grad[:, band].abs().max()) > 0.1 * scale
        np.testing.assert_allclose(got[:, band].numpy(),
                                   grad[:, band].numpy(), rtol=0,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("s,h", CASES)
def test_warp_rows_equal_whole_image(s, h):
    """A band of flow rows warps from the whole frame as the whole flow
    does, bit for bit, with the gradient: generate_fake_flow's flow, and
    one whose every displacement lies on a .5 tie of the sample position
    (global rows and the global H give the whole frame's float sequence,
    so each tie rounds the same way)."""
    rng = np.random.default_rng(6)
    x = _t(rng.uniform(size=(2, h, W, 3)))
    fake = _t(np.stack([generate_fake_flow(rng, h, W) for _ in range(2)]))
    ties = _t(rng.integers(-12, 12, size=(2, h, W, 2)) + 0.5)
    for flow in (fake, ties):
        xx = x.clone().requires_grad_(True)
        want = flow_warp_nearest(xx, flow)
        want.sum().backward()
        xr = x.clone().requires_grad_(True)
        got = torch.cat([flow_warp_nearest(xr, f, k * (h // s))
                         for k, f in enumerate(_rows(flow, s))], 1)
        got.sum().backward()
        assert torch.equal(got, want)
        assert torch.equal(xr.grad, xx.grad)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,h", CASES)
def test_transfer_rows_matches_transfer(weights, s, h, dt):
    """The training step's row transfer, transfer_rows against
    style_factors_rows, against cwct.transfer: value and the gradient in
    both latents (the statistics, the Cholesky factors and the solve are
    differentiated through)."""
    _, _, net, _ = weights
    a, st, _, _ = _batch(7, h)
    with torch.no_grad():
        zc = net(_t(a)).to(dt)
        zs = net(_t(st)).to(dt)
    proj = _t(np.random.default_rng(8).standard_normal(zc.shape))

    def run(fn):
        c = zc.clone().requires_grad_(True)
        z = zs.clone().requires_grad_(True)
        y = fn(c, z)
        (y.float() * proj).sum().backward()
        return y.detach(), torch.cat([c.grad.flatten(), z.grad.flatten()])

    want, gw = run(cwct.transfer)
    got, gr = run(lambda c, z: torch.cat(cwct.transfer_rows(
        _rows(c, s), *cwct.style_factors_rows(_rows(z, s))), 1))
    assert got.dtype == dt
    if dt == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
        assert _rel(gr, gw) < 1e-5
    else:
        err = float((got.float() - want.float()).abs().max())
        assert err <= _bf16_ulp(want.float()), err
        assert _cos(gr, gw) > 0.99


def test_height_not_a_multiple_of_8s_raises(weights):
    """24 rows over 2 shards: 12 a shard, a multiple of the net's
    down_scale (4) but not of VGG's 8."""
    _, _, net, vgg = weights
    a, st, _, _ = _batch(9, 24)
    with pytest.raises(ValueError, match="a multiple of 16"):
        loss_and_grads_rows(net, vgg, _rows(_t(a), 2), _rows(_t(st), 2),
                            LossWeights(**WEIGHTS))
    with pytest.raises(ValueError, match="a multiple of 8"):
        features_rows(vgg, _rows(_t(a), 2))


def test_shard_batch_of_a_data_row():
    """The CPU mesh of this file and the rows it gives a rank."""
    mesh = make_mesh(2, ("data", "spatial"), spatial=2, device_type="cpu")
    assert mesh == ((torch.device("cpu"),) * 2,)
    x = torch.arange(2 * 32 * 1.0).reshape(2, 32, 1, 1)
    (row,) = shard_batch(mesh, x, spatial=True)
    assert [r.shape[1] for r in row] == [16, 16]
    assert torch.equal(torch.cat(row, 1), x)


# ---------------------------------------------------------------------------
# loss_and_grads_rows against loss_and_grads and JAX
# ---------------------------------------------------------------------------

# The port's side: in float32, float64 and bf16 and in both phases,
# loss_and_grads on the whole batch and loss_and_grads_rows on its S row
# shards (shard_batch of a (1, S) CPU mesh) for each S; torch.save to
# argv[1].
_PORT_SIDE = r"""
import sys
import torch
torch.backends.mkldnn.enabled = False
torch.set_num_threads(2)
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.vgg import VGG
from vstnet_tpu_torch.parallel import make_mesh, shard_batch
from vstnet_tpu_torch.train.losses import (
    LossWeights, loss_and_grads, loss_and_grads_rows)

d = sys.argv[1]
blob = torch.load(d + "/in.pt", weights_only=True)
cfg = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
w = LossWeights(**blob["weights"])
out = {}
for prec, dt in (("f32", torch.float32), ("f64", torch.float64),
                 ("bf16", torch.float32)):
    net = RevResNet(cfg, device="cpu").to(dt)
    net.load_state_dict(blob["net"])
    vgg = VGG(device="cpu").to(dt)
    vgg.load_state_dict(blob["vgg"])
    b = {k: (v if k == "flow" else v.to(dt))
         for k, v in blob["batch"].items()}
    for temporal in (False, True):
        g, aux = loss_and_grads(net, vgg, b["a"], b["s"], w, b["flow"],
                                b["noise"], temporal, precision=prec)
        out[("whole", temporal, prec)] = (
            {k: v.clone() for k, v in g.items()}, aux)
        for s in blob["shards"]:
            mesh = make_mesh(s, ("data", "spatial"), spatial=s,
                             device_type="cpu")
            rows = {k: shard_batch(mesh, v, spatial=True)[0]
                    for k, v in b.items()}
            g, aux = loss_and_grads_rows(net, vgg, rows["a"], rows["s"], w,
                                         rows["flow"], rows["noise"],
                                         temporal, precision=prec)
            out[(s, temporal, prec)] = (
                {k: v.clone() for k, v in g.items()}, aux)
torch.save(out, d + "/out.pt")
"""


@pytest.fixture(scope="module")
def steps(weights, tmp_path_factory):
    """{("whole" or S, temporal, precision): (grads, aux)} of the port's
    loss_and_grads and loss_and_grads_rows on one batch of STEP_H x 16,
    from the child process, and {temporal: (grads, aux)} of JAX's
    loss_and_grads_flat on it, computed meanwhile."""
    from jax.flatten_util import ravel_pytree
    from vstnet_tpu.train.losses import LossWeights as JLossWeights
    from vstnet_tpu.train.losses import loss_and_grads_flat

    params, vggp, _, vgg = weights
    d = tmp_path_factory.mktemp("spatial_train")
    batch = _batch(14, STEP_H)
    torch.save({"net": params_from_jax(params), "vgg": vgg.state_dict(),
                "weights": WEIGHTS, "shards": [s for s, _ in CASES],
                "batch": dict(zip(("a", "s", "flow", "noise"),
                                  map(_t, batch)))}, d / "in.pt")
    env = dict(os.environ, MKL_CBWR="COMPATIBLE")
    child = subprocess.Popen([sys.executable, "-c", _PORT_SIDE, str(d)],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        flat, unravel = ravel_pytree(jax.tree.map(jnp.asarray, params))
        step = jax.jit(
            lambda f, a, s, fl, n, t: loss_and_grads_flat(
                f, unravel, vggp, a, s, fl, n, JSMALL,
                JLossWeights(**WEIGHTS), t), static_argnums=5)
        jax_out = {}
        for temporal in (False, True):
            g, aux = step(flat, *map(jnp.asarray, batch), temporal)
            jax_out[temporal] = (params_from_jax(_np_tree(unravel(g))),
                                 dict(zip(AUX_KEYS, np.asarray(aux))))
        _, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, err[-4000:]
    return torch.load(d / "out.pt", weights_only=False), jax_out


def _check_grads(got, want, bound):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert _rel(got[k], want[k]) <= bound, (k, _rel(got[k], want[k]))
    assert _cos(torch.cat([got[k].flatten() for k in want]),
                torch.cat([want[k].flatten() for k in want])) > 0.99999


def _check_aux(got, want, rtol=1e-4, atol=2e-5):
    for k in AUX_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("temporal", [False, True],
                         ids=["image", "temporal"])
@pytest.mark.parametrize("s", [s for s, _ in CASES])
def test_loss_and_grads_rows_match_whole_and_jax(steps, s, temporal):
    port, jax_out = steps
    gw, aw = port[("whole", temporal, "f32")]
    gr, ar = port[(s, temporal, "f32")]
    jg, jaux = jax_out[temporal]
    _check_grads(gr, gw, 1e-4)
    # against JAX: no further than the port's unsharded step, plus 1e-4
    for k in jg:
        assert _rel(gr[k], jg[k]) <= _rel(gw[k], jg[k]) + 1e-4, k
    assert _cos(torch.cat([gr[k].flatten() for k in jg]),
                torch.cat([jg[k].flatten() for k in jg])) > 0.99999
    _check_aux(ar, aw)
    _check_aux(ar, jaux)
    assert float(ar["loss_lap"]) > 0
    assert (float(ar["loss_tmp"]) > 0) == temporal


@pytest.mark.parametrize("temporal", [False, True],
                         ids=["image", "temporal"])
@pytest.mark.parametrize("s", [s for s, _ in CASES])
def test_loss_and_grads_rows_float64_is_exact(steps, s, temporal):
    port, _ = steps
    gw, aw = port[("whole", temporal, "f64")]
    gr, ar = port[(s, temporal, "f64")]
    for k in gw:
        assert gr[k].dtype == torch.float64
        assert _rel(gr[k], gw[k]) <= 1e-10, k
    _check_aux(ar, aw, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("temporal", [False, True],
                         ids=["image", "temporal"])
@pytest.mark.parametrize("s", [s for s, _ in CASES])
def test_loss_and_grads_rows_bf16_route(steps, s, temporal):
    port, _ = steps
    gw, aw = port[("whole", temporal, "bf16")]
    gr, ar = port[(s, temporal, "bf16")]
    assert all(g.dtype == torch.float32 for g in gr.values())
    flat_r = torch.cat([gr[k].flatten() for k in gw])
    assert torch.isfinite(flat_r).all()
    cos = _cos(flat_r, torch.cat([g.flatten() for g in gw.values()]))
    assert cos > 0.99, cos
    _check_aux(ar, aw, rtol=1e-2, atol=1e-3)
