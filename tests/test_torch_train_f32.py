"""Why the float32 training step lies far from float64 on one batch.

tests/test_torch_spatial_train.py's batch (64x16, B = 2, SMALL, seed 14,
lap 10): the port's float32 loss_and_grads lies 9.0e-3 (image phase) and
6.9e-4 (temporal) of stack.0.conv.1.bias's max |g| from its own float64
step, where the JAX package's jitted loss_and_grads_flat lies 1.3e-5 and
1.2e-5 from it. The cycle pass carries it (encode the stylized image,
cWCT against z_c, decode, L1 against the content): the cycle returns the
content, so its gradient is a sum of terms that cancel, and one ReLU
decides the rest. In the cycle's decode, the stage-1 block's first conv
has one pre-activation 1.5e-9 from zero in float64, 2.4e-7 of the layer's
max |pre|, inside float32's rounding: the float32 step puts it on the
other side, and the gradient flows through one unit more. No L1 sign
differs from float64. The JAX package's own float32 step lands on the same
side when it runs op by op (jax.disable_jit; only XLA's fusion differs),
and then lies as far from float64, within the flat bound of the port.
So the distance is a tie that float32 does not decide, in both packages,
not a fault of the port (scripts/torch_train_f32_tie.py prints the
numbers).

What the tests hold, in each phase:
  * the port's float32 step differs from float64 in ReLU decisions only
    at ties (|pre| <= 1e-6 of its layer's max in float64; measured: one,
    at 2.4e-7), and in no sign of an L1 that a weight's gradient reads;
  * with float64's decision at those ties (the ReLU's mask taken from the
    float64 run, nothing else changed) the port's float32 step is within
    the flat bound of test_torch_train.py (rtol 2e-5, atol 2e-6) of the
    JAX package's jitted step and of its own float64 step, times 2 bounds
    in the image phase and 4 in the temporal: JAX's own jitted step lies
    1.55 and 3.09 bounds from float64 here (measured: the port with the
    ties decided 1.80 and 2.78 from JAX, 0.83 and 1.92 from float64);
    as each tensor's max |dg| over its max |g|, 1.7e-5 and 1.5e-5 from
    JAX, where JAX lies 1.3e-5 and 1.2e-5 from float64;
  * JAX's float32 step run op by op moves from its jitted form by at least
    half the port's distance from float64 (measured: as far, 9.0e-3 and
    6.9e-4), and the port's unforced float32 step lies within 1e-4 of
    each tensor's max of it (measured 2.6e-5 and 1.4e-5).

The port's side runs in a child process with MKL_CBWR=COMPATIBLE and
oneDNN off, as tests/test_torch_train.py does and for its reason. This
file checks the image phase; tests/test_torch_train_f32_temporal.py runs
the same three tests on the temporal phase, so that xdist's --dist
loadfile gives the two phases to two workers.
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
from vstnet_tpu_torch.io.checkpoint import params_from_jax
from vstnet_tpu_torch.models.vgg import VGG, vgg_params_from_jax
from vstnet_tpu_torch.ops.warp import generate_fake_flow

torch.set_num_threads(2)

JSMALL = JaxConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 64, 16
WEIGHTS = dict(lap=10.0, temporal=60.0)
PHASES = [False, True]
# test_torch_train.py's flat bound, and the count of them per phase: the
# JAX package's own jitted float32 step lies 1.55 (image) and 3.09
# (temporal) bounds from the port's float64 step on this batch
RTOL, ATOL = 2e-5, 2e-6
BOUNDS = {False: 2, True: 4}
# each tensor's max |dg| over its max |g|: the port's float32 step against
# JAX's run op by op (measured 2.6e-5 image, 1.4e-5 temporal)
REL = 1e-4
# a ReLU decision counts as a tie within this share of its layer's max
TIE = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=14, b=2):
    """tests/test_torch_spatial_train.py's batch: (content, style, flow,
    noise) as numpy float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(b, H, W, 3)).astype(np.float32)
    s = rng.uniform(size=(b, H, W, 3)).astype(np.float32)
    flow = np.stack([generate_fake_flow(rng, H, W) for _ in range(b)])
    noise = (rng.normal(size=(b, H, W, 3)) * 1e-3).astype(np.float32)
    return a, s, flow, noise


# The port's side. In each phase: the float64 step, recording every ReLU's
# pre-activation (ops/pad_conv.reflect_conv, in call order) and the
# difference of every L1 on the gradient's path (train/losses._l1; not
# loss_tmp_gt, which no weight reaches); the float32 step, recording the same; the
# float32 step again with each ReLU's mask taken from the float64 run.
_PORT_SIDE = r"""
import sys
import torch
import torch.nn.functional as F
torch.backends.mkldnn.enabled = False
torch.set_num_threads(2)
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.vgg import VGG
from vstnet_tpu_torch.ops import pad_conv
from vstnet_tpu_torch.train import losses

d = sys.argv[1]
phases = [p == "temporal" for p in sys.argv[2].split(",")]
blob = torch.load(d + "/in.pt", weights_only=True)
cfg = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
w = losses.LossWeights(**blob["weights"])
plain_l1 = losses._l1
state = {}


def reflect_conv(x, wt, b=None, stride=1, relu=False):
    out = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), wt, b,
                   stride=stride)
    if not relu:
        return out
    state["pre"].append(out.detach().double())
    masks = state["masks"]
    if masks is None:
        return F.relu(out)
    return out * masks[len(state["pre"]) - 1].to(out.dtype)


def l1(x, y):
    if x.requires_grad or y.requires_grad:
        state["l1"].append((x - y).detach().double())
    return plain_l1(x, y)


pad_conv.reflect_conv = reflect_conv
losses._l1 = l1
out = {}
for temporal in phases:
    for tag, dt in (("f64", torch.float64), ("f32", torch.float32),
                    ("f32_ties", torch.float32)):
        state.update(pre=[], l1=[], masks=None)
        if tag == "f32_ties":
            state["masks"] = [p > 0 for p in out[(temporal, "f64")][1]]
        net = RevResNet(cfg, device="cpu").to(dt)
        net.load_state_dict(blob["net"])
        vgg = VGG(device="cpu").to(dt)
        vgg.load_state_dict(blob["vgg"])
        b = {k: (v if k == "flow" else v.to(dt))
             for k, v in blob["batch"].items()}
        g, _ = losses.loss_and_grads(
            net, vgg, b["a"], b["s"], w, b["flow"], b["noise"], temporal,
            precision=tag[:3])
        out[(temporal, tag)] = ({k: v.clone() for k, v in g.items()},
                                state["pre"], state["l1"])
torch.save(out, d + "/out.pt")
"""


def collect(d, phases=PHASES):
    """({(temporal, "f64" | "f32" | "f32_ties"): (grads, ReLU
    pre-activations, L1 differences)} of the port, from the child process,
    and {(temporal, "jit" | "eager"): grads} of the JAX package's
    loss_and_grads_flat, computed meanwhile, for each temporal in phases.
    d: a scratch directory."""
    from jax.flatten_util import ravel_pytree
    from vstnet_tpu.train.losses import LossWeights as JLossWeights
    from vstnet_tpu.train.losses import loss_and_grads_flat

    params = _np_tree(jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(5)))
    vggp = _np_tree(jax.jit(jinit_vgg)(jax.random.PRNGKey(6)))
    vgg = VGG(device="cpu")
    vgg.load_state_dict(vgg_params_from_jax(vggp))
    batch = _batch()
    torch.save({"net": params_from_jax(params), "vgg": vgg.state_dict(),
                "weights": WEIGHTS,
                "batch": {k: torch.from_numpy(v) for k, v in zip(
                    ("a", "s", "flow", "noise"), batch)}}, d / "in.pt")
    env = dict(os.environ, MKL_CBWR="COMPATIBLE")
    child = subprocess.Popen([sys.executable, "-c", _PORT_SIDE, str(d),
                              ",".join("temporal" if t else "image"
                                       for t in phases)],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        flat, unravel = ravel_pytree(jax.tree.map(jnp.asarray, params))

        def step(temporal, f, *args):
            g, _ = loss_and_grads_flat(f, unravel, vggp, *args, JSMALL,
                                       JLossWeights(**WEIGHTS), temporal)
            return g

        args = (flat, *map(jnp.asarray, batch))
        jax_out = {}
        for temporal in phases:
            g = jax.jit(step, static_argnums=0)(temporal, *args)
            with jax.disable_jit():
                ge = step(temporal, *args)
            for tag, v in (("jit", g), ("eager", ge)):
                jax_out[(temporal, tag)] = params_from_jax(
                    _np_tree(unravel(v)))
        _, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, err[-4000:]
    return torch.load(d / "out.pt", weights_only=False), jax_out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return collect(tmp_path_factory.mktemp("train_f32"), [False])


def _rel(got, want):
    """max |got - want| over max |want|, in float64."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max())


def _within_bound(got, want, temporal):
    b = BOUNDS[temporal]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            torch.as_tensor(got[k]).double().numpy(),
            torch.as_tensor(want[k]).double().numpy(), rtol=RTOL * b,
            atol=ATOL * b, err_msg=k)


def _worst(got, want):
    return max(_rel(got[k], want[k]) for k in want)


@pytest.mark.parametrize("temporal", [False], ids=["image"])
def test_float32_differs_from_float64_only_at_relu_ties(steps, temporal):
    port, _ = steps
    _, pre64, l1_64 = port[(temporal, "f64")]
    g32, pre32, l1_32 = port[(temporal, "f32")]
    g64 = port[(temporal, "f64")][0]
    assert len(pre32) == len(pre64) and len(l1_32) == len(l1_64) > 0
    flips = 0
    for p32, p64 in zip(pre32, pre64):
        flip = (p32 > 0) != (p64 > 0)
        flips += int(flip.sum())
        if flip.any():
            assert float(p64[flip].abs().max()) <= TIE * float(
                p64.abs().max())
    for x32, x64 in zip(l1_32, l1_64):
        assert torch.equal(torch.sign(x32), torch.sign(x64))
    # the distance this file explains: far beyond the flat bound
    assert flips >= 1
    assert _worst(g32, g64) > 1e-4


@pytest.mark.parametrize("temporal", [False], ids=["image"])
def test_float32_with_float64_ties_matches_jax_and_float64(steps,
                                                           temporal):
    port, jax_out = steps
    ties = port[(temporal, "f32_ties")][0]
    assert all(g.dtype == torch.float32 for g in ties.values())
    _within_bound(ties, jax_out[(temporal, "jit")], temporal)
    _within_bound(ties, port[(temporal, "f64")][0], temporal)


@pytest.mark.parametrize("temporal", [False], ids=["image"])
def test_jax_float32_moves_as_far_op_by_op(steps, temporal):
    port, jax_out = steps
    g32, g64 = port[(temporal, "f32")][0], port[(temporal, "f64")][0]
    jit, eager = jax_out[(temporal, "jit")], jax_out[(temporal, "eager")]
    assert _worst(eager, jit) >= 0.5 * _worst(g32, g64)
    assert _worst(eager, g64) >= 0.5 * _worst(g32, g64)
    for k in eager:
        assert _rel(g32[k], eager[k]) <= REL, (k, _rel(g32[k], eager[k]))
