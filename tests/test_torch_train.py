"""The port's training path against the JAX package's, on the CPU.

Weights are made by vstnet_tpu (init_revresnet, init_vgg) and carried
across with io/checkpoint.params_from_jax and models/vgg.vgg_params_from_jax;
inputs are numpy arrays from a seed. SMALL is the one-block-per-stage
config of tests/test_train.py, at 32x32 crops and B <= 2.

Tolerances, float32 on both sides:
  * VGG features: 1e-5 relative (13 convs of roundoff); the losses 1e-5
    against the port's float64 run and 3e-5 against JAX, whose float32
    style loss lies 1.6e-5 from float64;
  * the matting loss: 1e-5 relative; its gradient within 1e-6 of the
    gradient's scale on a textured image, and 5e-4 on one with a flat
    region, where windows that are partly flat have near-singular
    covariances: there both packages lie up to 3.8e-3 of the scale from a
    float64 run and agree with each other to 1.3e-4 (4 seeds);
  * flow_warp_nearest, generate_fake_flow and the loader's crops: equal;
  * loss_and_grads: aux rtol 1e-4 / atol 2e-5, grads rtol 2e-5 / atol
    2e-6, the bounds of test_train.py's test_flat_step_matches_tree_step,
    against JAX and against the port's own float64 run. In the temporal
    phase JAX's float32 gradient lies up to 2.74 such bounds from the
    float64 run (one bias; the port's: 0.74), so there the port is held to
    3 bounds against JAX;
  * three optimizer steps against optax's chain: params within 1e-6;
  * the bf16 route against float32: the contract of test_train.py's
    test_bf16_mixed_precision_step (float32 grads, cosine > 0.95, aux
    rtol 0.1 / atol 5e-3).

The port's side of loss_and_grads runs in a child process with
MKL_CBWR=COMPATIBLE and oneDNN off. The step's gradient is a sum of terms
that cancel (decode undoes encode, and the cycle pass returns the content
exactly), so it needs two evaluations of one conv backward to round alike.
On this CPU they do not: with oneDNN the port lies up to 1280 bounds
(image) and 5914 (temporal) from float64, and with MKL's sgemm, whose
rounding follows the buffers' alignment, 138 and 71; in MKL's reproducible
mode 0.32 and 0.74 (scripts/torch_train_precision.py, which also gives
the numbers above). That mode must be set before MKL starts, hence the
child process. On the card cuDNN computes these convs.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu.models.vgg import init_vgg as jinit_vgg
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import params_from_jax
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.vgg import VGG, vgg_params_from_jax
from vstnet_tpu_torch.train.losses import AUX_KEYS, LossWeights, loss_and_grads

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(1, 1, 1))
JSMALL = JaxConfig(n_blocks=(1, 1, 1))
LINE = re.compile(
    r"^Iteration: \d{8}/\d{8}  content_loss:-?\d+\.\d{4}  "
    r"lap_loss:-?\d+\.\d{4}  rec_loss:-?\d+\.\d{4}  style_loss:-?\d+\.\d{4}"
    r"  loss_tmp:-?\d+\.\d{4}  loss_tmp_GT:-?\d+\.\d{4}  \(\d+\.\d{2} s/it\)$")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _net(params, cfg=SMALL):
    net = RevResNet(cfg, device="cpu")
    net.load_state_dict(params_from_jax(params))
    return net


@pytest.fixture(scope="module")
def weights():
    """(JAX params, JAX VGG params, port VGG) from seeds 0 and 1."""
    params = _np_tree(jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(0)))
    vggp = _np_tree(jax.jit(jinit_vgg)(jax.random.PRNGKey(1)))
    vgg = VGG(device="cpu")
    vgg.load_state_dict(vgg_params_from_jax(vggp))
    return params, vggp, vgg


def _batch(seed, b=2, hw=32):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(b, hw, hw, 3)).astype(np.float32)
    s = rng.uniform(size=(b, hw, hw, 3)).astype(np.float32)
    flow = (rng.normal(size=(b, hw, hw, 2)) * 2).astype(np.float32)
    noise = (rng.normal(size=(b, hw, hw, 3)) * 1e-3).astype(np.float32)
    return a, s, flow, noise


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_vgg_matches_jax(weights):
    from vstnet_tpu.models.vgg import vgg_features, vgg_losses as jlosses
    from vstnet_tpu_torch.models.vgg import vgg_losses

    _, vggp, vgg = weights
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(1, 33, 37, 3)).astype(np.float32)  # ceil pools
    want = vgg_features(vggp, jnp.asarray(x), n_layer=5)
    got = vgg.features(_t(x), n_layer=5)
    assert len(got) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())

    a, s, _, _ = _batch(1)
    st = rng.uniform(size=a.shape).astype(np.float32)
    jc, js = jlosses(vggp, jnp.asarray(a), jnp.asarray(s), jnp.asarray(st),
                     content_weight=1.0)
    c, sl = vgg_losses(vgg, _t(a), _t(s), _t(st), content_weight=1.0)
    vgg64 = VGG(device="cpu").double()
    vgg64.load_state_dict(vgg.state_dict())
    c64, sl64 = vgg_losses(vgg64, _t(a).double(), _t(s).double(),
                           _t(st).double(), content_weight=1.0)
    for ours, ref64, theirs in ((c, c64, jc), (sl, sl64, js)):
        np.testing.assert_allclose(float(ours), float(ref64), rtol=1e-5)
        # JAX's float32 style loss lies 1.6e-5 from float64 (measured)
        np.testing.assert_allclose(float(ours), float(theirs), rtol=3e-5)


def test_matting_matches_jax():
    from vstnet_tpu.ops.matting import matting_loss_and_grad as jmat
    from vstnet_tpu_torch.ops.matting import matting_loss_and_grad

    rng = np.random.default_rng(2)
    img = rng.uniform(size=(2, 20, 24, 3)).astype(np.float32)
    img[1, :10] = 0.5                   # a flat region
    x = rng.uniform(size=(2, 20, 24, 3)).astype(np.float32)
    jl, jg = jmat(jnp.asarray(img), jnp.asarray(x))
    loss, grad = matting_loss_and_grad(_t(img), _t(x))
    assert loss.dtype == grad.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-5)
    jg = np.asarray(jg)
    for i, tol in ((0, 1e-6), (1, 5e-4)):
        scale = np.abs(jg[i]).max()
        np.testing.assert_allclose(grad[i].numpy(), jg[i], rtol=0,
                                   atol=tol * scale, err_msg=f"sample {i}")


def test_flow_warp_bit_equal_to_jax():
    from vstnet_tpu.ops.warp import flow_warp_nearest as jwarp
    from vstnet_tpu_torch.ops.warp import flow_warp_nearest

    rng = np.random.default_rng(3)
    for h, w in ((17, 23), (32, 32)):
        x = rng.uniform(size=(2, h, w, 3)).astype(np.float32)
        # half-integer flows put sample positions near x.5 ties; large
        # ones reach the border
        flows = [rng.integers(-12, 13, size=(2, h, w, 2)) / 2.0,
                 rng.normal(size=(2, h, w, 2)) * 3,
                 np.full((2, h, w, 2), 40.0)]
        for f in flows:
            f = f.astype(np.float32)
            want = np.asarray(jwarp(jnp.asarray(x), jnp.asarray(f)))
            np.testing.assert_array_equal(
                flow_warp_nearest(_t(x), _t(f)).numpy(), want)


def test_generate_fake_flow_equals_jax():
    from vstnet_tpu.ops.warp import generate_fake_flow as jflow
    from vstnet_tpu_torch.ops.warp import generate_fake_flow

    for h, w in ((32, 32), (256, 312)):
        np.testing.assert_array_equal(
            generate_fake_flow(np.random.default_rng(5), h, w),
            jflow(np.random.default_rng(5), h, w))


# The port's loss_and_grads on the weights and batches of the tests below:
# float32 and float64 in both phases, and float32 with remat in the temporal
# phase, written by torch.save to argv[1]/out.pt.
_PORT_SIDE = r"""
import sys
import torch
torch.backends.mkldnn.enabled = False
torch.set_num_threads(2)
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.vgg import VGG
from vstnet_tpu_torch.train.losses import LossWeights, loss_and_grads

d = sys.argv[1]
blob = torch.load(d + "/in.pt", weights_only=True)
cfg = RevResNetConfig(n_blocks=(1, 1, 1))
out = {}
for temporal, tag, precision, c in (
        (False, "f32", "f32", cfg), (False, "f64", "f64", cfg),
        (True, "f32", "f32", cfg), (True, "f64", "f64", cfg),
        (True, "remat", "f32", cfg.with_remat())):
    dt = torch.float64 if precision == "f64" else torch.float32
    net = RevResNet(c, device="cpu").to(dt)
    net.load_state_dict(blob["net"])
    vgg = VGG(device="cpu").to(dt)
    vgg.load_state_dict(blob["vgg"])
    b = {k: v.to(dt) for k, v in blob["batch"].items()}
    grads, aux = loss_and_grads(net, vgg, b["a"], b["s"],
                                LossWeights(lap=10.0), b["flow"].float(),
                                b["noise"], temporal, precision=precision)
    out[(temporal, tag)] = ({k: v.clone() for k, v in grads.items()}, aux)
torch.save(out, d + "/out.pt")
"""


@pytest.fixture(scope="module")
def port_grads(weights, tmp_path_factory):
    """{(temporal, "f32" | "f64" | "remat"): (grads, aux)} of the port, on
    _batch(4), computed in a child process (see the module docstring)."""
    import os
    import pathlib
    import subprocess
    import sys

    params, _, vgg = weights
    d = tmp_path_factory.mktemp("port_side")
    torch.save({"net": params_from_jax(params), "vgg": vgg.state_dict(),
                "batch": {k: _t(v) for k, v in zip(
                    ("a", "s", "flow", "noise"), _batch(4))}},
               d / "in.pt")
    env = dict(os.environ, MKL_CBWR="COMPATIBLE")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _PORT_SIDE, str(d)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return torch.load(d / "out.pt", weights_only=False)


@pytest.mark.parametrize("temporal", [False, True], ids=["image", "temporal"])
def test_loss_and_grads_match_jax(weights, port_grads, temporal):
    from vstnet_tpu.train.losses import loss_and_grads as jloss

    params, vggp, _ = weights
    a, s, flow, noise = _batch(4)
    jg, jaux = jloss(params, vggp, jnp.asarray(a), jnp.asarray(s),
                     jnp.asarray(flow), jnp.asarray(noise), JSMALL,
                     LossWeights(lap=10.0), temporal)
    grads, aux = port_grads[(temporal, "f32")]
    g64, aux64 = port_grads[(temporal, "f64")]
    for k in AUX_KEYS:
        for want in (float(jaux[k]), float(aux64[k])):
            np.testing.assert_allclose(float(aux[k]), want, rtol=1e-4,
                                       atol=2e-5, err_msg=k)
    assert float(aux["loss_lap"]) > 0
    assert (float(aux["loss_tmp"]) > 0) == temporal
    want = params_from_jax(_np_tree(jg))
    assert set(grads) == set(want)
    bounds = 3 if temporal else 1
    for k, g in grads.items():
        assert g.dtype == torch.float32 and g64[k].dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), g64[k].numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=k)
        np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                   rtol=2e-5 * bounds, atol=2e-6 * bounds,
                                   err_msg=k)


def test_remat_changes_no_gradient(port_grads):
    grads, aux = port_grads[(True, "f32")]
    rgrads, raux = port_grads[(True, "remat")]
    for k in grads:
        assert torch.equal(grads[k], rgrads[k]), k
    for k in AUX_KEYS:
        assert torch.equal(aux[k], raux[k]), k


def test_optimizer_matches_optax():
    import optax
    from vstnet_tpu.train.trainer import TrainConfig as JTC
    from vstnet_tpu.train.trainer import make_optimizer as jmake
    from vstnet_tpu_torch.train.trainer import (
        TrainConfig,
        clip_by_global_norm,
        make_optimizer,
    )

    rng = np.random.default_rng(7)
    shapes = [(16, 16, 3, 3), (16,), (64, 4, 3, 3), (4,)]
    p0 = [rng.normal(size=sh).astype(np.float32) * 0.1 for sh in shapes]
    # step 2's gradients have a global norm far above the clip of 5
    gs = [[rng.normal(size=sh).astype(np.float32) * scale for sh in shapes]
          for scale in (0.01, 3.0, 0.02)]
    assert np.sqrt(sum((g ** 2).sum() for g in gs[1])) > 5

    kw = dict(lr=1e-2, lr_decay=0.5)
    opt = jmake(JTC(**kw))
    jp = [jnp.asarray(p) for p in p0]
    jstate = opt.init(jp)
    tp = [torch.nn.Parameter(_t(p.copy())) for p in p0]
    topt, sched = make_optimizer(TrainConfig(**kw), tp)
    for g in gs:
        upd, jstate = opt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = _t(x.copy())
        clip_by_global_norm([p.grad for p in tp], 5.0)
        topt.step()
        sched.step()
    for p, q in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                   rtol=0, atol=1e-6)


def test_bf16_route_contract(weights):
    params, _, vgg = weights
    a, s, flow, noise = _batch(8)
    w = LossWeights(lap=10.0, temporal=0.0)
    net = _net(params)
    g32, aux32 = loss_and_grads(net, vgg, _t(a), _t(s), w)
    g32 = torch.cat([g.flatten() for g in g32.values()])
    g16, aux16 = loss_and_grads(net, vgg, _t(a), _t(s), w, precision="bf16")
    assert all(g.dtype == torch.float32 for g in g16.values())
    g16 = torch.cat([g.flatten() for g in g16.values()])
    assert torch.isfinite(g16).all()
    cos = float(torch.dot(g32, g16) / (g32.norm() * g16.norm()))
    assert cos > 0.95, f"bf16/f32 gradient cosine {cos:.4f}"
    for k in AUX_KEYS:
        assert aux16[k].dtype == torch.float32
        np.testing.assert_allclose(float(aux16[k]), float(aux32[k]),
                                   rtol=0.1, atol=5e-3, err_msg=k)


def _pngs(root, n, seed, size=(40, 52)):
    root.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray((rng.uniform(size=(*size, 3)) * 255).astype(
            np.uint8)).save(root / f"{i}.png")
    return str(root)


def test_loader_crops_equal_jax(tmp_path):
    from vstnet_tpu.train.data import InfiniteLoader as JLoader
    from vstnet_tpu_torch.train.data import InfiniteLoader

    d = _pngs(tmp_path / "imgs", 5, 9)
    ours = InfiniteLoader(d, 2, new_size=32, crop=24, num_workers=1, seed=3)
    theirs = JLoader(d, 2, new_size=32, crop=24, num_workers=1, seed=3)
    try:
        for _ in range(4):
            np.testing.assert_array_equal(next(ours), next(theirs))
        np.testing.assert_array_equal(ours.sample(3), theirs.sample(3))
    finally:
        ours.close()
        theirs.close()


def test_loader_smaller_dataset_than_batch(tmp_path):
    from vstnet_tpu_torch.train.data import InfiniteLoader

    loader = InfiniteLoader(_pngs(tmp_path / "imgs", 2, 10, (20, 20)),
                            batch_size=5, new_size=16, crop=16,
                            num_workers=1)
    try:
        assert next(loader).shape == (5, 16, 16, 3)
    finally:
        loader.close()


def test_save_revresnet_reads_in_both_packages(weights, tmp_path):
    from vstnet_tpu.io.checkpoint import load_revresnet as jload
    from vstnet_tpu_torch.io.checkpoint import load_revresnet, save_revresnet

    params = weights[0]
    net = _net(params)
    path = str(tmp_path / "m.pt")
    save_revresnet(net, path)
    sd = load_revresnet(path)
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = params_from_jax(_np_tree(jload(path)))
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k


def test_cli_trains_and_resumes(tmp_path, monkeypatch):
    import vstnet_tpu_torch.train.trainer as tr
    from vstnet_tpu_torch.cli.train import main

    monkeypatch.setattr(tr, "PHOTO_CONFIG", SMALL)
    argv = ["--device", "cpu",
            "--train_content", _pngs(tmp_path / "content", 3, 11),
            "--train_style", _pngs(tmp_path / "style", 3, 12),
            "--vgg_ckpoint", str(tmp_path / "missing.pth"),
            "--batch_size", "1", "--new_size", "32", "--crop_size", "32",
            "--use_lap", "False", "--log_every", "1", "--display_size", "2",
            "--training_iterations", "1", "--fine_tuning_iterations", "3",
            "--logs_directory", str(tmp_path / "logs"), "--base_name", "run"]
    state = main(argv + ["--max_steps", "2"])
    assert state.step == 2
    # step 3 is temporal (step 2 > training_iterations 1)
    state = main(argv + ["--max_steps", "1", "--resume"])
    assert state.step == 3
    run = tmp_path / "logs" / "run"
    lines = (run / "loss.log").read_text().splitlines()
    assert len(lines) == 3 and all(LINE.match(x) for x in lines), lines
    assert [int(x[11:19]) for x in lines] == [1, 2, 3]
    assert "lap_loss:0.0000" in lines[0]
    assert "loss_tmp:0.0000" in lines[1]
    assert "loss_tmp:0.0000" not in lines[2]
    ckpt = run / "checkpoints"
    for name in ("last.pt", "last.pt.opt.msgpack", "model_image.pt"):
        assert (ckpt / name).exists(), name
    assert (run / "images" / "train_current.jpg").exists()


def test_opt_pt_of_earlier_versions_still_resumes(tmp_path, monkeypatch):
    """A checkpoint whose optimizer went to `<ckpt>.opt.pt` (torch.save of
    the optimizer's and the schedule's state dicts and the step, as this
    trainer wrote before `.opt.msgpack`) resumes with Adam's state, the
    schedule and the step as saved, and its next update equals the live
    state's bit for bit."""
    import vstnet_tpu_torch.train.trainer as tr
    from vstnet_tpu_torch.io.checkpoint import save_revresnet

    monkeypatch.setattr(tr, "PHOTO_CONFIG", SMALL)
    tc = tr.TrainConfig(lr=1e-2, lr_decay=0.5)
    state = tr.init_train_state(tc, "cpu")
    rng = np.random.default_rng(5)
    grads = [[_t((rng.normal(size=tuple(p.shape)) * 1e-2).astype(np.float32))
              for p in state.net.parameters()] for _ in range(3)]
    for gs in grads[:2]:
        for p, g in zip(state.net.parameters(), gs):
            p.grad = g.clone()
        tr.apply_gradients(state, tc)
    save_revresnet(state.net, str(tmp_path / "last.pt"))
    torch.save({"optimizer": state.opt.state_dict(),
                "scheduler": state.sched.state_dict(), "step": state.step},
               tmp_path / "last.pt.opt.pt")
    r = tr.load_checkpoint(tc, str(tmp_path), device="cpu")
    assert r.step == 2 and r.sched.last_epoch == 2
    assert r.opt.param_groups[0]["lr"] == state.opt.param_groups[0]["lr"]
    for p, q in zip(state.net.parameters(), r.net.parameters()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state.opt.state[p][k], r.opt.state[q][k]), k
    for st in (state, r):
        for p, g in zip(st.net.parameters(), grads[2]):
            p.grad = g.clone()
        tr.apply_gradients(st, tc)
    for p, q in zip(state.net.parameters(), r.net.parameters()):
        assert torch.equal(p, q)
    assert tr.load_checkpoint(tc, str(tmp_path), resume_iter=7,
                              device="cpu").step == 7


def test_cli_without_card_or_device_exits(tmp_path, monkeypatch):
    from vstnet_tpu_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(["--train_content", str(tmp_path),
              "--train_style", str(tmp_path), "--max_steps", "1"])
    assert exc.value.code not in (None, 0)
    assert "--device cpu" in str(exc.value.code)


def test_inference_builds_no_graph(weights):
    from vstnet_tpu_torch.models import pipeline

    net = _net(weights[0])
    x = _t(np.random.default_rng(13).uniform(size=(1, 16, 16, 3)).astype(
        np.float32))
    assert all(p.requires_grad for p in net.parameters())
    z = net.encode(x)
    assert not z.requires_grad and not net.decode(z).requires_grad
    assert not pipeline.stylize(net, x, x).requires_grad
    model = pipeline.StyleModel(cfg=SMALL, net=net, mode="photorealistic")
    for fast in (False, True):
        assert not model.stylize(x, x, fast=fast).requires_grad
    # the training path builds one, and equals the inference path in f32
    zt = net(x)
    assert zt.requires_grad and torch.equal(zt.detach(), z)
    assert torch.equal(net.inverse(zt).detach(), net.decode(z))


def test_training_modules_never_import_jax():
    """The training path imports neither jax nor vstnet_tpu: with both
    blocked, its modules import and one loss_and_grads runs."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['vstnet_tpu'] = None\n"
        "import torch\n"
        "from vstnet_tpu_torch.cli import train as cli\n"
        "from vstnet_tpu_torch.models.vgg import init_vgg\n"
        "from vstnet_tpu_torch.ops import matting, warp\n"
        "from vstnet_tpu_torch.train import data, trainer\n"
        "from vstnet_tpu_torch.train.losses import LossWeights, "
        "loss_and_grads\n"
        "tc = trainer.TrainConfig()\n"
        "trainer.PHOTO_CONFIG = tc.model_cfg.__class__(n_blocks=(1, 1, 1))\n"
        "state = trainer.init_train_state(tc, 'cpu')\n"
        "vgg = init_vgg(torch.Generator().manual_seed(0), device='cpu')\n"
        "x = torch.rand(1, 16, 16, 3)\n"
        "aux = trainer.train_step(state, vgg, x, x, tc)\n"
        "assert state.step == 1 and torch.isfinite(aux['loss_total'])\n"
        "assert not [m for m in sys.modules if m.startswith('jax')\n"
        "            and sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_load_vgg_reads_the_bare_sequential_file(weights, tmp_path):
    """vgg_normalised.pth is a bare Sequential state dict with layers past
    relu5_1: strict loading takes the network's tensors and ignores the
    rest; strict=False keeps init_vgg(seed)'s value for a missing one."""
    from vstnet_tpu_torch.models.vgg import init_vgg, load_vgg

    vgg = weights[2]
    sd = dict(vgg.state_dict())
    sd["46.weight"] = torch.zeros(512, 512, 3, 3)      # deeper layers
    path = tmp_path / "vgg_normalised.pth"
    torch.save(sd, path)
    got = load_vgg(str(path), device="cpu")
    for k, v in vgg.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    assert not any(p.requires_grad for p in got.parameters())
    del sd["42.bias"]
    torch.save(sd, path)
    with pytest.raises(KeyError):
        load_vgg(str(path), device="cpu")
    with pytest.warns(UserWarning) as rec:
        got = load_vgg(str(path), strict=False, seed=3, device="cpu")
    assert any("42.bias" in str(w.message) for w in rec)
    assert any("46.weight" in str(w.message) for w in rec)
    init = init_vgg(torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(got[42].bias, init[42].bias)
    assert torch.equal(got[42].weight, vgg[42].weight)
