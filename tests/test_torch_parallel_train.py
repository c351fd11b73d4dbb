"""The port's data-parallel training step and trainer
(vstnet_tpu_torch/parallel/sharding.parallel_train_step,
train/trainer.train(data_parallel=...)) against the JAX package's, on the
CPU. tests/test_torch_parallel.py holds the inference side; the two files
are apart so that pytest-xdist runs them on two workers.

Two gloo ranks run in child processes, with MKL_CBWR=COMPATIBLE and
oneDNN off for the reason given in tests/test_torch_train.py (the step's
gradient is a sum of terms that cancel, so two evaluations of one conv
backward must round alike). Weights come from vstnet_tpu's init_revresnet
and init_vgg through params_from_jax and vgg_params_from_jax; the global
batch (4 images of 16x16, 2 a rank) and the temporal step's flow and noise
come from a numpy seed. JAX's make_parallel_flat_step runs on a 2-device
CPU mesh meanwhile.

Tolerances: parameters bit-equal across ranks; against the port's
single-process steps on the global batch and against JAX, rtol = atol =
1e-4 with a mean absolute difference under 1e-6 (Adam's first steps
divide by sqrt(v), which lifts the reduction-order noise of a near-zero
gradient to the step size, lr = 1e-4), aux rtol 1e-4 / atol 2e-5: the
bounds of test_parallel.py's test_parallel_flat_step_matches_single.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu.parallel import make_mesh as jmake_mesh
from vstnet_tpu.parallel import shard_batch as jshard
from vstnet_tpu_torch.io.checkpoint import params_from_jax

torch.set_num_threads(2)

JSMALL = JaxConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
DIST_ENV = ("VSTNET_COORDINATOR", "VSTNET_NUM_PROCESSES", "VSTNET_PROCESS_ID",
            "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


# Runs as a file (spawned ranks import it as their main module): the
# port's single-process steps on the global batch, then the same two steps
# by parallel_train_step on 2 gloo ranks, then train(data_parallel="on")
# on 2 gloo ranks; everything lands under argv[1].
_PORT_SIDE = r'''
import os
import sys

import torch

torch.backends.mkldnn.enabled = False
torch.set_num_threads(1)

from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.vgg import VGG
from vstnet_tpu_torch.train.losses import LossWeights
from vstnet_tpu_torch.train import trainer as tr

SMALL = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
TC = tr.TrainConfig(weights=LossWeights(lap=10.0))


def _models(blob):
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(blob["net"])
    vgg = VGG(device="cpu")
    vgg.load_state_dict(blob["vgg"])
    return tr.init_train_state(TC, "cpu", net), vgg


def _steps(step_fn, rows, d, name):
    blob = torch.load(d + "/in.pt", weights_only=True)
    state, vgg = _models(blob)
    auxes = []
    for i, temporal in enumerate((False, True)):
        b = {k: v[rows] for k, v in blob["batches"][i].items()}
        auxes.append(step_fn(state, vgg, b["a"], b["s"], TC, b["flow"],
                             b["noise"], temporal))
    torch.save({"params": state.net.state_dict(), "aux": auxes},
               f"{d}/{name}.pt")


def step_rank(rank, d):
    from vstnet_tpu_torch.parallel.sharding import parallel_train_step

    _steps(parallel_train_step, slice(2 * rank, 2 * rank + 2), d,
           f"rank{rank}")


def train_rank(rank, d):
    tr.PHOTO_CONFIG = SMALL
    tc = tr.TrainConfig(batch_size=1, new_size=32, crop_size=32,
                        weights=LossWeights(lap=0.0), log_every=1,
                        display_size=2, training_iterations=1,
                        fine_tuning_iterations=3,
                        logs_directory=d + "/logs", base_name="run")
    vgg = VGG(device="cpu").init_weights(torch.Generator().manual_seed(0))
    state = tr.train(tc, d + "/content", d + "/style", vgg, max_steps=2,
                     loader_workers=1, data_parallel="on", device="cpu")
    torch.save({"step": state.step, "params": state.net.state_dict()},
               f"{d}/train{rank}.pt")


if __name__ == "__main__":
    from vstnet_tpu_torch.parallel.multihost import spawn_ranks

    d = sys.argv[1]
    _steps(tr.train_step, slice(0, 4), d, "single")
    print(spawn_ranks(step_rank, 2, (d,), device_type="cpu"))
    spawn_ranks(train_rank, 2, (d,), device_type="cpu")
'''


def _batches():
    rng = np.random.default_rng(9)
    out = []
    for _ in range(2):
        a = rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
        s = rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
        flow = (rng.normal(size=(4, 16, 16, 2)) * 2).astype(np.float32)
        noise = (rng.normal(size=(4, 16, 16, 3)) * 1e-3).astype(np.float32)
        out.append({"a": a, "s": s, "flow": flow, "noise": noise})
    return out


def _pngs(root, n, seed):
    from PIL import Image

    root.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray((rng.uniform(size=(36, 40, 3)) * 255).astype(
            np.uint8)).save(root / f"{i}.png")


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The child's results and the JAX side's, computed meanwhile:
    (directory, child's stdout, JAX params and VGG params, JAX flat
    params after each step with its aux)."""
    from jax.flatten_util import ravel_pytree
    from vstnet_tpu.models.vgg import init_vgg as jinit_vgg
    from vstnet_tpu.parallel import make_parallel_flat_step
    from vstnet_tpu.train.losses import LossWeights
    from vstnet_tpu.train.trainer import TrainConfig, make_optimizer
    from vstnet_tpu_torch.models.vgg import VGG, vgg_params_from_jax

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    d = tmp_path_factory.mktemp("dp")
    params = _np_tree(jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(2)))
    vggp = _np_tree(jax.jit(jinit_vgg)(jax.random.PRNGKey(3)))
    vgg = VGG(device="cpu")
    vgg.load_state_dict(vgg_params_from_jax(vggp))
    batches = _batches()
    torch.save({"net": params_from_jax(params), "vgg": vgg.state_dict(),
                "batches": [{k: _t(v) for k, v in b.items()}
                            for b in batches]}, d / "in.pt")
    _pngs(d / "content", 3, 11)
    _pngs(d / "style", 3, 12)
    (d / "port_side.py").write_text(_PORT_SIDE)
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.update(MKL_CBWR="COMPATIBLE", PYTHONPATH=str(ROOT))
    child = subprocess.Popen([sys.executable, str(d / "port_side.py"),
                              str(d)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        # JAX's data-parallel flat step on a 2-device mesh, meanwhile
        mesh = jmake_mesh(2, axes=("data",))
        opt = make_optimizer(TrainConfig())
        flat, unravel = ravel_pytree(jax.tree.map(jnp.asarray, params))
        step = make_parallel_flat_step(mesh, opt, JSMALL,
                                       LossWeights(lap=10.0), unravel)
        state = opt.init(flat)
        jax_out = []
        with mesh:
            for b, temporal in zip(batches, (False, True)):
                flat, state, aux = step(
                    flat, state, vggp,
                    *(jshard(mesh, jnp.asarray(b[k]))
                      for k in ("a", "s", "flow", "noise")), temporal)
                jax_out.append((np.asarray(flat), np.asarray(aux)))
        out, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, err[-4000:]
    return d, out, unravel, jax_out


def _load(d, name):
    return torch.load(d / f"{name}.pt", weights_only=False)


def test_data_parallel_step_ranks_agree_and_match_single(dp_run):
    d, out, _, _ = dp_run
    assert "gloo" in out
    r0, r1, single = (_load(d, n) for n in ("rank0", "rank1", "single"))
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k      # bit-equal ranks
    got = torch.cat([v.flatten() for v in r0["params"].values()]).numpy()
    want = torch.cat([v.flatten()
                      for v in single["params"].values()]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.mean(np.abs(got - want)) < 1e-6
    for aux, aux_single in zip(r0["aux"], single["aux"]):
        for k, v in aux.items():
            np.testing.assert_allclose(float(v), float(aux_single[k]),
                                       rtol=1e-4, atol=2e-5, err_msg=k)
    assert float(r0["aux"][1]["loss_tmp"]) > 0    # the temporal step


def test_data_parallel_step_matches_jax(dp_run):
    from vstnet_tpu.train.losses import AUX_KEYS

    d, _, unravel, jax_out = dp_run
    r0 = _load(d, "rank0")
    want = params_from_jax(_np_tree(unravel(jnp.asarray(jax_out[-1][0]))))
    got = r0["params"]
    assert set(got) == set(want)
    g = torch.cat([got[k].flatten() for k in sorted(got)]).numpy()
    w = torch.cat([want[k].flatten() for k in sorted(got)]).numpy()
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert np.mean(np.abs(g - w)) < 1e-6
    for aux, (_, jaux) in zip(r0["aux"], jax_out):
        for k, want_k in zip(AUX_KEYS, jaux):
            np.testing.assert_allclose(float(aux[k]), float(want_k),
                                       rtol=1e-4, atol=2e-5, err_msg=k)


def test_train_data_parallel_on_two_gloo_ranks(dp_run):
    """train(data_parallel="on") inside a 2-rank gloo group: 2 steps, one
    loss.log of 2 lines and one last.pt, written by rank 0 alone; both
    ranks end with the same weights."""
    d, _, _, _ = dp_run
    run = d / "logs" / "run"
    assert sorted(p.name for p in d.rglob("loss.log")) == ["loss.log"]
    lines = (run / "loss.log").read_text().splitlines()
    assert [int(x[11:19]) for x in lines] == [1, 2]
    assert all(re.match(r"^Iteration: \d{8}/00000004  content_loss", x)
               for x in lines)
    assert [p.name for p in d.rglob("last.pt")] == ["last.pt"]
    assert (run / "checkpoints" / "last.pt.opt.msgpack").exists()
    t0, t1 = _load(d, "train0"), _load(d, "train1")
    assert t0["step"] == t1["step"] == 2
    for k, v in t0["params"].items():
        assert torch.equal(v, t1["params"][k]), k


def test_train_data_parallel_on_needs_two_devices(tmp_path):
    from vstnet_tpu_torch.models.vgg import VGG
    from vstnet_tpu_torch.train.trainer import TrainConfig, train

    with pytest.raises(ValueError, match="only 1 device"):
        train(TrainConfig(logs_directory=str(tmp_path)), str(tmp_path),
              str(tmp_path), VGG(device="cpu"), data_parallel="on",
              device="cpu")
