"""The row-sharded training step (vstnet_tpu_torch/parallel/sharding.
parallel_train_step with rows=) on a (2, 2) grid: two gloo ranks, each a
data row of 2 CPU row shards, against the port's single-process step on
the global batch and against the JAX package's
make_parallel_flat_step(..., spatial=True) on a (2, 2) CPU mesh.
tests/test_torch_spatial_train.py holds the step's terms and
loss_and_grads_rows; the two files are apart so that pytest-xdist runs
them on two workers.

The ranks run in child processes, with MKL_CBWR=COMPATIBLE and oneDNN
off for the reason given in tests/test_torch_train.py. Weights come from
vstnet_tpu's init_revresnet and init_vgg through params_from_jax and
vgg_params_from_jax; the global batch (4 images of 32x32, 2 a rank, 16
rows a shard) with generate_fake_flow's flow and the noise from a numpy
seed; one step of the temporal phase (every term on), Adam at the
trainer's lr = 1e-4.

Tolerances: parameters bit-equal across ranks. Against the single
process and against JAX: the mean absolute difference of the parameters
under 1e-6 and the largest under 3 lr = 3e-4. Adam's first step is
-lr * g / (|g| + eps), so a near-zero gradient whose sign the reduction
order flips moves its parameter by 2 lr: JAX's own spatial step lies
2.0e-4 at the max and 2.1e-7 in the mean from its unsharded step. Aux
losses rtol 1e-4 / atol 2e-5.
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
from vstnet_tpu_torch.io.checkpoint import params_from_jax

torch.set_num_threads(2)

JSMALL = JaxConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
DIST_ENV = ("VSTNET_COORDINATOR", "VSTNET_NUM_PROCESSES", "VSTNET_PROCESS_ID",
            "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
LR = 1e-4
WEIGHTS = dict(lap=10.0, temporal=60.0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# Runs as a file (spawned ranks import it as their main module): the
# port's single-process step on the global batch, then the row-sharded
# step on 2 gloo ranks, each a data row of 2 CPU row shards; everything
# lands under argv[1].
_PORT_SIDE = r'''
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


def _step(step_fn, images, d, name, **kw):
    blob = torch.load(d + "/in.pt", weights_only=True)
    tc = tr.TrainConfig(lr=blob["lr"], weights=LossWeights(**blob["weights"]))
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(blob["net"])
    vgg = VGG(device="cpu")
    vgg.load_state_dict(blob["vgg"])
    state = tr.init_train_state(tc, "cpu", net)
    b = {k: v[images] for k, v in blob["batch"].items()}
    aux = step_fn(state, vgg, b["a"], b["s"], tc, b["flow"], b["noise"],
                  True, **kw)
    torch.save({"params": state.net.state_dict(), "aux": aux},
               f"{d}/{name}.pt")


def rank(r, d):
    from vstnet_tpu_torch.parallel import make_mesh, parallel_train_step

    mesh = make_mesh(4, ("data", "spatial"), spatial=2, device_type="cpu")
    _step(parallel_train_step, slice(2 * r, 2 * r + 2), d, f"rank{r}",
          rows=mesh[r])


if __name__ == "__main__":
    from vstnet_tpu_torch.parallel.multihost import spawn_ranks

    d = sys.argv[1]
    _step(tr.train_step, slice(0, 4), d, "single")
    print(spawn_ranks(rank, 2, (d,), device_type="cpu"))
'''


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    """(directory, child's stdout, unravel, JAX's flat params and aux
    after its spatial step), the JAX side computed meanwhile."""
    from jax.flatten_util import ravel_pytree
    from vstnet_tpu.models.vgg import init_vgg as jinit_vgg
    from vstnet_tpu.parallel import make_mesh as jmake_mesh
    from vstnet_tpu.parallel import make_parallel_flat_step
    from vstnet_tpu.parallel import shard_batch as jshard
    from vstnet_tpu.train.losses import LossWeights
    from vstnet_tpu.train.trainer import TrainConfig, make_optimizer
    from vstnet_tpu_torch.models.vgg import VGG, vgg_params_from_jax
    from vstnet_tpu_torch.ops.warp import generate_fake_flow

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    d = tmp_path_factory.mktemp("spatial_grid")
    params = _np_tree(jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(11)))
    vggp = _np_tree(jax.jit(jinit_vgg)(jax.random.PRNGKey(12)))
    vgg = VGG(device="cpu")
    vgg.load_state_dict(vgg_params_from_jax(vggp))
    rng = np.random.default_rng(13)
    batch = {
        "a": rng.uniform(size=(4, 32, 32, 3)).astype(np.float32),
        "s": rng.uniform(size=(4, 32, 32, 3)).astype(np.float32),
        "flow": np.stack([generate_fake_flow(rng, 32, 32)
                          for _ in range(4)]),
        "noise": (rng.normal(size=(4, 32, 32, 3)) * 1e-3).astype(
            np.float32)}
    torch.save({"net": params_from_jax(params), "vgg": vgg.state_dict(),
                "lr": LR, "weights": WEIGHTS,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               d / "in.pt")
    (d / "port_side.py").write_text(_PORT_SIDE)
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.update(MKL_CBWR="COMPATIBLE", PYTHONPATH=str(ROOT))
    child = subprocess.Popen([sys.executable, str(d / "port_side.py"),
                              str(d)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        # JAX's row-sharded flat step on a (2, 2) mesh, meanwhile
        mesh = jmake_mesh(4, ("data", "spatial"), spatial=2)
        opt = make_optimizer(TrainConfig(lr=LR))
        flat, unravel = ravel_pytree(jax.tree.map(jnp.asarray, params))
        step = make_parallel_flat_step(mesh, opt, JSMALL,
                                       LossWeights(**WEIGHTS), unravel,
                                       spatial=True)
        with mesh:
            flat, _, aux = step(
                flat, opt.init(flat), vggp,
                *(jshard(mesh, jnp.asarray(batch[k]), spatial=True)
                  for k in ("a", "s", "flow", "noise")), True)
            jax_out = (np.asarray(flat), np.asarray(aux))
        out, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, err[-4000:]
    return d, out, unravel, jax_out


def _load(d, name):
    return torch.load(d / f"{name}.pt", weights_only=False)


def _flat(params, keys):
    return torch.cat([params[k].flatten() for k in keys]).numpy()


def _check_params(got, want):
    keys = sorted(want)
    assert set(got) == set(want)
    diff = np.abs(_flat(got, keys) - _flat(want, keys))
    assert diff.max() <= 3 * LR, diff.max()
    assert diff.mean() < 1e-6, diff.mean()


def test_row_sharded_step_ranks_agree_and_match_single(grid_run):
    d, out, _, _ = grid_run
    assert "gloo" in out
    r0, r1, single = (_load(d, n) for n in ("rank0", "rank1", "single"))
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k      # bit-equal ranks
    for k, v in r0["aux"].items():
        assert torch.equal(v, r1["aux"][k]), k
    _check_params(r0["params"], single["params"])
    for k, v in r0["aux"].items():
        np.testing.assert_allclose(float(v), float(single["aux"][k]),
                                   rtol=1e-4, atol=2e-5, err_msg=k)
    assert float(r0["aux"]["loss_tmp"]) > 0
    assert float(r0["aux"]["loss_lap"]) > 0


def test_row_sharded_step_matches_jax_spatial_step(grid_run):
    from vstnet_tpu.train.losses import AUX_KEYS

    d, _, unravel, (jflat, jaux) = grid_run
    want = params_from_jax(_np_tree(unravel(jnp.asarray(jflat))))
    r0 = _load(d, "rank0")
    _check_params(r0["params"], want)
    for k, v in zip(AUX_KEYS, jaux):
        np.testing.assert_allclose(float(r0["aux"][k]), float(v),
                                   rtol=1e-4, atol=2e-5, err_msg=k)
