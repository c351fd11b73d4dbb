"""The port's native (flax msgpack) checkpoints against the JAX package's.

* The codec (vstnet_tpu_torch/io/msgpack.py) against flax.serialization:
  flax's bytes decode in the port, and the port's in flax, to bit-equal
  trees, and the port writes flax's bytes; what the codec does not know
  raises.
* The JAX layout: ravel_jax_tree(params_to_jax(sd)) equals
  jax.flatten_util.ravel_pytree(revresnet_from_torch(sd)) bit for bit at
  PHOTO_CONFIG (4,089,936 values), the order of the flat optimizer vectors.
* Optimizer state across packages, at PHOTO_CONFIG with seeded synthetic
  gradients (no network runs): a JAX state after three optax updates,
  saved by vstnet_tpu's save_checkpoint in the flat layout (train()'s) and
  in the tree layout (a TrainState's), loads in the port with Adam's
  moments and counts bit-equal. The port's learning rate is
  lr0 / (1 + decay * count) in float64; optax's is the same expression in
  float32, within one float32 ulp of it. One more update from the same
  gradients agrees within UPDATE_RTOL of the update's scale (its largest
  magnitude) plus one ulp of each parameter: optax forms Adam's bias
  corrections 1 - beta**t in float32, which at t = 4 loses ~1e-5 of
  1 - 0.999**4 to cancellation, where torch forms them in float64
  (measured: 1.1e-5 of the update's scale at worst). The
  port's checkpoint resumes in vstnet_tpu's load_checkpoint(flat=True) with
  opt_state bit-equal. A file that does not fit the model raises.
* The image CLI on a JAX-written .msgpack equals its run on the same
  weights as a .pt file, byte for byte.
"""

import os

import jax
import jax.numpy as jnp
import msgpack as pymsgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree

import vstnet_tpu.train.trainer as jtr
from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.io.checkpoint import (
    revresnet_from_torch,
    save_native as jsave_native,
    save_torch_checkpoint,
)
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu_torch.config import PHOTO_CONFIG, RevResNetConfig
from vstnet_tpu_torch.io import msgpack
from vstnet_tpu_torch.io.checkpoint import (
    jax_tree_leaves,
    load_native,
    params_from_jax,
    params_to_jax,
    ravel_jax_tree,
    save_native,
    unravel_jax_tree,
)
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.train import trainer as tr

torch.set_num_threads(2)

LR = dict(lr=1e-2, lr_decay=0.5)       # a schedule that moves per step
SCALES = (1e-3, 1e-2, 2e-3, 3e-3)      # gradient sizes; step 2 is clipped
UPDATE_RTOL = 2e-5
JSMALL = JaxConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
SMALL = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)


def _same(a, b, path="tree"):
    """Bit-equal trees: keys, list lengths, leaf types, dtypes, shapes and
    bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype, path
        assert np.shape(a) == np.shape(b), path
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path
    else:
        assert type(a) is type(b) and a == b, path


def _tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(3, 5, 7)).astype(np.float32),
        "i32": np.arange(-3, 40, dtype=np.int32),
        "zero_d": np.asarray(7, np.int32),
        "step": np.asarray(123456789),
        "bool": np.array([True, False, True]),
        "empty": np.zeros((0, 4), np.float32),
        "big": rng.normal(size=70_000).astype(np.float32),  # a bin32 payload
        "scalar": np.float32(2.5),                          # ext type 3
        "nested": [np.ones(2, np.float64), [1, -2, 2 ** 40, -(2 ** 33)],
                   {"s": "x" * 40, "n": None, "t": True, "f": 0.25,
                    "b": b"\x00\x01"}],
        "wide": {str(i): np.asarray(i, np.int32) for i in range(20)},
    }


def test_flax_bytes_decode_bit_equal_in_the_port():
    blob = serialization.msgpack_serialize(_tree())
    _same(msgpack.unpackb(blob), serialization.msgpack_restore(blob))


def test_port_bytes_are_flax_bytes_and_decode_in_flax():
    ours = msgpack.packb(_tree())
    assert ours == serialization.msgpack_serialize(_tree())
    _same(serialization.msgpack_restore(ours), msgpack.unpackb(ours))


def _bad_blobs():
    """Files the codec must refuse: (name, bytes)."""
    import unittest.mock as mock

    big = {"x": np.arange(64, dtype=np.float32)}
    with mock.patch.object(serialization, "MAX_CHUNK_SIZE", 64):
        chunked = serialization.msgpack_serialize(big)
    bf16 = serialization.msgpack_serialize(
        {"x": np.asarray(jnp.ones(3, jnp.bfloat16))})
    good = serialization.msgpack_serialize(big)
    return [("chunked", chunked),
            ("unknown ext", pymsgpack.packb(pymsgpack.ExtType(5, b"xyz"))),
            ("complex ext", serialization.msgpack_serialize({"c": 1 + 2j})),
            ("bfloat16", bf16),
            ("truncated", good[:-3]),
            ("trailing", good + b"\xc0")]


@pytest.mark.parametrize("name", [n for n, _ in _bad_blobs()])
def test_codec_refuses_what_it_does_not_know(name):
    blob = dict(_bad_blobs())[name]
    with pytest.raises(ValueError, match="msgpack"):
        msgpack.unpackb(blob)


def _photo_state_dict(seed=0):
    net = RevResNet(PHOTO_CONFIG, device="cpu")
    net.init_weights(torch.Generator().manual_seed(seed))
    return net.state_dict()


def test_ravel_order_is_ravel_pytree_at_photo_config():
    sd = _photo_state_dict()
    ours = ravel_jax_tree(params_to_jax(sd))
    theirs, _ = ravel_pytree(revresnet_from_torch(
        {k: v.numpy() for k, v in sd.items()}))
    assert ours.shape == (4_089_936,) and ours.dtype == np.float32
    assert ours.tobytes() == np.asarray(theirs).tobytes()
    back = params_from_jax(unravel_jax_tree(ours, params_to_jax(sd)))
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def _grads(n):
    rng = np.random.default_rng(1)
    return [(rng.normal(size=n) * s).astype(np.float32) for s in SCALES]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX states after three updates at PHOTO_CONFIG, flat and tree,
    each saved by vstnet_tpu's save_checkpoint: {layout: (state, dir)}."""
    params = revresnet_from_torch(
        {k: v.numpy() for k, v in _photo_state_dict().items()})
    jtc = jtr.TrainConfig(**LR)
    flat, _ = jtr.init_flat_train_state(jtc, params)
    tree, opt = jtr.init_train_state(jtc, params)
    update = jax.jit(opt.update)
    gs = _grads(flat.flat.size)
    assert np.linalg.norm(gs[1]) > jtc.grad_clip
    for g in gs[:3]:
        u, s = update(jnp.asarray(g), flat.opt_state, flat.flat)
        flat = jtr.FlatTrainState(optax.apply_updates(flat.flat, u), s,
                                  flat.unravel, flat.step + 1)
        u, s = update(flat.unravel(jnp.asarray(g)), tree.opt_state,
                      tree.params)
        tree = jtr.TrainState(optax.apply_updates(tree.params, u), s,
                              tree.step + 1)
    out = {}
    for layout, state in (("flat", flat), ("tree", tree)):
        d = tmp_path_factory.mktemp(layout)
        jtr.save_checkpoint(state, str(d))
        out[layout] = (state, str(d))
    return {"runs": out, "update": update, "grads": gs, "jtc": jtc}


def _leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state.opt_state)]


def _flat_params(state):
    if isinstance(state, jtr.FlatTrainState):
        return np.asarray(state.flat)
    return np.asarray(ravel_pytree(state.params)[0])


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_jax_checkpoint_resumes_in_the_port(jax_runs, layout):
    jstate, d = jax_runs["runs"][layout]
    jl = _leaves(jstate)
    assert len(jl) == (4 if layout == "flat" else 2 * 192 + 2)
    tc = tr.TrainConfig(**LR)
    state = tr.load_checkpoint(tc, d, device="cpu")
    assert state.step == jstate.step == 3
    got = tr.native_opt_state(state)["opt_state"]["leaves"]
    n = (len(jl) - 2) // 2
    want = [jl[0], ravel_jax_tree(jl[1:1 + n]), ravel_jax_tree(jl[1 + n:-1]),
            jl[-1]]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    for p in state.net.parameters():
        assert float(state.opt.state[p]["step"]) == 3.0
    assert state.sched.last_epoch == 3
    lr = state.opt.param_groups[0]["lr"]
    assert lr == tc.lr * (1.0 / (1.0 + tc.lr_decay * 3))
    jlr = np.asarray(jax.jit(lambda c: tc.lr / (1.0 + tc.lr_decay * c))(
        jl[-1]))
    assert abs(np.float32(lr) - jlr) <= np.spacing(jlr)

    # one more update from the same gradient in both packages
    g = jax_runs["grads"][3]
    w0 = _flat_params(jstate)
    gj = jnp.asarray(g) if layout == "flat" else jax.tree.map(
        jnp.asarray, unravel_jax_tree(g, jax.tree.map(np.asarray,
                                                      jstate.params)))
    params = jstate.flat if layout == "flat" else jstate.params
    u, _ = jax_runs["update"](gj, jstate.opt_state, params)
    w1 = np.asarray(ravel_pytree(optax.apply_updates(params, u))[0])
    named = dict(state.net.named_parameters())
    grads = params_from_jax(unravel_jax_tree(g, params_to_jax(named)))
    for k, p in named.items():
        p.grad = grads[k]
    tr.apply_gradients(state, tc)
    ours = ravel_jax_tree(params_to_jax(state.net.state_dict()))
    scale = float(np.abs(w1 - w0).max())
    worst = float(np.max(np.abs(ours - w1)
                         / (UPDATE_RTOL * scale + np.spacing(np.abs(w1)))))
    print(f"{layout}: one update of scale {scale:.3e}: worst |port - "
          f"optax| / bound {worst:.3f}")
    assert worst <= 1.0


def test_port_checkpoint_resumes_in_jax(tmp_path):
    tc = tr.TrainConfig(**LR)
    state = tr.init_train_state(tc, "cpu")
    named = dict(state.net.named_parameters())
    like = params_to_jax(named)
    for g in _grads(4_089_936)[:3]:
        grads = params_from_jax(unravel_jax_tree(g, like))
        for k, p in named.items():
            p.grad = grads[k]
        tr.apply_gradients(state, tc)
    tr.save_checkpoint(state, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["last.pt", "last.pt.opt.msgpack"]
    jstate, _ = jtr.load_checkpoint(jtr.TrainConfig(**LR), str(tmp_path),
                                    flat=True)
    assert jstate.step == 3
    ours = tr.native_opt_state(state)["opt_state"]["leaves"]
    for g, w in zip(ours, _leaves(jstate)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert np.asarray(jstate.flat).tobytes() == ravel_jax_tree(
        params_to_jax(state.net.state_dict())).tobytes()


def _mismatched(jax_runs, name):
    """An optimizer file's leaves that do not fit PHOTO_CONFIG."""
    jl = _leaves(jax_runs["runs"]["flat"][0])
    if name == "flat, short vector":
        return [jl[0], jl[1][:-1], jl[2][:-1], jl[3]]
    if name == "count not a scalar":
        return [jl[0][None], jl[1], jl[2], jl[3]]
    # the tree layout of a network one block a stage deep
    small = RevResNet(SMALL, device="cpu").state_dict()
    moments = jax_tree_leaves(params_to_jax(small))
    return [jl[0], *moments, *moments, jl[3]]


@pytest.mark.parametrize("name", ["flat, short vector",
                                  "tree of another depth",
                                  "count not a scalar"])
def test_a_mismatched_optimizer_file_raises(jax_runs, tmp_path, name):
    import shutil

    shutil.copy(os.path.join(jax_runs["runs"]["flat"][1], "last.pt"),
                tmp_path / "last.pt")
    save_native({"opt_state": {"leaves": _mismatched(jax_runs, name)},
                 "step": np.asarray(3)}, str(tmp_path / "last.pt.opt.msgpack"))
    with pytest.raises(ValueError, match="opt.msgpack"):
        tr.load_checkpoint(tr.TrainConfig(), str(tmp_path), device="cpu")


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """Tiny weights written by vstnet_tpu as w.msgpack and w.pt, and a
    32x32 content and style."""
    from PIL import Image

    root = tmp_path_factory.mktemp("cli")
    params = jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(0))
    jsave_native(params, str(root / "w.msgpack"))
    save_torch_checkpoint(params, str(root / "w.pt"))
    rng = np.random.default_rng(3)
    for name in ("content", "style"):
        Image.fromarray((rng.uniform(size=(32, 32, 3)) * 255).astype(
            np.uint8)).save(root / f"{name}.png")
    return root


@pytest.mark.parametrize("fast", [False, True])
def test_image_cli_reads_jax_msgpack_weights(cli_files, tmp_path,
                                             monkeypatch, fast):
    import vstnet_tpu_torch.models.pipeline as tpipe
    from vstnet_tpu_torch.cli.image_transfer import main

    monkeypatch.setattr(tpipe, "PHOTO_CONFIG", SMALL)
    assert load_native(str(cli_files / "w.msgpack"))["stack"][0]["conv1"][
        "w"].shape == (3, 3, 16, 4)
    outs = []
    for ckpt in ("w.msgpack", "w.pt"):
        outs.append(main(
            ["--ckpoint", str(cli_files / ckpt), "--content",
             str(cli_files / "content.png"), "--style",
             str(cli_files / "style.png"), "--out_dir",
             str(tmp_path / ckpt.replace(".", "_")), "--max_size", "32",
             "--device", "cpu"] + (["--fast"] if fast else [])))
    a, b = (open(p, "rb").read() for p in outs)
    assert a == b
