"""The port's GGUF codec (vstnet_tpu_torch/io/gguf.py) against the JAX
package's (vstnet_tpu/io/gguf.py).

Files cross both ways at every type (F32, F16, Q8_0, Q4_0): each reader
decodes either writer's file to the same arrays, bit for bit, so the
quantizers and the dequantizers agree exactly. Q8_0 and Q4_0 reject a
tensor whose element count is no multiple of 32, in the writer and in the
reader. RevResNet weights written by one package and read by the other
encode a 32x32 image within 1e-5 of each other (float32 roundoff through
a tiny network; the weights themselves cross exactly). At Q8_0 and Q4_0
the port's RevResNet writer keeps the tensors whose size is no multiple
of 32 in F16, where the JAX writer refuses them.
"""

import struct
import warnings

import jax
import numpy as np
import pytest
import torch

from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.io import checkpoint as jckpt
from vstnet_tpu.io import gguf as jgg
from vstnet_tpu.models import revresnet as jrev
from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.io import gguf as gg
from vstnet_tpu_torch.models.revresnet import RevResNet

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(1, 1, 1))
JSMALL = JaxConfig(n_blocks=(1, 1, 1))
DTYPES = ("f32", "f16", "q8_0", "q4_0")


@pytest.fixture
def tensors(rng):
    return {
        "stack.0.conv.1.weight":
            rng.standard_normal((4, 16, 3, 3)).astype(np.float32),
        "stack.0.conv.1.bias": rng.standard_normal((32,)).astype(np.float32),
        "channel_reduction.block_list.0.conv.7.weight":
            (rng.standard_normal((256, 64, 3, 3)) * 0.1).astype(np.float32),
        "w": (rng.standard_normal((8, 64)) * 10).astype(np.float32),
    }


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        assert a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dtype", DTYPES)
def test_files_cross_both_ways(tmp_path, tensors, dtype):
    pj, pt = str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")
    jgg.write_gguf(pj, tensors, dtype=dtype)
    assert gg.write_gguf(pt, tensors, dtype=dtype) == pt
    ref = jgg.read_gguf(pj)
    _same(gg.read_gguf(pj), ref)
    _same(jgg.read_gguf(pt), ref)
    _same(gg.read_gguf(pt), ref)
    if dtype == "f32":
        _same(ref, tensors)


@pytest.mark.parametrize("dtype", ["q8_0", "q4_0"])
def test_quantized_types_reject_sizes_off_the_block(tmp_path, dtype):
    with pytest.raises(ValueError, match="32"):
        gg.write_gguf(str(tmp_path / "x.gguf"),
                      {"w": np.ones(33, np.float32)}, dtype=dtype)
    # a file whose header claims 33 elements of a 32-element tensor
    p = tmp_path / "bad.gguf"
    gg.write_gguf(str(p), {"w": np.ones(32, np.float32)}, dtype=dtype)
    raw = p.read_bytes()
    dim = b"w" + struct.pack("<IQ", 1, 32)
    assert raw.count(dim) == 1
    p.write_bytes(raw.replace(dim, b"w" + struct.pack("<IQ", 1, 33)))
    for reader in (gg.read_gguf, jgg._read_python):
        with pytest.raises(ValueError, match="32"):
            reader(str(p))


def test_unknown_type_is_rejected(tmp_path, tensors):
    with pytest.raises(ValueError, match="dtype"):
        gg.write_gguf(str(tmp_path / "x.gguf"), tensors, dtype="q5_1")


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: jrev.init_revresnet(k, JSMALL))(jax.random.PRNGKey(3)))


def _encode_both(jparams, net, rng):
    x = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jrev.encode(jparams, x, JSMALL))
    got = net.encode(torch.from_numpy(x)).numpy()
    return got, ref


@pytest.mark.parametrize("dtype", ["f32", "f16"])
def test_revresnet_from_a_jax_file(tmp_path, jax_params, rng, dtype):
    p = str(tmp_path / "rev.gguf")
    jgg.revresnet_to_gguf(jax_params, p, dtype=dtype)
    net = gg.revresnet_from_gguf(p, cfg=SMALL, device="cpu")
    assert next(net.parameters()).device.type == "cpu"
    got, ref = _encode_both(jgg.revresnet_from_gguf(p), net, rng)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_revresnet_to_gguf_is_read_by_jax(tmp_path, jax_params, rng):
    from vstnet_tpu_torch.io.checkpoint import params_from_jax

    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(params_from_jax(jax_params))
    p = str(tmp_path / "rev.gguf")
    gg.revresnet_to_gguf(net, p, dtype="f32")
    sd = gg.read_gguf(p)
    assert list(sd) == list(net.state_dict())
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy())
    got, ref = _encode_both(jgg.revresnet_from_gguf(p), net, rng)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # a state dict is taken as well as a module
    p2 = str(tmp_path / "rev2.gguf")
    gg.revresnet_to_gguf(net.state_dict(), p2, dtype="f32")
    _same(gg.read_gguf(p2), sd)


@pytest.mark.parametrize("dtype", ["q8_0", "q4_0"])
def test_quantized_revresnet_keeps_off_block_tensors_in_f16(
        tmp_path, jax_params, rng, dtype):
    """The JAX writer refuses these weights (a block of 4 output channels
    has 4 biases); the port writes such tensors as F16 in a file that both
    readers decode alike."""
    from vstnet_tpu_torch.io.checkpoint import params_from_jax

    sd = params_from_jax(jax_params)
    with pytest.raises(ValueError, match="32"):
        jgg.revresnet_to_gguf(jax_params, str(tmp_path / "j.gguf"), dtype)
    p = str(tmp_path / "rev.gguf")
    gg.revresnet_to_gguf(sd, p, dtype=dtype)
    back = gg.read_gguf(p)
    _same(jgg.read_gguf(p), back)
    for k, v in sd.items():
        v = v.numpy()
        if v.size % 32:
            np.testing.assert_array_equal(
                back[k], v.astype(np.float16).astype(np.float32))
    big = "channel_reduction.block_list.0.conv.7.weight"
    assert not np.array_equal(back[big],
                              sd[big].numpy().astype(np.float16))
    net = gg.revresnet_from_gguf(p, cfg=SMALL, device="cpu")
    got, ref = _encode_both(jgg.revresnet_from_gguf(p), net, rng)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_tolerant_load(tmp_path, jax_params, rng):
    """strict=False: an unused tensor is ignored with a warning in both
    packages; a missing or misshapen one keeps the value of a RevResNet
    initialised from `seed`."""
    sd = jckpt.revresnet_to_torch(jax_params)
    p = str(tmp_path / "extra.gguf")
    jgg.write_gguf(p, {**sd, "optimizer.state": np.ones(64, np.float32)},
                   dtype="f16")
    with pytest.raises(RuntimeError, match="Unexpected"):
        gg.revresnet_from_gguf(p, cfg=SMALL, device="cpu")
    with pytest.raises(ValueError, match="cfg"):
        gg.revresnet_from_gguf(p, strict=False, device="cpu")
    with pytest.warns(UserWarning, match="unused"):
        net = gg.revresnet_from_gguf(p, strict=False, cfg=SMALL,
                                     device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jparams = jgg.revresnet_from_gguf(p, strict=False, cfg=JSMALL)
    got, ref = _encode_both(jparams, net, rng)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    missing, bad = "stack.0.conv.4.weight", "stack.1.conv.1.bias"
    part = {k: v for k, v in sd.items() if k != missing}
    part[bad] = np.ones(7, np.float32)
    p = str(tmp_path / "part.gguf")
    gg.write_gguf(p, part, dtype="f32")
    with pytest.warns(UserWarning) as rec:
        net = gg.revresnet_from_gguf(p, strict=False, cfg=SMALL, seed=5,
                                     device="cpu")
    text = " ".join(str(w.message) for w in rec)
    assert missing in text and bad in text
    init = RevResNet(SMALL, device="cpu").init_weights(
        torch.Generator().manual_seed(5)).state_dict()
    got = net.state_dict()
    for k in (missing, bad):
        torch.testing.assert_close(got[k], init[k], rtol=0, atol=0)
    np.testing.assert_array_equal(got["stack.0.conv.1.weight"].numpy(),
                                  sd["stack.0.conv.1.weight"])
