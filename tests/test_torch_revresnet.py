"""The port's reversible network against the JAX package's.

Weights are made by vstnet_tpu's init_revresnet and carried across with
vstnet_tpu_torch.io.checkpoint.params_from_jax; inputs are numpy arrays
from a seed. The JAX fast path reaches its Pallas kernels, which run in
interpret mode (tests.conftest.patch_interpret_fused); the port's fast
path runs its kernels' plain versions on the CPU.

Tolerances: float32 encode/decode and fast encode/decode agree with the
JAX package to atol 1e-5 (float32 roundoff through 6+2 small blocks with
different summation orders). The round trip is exact algebra: > 100 dB
PSNR in float32 and > 55 dB in bf16, where each block rounds its output
to bf16 once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vstnet_tpu.models.revresnet_fast as jrf
from vstnet_tpu.config import RevResNetConfig as JaxConfig
from vstnet_tpu.io.checkpoint import revresnet_to_torch, save_torch_checkpoint
from vstnet_tpu.models.revresnet import decode as jdecode
from vstnet_tpu.models.revresnet import encode as jencode
from vstnet_tpu.models.revresnet import init_revresnet
from vstnet_tpu_torch.config import PHOTO_CONFIG, RevResNetConfig
from vstnet_tpu_torch.io.checkpoint import load_revresnet, params_from_jax
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models.revresnet import RevResNet

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(2, 2, 2))
JSMALL = JaxConfig(n_blocks=(2, 2, 2))


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.fixture(scope="module")
def pair():
    """(JAX params, port RevResNet) holding the same weights."""
    params = jax.jit(lambda k: init_revresnet(k, JSMALL))(
        jax.random.PRNGKey(0))
    net = RevResNet(SMALL, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, net


@pytest.fixture
def _interpret(monkeypatch):
    from tests.conftest import patch_interpret_fused

    patch_interpret_fused(monkeypatch)


def test_config_matches_jax():
    from vstnet_tpu.config import ARTISTIC_CONFIG as JA
    from vstnet_tpu.config import PHOTO_CONFIG as JP
    from vstnet_tpu_torch.config import ARTISTIC_CONFIG

    for ours, theirs in ((PHOTO_CONFIG, JP), (ARTISTIC_CONFIG, JA)):
        assert ours.block_plan() == theirs.block_plan()
        assert ours.inj_pad == theirs.inj_pad
        assert ours.latent_channels == theirs.latent_channels
        assert ours.latent_scale == theirs.latent_scale


def test_state_dict_uses_reference_keys(pair):
    params, net = pair
    sd = net.state_dict()
    ref = revresnet_to_torch(params)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
    assert "stack.0.conv.1.weight" in sd
    assert "channel_reduction.block_list.1.conv.7.bias" in sd


@pytest.mark.parametrize("w", [48])
def test_encode_decode_match_jax(rng, pair, w):
    params, net = pair
    x = rng.uniform(size=(2, 32, w, 3)).astype(np.float32)
    z_ref = np.asarray(jencode(params, jnp.asarray(x), JSMALL))
    z = net.encode(torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), z_ref, atol=1e-5)
    zin = (rng.standard_normal(z_ref.shape) * 0.1).astype(np.float32)
    x_ref = np.asarray(jdecode(params, jnp.asarray(zin), JSMALL))
    np.testing.assert_allclose(net.decode(torch.from_numpy(zin)).numpy(),
                               x_ref, atol=1e-5)


@pytest.mark.parametrize("w", [48, 256])
def test_fast_path_matches_jax(rng, pair, _interpret, w):
    params, net = pair
    jfast = jrf.pack_revresnet(params, JSMALL)
    fast = rf.pack_revresnet(net)
    x = rng.uniform(size=(1, 32, w, 3)).astype(np.float32)
    for packed in (False, True):
        z_ref = np.asarray(jrf.encode_fast(jfast, jnp.asarray(x), JSMALL,
                                           packed_latent=packed))
        z = rf.encode_fast(fast, torch.from_numpy(x), SMALL,
                           packed_latent=packed)
        np.testing.assert_allclose(z.numpy(), z_ref, atol=1e-5)
        x_ref = np.asarray(jrf.decode_fast(jfast, jnp.asarray(z_ref),
                                           JSMALL, packed_latent=packed))
        back = rf.decode_fast(fast, torch.from_numpy(np.array(z_ref)), SMALL,
                              packed_latent=packed)
        np.testing.assert_allclose(back.numpy(), x_ref, atol=1e-5)


def test_size_not_multiple_of_4_raises(pair):
    _, net = pair
    x = torch.rand(1, 30, 32, 3)
    with pytest.raises(ValueError):
        net.encode(x)
    with pytest.raises(ValueError):
        rf.encode_fast(rf.pack_revresnet(net), x, SMALL)


@pytest.mark.parametrize("dt,bar", [(torch.float32, 100.0),
                                    (torch.bfloat16, 55.0)])
def test_round_trip(rng, pair, dt, bar):
    _, net = pair
    fast = rf.pack_revresnet(net, dt)
    x = torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(
        np.float32)).to(dt)
    back = rf.decode_fast(fast, rf.encode_fast(fast, x, SMALL), SMALL)
    assert back.dtype == dt
    assert _psnr(back.float().numpy(), x.float().numpy()) > bar
    if dt == torch.float32:
        back = net.decode(net.encode(x))
        assert _psnr(back.numpy(), x.numpy()) > bar


def test_reference_checkpoint_loads(tmp_path, rng, pair):
    """save_torch_checkpoint (the JAX package's writer of the reference
    .pt schema) -> load_revresnet -> plain load_state_dict: the same
    outputs as the weights carried by params_from_jax."""
    params, net = pair
    x = torch.from_numpy(rng.uniform(size=(1, 32, 32, 3)).astype(np.float32))
    for wrap in (True, False):
        path = tmp_path / f"ckpt_{wrap}.pt"
        save_torch_checkpoint(params, str(path), wrap=wrap)
        loaded = RevResNet(SMALL, device="cpu")
        loaded.load_state_dict(load_revresnet(str(path)))
        assert torch.equal(loaded.encode(x), net.encode(x))


def test_random_init_is_seeded():
    a = RevResNet(SMALL, device="cpu").init_weights(torch.Generator().manual_seed(7))
    b = RevResNet(SMALL, device="cpu").init_weights(torch.Generator().manual_seed(7))
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
        if ka.endswith("bias"):
            assert not va.any()
        else:
            fan_in = va[0].numel()
            assert float(va.abs().max()) <= fan_in ** -0.5
