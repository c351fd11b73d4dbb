"""The port's invertible 1x1 conv against vstnet_tpu/ops/invconv.py.

The same numpy parameters (the port's init_invconv from a seeded
generator) and inputs go through both packages' forward and inverse. The
tolerance is 1e-5 absolute on values of order 1-10 (a 16- or 64-term
float32 dot product and, for the inverse, a float32 matrix inverse of an
orthogonal matrix), as is inverse(forward(x)) against x.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstnet_tpu.ops import invconv as jinv
from vstnet_tpu_torch.ops import invconv as tinv

TOL = 1e-5


@pytest.mark.parametrize("channel", [16, 64])
def test_invconv_matches_jax_both_ways(channel):
    params = tinv.init_invconv(torch.Generator().manual_seed(channel),
                               channel, device="cpu")
    w = params["w"].numpy()
    np.testing.assert_allclose(w @ w.T, np.eye(channel), atol=1e-5)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    x = np.random.default_rng(channel).normal(
        size=(2, 6, 10, channel)).astype(np.float32)

    y = tinv.invconv_forward(params, torch.from_numpy(x))
    yj = np.asarray(jinv.invconv_forward(jparams, jnp.asarray(x)))
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), yj, rtol=0, atol=TOL)

    back = tinv.invconv_inverse(params, y)
    backj = np.asarray(jinv.invconv_inverse(jparams, jnp.asarray(yj)))
    np.testing.assert_allclose(back.numpy(), backj, rtol=0, atol=TOL)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=TOL)


def test_invconv_init_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        tinv.init_invconv(torch.Generator().manual_seed(0), 4)
