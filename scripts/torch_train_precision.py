"""How far the training step of each package lies from float64, on the CPU.

    MKL_CBWR=COMPATIBLE JAX_PLATFORMS=cpu python3 scripts/torch_train_precision.py
    JAX_PLATFORMS=cpu python3 scripts/torch_train_precision.py --onednn on

The float64 reference is the port's own loss_and_grads in float64
(ops.at_least_f32 keeps float64 through the statistics); both packages'
float32 results are measured against it and against each other, at the
setting of tests/test_torch_train.py (SMALL = n_blocks (1, 1, 1), B=2,
32x32, lap 10):

  1. loss_and_grads in the image and the temporal phase: the largest
     gradient error in units of the test's bound (2e-6 + 2e-5 |g|), port
     vs JAX, port vs float64, JAX vs float64. The port's side depends on
     the CPU's BLAS: run it with MKL_CBWR=COMPATIBLE (MKL's reproducible
     mode, read when MKL starts) and without, and with oneDNN on or off
     (--onednn, default off).
  2. the VGG losses' relative errors against float64;
  3. the matting gradient's error, as a share of its scale, on images with
     a flat region (seeds 2-5);
  4. bf16 against float32 at 128x128 smooth images, with every term on in
     the temporal phase and at lap 10 in the image phase: the gradient
     cosine and loss_total of each package.

Prints only; gates nothing. CPU numbers, not a device measurement.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.flatten_util import ravel_pytree

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from vstnet_tpu.config import RevResNetConfig as JaxConfig  # noqa: E402
from vstnet_tpu.models.revresnet import init_revresnet  # noqa: E402
from vstnet_tpu.models.vgg import init_vgg as jinit_vgg  # noqa: E402
from vstnet_tpu.train import losses as jl  # noqa: E402
from vstnet_tpu_torch.config import RevResNetConfig  # noqa: E402
from vstnet_tpu_torch.io.checkpoint import params_from_jax  # noqa: E402
from vstnet_tpu_torch.models.revresnet import RevResNet  # noqa: E402
from vstnet_tpu_torch.models.vgg import VGG, vgg_params_from_jax  # noqa: E402
from vstnet_tpu_torch.train.losses import (  # noqa: E402
    AUX_KEYS,
    LossWeights,
    loss_and_grads,
)

SMALL = RevResNetConfig(n_blocks=(1, 1, 1))
JSMALL = JaxConfig(n_blocks=(1, 1, 1))


def _t(x, dt=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dt)


def _port(params, vggp, batch, w, temporal, dt, precision):
    net = RevResNet(SMALL, device="cpu").to(dt)
    net.load_state_dict(params_from_jax(params))
    vgg = VGG(device="cpu").to(dt)
    vgg.load_state_dict(vgg_params_from_jax(vggp))
    a, s, flow, noise = batch
    grads, aux = loss_and_grads(net, vgg, _t(a, dt), _t(s, dt), w,
                                _t(flow), _t(noise, dt), temporal,
                                precision=precision)
    return {k: v.double().numpy() for k, v in grads.items()}, aux


def _smooth(rng, b, hw):
    small = torch.from_numpy(rng.uniform(size=(b, 3, hw // 16, hw // 16)))
    x = torch.nn.functional.interpolate(small, size=(hw, hw),
                                        mode="bilinear", align_corners=False)
    x = x + 0.05 * torch.from_numpy(rng.uniform(size=(b, 3, hw, hw)))
    return x.clamp(0, 1).permute(0, 2, 3, 1).float().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--onednn", choices=["on", "off"], default="off")
    args = ap.parse_args()
    torch.backends.mkldnn.enabled = args.onednn == "on"
    print(f"MKL_CBWR={os.environ.get('MKL_CBWR', '(unset)')} "
          f"oneDNN {args.onednn}; torch {torch.__version__}, "
          f"jax {jax.__version__}")
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: init_revresnet(k, JSMALL))(jax.random.PRNGKey(0)))
    vggp = jax.tree.map(np.asarray, jax.jit(jinit_vgg)(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(4)
    batch = (rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
             rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
             (rng.normal(size=(2, 32, 32, 2)) * 2).astype(np.float32),
             (rng.normal(size=(2, 32, 32, 3)) * 1e-3).astype(np.float32))

    w = LossWeights(lap=10.0)
    for temporal in (False, True):
        jg, _ = jl.loss_and_grads(params, vggp,
                                  *[jnp.asarray(x) for x in batch], JSMALL,
                                  w, temporal)
        jg = {k: v.double().numpy()
              for k, v in params_from_jax(jax.tree.map(np.asarray,
                                                       jg)).items()}
        p32, _ = _port(params, vggp, batch, w, temporal, torch.float32,
                       "f32")
        p64, _ = _port(params, vggp, batch, w, temporal, torch.float64,
                       "f64")

        def units(x, ref):
            return max(float(np.max(np.abs(x[k] - ref[k])
                                    / (2e-6 + 2e-5 * np.abs(ref[k]))))
                       for k in ref)

        print(f"loss_and_grads {'temporal' if temporal else 'image'}: "
              f"largest gradient error in bounds: port-JAX "
              f"{units(p32, jg):.2f}, port-f64 {units(p32, p64):.2f}, "
              f"JAX-f64 {units(jg, p64):.2f}")

    from vstnet_tpu.models.vgg import vgg_losses as jvgg_losses
    from vstnet_tpu_torch.models.vgg import vgg_losses

    # the inputs of tests/test_torch_train.py's test_vgg_matches_jax
    r0, r1 = np.random.default_rng(0), np.random.default_rng(1)
    r0.uniform(size=(1, 33, 37, 3))
    c, s = (r1.uniform(size=(2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    st = r0.uniform(size=c.shape).astype(np.float32)
    jc, js = jvgg_losses(vggp, jnp.asarray(c), jnp.asarray(s),
                         jnp.asarray(st), content_weight=1.0)
    out = {}
    for dt in (torch.float32, torch.float64):
        vgg = VGG(device="cpu").to(dt)
        vgg.load_state_dict(vgg_params_from_jax(vggp))
        out[dt] = vgg_losses(vgg, _t(c, dt), _t(s, dt), _t(st, dt),
                             content_weight=1.0)
    (c32, s32), (c64, s64) = out[torch.float32], out[torch.float64]
    print(f"VGG losses, relative error against float64: content port "
          f"{abs(float(c32) / float(c64) - 1):.2e} JAX "
          f"{abs(float(jc) / float(c64) - 1):.2e}; style port "
          f"{abs(float(s32) / float(s64) - 1):.2e} JAX "
          f"{abs(float(js) / float(s64) - 1):.2e}")

    from vstnet_tpu.ops.matting import matting_loss_and_grad as jmat
    from vstnet_tpu_torch.ops.matting import matting_loss_and_grad

    for seed in (2, 3, 4, 5):
        r = np.random.default_rng(seed)
        img = r.uniform(size=(2, 20, 24, 3)).astype(np.float32)
        img[1, :10] = 0.5
        x = r.uniform(size=(2, 20, 24, 3)).astype(np.float32)
        g64 = matting_loss_and_grad(_t(img, torch.float64),
                                    _t(x, torch.float64))[1].numpy()
        g32 = matting_loss_and_grad(_t(img), _t(x))[1].double().numpy()
        gj = np.asarray(jmat(jnp.asarray(img), jnp.asarray(x))[1],
                        np.float64)
        sc = np.abs(g64).max()
        print(f"matting gradient, seed {seed}, error / scale: port-f64 "
              f"{np.abs(g32 - g64).max() / sc:.2e}, JAX-f64 "
              f"{np.abs(gj - g64).max() / sc:.2e}, port-JAX "
              f"{np.abs(g32 - gj).max() / sc:.2e} (the textured sample: "
              f"port-f64 {np.abs(g32 - g64)[0].max() / sc:.2e})")

    from vstnet_tpu.ops.warp import generate_fake_flow

    a, s = _smooth(rng, 2, 128), _smooth(rng, 2, 128)
    flow = np.broadcast_to(generate_fake_flow(np.random.default_rng(7), 128,
                                              128)[None], (2, 128, 128, 2))
    noise = (1.5e-3 * rng.normal(size=a.shape)).astype(np.float32)
    big = (a, s, np.ascontiguousarray(flow), noise)
    flat, unravel = ravel_pytree(params)
    for tag, wt, temporal in (("every term, temporal", LossWeights(), True),
                              ("lap 10, image", LossWeights(lap=10.0,
                                                            temporal=0.0),
                               False)):
        res = {}
        for cd in (None, jnp.bfloat16):
            g, aux = jl.loss_and_grads_flat(
                flat, unravel, vggp, *[jnp.asarray(x) for x in big], JSMALL,
                wt, temporal, compute_dtype=cd)
            res[cd] = (np.asarray(g, np.float64),
                       float(aux[list(jl.AUX_KEYS).index("loss_total")]))
        (j32, jt32), (j16, jt16) = res[None], res[jnp.bfloat16]
        port = {}
        for precision in ("f32", "bf16"):
            g, aux = _port(params, vggp, big, wt, temporal, torch.float32,
                           precision)
            port[precision] = (np.concatenate([v.ravel() for v in
                                               g.values()]),
                               float(aux["loss_total"]))
        (p32, pt32), (p16, pt16) = port["f32"], port["bf16"]

        def cos(x, y):
            return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))

        print(f"bf16 vs f32 at 128x128, {tag}: cosine JAX {cos(j32, j16):.5f}"
              f" port {cos(p32, p16):.5f}; loss_total JAX {jt16:.5g}/{jt32:.5g}"
              f" port {pt16:.5g}/{pt32:.5g}")
    assert AUX_KEYS == jl.AUX_KEYS


if __name__ == "__main__":
    main()
