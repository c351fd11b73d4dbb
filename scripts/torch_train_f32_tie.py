"""Where the float32 training step parts from float64 on one CPU batch.

    MKL_CBWR=COMPATIBLE JAX_PLATFORMS=cpu python3 scripts/torch_train_f32_tie.py

The batch of tests/test_torch_spatial_train.py (64x16, B = 2, SMALL, seed
14, lap 10), through tests/test_torch_train_f32.py's `collect`: the port's
loss_and_grads in float64 and float32 (each ReLU's pre-activation and
each L1's difference recorded), the port's float32 step with float64's
ReLU decisions, and the JAX package's loss_and_grads_flat jitted and run
op by op (jax.disable_jit). Prints, per phase: the ReLU decisions that
float32 takes the other way (call, shape, count, |pre| over the layer's
max |pre| in float64), the L1 signs that differ, and each pair's largest
max |dg| / max |g| over the parameter tensors with its tensor and in
units of test_torch_train.py's flat bound (2e-6 + 2e-5 |g|).

Then the bisection of the cycle pass (encode the stylized image, cWCT
against z_c, decode, L1 against the content) on the same batch: each
intermediate (the stylized image, z_cs2, the cWCT's mean and covariances,
both Cholesky factors, _inv_lower, z_csc, rec) and its cotangent under
the cycle term alone (rec weight 10), as max |d| / max |x| from the
port's float64 run, for the port's float32 run and the JAX package's
float32 run, op by op and jitted (a zero perturbation added to each
intermediate gives its cotangent in both packages). The port's float32
run goes once with oneDNN off, as the tests run it, and once with it
on: the tie's side follows the convs' rounding.

Prints only; gates nothing. CPU numbers, not a device measurement.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

import jax
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import test_torch_train_f32 as t  # noqa: E402
from vstnet_tpu.models import cwct as jc  # noqa: E402
from vstnet_tpu.models.revresnet import decode as jdecode  # noqa: E402
from vstnet_tpu.models.revresnet import encode as jencode  # noqa: E402
from vstnet_tpu.models.revresnet import init_revresnet  # noqa: E402
from vstnet_tpu_torch.config import RevResNetConfig  # noqa: E402
from vstnet_tpu_torch.io.checkpoint import params_from_jax  # noqa: E402
from vstnet_tpu_torch.models import cwct as tc  # noqa: E402
from vstnet_tpu_torch.models.revresnet import RevResNet  # noqa: E402

SMALL = RevResNetConfig(n_blocks=(1, 1, 1), hidden_dim=16, sp_steps=2)
FACTORS = ("mean_c", "cov_c", "cov_s", "lc", "ls", "inv")


def _units(got, want):
    """Largest |dg| in units of the flat bound, over every tensor."""
    return max(float(((got[k].double() - want[k].double()).abs() / (
        t.ATOL + t.RTOL * want[k].double().abs())).max()) for k in want)


def main():
    with tempfile.TemporaryDirectory() as d:
        port, jax_out = t.collect(pathlib.Path(d))
    as_t = {k: {n: torch.as_tensor(v) for n, v in g.items()}
            for k, g in jax_out.items()}
    for temporal in t.PHASES:
        phase = "temporal" if temporal else "image"
        g64, pre64, l1_64 = port[(temporal, "f64")]
        g32, pre32, l1_32 = port[(temporal, "f32")]
        for i, (p32, p64) in enumerate(zip(pre32, pre64)):
            flip = (p32 > 0) != (p64 > 0)
            if flip.any():
                print(f"{phase}: ReLU call {i} of {len(pre64)}, "
                      f"{tuple(p64.shape)}: {int(flip.sum())} decision(s) "
                      f"differ, |pre| {float(p64[flip].abs().max()):.3e} = "
                      f"{float(p64[flip].abs().max() / p64.abs().max()):.3e}"
                      f" of the layer's max")
        print(f"{phase}: L1 signs that differ: " + str(
            [int((torch.sign(a) != torch.sign(b)).sum())
             for a, b in zip(l1_32, l1_64)]))
        runs = {"port f32": g32, "port f64": g64,
                "port f32, f64 ties": port[(temporal, "f32_ties")][0],
                "JAX jit": as_t[(temporal, "jit")],
                "JAX op by op": as_t[(temporal, "eager")]}
        for a, b in (("port f32", "port f64"), ("JAX jit", "port f64"),
                     ("JAX op by op", "port f64"),
                     ("JAX op by op", "JAX jit"),
                     ("port f32", "JAX op by op"),
                     ("port f32, f64 ties", "JAX jit"),
                     ("port f32, f64 ties", "port f64")):
            rel, k = max((t._rel(runs[a][n], runs[b][n]), n)
                         for n in runs[b])
            print(f"{phase}: {a} vs {b}: {rel:.3e} ({k}), "
                  f"{_units(runs[a], runs[b]):.2f} bounds")


def _zeros(a, z, lib):
    """Zero perturbations, one per intermediate, in lib's arrays."""
    b, c = z[0], z[3]
    fac = {k: lib((b, c) if k == "mean_c" else (b, c, c)) for k in FACTORS}
    return {"stylized": lib(a), "z_cs2": lib(z), "z_csc": lib(z),
            "rec": lib(a), "fac": fac}


def _jax_cycle(params, a, s, d):
    """(10 * L1(rec, a), intermediates) of the JAX package's functions,
    each intermediate plus its perturbation in d."""
    A, S = jnp.asarray(a), jnp.asarray(s)
    z_c, z_s = jencode(params, A, t.JSMALL), jencode(params, S, t.JSMALL)
    out = {"stylized": jdecode(params, jc.transfer(z_c, z_s), t.JSMALL)
           + d["stylized"]}
    out["z_cs2"] = jencode(params, out["stylized"], t.JSMALL) + d["z_cs2"]

    def one(xcb, xsb, dd):
        mc, cc = jc._feat_stats(xcb)
        ms, cs = jc._feat_stats(xsb)
        f = {"mean_c": mc + dd["mean_c"], "cov_c": cc + dd["cov_c"],
             "cov_s": cs + dd["cov_s"]}
        f["lc"] = jc.robust_cholesky(f["cov_c"]) + dd["lc"]
        f["ls"] = jc.robust_cholesky(f["cov_s"]) + dd["ls"]
        f["inv"] = jc._inv_lower(f["lc"]) + dd["inv"]
        tr = jc._mm(f["ls"], f["inv"])
        return jc._apply(xcb, tr, ms - jc._mm(tr, f["mean_c"])), f

    y, fac = jax.vmap(one)(jc._to_nc(out["z_cs2"]), jc._to_nc(z_c),
                           d["fac"])
    out.update(fac)
    out["z_csc"] = y.reshape(out["z_cs2"].shape) + d["z_csc"]
    out["rec"] = jdecode(params, out["z_csc"], t.JSMALL) + d["rec"]
    return 10 * jnp.mean(jnp.abs(out["rec"] - A)), out


def _port_cycle(params, a, s, dt):
    """Intermediates and their cotangents of the port's cycle pass."""
    net = RevResNet(SMALL, device="cpu").to(dt)
    net.load_state_dict(params_from_jax(params))
    A, S = torch.from_numpy(a).to(dt), torch.from_numpy(s).to(dt)
    d = _zeros(a.shape, (a.shape[0], a.shape[1], a.shape[2], 32),
               lambda shp: torch.zeros(shp, dtype=dt, requires_grad=True))
    z_c, z_s = net(A), net(S)
    out = {"stylized": net.inverse(tc.transfer(z_c, z_s)) + d["stylized"]}
    out["z_cs2"] = net(out["stylized"]) + d["z_cs2"]
    xc = tc._nhwc_as_gcn(out["z_cs2"])
    mc, cc = tc._stats(xc)
    ms, cs = tc._stats(tc._nhwc_as_gcn(z_c))
    dd = d["fac"]
    f = {"mean_c": mc + dd["mean_c"], "cov_c": cc + dd["cov_c"],
         "cov_s": cs + dd["cov_s"]}
    f["lc"] = tc.robust_cholesky(f["cov_c"]) + dd["lc"]
    f["ls"] = tc.robust_cholesky(f["cov_s"]) + dd["ls"]
    f["inv"] = tc._inv_lower(f["lc"]) + dd["inv"]
    tr = f["ls"] @ f["inv"]
    bias = ms - (tr @ f["mean_c"][..., None])[..., 0]
    y = torch.matmul(tr[:, None], xc) + bias[:, None, :, None]
    out.update(f)
    out["z_csc"] = tc._gcn_as_nhwc(y, out["z_cs2"].shape) + d["z_csc"]
    out["rec"] = net.inverse(out["z_csc"]) + d["rec"]
    (10 * (out["rec"] - A).abs().mean()).backward()
    cot = {k: (d["fac"][k] if k in FACTORS else d[k]).grad.double()
           for k in out}
    return {k: v.detach().double() for k, v in out.items()}, cot


def cycle_bisect():
    params = t._np_tree(jax.jit(lambda k: init_revresnet(k, t.JSMALL))(
        jax.random.PRNGKey(5)))
    a, s, _, _ = t._batch()
    jp = jax.tree.map(jnp.asarray, params)
    z = (a.shape[0], a.shape[1], a.shape[2], 32)
    d0 = _zeros(a.shape, z, lambda shp: jnp.zeros(shp, jnp.float32))
    port = {}
    for on in (False, True):
        torch.backends.mkldnn.enabled = on
        port[f"port f32 (oneDNN {'on' if on else 'off'})"] = _port_cycle(
            params, a, s, torch.float32)
    torch.backends.mkldnn.enabled = False  # as the tests run the port
    port["port f64"] = _port_cycle(params, a, s, torch.float64)
    for tag, fn in (("JAX op by op", _jax_cycle),
                    ("JAX jit", jax.jit(_jax_cycle))):
        _, vjp, out = jax.vjp(lambda p, d: fn(p, a, s, d), jp, d0,
                              has_aux=True)
        _, cot = vjp(jnp.asarray(1.0))
        flat = dict(cot, **cot["fac"])
        port[tag] = ({k: torch.from_numpy(np.array(v)).double()
                      for k, v in out.items()},
                     {k: torch.from_numpy(np.array(flat[k])).double()
                      for k in out})
    ref_out, ref_cot = port.pop("port f64")
    print("cycle pass, max |d| / max |x| from the port's float64 run "
          "(value; cotangent): " + ", ".join(port))
    for k in ref_out:
        print(f"  {k:9s} " + "   ".join(
            f"{t._rel(o[k], ref_out[k]):.2e}; {t._rel(c[k], ref_cot[k]):.2e}"
            for o, c in port.values()))


if __name__ == "__main__":
    main()
    cycle_bisect()
