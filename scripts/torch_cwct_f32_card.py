"""Where the card's float32 cWCT parts from float64, op by op.

    python3 scripts/torch_cwct_f32_card.py        (from the repo root)
    python3 scripts/torch_cwct_f32_card.py --device cpu

The first cWCT of phase 10's float32-vs-float64 training call, as
scripts/torch_train_f32_tie_card.py makes it (PHOTO_CONFIG at full depth,
RevResNet weights from seed 0, a 128x128 B=2 batch from
chip_smoke._train_batch with seed 0): z_c and z_s encoded in float64.
Each op of models/cwct.py's global transfer (the means and covariances
of _stats, robust_cholesky's factors, _inv_lower, t = Ls Lc^-1, the bias
b, the output) runs in float32 on the device and on the CPU, two ways:
chained from the float32 latents, as the training step runs it (the
error carried), and from float64's own input to that op rounded to
float32 (the op's local error). Each is printed as max |d| / max |x|
from float64, beside the covariances' condition numbers and the
precision flags in force. Prints only; gates nothing.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

OPS = ("mean_c", "cov_c", "mean_s", "cov_s", "lc", "ls", "inv", "t", "b",
       "out")


def _ops(zc, zs, inputs=None):
    """Every op of the global transfer of zc by zs (NHWC). inputs: float64
    values of each op's inputs, to run each op from them (cast to zc's
    dtype and device) instead of from the previous op's output."""
    from vstnet_tpu_torch.models import cwct

    def arg(name, chained):
        if inputs is None:
            return chained
        return inputs[name].to(zc.device, zc.dtype)

    out = {}
    with cwct.true_f32_matmul():
        xc, xs = cwct._nhwc_as_gcn(zc), cwct._nhwc_as_gcn(zs)
        out["mean_c"], out["cov_c"] = cwct._stats(xc)
        out["mean_s"], out["cov_s"] = cwct._stats(xs)
        out["lc"] = cwct.robust_cholesky(arg("cov_c", out["cov_c"]))
        out["ls"] = cwct.robust_cholesky(arg("cov_s", out["cov_s"]))
        out["inv"] = cwct._inv_lower(arg("lc", out["lc"]))
        out["t"] = arg("ls", out["ls"]) @ arg("inv", out["inv"])
        t, mean_c = arg("t", out["t"]), arg("mean_c", out["mean_c"])
        out["b"] = arg("mean_s", out["mean_s"]) - (t @ mean_c[..., None])[
            ..., 0]
        out["out"] = torch.matmul(t[:, None], xc) + arg("b", out["b"])[
            :, None, :, None]
    return out


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def main():
    from vstnet_tpu_torch.config import PHOTO_CONFIG
    from vstnet_tpu_torch.models.revresnet import RevResNet

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; cpu to rehearse")
    args = p.parse_args()
    if args.device == "cpu":
        smi, device = "cpu", torch.device("cpu")
    else:
        smi, device = chip_smoke._require_card(), torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi, torch.__version__, torch.version.cuda)
    print("flags: cuda.matmul.allow_tf32",
          torch.backends.cuda.matmul.allow_tf32,
          "fp32_precision", getattr(torch.backends.cuda.matmul,
                                    "fp32_precision", "n/a"),
          "float32_matmul_precision", torch.get_float32_matmul_precision(),
          "preferred_linalg_library",
          torch.backends.cuda.preferred_linalg_library()
          if device.type == "cuda" else "n/a")
    net = RevResNet(PHOTO_CONFIG, device=device)
    net.init_weights(torch.Generator().manual_seed(0))
    a, s, _, _ = chip_smoke._train_batch(torch.Generator().manual_seed(0), 2,
                                         128, device)
    net64 = net.double()
    with torch.no_grad():
        zc, zs = net64(a.double()), net64(s.double())
    ref = _ops(zc.cpu(), zs.cpu())
    print("cond(cov_c)", [f"{float(c):.3e}" for c in
                          torch.linalg.cond(ref["cov_c"])],
          "cond(cov_s)", [f"{float(c):.3e}" for c in
                          torch.linalg.cond(ref["cov_s"])])
    for where in dict.fromkeys((device, torch.device("cpu"))):
        z32 = (zc.float().to(where), zs.float().to(where))
        chained = _ops(*z32)
        local = _ops(*z32, inputs=ref)
        print(f"float32 on {where}, max |d| / max |x| from float64, "
              f"chained / local: " + ", ".join(
                  f"{k} {_rel(chained[k], ref[k]):.2e} / "
                  f"{_rel(local[k], ref[k]):.2e}" for k in OPS))


if __name__ == "__main__":
    main()
