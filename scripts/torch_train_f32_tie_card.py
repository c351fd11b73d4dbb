"""Where the card's float32 training step parts from float64.

    python3 scripts/torch_train_f32_tie_card.py        (from the repo root)
    python3 scripts/torch_train_f32_tie_card.py --device cpu --hw 64 64

The card's counterpart of scripts/torch_train_f32_tie.py, without JAX.
Two calls of chip_smoke.py, each through the port's loss_and_grads with
TF32 off, in float64 and in float32, on PHOTO_CONFIG at full depth with
remat, RevResNet weights from seed 0 and VGG weights from seed 42:

  * phase 10's float32-vs-float64 call: 128x128, B=2, temporal phase,
    the default LossWeights (lap 1500, rec 10, temporal 60), a batch made
    by chip_smoke._train_batch from its own generator (seed 0; in the
    whole run phase 10's draws follow those of the phases before it);
  * phase 15's image step: 1024x1024, B=1, image phase (seed 1).

Every discrete decision of the step is recorded in forward order: each
ReLU's mask (RevResNet's convs through ops/pad_conv.reflect_conv, VGG's
nn.ReLU layers; remat's recomputation in the backward pass finds its
forward call by the pre-activation's sums), each L1 difference's signs,
VGG's max-pool choices and the cWCT's Cholesky jitter (the first of
robust_cholesky's escalating diagonal shifts whose factor is finite),
and so is each RevResNet pass's and cWCT's output. The float32 run is
then repeated: plainly (the run-to-run distance: cuDNN's backward may
sum in another order each run), with every decision forced to its own
(a control: bit for bit the plain run where that is, else as near as
the run to run distance), with every
decision forced to float64's ("float32, float64's decisions"), and at
DIRECT_HW on the card with cuDNN off (PyTorch's own convs). Prints the
decisions float32 takes the other way (for the
ReLUs: call, shape, count, |pre| over the layer's max |pre| in float64,
and float32's own error at the layer's near-zero pre-activations), each
output's distance from float64 in call order, and each run's distance of
the gradients from float64: the max over tensors of max |dg| / max |g64|
(phase 15's measure), the cosine and the relative L2 (phase 10's). A
flip is a tie when its float64 |pre| is within TIE of its layer's max
(tests/test_torch_train_f32.py's bar) or within float32's own error at
that layer.

Exits non-zero without a card (unless --device cpu) or when the control
fails where the float32 run repeats bit for bit; gates nothing else.
"""

from __future__ import annotations

import argparse
import copy
import pathlib
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TIE = 1e-6
# float64 pre-activations kept by value: |pre| within NEAR of the layer's
# max; a flip outside them is counted apart
NEAR = 1e-3
# sizes at which the float32 call also runs without cuDNN
DIRECT_HW = 128


def _key(x):
    """The pre-activation's identity across remat's recomputation."""
    x = x.detach().double()
    return tuple(x.shape), float(x.sum()), float(x.abs().sum())


class Record:
    """The decisions and outputs of one loss_and_grads call, in forward
    order. force: a Record whose decisions this call takes; ref: the
    float64 call's Record, against which each ReLU call is compared as it
    runs."""

    def __init__(self, force=None, ref=None):
        self.force, self.ref = force, ref
        self.relu = []      # per call: where, shape, mask, top, near, pre
        self.flips = []     # per call against ref: see _compare
        self.keys = {}
        self.l1, self.pool, self.jitter, self.outs = [], [], [], []

    def relu_call(self, out, where):
        if torch._C._current_graph_task_id() != -1:
            # remat's recomputation inside the backward pass
            if self.force is None:
                return F.relu(out)
            i = self.keys[_key(out)]
        else:
            i = len(self.relu)
            pre = out.detach()
            top = float(pre.abs().max())
            near = (pre.abs() <= NEAR * top).flatten().nonzero()[:, 0]
            self.relu.append(dict(where=where, shape=tuple(pre.shape),
                                  mask=pre > 0, top=top, near=near,
                                  pre=pre.flatten()[near].double()))
            if self.ref is not None:
                self.flips.append(_compare(pre, self.ref.relu[i]))
            if self.force is not None:
                self.keys.setdefault(_key(out), i)
        if self.force is None:
            return F.relu(out)
        return out * self.force.relu[i]["mask"].to(out.dtype)


def _compare(pre, ref):
    """(flips, their largest float64 |pre| over the layer's max, flips
    beyond NEAR, float32's largest error at the layer's near-zero
    pre-activations over the layer's max)."""
    top = max(ref["top"], 1e-300)
    flip = ((pre > 0) != ref["mask"]).flatten().nonzero()[:, 0]
    err = float((pre.flatten()[ref["near"]].double() - ref["pre"]).abs()
                .max()) / top if len(ref["near"]) else 0.0
    hit = torch.isin(flip, ref["near"])
    pos = torch.searchsorted(ref["near"], flip[hit])
    rel = float(ref["pre"][pos].abs().max()) / top if len(pos) else 0.0
    return len(flip), rel, int((~hit).sum()), err


class _Relu(torch.nn.Module):
    def __init__(self, state, where):
        super().__init__()
        self.state, self.where = state, where

    def forward(self, x):
        return self.state["rec"].relu_call(x, self.where)


class _Pool(torch.nn.Module):
    def __init__(self, state):
        super().__init__()
        self.state = state

    def forward(self, x):
        rec = self.state["rec"]
        out, idx = F.max_pool2d(x, 2, 2, ceil_mode=True, return_indices=True)
        if rec.force is not None:
            idx = rec.force.pool[len(rec.pool)]
            out = x.flatten(2).gather(2, idx.flatten(2)).view_as(out)
        rec.pool.append(idx)
        return out


def _instrument(vggs, state):
    """Route every decision of the step and each RevResNet pass's and
    cWCT's output through state["rec"]; the VGGs are changed in place."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models.revresnet import RevResNet
    from vstnet_tpu_torch.ops import at_least_f32, pad_conv
    from vstnet_tpu_torch.train import losses

    def reflect_conv(x, w, b=None, stride=1, relu=False):
        out = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w, b,
                       stride=stride)
        return state["rec"].relu_call(out, "revresnet") if relu else out

    def l1(a, b):
        d = at_least_f32(a) - at_least_f32(b)
        rec = state["rec"]
        if not (a.requires_grad or b.requires_grad):
            return d.abs().mean()
        sign = torch.sign(d.detach())
        if rec.force is not None:
            sign = rec.force.l1[len(rec.l1)].to(d.dtype)
        rec.l1.append(sign.to(torch.int8))
        return (d * sign).mean()

    def jitter_ladder(cov, eps, attempts):
        # cwct._jitter_ladder with its choice recorded or forced
        rec = state["rec"]
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        scales = torch.cat([
            torch.zeros(1, dtype=cov.dtype, device=cov.device),
            2.0 ** torch.arange(attempts - 1, dtype=cov.dtype,
                                device=cov.device)]) * eps
        cands = cov.unsqueeze(-3) + scales[:, None, None] * eye
        ls, info = torch.linalg.cholesky_ex(cands)
        ok = (info == 0) & torch.isfinite(ls).all(dim=-1).all(dim=-1)
        idx = torch.argmax(ok.to(torch.int32), dim=-1)
        if rec.force is not None:
            idx = rec.force.jitter[len(rec.jitter)]
        rec.jitter.append(idx)
        l = torch.take_along_dim(ls, idx[..., None, None, None], dim=-3)
        return l.squeeze(-3), ok.any(dim=-1)

    def keep(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            state["rec"].outs.append((name, out.detach().double()))
            return out
        return wrapped

    pad_conv.reflect_conv = reflect_conv
    losses._l1 = l1
    cwct._jitter_ladder = jitter_ladder
    RevResNet.forward = keep("encode", RevResNet.forward)
    RevResNet.inverse = keep("decode", RevResNet.inverse)
    cwct.transfer = keep("cWCT", cwct.transfer)
    for vgg in vggs:
        for i, layer in enumerate(vgg):
            if isinstance(layer, torch.nn.ReLU):
                vgg[i] = _Relu(state, f"vgg {i}")
            elif isinstance(layer, torch.nn.MaxPool2d):
                vgg[i] = _Pool(state)


def _grads(net, vgg, batch, temporal, dt, state, rec):
    from vstnet_tpu_torch.train.losses import LossWeights, loss_and_grads

    state["rec"] = rec
    a, s, flow, noise = batch
    g, _ = loss_and_grads(net, vgg, a.to(dt), s.to(dt), LossWeights(), flow,
                          noise.to(dt), temporal,
                          precision="f64" if dt == torch.float64 else "f32")
    return [x.detach().double().clone() for x in g.values()]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _distance(g, g64):
    rel = max(_rel(x, y) for x, y in zip(g, g64))
    a = torch.cat([x.flatten() for x in g])
    b = torch.cat([x.flatten() for x in g64])
    cos = float(a @ b / (a.norm() * b.norm()))
    return (f"max over tensors of max |dg| / max |g64| {rel:.3e}, cosine "
            f"{cos:.9f}, rel L2 {float((a - b).norm() / b.norm()):.3e}")


def bisect(name, hw, b, temporal, device, smi):
    from vstnet_tpu_torch.config import PHOTO_CONFIG
    from vstnet_tpu_torch.models.revresnet import RevResNet
    from vstnet_tpu_torch.models.vgg import init_vgg

    t0 = time.perf_counter()
    state = {}
    net = RevResNet(PHOTO_CONFIG.with_remat(), device=device)
    net.init_weights(torch.Generator().manual_seed(0))
    vgg = init_vgg(torch.Generator().manual_seed(42), device=device)
    net64, vgg64 = copy.deepcopy(net).double(), copy.deepcopy(vgg).double()
    _instrument((vgg, vgg64), state)
    gen = torch.Generator().manual_seed(0 if temporal else 1)
    batch = chip_smoke._train_batch(gen, b, hw, device)
    r64 = Record()
    g64 = _grads(net64, vgg64, batch, temporal, torch.float64, state, r64)
    del net64, vgg64
    r32 = Record(ref=r64)
    g32 = _grads(net, vgg, batch, temporal, torch.float32, state, r32)
    again = _grads(net, vgg, batch, temporal, torch.float32, state,
                   Record())
    own = _grads(net, vgg, batch, temporal, torch.float32, state,
                 Record(force=r32))
    forced = _grads(net, vgg, batch, temporal, torch.float32, state,
                    Record(force=r64))
    direct = None
    if device.type == "cuda" and hw <= DIRECT_HW:
        # the same float32 call on PyTorch's own convs instead of cuDNN's
        torch.backends.cudnn.enabled = False
        try:
            rd = Record()
            direct = _grads(net, vgg, batch, temporal, torch.float32, state,
                            rd)
        finally:
            torch.backends.cudnn.enabled = True
    phase = "temporal" if temporal else "image"
    head = (f"{name}: PHOTO_CONFIG full depth remat, {hw}x{hw}, B={b}, "
            f"{phase} phase")
    print(f"{head}: {len(r64.relu)} ReLU calls, "
          f"{sum(c['mask'].numel() for c in r64.relu)} decisions; "
          f"{len(r64.l1)} L1s, {len(r64.pool)} max pools, "
          f"{len(r64.jitter)} Cholesky ladders [{smi}]")
    if len(r32.relu) != len(r64.relu):
        raise AssertionError(f"{len(r32.relu)} float32 ReLU calls, "
                             f"{len(r64.relu)} float64")
    flips, worst, over = 0, 0.0, 0
    for i, (n, rel, far, err) in enumerate(r32.flips):
        if not n:
            continue
        c = r64.relu[i]
        flips, worst = flips + n, max(worst, rel)
        over += far + (rel > max(TIE, err))
        print(f"  ReLU call {i} ({c['where']}) {c['shape']}: {n} "
              f"decision(s) differ, float64 |pre| up to {rel:.3e} of the "
              f"layer's max {c['top']:.3e}; float32's error at the "
              f"layer's near-zero pre-activations {err:.3e} of it"
              + (f"; {far} beyond {NEAR}" if far else ""))
    l1 = [int((x != y).sum()) for x, y in zip(r32.l1, r64.l1)]
    pool = [int((x != y).sum()) for x, y in zip(r32.pool, r64.pool)]
    jit = [(x.tolist(), y.tolist()) for x, y in zip(r32.jitter, r64.jitter)
           if not torch.equal(x, y)]
    print(f"{head}: ReLU decisions float32 takes the other way: {flips}, "
          f"float64 |pre| up to {worst:.3e} of the layer's max; beyond both "
          f"{TIE} and float32's own error at that layer: {over}; L1 signs "
          f"that differ {l1}; max-pool choices that differ {pool}; "
          f"Cholesky jitters that differ (float32, float64): {jit or 'none'}")
    print(f"{head}: outputs in call order, max |d| / max |x| float32 vs "
          f"float64: " + ", ".join(
              f"{n} {_rel(x, y):.2e}" for (n, x), (_, y) in zip(r32.outs,
                                                                r64.outs)))
    floor = max(_rel(x, y) for x, y in zip(again, g32))
    control = max(_rel(x, y) for x, y in zip(own, g32))
    print(f"{head}: float32 run to run (max over tensors of max |dg| / max "
          f"|g|): {floor:.3e}; control, float32 with its own decisions "
          f"forced vs the plain run: {control:.3e}")
    print(f"{head}: float32 vs float64: {_distance(g32, g64)}")
    print(f"{head}: float32 with float64's decisions vs float64: "
          f"{_distance(forced, g64)} [{smi}]")
    if direct is not None:
        print(f"{head}: float32 without cuDNN (PyTorch's own convs) vs "
              f"float64: {_distance(direct, g64)}; outputs: " + ", ".join(
                  f"{n} {_rel(x, y):.2e}" for (n, x), (_, y) in
                  zip(rd.outs, r64.outs)))
    print(f"{head}: {time.perf_counter() - t0:.1f} s")
    if floor == 0.0 and control != 0.0:
        raise AssertionError("the forced decisions do not reproduce float32")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; cpu to rehearse")
    p.add_argument("--hw", type=int, nargs=2, default=(128, 1024),
                   help="phase 10's and phase 15's sizes (0: skip)")
    args = p.parse_args()
    if args.device == "cpu":
        smi, device = "cpu", torch.device("cpu")
    else:
        smi, device = chip_smoke._require_card(), torch.device("cuda:0")
    print(smi, torch.__version__, torch.version.cuda)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.hw[0]:
        bisect("phase 10 f32 vs f64", args.hw[0], 2, True, device, smi)
    if args.hw[1]:
        bisect("phase 15 image step", args.hw[1], 1, False, device, smi)


if __name__ == "__main__":
    main()
