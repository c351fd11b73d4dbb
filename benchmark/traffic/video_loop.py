"""Traffic loop: offline video through the video CLI's own loop.

A clip of `pool_frames` frames (height x width, uint8) and one style image
are made from the seed; the clip is played over and over in batches of
`batch` frames. The loop is the video CLI's (cli/video_transfer.py:
upload, readback, flush, _drain): a batch is stacked and pinned on the
host, uploaded as uint8 and scaled on the device, run through the
route's program, packed to uint8 there and read back into pinned memory
behind an event, with `in_flight` batches in flight; a batch completes
when the host has waited on its event. A closed loop: the next batch is
submitted when one completes.

Routes, by the configuration: without a segmenter, the global program
(parallel_stylize_fused(out_u8=True) against the style's factors from the
float32 encode, as the CLI sets it up); with one, the auto-seg program
(prepare_masked_style once, then parallel_stylize_masked_fused with
min_ratio and seg_hw=None).

The check compares the sampled batches' frames with the plain reference
(benchmark/reference) at the same sizes: the worst frame's RMSE in [0, 1]
units; on the auto-seg route the reference stylizes under the program's
own masks, and the masks are compared with the reference's: the worst
frame's share, among the pixels whose label the reference decides
clearly (reference/segformer.py, CLEAR), of those whose label differs.
With random weights SegFormer's logits lie close together, and 1-3 % of a
frame's pixels are near-ties that bf16 rounding flips either way.
"""

from __future__ import annotations

import collections
import sys
import types

import numpy as np
import torch

from benchmark.core import program, synth
from benchmark.core import window as win
from benchmark.core.trace import span
from benchmark.reference import cwct as ref_cwct
from benchmark.reference import remap as ref_remap
from benchmark.reference import revresnet as ref_rn
from benchmark.reference import segformer as ref_seg
from benchmark.reference.lowp import Exact
from benchmark.reference.resize import resize_nearest

Item = collections.namedtuple("Item", "idx t_sub enqueue out cm events")


def build(cell, seed, device):
    from vstnet_tpu_torch.io.image import device_put_image
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import pipeline as pl
    from vstnet_tpu_torch.ops.resize import resize_bilinear
    from vstnet_tpu_torch.parallel import map_shards
    from vstnet_tpu_torch.parallel import sharding as ps

    p = cell.traffic
    cfg = cell.config
    st = types.SimpleNamespace(cell=cell, seed=seed, dev=device, p=p,
                               cfg=cfg, k=0, on_card=device.type == "cuda")
    st.model, st.weights = program.style_model(cfg, seed, device)
    st.b, st.h, st.w = p["batch"], p["height"], p["width"]
    clip = synth.clip(seed, "clip", p["pool_frames"], st.h, st.w, device)
    st.pool = list(clip.cpu().numpy())
    st.style_u8 = synth.clip(seed, "style", 1, p["style_height"],
                             p["style_width"], device).cpu().numpy()
    del clip
    devices = [device]
    style = device_put_image(st.style_u8, device)
    fast = st.model.fast_params
    st.masked = "segformer" in cfg
    if st.masked:
        st.seg, st.seg_weights = program.segmenter(
            cfg["segformer"], seed, device, p["min_ratio"])
        st.region, st.plan, smask = pl.prepare_masked_style(
            fast, st.seg, style, st.model.cfg, p["min_ratio"])
        st.style_labels = int(torch.unique(smask).numel())
        fn = ps.parallel_stylize_masked_fused(
            devices, st.model.cfg, min_ratio=p["min_ratio"], out_u8=True,
            seg_hw=None)
        st.stylize = lambda xs: fn(fast, st.seg.net, st.seg.label_mapping,
                                   st.region, st.plan, xs)
    else:
        ls, mu_s = cwct.style_factors(st.model.net.encode(style))
        fn = ps.parallel_stylize_fused(devices, st.model.cfg, out_u8=True)
        st.stylize = lambda xs: (fn(fast, xs, ls, mu_s), None)
    st.window_batch = lambda: _inputs(st, 0)
    st.prep = map_shards(devices, lambda x: resize_bilinear(
        x.float() / 255.0, st.h, st.w), sharded=(0,))
    pending = collections.deque()
    for _ in range(p["warm_batches"]):
        _submit(st, pending, lambda it, t: None)
    _finish(st, pending, lambda it, t: None)
    return st


def _readback(st, shards):
    if shards is None:
        return None
    if not st.on_card:
        return torch.cat([t.cpu() for t in shards])
    per = shards[0].shape[0]
    host = torch.empty((per * len(shards), *shards[0].shape[1:]),
                       dtype=shards[0].dtype, pin_memory=True)
    for i, t in enumerate(shards):
        host[i * per:(i + 1) * per].copy_(t, non_blocking=True)
    return host


def _flush(st):
    idx = (st.k * st.b) % len(st.pool)
    batch = st.pool[idx:idx + st.b]
    batch = batch + st.pool[:st.b - len(batch)]
    t_sub = win.now()
    with span("upload"):
        x = torch.from_numpy(np.stack(batch))
        if st.on_card:
            x = x.pin_memory()
        shards = st.prep(x)
    t_call = win.now()
    with span("program"):
        out, cm = st.stylize(shards)
    enqueue = win.now() - t_call
    with span("readback"):
        out, cm = _readback(st, out), _readback(st, cm)
        events = []
        if st.on_card:
            events.append(torch.cuda.Event())
            events[-1].record()
    st.k += 1
    return Item(idx, t_sub, enqueue, out, cm, events)


def _wait(item):
    with span("wait"):
        for e in item.events:
            e.synchronize()
    return win.now()


def _submit(st, pending, done):
    """One flush, then drain while more than in_flight are pending;
    done(item, completion time) for each drained batch."""
    item = _flush(st)
    pending.append(item)
    while len(pending) > st.p["in_flight"]:
        it = pending.popleft()
        done(it, _wait(it))
    return item


def _finish(st, pending, done):
    while pending:
        it = pending.popleft()
        done(it, _wait(it))


def run_window(st, seconds):
    w = win.Window("batch", st.b)
    res = win.Reservoir(st.cell.workload["sample"], st.seed)
    pending = collections.deque()
    for _ in range(st.p["in_flight"]):
        _submit(st, pending, lambda it, t: None)

    def done(it, t):
        w.units += 1
        w.latencies_s.append(t - it.t_sub)
        res.offer((it.idx, it.out, it.cm))

    t0 = win.now()
    while True:
        item = _submit(st, pending, done)
        w.attempted += 1
        w.enqueue_s.append(item.enqueue)
        if win.now() - t0 >= seconds:
            break
    w.seconds = win.now() - t0
    _finish(st, pending, lambda it, t: None)
    w.sample = res.items
    return w


def run_traced(st, units):
    """`units` whole batches, the pipeline filled and drained inside."""
    pending = collections.deque()
    for _ in range(units):
        _submit(st, pending, lambda it, t: None)
    _finish(st, pending, lambda it, t: None)


def _inputs(st, idx):
    batch = np.stack((st.pool + st.pool)[idx:idx + st.b])
    return torch.from_numpy(batch).to(st.dev).float() / 255.0


def _style(st):
    return torch.from_numpy(st.style_u8).to(st.dev).float() / 255.0


class _Reference:
    """The reference's per-video state (recomputed from the inputs and
    weights, in the precision of `lp`)."""

    def __init__(self, st, lp):
        self.st, self.lp = st, lp
        cfg = st.cfg
        style = _style(st)
        z_s = ref_rn.encode(st.weights, cfg, style, lp)
        if st.masked:
            ratio = st.p["min_ratio"]
            self.table = torch.from_numpy(np.load(program.LABEL_TABLE))
            sm = ref_seg.segment(st.seg_weights, cfg["segformer"], style,
                                 lp)[0][0]
            sm = ref_remap.self_remap(sm, self.table, ratio)   # holes
            sm = ref_remap.self_remap(sm, self.table, ratio)
            self.style_present = ref_remap.present(sm)
            sm = resize_nearest(sm[None], z_s.shape[1], z_s.shape[2])[0]
            self.regions = ref_cwct.style_regions(z_s[0], sm)
        else:
            self.ls, self.mu = ref_cwct.style_factor(z_s[0])

    def masks(self, x):
        """(remapped masks, decided clearly) of frames x."""
        ratio = self.st.p["min_ratio"]
        raw, clear = ref_seg.segment(self.st.seg_weights,
                                     self.st.cfg["segformer"], x, self.lp)
        return torch.stack([
            ref_remap.cross_remap(ref_remap.self_remap(m, self.table, ratio),
                                  self.style_present, self.table)
            for m in raw]), clear

    def frames(self, x, cm=None):
        """Stylized frames in [0, 1], float32; cm: the masks to stylize
        under (auto-seg route)."""
        st, lp = self.st, self.lp
        out = []
        for i in range(x.shape[0]):
            z = ref_rn.encode(st.weights, st.cfg, x[i:i + 1], lp)
            if st.masked:
                m = resize_nearest(cm[i:i + 1].to(z.device), z.shape[1],
                                   z.shape[2])[0]
                zt = ref_cwct.transfer_regional(z[0], m, self.regions)[None]
            else:
                zt = ref_cwct.transfer_global(z, self.ls, self.mu)
            out.append(ref_rn.decode(st.weights, st.cfg, zt, lp).clamp(0, 1))
        return torch.cat(out)


def reference_outputs(st, idx, lp):
    """What the reference in the precision of `lp` produces for the batch
    at pool index idx, in the program's form: (uint8 frames, masks)."""
    ref = _Reference(st, lp)
    x = _inputs(st, idx)
    cm = ref.masks(x)[0].to(torch.int32) if st.masked else None
    out = torch.round(ref.frames(x, cm) * 255).to(torch.uint8)
    return out.cpu(), None if cm is None else cm.cpu()


def control_sample(st, lp):
    """The sample a run compares, produced by the reference in the
    precision of `lp` in the program's place."""
    return [(idx, *reference_outputs(st, idx, lp)) for idx in
            [(i * st.b) % len(st.pool)
             for i in range(st.cell.workload["sample"])]]


def check(st, w):
    """({number: value}, failed frames) over the sampled batches."""
    ref = _Reference(st, Exact())
    rmse, mismatch, failed = [], [], 0
    lim = st.cell.workload["limits"]
    labels = []
    for idx, out, cm in w.sample:
        x = _inputs(st, idx)
        prog = out.to(st.dev).float() / 255.0
        if st.masked:
            cm = cm.to(st.dev)
            labels.append(int(torch.unique(cm).numel()))
            want, clear = ref.masks(x)
            mm = ((want != cm) & clear).float().sum(dim=(1, 2)) / clear.float(
                ).sum(dim=(1, 2)).clamp(min=1)
            mismatch += mm.tolist()
        r = ref.frames(x, cm)
        e = ((prog - r) ** 2).mean(dim=(1, 2, 3)).sqrt()
        rmse += e.tolist()
    numbers = {"worst_frame_rmse": max(rmse)}
    bad = [v > lim.get("worst_frame_rmse", float("inf")) for v in rmse]
    if st.masked:
        numbers["worst_clear_mask_mismatch"] = max(mismatch)
        bad = [a or m > lim.get("worst_clear_mask_mismatch", float("inf"))
               for a, m in zip(bad, mismatch)]
        print(f"labels: style {st.style_labels} (capacity "
              f"{st.region[0].numel()}); sampled batches {labels}",
              file=sys.stderr)
    failed = sum(bad)
    return numbers, failed
