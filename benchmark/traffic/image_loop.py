"""Traffic loop: photos through the image CLI's routes, one at a time.

A pool of `pool_images` content images (height x width, uint8) and one
style image are made from the seed. Each request uploads its content and
the style as uint8 and scales them on the device (io.image.
device_put_image, as the CLI does), runs the route and reads the float32
result back into pinned host memory (PyTorch's caching host allocator,
as the video CLI reads frames back; a fresh pageable buffer a request
would time the host's page faults). A closed loop of one client: the
next request is sent when the last one is back.

Routes (`route`): "standard", the image CLI's default, StyleModel.stylize
on the float32 standard path (TF32 off); "tiled", its --fast route above
--ultra_threshold, models.ultra.stylize_tiled with the bf16 packed
weights, `tile` and `overlap`.

The check compares the sampled requests' outputs with the plain
reference at the same sizes: the worst image's RMSE of the raw decoder
output, in [0, 1] units.
"""

from __future__ import annotations

import types

import torch

from benchmark.core import program, synth
from benchmark.core import window as win
from benchmark.core.trace import span
from benchmark.reference import cwct as ref_cwct
from benchmark.reference import revresnet as ref_rn
from benchmark.reference import tiler as ref_tiler
from benchmark.reference.lowp import Exact


def build(cell, seed, device):
    from vstnet_tpu_torch.io.image import device_put_image
    from vstnet_tpu_torch.models import ultra

    p = cell.traffic
    st = types.SimpleNamespace(cell=cell, seed=seed, dev=device, p=p,
                               cfg=cell.config, k=0,
                               on_card=device.type == "cuda")
    st.model, st.weights = program.style_model(cell.config, seed, device)
    st.h, st.w = p["height"], p["width"]
    st.pool = list(synth.clip(seed, "photos", p["pool_images"], st.h, st.w,
                              device).cpu().numpy()[:, None])
    st.style_u8 = synth.clip(seed, "style", 1, p["style_height"],
                             p["style_width"], device).cpu().numpy()
    if p["route"] == "standard":
        st.run = lambda c, s: st.model.stylize(c, s)
    else:
        fast = st.model.fast_params
        st.run = lambda c, s: ultra.stylize_tiled(
            st.model.net, c, s, st.model.cfg, tile=p["tile"],
            overlap=p["overlap"], fast_params=fast)
    st.put = device_put_image
    # as many pinned outputs held at once as the window's sample holds,
    # and one more, so that the window allocates no pinned memory
    held = [_request(st) for _ in range(max(p["warm_images"],
                                            cell.workload["sample"] + 1))]
    del held
    return st


def _readback(st, out):
    if not st.on_card:
        return out.cpu()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(st.dev).synchronize()
    return host


def _request(st):
    idx = st.k % len(st.pool)
    st.k += 1
    t0 = win.now()
    with span("upload"):
        c = st.put(st.pool[idx], st.dev)
        s = st.put(st.style_u8, st.dev)
    t_call = win.now()
    with span("program"):
        out = st.run(c, s)
    enqueue = win.now() - t_call
    with span("readback"):
        host = _readback(st, out)
    return idx, host, win.now() - t0, enqueue


def run_window(st, seconds):
    w = win.Window("image", 1)
    res = win.Reservoir(st.cell.workload["sample"], st.seed)
    t0 = win.now()
    while win.now() - t0 < seconds:
        idx, host, lat, enq = _request(st)
        w.attempted += 1
        w.units += 1
        w.latencies_s.append(lat)
        w.enqueue_s.append(enq)
        res.offer((idx, host))
    w.seconds = win.now() - t0
    w.sample = res.items
    return w


def run_traced(st, units):
    for _ in range(units):
        _request(st)


def _image(st, u8):
    return torch.from_numpy(u8).to(st.dev).float() / 255.0


def reference_outputs(st, idx, lp):
    """The route's output for pool image idx, from the reference in the
    precision of `lp`."""
    c, s = _image(st, st.pool[idx]), _image(st, st.style_u8)
    if st.p["route"] == "standard":
        z_s = ref_rn.encode(st.weights, st.cfg, s, lp)
        ls, mu = ref_cwct.style_factor(z_s[0])
        z = ref_cwct.transfer_global(ref_rn.encode(st.weights, st.cfg, c,
                                                   lp), ls, mu)
        return ref_rn.decode(st.weights, st.cfg, z, lp).cpu()
    return ref_tiler.stylize_tiled(st.weights, st.cfg, c, s, st.p["tile"],
                                   st.p["overlap"], lp).cpu()


def control_sample(st, lp):
    """The sample a run compares, produced by the reference in the
    precision of `lp` in the program's place."""
    return [(i % len(st.pool), reference_outputs(st, i % len(st.pool), lp))
            for i in range(st.cell.workload["sample"])]


def check(st, w):
    lim = st.cell.workload["limits"].get("worst_image_rmse", float("inf"))
    errs = []
    for idx, host in w.sample:
        r = reference_outputs(st, idx, Exact()).to(st.dev)
        errs.append(float(((host.to(st.dev) - r) ** 2).mean().sqrt()))
    return ({"worst_image_rmse": max(errs)},
            sum(e > lim for e in errs))
