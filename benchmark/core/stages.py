"""The program's stages in a traced segment, read from its own spans.

The port opens a host span "vst.<stage>" around each stage of a program
call (vstnet_tpu_torch/runtime/profiling.span: the video programs'
segment, remap, encode, regional_cwct, cwct and decode, the tiler's
tile_pass1 and tile_pass2) while a profiler records, so in a traced
segment each stage's spans lie in the same trace as the device's events.
A device event (kernel, memcpy or memset) belongs to a stage when the host
call that launched it (the cuda_runtime or cuda_driver event with the same
args.correlation) starts inside one of the stage's spans, at any depth of
nesting. Inside the traced window (the bench.traced span), a stage's

  device ms   the union of its device events' intervals;
  host ms     the sum of its spans' durations;
  idle ms     the window's idle intervals (no device event at all) that
              fall inside its spans: the device ran dry while the host was
              in that stage;
  launches    its kernel events.

The harness's Trace (trace.py) keeps what it computes and not the events,
and a stage needs their correlation ids. So the first stage metric a
traced run reads records a segment of its own (`record`), right after the
harness's and of as many units, under the same profiler settings, and
keeps its Stages on the context for the run's other stage metrics. A
program without these spans (an earlier commit, whose runtime/profiling
has no SPAN_PREFIX) records no such segment, and the metrics that read
them are left out; `per_unit` then says so.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

from benchmark.core import trace as tr

PREFIX = "vst."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _inside(merged, heads, t):
    """Whether t lies in one of the sorted, merged intervals."""
    i = bisect.bisect_right(heads, t) - 1
    return i >= 0 and t <= merged[i][1]


def _overlap(xs, ys):
    """Length of the intersection of two sorted, merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


class Stages:
    """The vst.* spans of a traced segment's Chrome trace events and the
    device events launched inside them."""

    def __init__(self, events):
        window = tr.Trace(events)
        t0, t1 = window.t0, window.t1
        self.spans = {}
        launched = {}
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat"), str(e.get("name", ""))
            ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            corr = e.get("args", {}).get("correlation")
            if cat == "user_annotation" and name.startswith(PREFIX):
                a, b = max(ts, t0), min(end, t1)
                if b > a:
                    self.spans.setdefault(name[len(PREFIX):], []).append(
                        [a, b])
            elif cat in LAUNCH_CATS and corr is not None:
                launched[corr] = ts
            elif cat in tr.DEVICE_CATS:
                a, b = max(ts, t0), min(end, t1)
                if b > a:
                    device.append((cat, a, b, corr))
        # (category, start, end, launch time) of each device event
        self.device = [(cat, a, b, launched.get(corr))
                       for cat, a, b, corr in device]
        # the window less the device's busy intervals
        edges = [t0] + [x for ab in window.busy for x in ab] + [t1]
        self.idle = [[edges[i], edges[i + 1]]
                     for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]

    def _host(self, names):
        return tr._union([ab for n in names for ab in self.spans.get(n, [])])

    def owned(self, names):
        """The device events launched inside the spans of `names`."""
        merged = self._host(names)
        heads = [a for a, _ in merged]
        return [d for d in self.device
                if d[3] is not None and _inside(merged, heads, d[3])]

    def device_ms(self, *names) -> float:
        return sum(b - a for a, b in tr._union(
            [[a, b] for _, a, b, _ in self.owned(names)])) * 1e-3

    def host_ms(self, *names) -> float:
        return sum(b - a for n in names for a, b in self.spans.get(n, [])
                   ) * 1e-3

    def idle_ms(self, *names) -> float:
        return _overlap(self.idle, self._host(names)) * 1e-3

    def launches(self, *names) -> float:
        return float(sum(d[0] == "kernel" for d in self.owned(names)))


def _program_has_spans() -> bool:
    try:
        from vstnet_tpu_torch.runtime import profiling
    except ImportError:
        return False
    return getattr(profiling, "SPAN_PREFIX", None) == PREFIX


def record(ctx):
    """The Stages of ctx.traced_units more units of the cell's loop, run
    inside bench.traced under torch.profiler as trace.capture runs the
    harness's segment; None, with a note, where the program opens no
    vst.* span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.core import spec

    if not _program_has_spans():
        ctx.note(f"the program opens no {PREFIX}* span")
        return None
    loop = ctx.cell.loop(ctx._bench_dir or spec.BENCH_DIR)
    on_card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        with tr.span("traced"):
            loop.run_traced(ctx.state, ctx.traced_units)
        if on_card:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Stages(events)


def per_unit(ctx, what: str, *names):
    """Stages.<what>(*names) of the run's stage segment over its units;
    None, with a note, when the run is untraced, or the program or its
    trace has none of the spans."""
    if ctx.trace is None or not ctx.traced_units:
        return None
    if not hasattr(ctx, "stages"):
        ctx.stages = record(ctx)
    st = ctx.stages
    if st is None:
        return None
    missing = [n for n in names if n not in st.spans]
    if missing:
        ctx.note(f"no {PREFIX}{missing[0]} span in the trace")
        return None
    return getattr(st, what)(*names) / ctx.traced_units
