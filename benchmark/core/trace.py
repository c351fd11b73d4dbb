"""The device trace of a traced segment, and what it says.

A segment runs under torch.profiler (CUPTI) with the harness's own host
spans (`span`, record_function under the prefix "bench."). The Chrome
trace goes to a file under TMPDIR, is read back once and deleted. The
traced window is the outermost span, "bench.traced"; the device is busy
where a kernel, a memcpy or a memset runs (the union of their intervals,
the arithmetic of the port's runtime/profiling.py) and idle elsewhere in
the window, from its first microsecond to its last.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench."
WINDOW = PREFIX + "traced"
TOP = 10           # entries in each list of the breakdown


def span(name: str):
    """A host span of the harness, named bench.<name>, in the trace."""
    return torch.profiler.record_function(PREFIX + name)


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """What a traced window holds: its length, the device's events inside
    it, and the harness's host spans."""

    def __init__(self, events):
        host = [e for e in events if e.get("ph") == "X"
                and e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith(PREFIX)]
        windows = [e for e in host if e["name"] == WINDOW]
        if not windows:
            raise RuntimeError("trace: no bench.traced span")
        w = max(windows, key=lambda e: e["dur"])
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.spans = [(e["name"][len(PREFIX):], float(e["ts"]),
                       float(e["ts"]) + float(e["dur"]))
                      for e in host if e is not w]
        self.device = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b > a:
                self.device.append((e["name"], e["cat"], a, b))
        self.busy = _union([[a, b] for _, _, a, b in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernels(self, needles):
        """(launches, seconds) of the kernels whose name holds any of the
        needles."""
        hit = [b - a for name, cat, a, b in self.device
               if cat == "kernel" and any(n in name for n in needles)]
        return len(hit), sum(hit) * 1e-6

    def top_ops(self):
        """[[name, seconds]] of the TOP device operations that took most
        time, summed by name."""
        by = collections.Counter()
        for name, _, a, b in self.device:
            by[name[:160]] += (b - a) * 1e-6
        return [[n, s] for n, s in by.most_common(TOP)]

    def idle_gaps(self):
        """[[name, seconds]] of the TOP longest stretches in which the device
        was idle, each named by the innermost harness span that covered
        its middle ("host" where none did)."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
            mid = 0.5 * (a + b)
            cover = [s for s in self.spans if s[1] <= mid <= s[2]]
            name = (min(cover, key=lambda s: s[2] - s[1])[0] if cover
                    else "host")
            out.append([name, (b - a) * 1e-6])
        return out


@contextlib.contextmanager
def capture(device):
    """Profile the block (host and device); yields a holder whose `.trace`
    is the Trace once the block has ended. The block must open the
    bench.traced span itself."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Captured", (), {"trace": None})()
    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        yield holder
        if on_card:
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    holder.trace = Trace(events)
