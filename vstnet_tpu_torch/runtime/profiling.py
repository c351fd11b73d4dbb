"""Tracing and memory observability.

Counterpart of vstnet_tpu/runtime/profiling.py:

  * `span(name)`: a host range named "vst.<name>" around a stage of the
    port's programs (the video programs' segment, remap, encode, cWCT and
    decode, the tiler's two passes, the service's device section and reply
    encodes). It records only while a profiler records on the calling
    thread (`torch.profiler.profile`, or `torch.autograd.profiler.
    emit_nvtx`, which makes it an NVTX range), and never while torch.compile
    or torch.export traces; otherwise it is one shared nullcontext, a flag
    test and no dispatcher call. Its ranges lie in the same Chrome trace as
    the device's events, on the same clock.
  * `trace(logdir)`: a torch.profiler capture of the host and, where there
    is one, the CUDA device, written under `logdir` as a Chrome/TensorBoard
    trace (`*.pt.trace.json`, viewable in Perfetto or TensorBoard), the
    block inside the span "vst.traced". CUPTI records every kernel by its
    CUDA name, the port's own kernels (launched through ctypes) included.
  * `kernel_counts(logdir)` and `summarize_trace(logdir)`: the reader of
    those traces: the device kernels by name, and by total time beside the
    device's busy and idle share of the "vst.traced" window, and each
    span's calls, host time and the device time of the work launched
    inside it.
  * `device_memory_stats()`: live numbers of the CUDA caching allocator
    under the JAX package's keys; None on the CPU.
  * `call_memory_analysis(fn, *args)`: the memory of one call. PyTorch has
    no static memory analysis of a program, so this measures: it resets the
    allocator's peak, runs the call, synchronises, and reports the bytes of
    the arguments and of the outputs, and as temps the peak above what was
    allocated before the call, less the outputs.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
from typing import Dict, List, Optional

import torch
from torch.utils._pytree import tree_leaves


SPAN_PREFIX = "vst."
WINDOW = "traced"     # trace()'s outermost span: the summary's window
_OFF = contextlib.nullcontext()


def span(name: str):
    """The host range "vst.<name>" while a profiler records on this thread;
    the shared nullcontext otherwise, and while torch.compile or
    torch.export traces (a range would enter their graphs). The compiler
    tests come first: torch.compile cannot trace the profiler's flag."""
    if (torch.compiler.is_compiling() or torch.compiler.is_exporting()
            or not torch._C._autograd._profiler_enabled()):
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device profile of the block under `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    if ProfilerActivity.CUDA in activities and not torch.cuda.is_available():
        activities.remove(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     logdir)):
        with span(WINDOW):
            yield
            if ProfilerActivity.CUDA in activities:
                # the block's device work ends inside the window
                torch.cuda.synchronize()


# the trace's categories of work on the device
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_files(logdir: str) -> List[str]:
    """The Chrome traces under `logdir`, sorted; raises if there are
    none."""
    files = sorted(os.path.join(logdir, f) for f in os.listdir(logdir)
                   if f.endswith(".json"))
    if not files:
        raise FileNotFoundError(f"no trace under {logdir}")
    return files


def _events(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _device(events) -> List[dict]:
    """The complete ("X") device events among a trace's events."""
    return [e for e in events
            if e.get("cat") in DEVICE_EVENT_CATS and e.get("ph") == "X"]


def device_events(path: str) -> List[dict]:
    """The complete ("X") device events of one Chrome trace."""
    return _device(_events(path))


def kernel_counts(logdir: str) -> collections.Counter:
    """{kernel name: launches} over the traces under `logdir`."""
    return collections.Counter(
        e["name"] for path in trace_files(logdir)
        for e in device_events(path) if e["cat"] == "kernel")


def _union(intervals) -> List[List[float]]:
    """Sorted, merged [start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _busy_us(events, t0=float("-inf"), t1=float("inf")) -> float:
    """Microseconds of [t0, t1] covered by the union of the events'
    intervals."""
    return sum(b - a for a, b in _union(
        [max(e["ts"], t0), min(e["ts"] + e["dur"], t1)] for e in events
        if e["ts"] + e["dur"] > t0 and e["ts"] < t1))


def _spans(events) -> Dict[str, List[List[float]]]:
    """{name without the prefix: [[start, end]] of each call} of the
    trace's vst.* host spans."""
    out = collections.defaultdict(list)
    for e in events:
        name = str(e.get("name", ""))
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and name.startswith(SPAN_PREFIX)):
            out[name[len(SPAN_PREFIX):]].append(
                [float(e["ts"]), float(e["ts"]) + float(e["dur"])])
    return out


def _launched_in(device, launches, intervals) -> List[dict]:
    """The device events whose launching host call (launches: {correlation
    id: start} of the cuda_runtime and cuda_driver events) starts inside
    one of the intervals."""
    merged = _union(intervals)
    heads = [a for a, _ in merged]
    out = []
    for e in device:
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(heads, t) - 1
        if i >= 0 and t <= merged[i][1]:
            out.append(e)
    return out


def summarize_trace(logdir: str, top: int = 20) -> str:
    """Each trace under `logdir`: the device's busy time and idle share of
    the window (the longest vst.traced span, which trace() opens; in a
    trace without one, the device events' first to last microsecond), the
    `top` kernels (and copies) by total time, and each vst.* span's calls,
    host ms and the device ms of the work launched inside it."""
    lines = []
    for path in trace_files(logdir):
        events = _events(path)
        device = _device(events)
        name = os.path.basename(path)
        if not device:
            lines.append(f"  {name}: no device events")
            continue
        spans = _spans(events)
        if spans.get(WINDOW):
            t0, t1 = max(spans.pop(WINDOW), key=lambda ab: ab[1] - ab[0])
        else:
            t0 = min(e["ts"] for e in device)
            t1 = max(e["ts"] + e["dur"] for e in device)
        busy = _busy_us(device, t0, t1)
        by_name = collections.defaultdict(lambda: [0, 0.0])
        for e in device:
            by_name[e["name"]][0] += 1
            by_name[e["name"]][1] += e["dur"]
        total = sum(d for _, d in by_name.values())
        window = t1 - t0
        lines.append(f"  {name}: {len(device)} device events, window "
                     f"{window / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle "
                     f"{100 * (1 - busy / window):.1f} %")
        for kname, (n, dur) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][1])[:top]:
            lines.append(f"    {dur / 1e3:10.3f} ms {100 * dur / total:5.1f} "
                         f"% {n:6d}x  {kname[:110]}")
        launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}
        for sname, calls in sorted(spans.items()):
            dev = _busy_us(_launched_in(device, launches, calls))
            host = sum(b - a for a, b in calls)
            lines.append(f"    span {SPAN_PREFIX}{sname}: {len(calls)}x, host "
                         f"{host / 1e3:.3f} ms, device {dev / 1e3:.3f} ms")
    return "\n".join(lines)


def _cuda(device) -> Optional[torch.device]:
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.type == "cuda" else None


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """{bytes_in_use, peak_bytes_in_use, bytes_reserved, bytes_limit} of a
    CUDA device's caching allocator (device None: the current one), or
    None on the CPU. bytes_limit is the card's total memory."""
    dev = _cuda(device)
    if dev is None:
        return None
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "bytes_limit": int(total)}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def call_memory_analysis(fn, *args, device=None,
                         **kwargs) -> Optional[Dict[str, int]]:
    """Measured memory of one call fn(*args, **kwargs) on a CUDA device:
    {arguments, outputs, temps} in bytes, where temps is the allocator's
    peak during the call above what was allocated before it, less the
    outputs. None on the CPU. The call runs once, for real."""
    dev = _cuda(device)
    if dev is None:
        return None
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    outputs = _nbytes(out)
    return {"arguments": _nbytes((args, kwargs)), "outputs": outputs,
            "temps": max(peak - before - outputs, 0)}


def format_memory_report(fn=None, args=(), device=None) -> str:
    """A human-readable memory block for the CLIs' --profile output: live
    allocator numbers, and with `fn` the measured memory of fn(*args)."""
    lines = []
    live = device_memory_stats(device)
    if live:
        lines.append(
            f"  device memory in use {live['bytes_in_use'] / 2**20:.1f} MiB,"
            f" peak {live['peak_bytes_in_use'] / 2**20:.1f} MiB, reserved "
            f"{live['bytes_reserved'] / 2**20:.1f} MiB, limit "
            f"{live['bytes_limit'] / 2**20:.1f} MiB")
    if fn is not None:
        measured = call_memory_analysis(fn, *args, device=device)
        if measured:
            parts = ", ".join(f"{k} {v / 2**20:.1f} MiB"
                              for k, v in measured.items())
            lines.append(f"  one call: {parts}")
    return "\n".join(lines) if lines else "  (no memory stats available)"
