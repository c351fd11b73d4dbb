"""Tracing and memory observability.

Counterpart of vstnet_tpu/runtime/profiling.py:

  * `trace(logdir)`: a torch.profiler capture of the host and, where there
    is one, the CUDA device, written under `logdir` as a Chrome/TensorBoard
    trace (`*.pt.trace.json`, viewable in Perfetto or TensorBoard). CUPTI
    records every kernel by its CUDA name, the port's own kernels (launched
    through ctypes) included.
  * `kernel_counts(logdir)` and `summarize_trace(logdir)`: the reader of
    those traces: the device kernels by name, and by total time beside the
    device's busy and idle share of the window from its first to its last
    device event.
  * `device_memory_stats()`: live numbers of the CUDA caching allocator
    under the JAX package's keys; None on the CPU.
  * `call_memory_analysis(fn, *args)`: the memory of one call. PyTorch has
    no static memory analysis of a program, so this measures: it resets the
    allocator's peak, runs the call, synchronises, and reports the bytes of
    the arguments and of the outputs, and as temps the peak above what was
    allocated before the call, less the outputs.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
from typing import Dict, List, Optional

import torch
from torch.utils._pytree import tree_leaves


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
        yield


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


def device_events(path: str) -> List[dict]:
    """The complete ("X") device events of one Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("cat") in DEVICE_EVENT_CATS and e.get("ph") == "X"]


def kernel_counts(logdir: str) -> collections.Counter:
    """{kernel name: launches} over the traces under `logdir`."""
    return collections.Counter(
        e["name"] for path in trace_files(logdir)
        for e in device_events(path) if e["cat"] == "kernel")


def _busy_us(events) -> float:
    """Microseconds covered by the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def summarize_trace(logdir: str, top: int = 20) -> str:
    """Each trace under `logdir`: its device events' window, busy time and
    idle share, and the `top` kernels (and copies) by total time."""
    lines = []
    for path in trace_files(logdir):
        events = device_events(path)
        name = os.path.basename(path)
        if not events:
            lines.append(f"  {name}: no device events")
            continue
        by_name = collections.defaultdict(lambda: [0, 0.0])
        for e in events:
            by_name[e["name"]][0] += 1
            by_name[e["name"]][1] += e["dur"]
        window = (max(e["ts"] + e["dur"] for e in events)
                  - min(e["ts"] for e in events))
        busy = _busy_us(events)
        total = sum(d for _, d in by_name.values())
        lines.append(f"  {name}: {len(events)} device events, window "
                     f"{window / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle "
                     f"{100 * (1 - busy / window):.1f} %")
        for kname, (n, dur) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][1])[:top]:
            lines.append(f"    {dur / 1e3:10.3f} ms {100 * dur / total:5.1f} "
                         f"% {n:6d}x  {kname[:110]}")
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
