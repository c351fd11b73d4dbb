"""One run of one cell: set-up, the measured window, the traced segment
(--trace 1), the check against the plain reference, the result line.

The result line is the last line of standard output; the numbers that
decided `correct`, each beside its limit, are the last lines of standard
error and the last key of the line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vstnet_tpu")


def forbidden_modules(modules=None):
    """Top-level names in sys.modules that the run may not hold, compared
    whole (vstnet_tpu_torch is not vstnet_tpu)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class Context:
    """What a metric reader may read: the cell, the loop's state, the
    window, the trace, the set-up time, and the counts modules."""

    def __init__(self, cell, state, window, setup_s, trace=None,
                 traced_units=0, bench_dir=None):
        self.cell = cell
        self.state = state
        self.window = window
        self.setup_s = setup_s
        self.trace = trace
        self.traced_units = traced_units
        self._bench_dir = bench_dir

    def counts(self, name: str):
        from benchmark.core import spec

        return spec.load_module("counts", name,
                                self._bench_dir or spec.BENCH_DIR)

    def note(self, text: str):
        print(f"[{self.cell.name}] {text}", file=sys.stderr, flush=True)


def read_metrics(ctx, metrics, bench_dir):
    from benchmark.core import spec

    out = {}
    for m in metrics:
        value = spec.load_module("metrics", m["name"], bench_dir).read(ctx)
        if value is None:
            ctx.note(f"metric {m['name']}: nothing to read, left out")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict):
    """(correct, checks): every number at or under its limit; a number
    without a limit, or a limit without a number, is not correct."""
    checks = {}
    ok = set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name, float("nan"))
        limit = limits.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, checks


def run(cell, seed: int, seconds: float, trace: bool, device, t_start,
        bench_dir=None):
    """Run the cell once and return the result object (the line)."""
    import torch

    from benchmark.core import spec
    from benchmark.core import trace as tr

    bench_dir = bench_dir or spec.BENCH_DIR
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    loop = cell.loop(bench_dir)
    state = loop.build(cell, seed, device)
    setup_s = time.time() - t_start
    w = loop.run_window(state, seconds)
    on_card = device.type == "cuda"
    peak = (torch.cuda.max_memory_allocated(device) if on_card else 0)
    ctx = Context(cell, state, w, setup_s, bench_dir=bench_dir)
    result = {"correct": False, "attempted": w.attempted, "failed": 0}
    if trace:
        units = int(cell.workload["trace_units"])
        with tr.capture(device) as cap:
            with tr.span("traced"):
                loop.run_traced(state, units)
        ctx.trace, ctx.traced_units = cap.trace, units
        metrics = read_metrics(ctx, cell.per_layer, bench_dir)
    else:
        metrics = read_metrics(ctx, cell.end_to_end, bench_dir)
    numbers, failed = loop.check(state, w)
    correct, checks = judge(numbers, cell.workload["limits"])
    result.update(correct=correct, failed=failed, metrics=metrics)
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        t = ctx.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv, t_start):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.core import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device,
                 t_start)
    found = forbidden_modules()
    if found:
        print(f"error: the run imported {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
