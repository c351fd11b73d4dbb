"""The readings that a cell's limits of `correct` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 12 \
        --controls 3 --seconds 3 [--first-seed N] [--out FILE]

In one process, on the card: for each of --seeds seeds, the cell's
set-up and a short window at its own load, then its check (the program's
readings); for each of --controls seeds, the same sample produced by the
plain reference in the precision below the cell's (reference/lowp.py:
fp8 for a bf16 cell, TF32 for a float32 one) in the program's place, and
the same check (the control's readings). Prints one JSON line per seed
and a summary: each number's largest program reading (the lower reading)
and smallest control reading (the upper one). The benchmark's own runs do
not run this; benchmark/tests/test_bench_control.py runs it at a small
size on the CPU.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def program_readings(cell, seed, seconds, device, bench_dir=None):
    import torch

    loop = cell.loop(bench_dir) if bench_dir else cell.loop()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    st = loop.build(cell, seed, device)
    w = loop.run_window(st, seconds)
    numbers, _ = loop.check(st, w)
    return numbers, w.units


def control_readings(cell, seed, device, bench_dir=None):
    import torch

    from benchmark.core.window import Window
    from benchmark.reference import lowp

    loop = cell.loop(bench_dir) if bench_dir else cell.loop()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    st = loop.build(cell, seed, device)
    w = Window("control", 0)
    w.sample = loop.control_sample(st, lowp.CONTROL[cell.traffic[
        "precision"]]())
    numbers, _ = loop.check(st, w)
    return numbers


def _free():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=3000000001)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark.core import spec

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    prog, ctrl = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + i
        t0 = time.time()
        numbers, units = program_readings(cell, seed, args.seconds, device)
        emit({"side": "program", "seed": seed, "units": units,
              "numbers": numbers, "s": time.time() - t0})
        for k, v in numbers.items():
            prog[k] = max(prog.get(k, v), v)
        _free()
    for i in range(args.controls):
        seed = args.first_seed + 1000 + i
        t0 = time.time()
        numbers = control_readings(cell, seed, device)
        emit({"side": "control", "seed": seed, "numbers": numbers,
              "s": time.time() - t0})
        for k, v in numbers.items():
            ctrl[k] = min(ctrl.get(k, v), v)
        _free()
    emit({"summary": args.workload, "lower": prog, "upper": ctrl,
          "device": torch.cuda.get_device_name(device)})
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
