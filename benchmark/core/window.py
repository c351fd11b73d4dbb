"""What a measured window records, and the seeded sample of its outputs
that the check compares."""

from __future__ import annotations

import dataclasses
import random
import statistics
import time

import torch


@dataclasses.dataclass
class Window:
    """unit: what one submission is ("batch", "image"); per_unit: frames or
    images in one. units: submissions completed inside the window;
    latencies_s: theirs, submission to completion on the host;
    enqueue_s: host seconds of each program call made in the window;
    attempted: submissions made in the window; sample: the Reservoir's
    items."""
    unit: str
    per_unit: int
    seconds: float = 0.0
    units: int = 0
    attempted: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    enqueue_s: list = dataclasses.field(default_factory=list)
    sample: list = dataclasses.field(default_factory=list)


class Reservoir:
    """A uniform sample of k of the items offered, drawn from the seed
    (Algorithm R): the check compares these, once the window has closed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(f"sample:{seed}")
        self.items = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values) -> float:
    return statistics.fmean(values)


def now() -> float:
    return time.perf_counter()


REPS, WARM = 5, 2


def cuda_ms(fn, device) -> float:
    """Mean milliseconds of fn() between two CUDA events on `device`'s
    current stream, over REPS calls after WARM untimed ones."""
    for _ in range(WARM):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        stop.synchronize()
    return start.elapsed_time(stop) / REPS
