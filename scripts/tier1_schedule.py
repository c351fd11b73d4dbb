"""Which test file sets the pace of the Tier-1 run under pytest-xdist.

    python3 scripts/tier1_schedule.py JUNIT.xml [--workers 6]
        [--split tests.test_x]

Reads the per-test times of one run from its JUnit XML (pytest
--junitxml), sums them by file, and replays pytest-xdist's --dist
loadfile scheduling on them: files ordered by their number of tests,
most first (--loadscope-reorder, the default), one to each worker, and
the next file to a worker when two or fewer of its assigned tests are
left (each file's tests taking its seconds in equal shares). Prints the replayed makespan, each worker's end, and the files
that end in the last third of the run with their worker, seconds and
test count. --split FILE replays the run again with FILE cut into two
files of half its tests and half its time each (plus
SPLIT_OVERHEAD seconds of set-up apiece), and prints that makespan.

The times are the ones measured with every worker running (they include
the contention between workers), so the replay reproduces the run it
reads; it predicts another schedule only as far as those times hold.
"""

from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET

SPLIT_OVERHEAD = 10.0


def file_times(path):
    """{file (dotted, as JUnit's classname): (seconds, tests)}."""
    secs, tests = collections.Counter(), collections.Counter()
    for case in ET.parse(path).iter("testcase"):
        name = case.get("classname") or "?"
        secs[name] += float(case.get("time") or 0.0)
        tests[name] += 1
    return {f: (secs[f], tests[f]) for f in secs}


def replay(files, workers):
    """-> (makespan, {worker: end}, {file: (end, worker)}). Each file's
    tests take its seconds in equal shares; a worker is handed the next
    file when two or fewer of its assigned tests are left, as xdist's
    LoadScopeScheduling._reschedule does."""
    queue = sorted(sorted(files), key=lambda f: -files[f][1])
    assigned = {w: [] for w in range(workers)}   # [file, tests left]

    def refill(w):
        while queue and sum(n for _, n in assigned[w]) <= 2:
            f = queue.pop(0)
            assigned[w].append([f, files[f][1]])

    for w in range(workers):
        if queue:
            f = queue.pop(0)
            assigned[w].append([f, files[f][1]])
    for w in range(workers):
        refill(w)
    events = []
    for w in range(workers):
        if assigned[w]:
            f = assigned[w][0][0]
            heapq.heappush(events, (files[f][0] / files[f][1], w))
    ends, done = dict.fromkeys(range(workers), 0.0), {}
    while events:
        t, w = heapq.heappop(events)
        head = assigned[w][0]
        head[1] -= 1
        if head[1] == 0:
            done[head[0]] = (t, w)
            assigned[w].pop(0)
        refill(w)
        ends[w] = t
        if assigned[w]:
            f = assigned[w][0][0]
            heapq.heappush(events, (t + files[f][0] / files[f][1], w))
    return max(ends.values()), ends, done


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("junit")
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--split", default=None)
    args = p.parse_args()
    files = file_times(args.junit)
    total = sum(s for s, _ in files.values())
    span, ends, done = replay(files, args.workers)
    print(f"{len(files)} files, {sum(n for _, n in files.values())} tests, "
          f"{total:.1f} s of test time, {total / args.workers:.1f} s a "
          f"worker on average; replayed makespan {span:.1f} s; worker ends "
          + ", ".join(f"{w}: {t:.1f}" for w, t in ends.items()))
    for f, (t, w) in sorted(done.items(), key=lambda kv: kv[1][0]):
        if t > 2 * span / 3:
            print(f"  ends {t:7.1f} s on worker {w}: {f} ({files[f][0]:.1f}"
                  f" s, {files[f][1]} tests)")
    if args.split:
        secs, n = files.pop(args.split)
        half = (secs / 2 + SPLIT_OVERHEAD, n // 2)
        files[args.split] = half
        files[args.split + "_b"] = (half[0], n - n // 2)
        print(f"with {args.split} split in two: replayed makespan "
              f"{replay(files, args.workers)[0]:.1f} s")


if __name__ == "__main__":
    main()
