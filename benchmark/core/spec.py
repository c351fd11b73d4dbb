"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of "workloads") is found with:
  benchmark/workloads/<cell>.json   its configuration, traffic and limits
  <config "file">                   the configuration as it is run
  benchmark/traffic/<traffic>.json  the traffic mix: the loop that runs
                                    it and the loop's parameters
  benchmark/traffic/<loop>.py       the loop that runs the mix
  benchmark/metrics/<metric>.py     one reader per metric
  benchmark/counts/<name>.py        operations and bytes from shapes
Nothing here lists cells, mixes or metrics: adding one is adding files and
entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """benchmark/<kind>/<name>.py, imported from its file."""
    path = os.path.join(bench_dir, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod_name = f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list

    def loop(self, bench_dir: str = BENCH_DIR):
        return load_module("traffic", self.traffic["loop"], bench_dir)


def _reports(metric: dict, cell: str, e2e_by_name: dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = e2e_by_name.get(metric.get("moves"))
    if moved is None:        # an end-to-end metric without a list
        return True
    return _reports(moved, cell, {})


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, "benchmark")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    workload = _json(os.path.join(bench_dir, "workloads", name + ".json"))
    for key in ("config", "traffic"):
        if workload.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{workload.get(key)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return Cell(
        name=name, chips=int(entry["chips"]), config_name=entry["config"],
        config=_json(os.path.join(root, configs[entry["config"]]["file"])),
        traffic_name=entry["traffic"],
        traffic=_json(os.path.join(bench_dir, "traffic",
                                   entry["traffic"] + ".json")),
        workload=workload,
        end_to_end=[m for m in bench["end_to_end"]
                    if _reports(m, name, {})],
        per_layer=[m for m in bench["per_layer"]
                   if _reports(m, name, e2e)])
