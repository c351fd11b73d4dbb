"""BENCHMARK.json against the contract's shape, every entry resolved to
its files by name, and a cell added from files alone."""

import json
import os
import re
import shutil
import time

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


def test_every_entry_resolves_to_its_files():
    from benchmark.core import spec

    b = _bench()
    bench_dir = os.path.join(ROOT, "benchmark")
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"])), c
        assert c["file"].startswith("benchmark/")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(bench_dir, "metrics",
                                           m["name"] + ".py")), m
        if "moves" in m:
            assert m["moves"] in e2e
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.chips == 1
        assert hasattr(cell.loop(), "run_window")
        e2e_here = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e_here and len(e2e_here) >= 2, w
        assert cell.per_layer, w
        for m in cell.per_layer:
            assert m["moves"] in e2e_here, (w["name"], m["name"])
        for name in cell.workload["limits"]:
            assert NAME.match(name)


def test_a_cell_added_from_files_alone_is_found_and_runs(tmp_path, cpu):
    """A new configuration, traffic mix, per-layer metric and cell, as new
    files and new BENCHMARK.json entries in a copy: no existing file of
    benchmark/ changes."""
    from conftest import make_tiny_root

    from benchmark.core import session, spec

    root = make_tiny_root(tmp_path)
    bd = os.path.join(root, "benchmark")
    def files():
        out = {}
        for dp, _, fs in os.walk(bd):
            for name in fs:
                if not name.endswith(".pyc"):
                    with open(os.path.join(dp, name), "rb") as f:
                        out[os.path.relpath(os.path.join(dp, name), bd)] = (
                            f.read())
        return out

    before = files()
    shutil.copy(os.path.join(bd, "configs", "cap-vstnet-photo.json"),
                os.path.join(bd, "configs", "cap-vstnet-photo-copy.json"))
    with open(os.path.join(bd, "traffic", "photo1280-f32.json")) as f:
        mix = json.load(f)
    mix["pool_images"] = 1
    with open(os.path.join(bd, "traffic", "photo-one.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bd, "metrics", "images_done.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.window.units\n")
    with open(os.path.join(bd, "workloads", "copy-one.json"), "w") as f:
        json.dump({"config": "cap-vstnet-photo-copy",
                   "traffic": "photo-one", "sample": 1, "trace_units": 1,
                   "limits": {"worst_image_rmse": 1e-3}}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append({"name": "cap-vstnet-photo-copy", "source": "x",
                         "file": "benchmark/configs/"
                                 "cap-vstnet-photo-copy.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "copy-one",
                           "config": "cap-vstnet-photo-copy",
                           "traffic": "photo-one", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "image_ms":
            m["workloads"].append("copy-one")
    b["per_layer"].append({"name": "images_done", "unit": "images",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "image_ms",
                           "workloads": ["copy-one"]})
    with open(path, "w") as f:
        json.dump(b, f)
    cell = spec.load_cell("copy-one", root)
    assert cell.config_name == "cap-vstnet-photo-copy"
    result = session.run(cell, 11, 0.2, True, cpu, time.time(),
                         bench_dir=bd)
    assert result["correct"] is True
    assert result["metrics"]["images_done"]["value"] >= 1
    after = files()
    assert all(after[p] == data for p, data in before.items())


def test_an_unknown_cell_is_refused():
    from benchmark.core import spec

    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
