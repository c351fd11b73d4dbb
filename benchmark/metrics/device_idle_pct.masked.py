"""device_idle_pct.video in the auto-seg cell."""

from benchmark.core.spec import load_module

read = load_module("metrics", "device_idle_pct.video").read
