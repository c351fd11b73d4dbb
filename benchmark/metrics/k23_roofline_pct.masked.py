"""k23_roofline_pct in the auto-seg cell."""

from benchmark.core.spec import load_module

read = load_module("metrics", "k23_roofline_pct").read
