"""mfu_pct.video in the auto-seg cell (SegFormer's operations included)."""

from benchmark.core.spec import load_module

read = load_module("metrics", "mfu_pct.video").read
