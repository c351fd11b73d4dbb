"""frame_latency_p95_ms in the auto-seg cell, where ~50 batches a window
leave too few beyond the 95th percentile for an end-to-end tail."""

from benchmark.core.spec import load_module

read = load_module("metrics", "frame_latency_p95_ms").read
