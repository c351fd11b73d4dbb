"""enqueue_ms.video in the auto-seg cell."""

from benchmark.core.spec import load_module

read = load_module("metrics", "enqueue_ms.video").read
