"""Frames read back into host memory in the window, over its seconds, in
the auto-seg cell: the host-paced route, whose runs spread more than the
global cell's, under a bound of its own."""

from benchmark.core.spec import load_module

read = load_module("metrics", "frames_per_s").read
