"""Milliseconds a batch in which the device ran dry while the host was
inside the auto-seg program's vst.segment span, in the traced segment
(benchmark/core/stages.py)."""

from benchmark.core import stages


def read(ctx):
    return stages.per_unit(ctx, "idle_ms", "segment")
