"""Host milliseconds a batch inside the auto-seg program's vst.segment
span in the traced segment: the time the host spends enqueuing SegFormer-B4
(benchmark/core/stages.py)."""

from benchmark.core import stages


def read(ctx):
    return stages.per_unit(ctx, "host_ms", "segment")
