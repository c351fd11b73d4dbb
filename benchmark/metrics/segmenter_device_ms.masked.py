"""Device milliseconds a batch of the auto-seg program's segment stage
(the vst.segment span: SegFormer-B4 and its input resize) in the traced
segment: the union of the kernels, copies and sets launched inside it
(benchmark/core/stages.py)."""

from benchmark.core import stages


def read(ctx):
    return stages.per_unit(ctx, "device_ms", "segment")
