"""Device milliseconds a request of the standard network inside the
program call (the vst.encode spans of the content and the style and the
vst.decode span of pipeline.stylize) in the traced segment: the union of
the kernels, copies and sets launched inside them
(benchmark/core/stages.py)."""

from benchmark.core import stages


def read(ctx):
    return stages.per_unit(ctx, "device_ms", "encode", "decode")
