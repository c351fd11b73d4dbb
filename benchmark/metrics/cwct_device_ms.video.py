"""Device milliseconds a batch of the global video program's cWCT (the
vst.cwct span: transfer_with_factors_packed, its float64 Gram included) in
the traced segment: the union of the kernels, copies and sets launched
inside it (benchmark/core/stages.py)."""

from benchmark.core import stages


def read(ctx):
    return stages.per_unit(ctx, "device_ms", "cwct")
