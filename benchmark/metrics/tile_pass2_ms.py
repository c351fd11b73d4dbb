"""Device milliseconds an image of the tiler's pass 2 (the vst.tile_pass2
span: every tile batch encoded, transformed, decoded and blended) in the
traced segment: the union of the kernels, copies and sets launched inside
it (benchmark/core/stages.py)."""

from benchmark.core import stages


def read(ctx):
    return stages.per_unit(ctx, "device_ms", "tile_pass2")
