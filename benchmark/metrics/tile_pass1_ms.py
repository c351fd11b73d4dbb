"""Device milliseconds an image of the tiler's pass 1 (the vst.tile_pass1
span: every tile batch encoded and its owned latent moments summed) in the
traced segment: the union of the kernels, copies and sets launched inside
it (benchmark/core/stages.py)."""

from benchmark.core import stages


def read(ctx):
    return stages.per_unit(ctx, "device_ms", "tile_pass1")
