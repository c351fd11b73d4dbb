"""Kernel launches a batch inside the auto-seg program's
vst.regional_cwct span in the traced segment (benchmark/core/stages.py)."""

from benchmark.core import stages


def read(ctx):
    return stages.per_unit(ctx, "launches", "regional_cwct")
