"""Host milliseconds a batch inside the auto-seg program's
vst.regional_cwct span in the traced segment: the time the host spends in
the regional transfer's frame and chunk loops (benchmark/core/stages.py)."""

from benchmark.core import stages


def read(ctx):
    return stages.per_unit(ctx, "host_ms", "regional_cwct")
