"""Device milliseconds a batch of the auto-seg program's regional cWCT
(the vst.regional_cwct span: the masks to the latent grid and
cwct.transfer_masked_factored) in the traced segment: the union of the
kernels, copies and sets launched inside it (benchmark/core/stages.py)."""

from benchmark.core import stages


def read(ctx):
    return stages.per_unit(ctx, "device_ms", "regional_cwct")
