"""K1 (csrc/coupling_mma.cu: coupling_mma_kernel and its narrow twin) as
a share of its roofline, over the traced batches: an encode and a decode
of each."""

from benchmark.core import roofline

NEEDLES = ("coupling_mma",)


def read(ctx):
    st = ctx.state
    if getattr(st, "b", None) is None:
        return None
    per = [l for l in ctx.counts("revresnet").launches(
        ctx.cell.config, st.b, st.h, st.w) if l.kernel == "k1"]
    return roofline.share(ctx, NEEDLES, 2 * per)
