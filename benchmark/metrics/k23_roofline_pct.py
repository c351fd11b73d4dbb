"""K2 and K3 (csrc/transition_mma.cu: transition_mma_kernel, full- and
half-resolution entries) as a share of their roofline, over the traced
batches: an encode and a decode of each."""

from benchmark.core import roofline

NEEDLES = ("transition_mma",)


def read(ctx):
    st = ctx.state
    if getattr(st, "b", None) is None:
        return None
    per = [l for l in ctx.counts("revresnet").launches(
        ctx.cell.config, st.b, st.h, st.w) if l.kernel in ("k2", "k3")]
    return roofline.share(ctx, NEEDLES, 2 * per)
