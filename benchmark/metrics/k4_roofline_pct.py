"""K4 (csrc/attention.cu: attention_kernel) as a share of its roofline,
over the traced batches: one segment call of each."""

from benchmark.core import roofline

NEEDLES = ("attention_kernel",)


def read(ctx):
    st = ctx.state
    if not getattr(st, "masked", False):
        return None
    per = ctx.counts("segformer").attention_launches(
        ctx.cell.config["segformer"], st.b, st.h, st.w)
    return roofline.share(ctx, NEEDLES, per)
