"""The video program's share of the card's bf16 dense peak (989 TFLOP/s)
over the window: each batch's operations from its shapes (the network's
encode and decode, the cWCT, and on the auto-seg route SegFormer) times
the batches completed, over the window's seconds."""

from benchmark.core import peaks


def read(ctx):
    st, w = ctx.state, ctx.window
    if w.unit != "batch" or w.seconds <= 0:
        return None
    cfg = ctx.cell.config
    flop = ctx.counts("revresnet").network_flop(cfg, st.b, st.h, st.w)
    flop += ctx.counts("cwct").flop(st.b * st.h * st.w,
                                    2 * cfg["hidden_dim"])
    if "segformer" in cfg:
        flop += ctx.counts("segformer").flop(cfg["segformer"], st.b, st.h,
                                             st.w)
    return 100.0 * flop * w.units / w.seconds / peaks.FLOPS["bf16"]
