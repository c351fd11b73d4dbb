"""The image route's share of the peak of its precision (float32, TF32
off: 67 TFLOP/s; bf16: 989) over the window: each image's operations from
its shapes times the images completed, over the window's seconds. The
standard route encodes the content and the style and decodes the
content; the tiled route encodes the style, encodes every tile twice
(statistics, then transfer) and decodes it once (padding tiles of a tile
batch are not counted)."""

from benchmark.core import peaks
from benchmark.reference.tiler import Grid


def read(ctx):
    st, w = ctx.state, ctx.window
    if w.unit != "image" or w.seconds <= 0:
        return None
    cfg, p = ctx.cell.config, st.p
    rn = ctx.counts("revresnet")
    c_lat = 2 * cfg["hidden_dim"]
    flop = rn.encode_flop(cfg, 1, p["style_height"], p["style_width"])
    flop += ctx.counts("cwct").flop(p["style_height"] * p["style_width"],
                                    c_lat) / 2
    if p["route"] == "standard":
        flop += rn.network_flop(cfg, 1, st.h, st.w)
        flop += ctx.counts("cwct").flop(st.h * st.w, c_lat)
    else:
        ds = 1
        for s in cfg["nStrides"]:
            ds *= s
        g = Grid(st.h, st.w, ds, ds // 2 ** cfg["sp_steps"], p["tile"],
                 p["overlap"])
        n = len(list(g.tiles()))
        flop += n * (3 * rn.encode_flop(cfg, 1, g.th, g.tw)
                     + ctx.counts("cwct").flop(g.th * g.tw, c_lat))
    return 100.0 * flop * w.units / w.seconds / peaks.FLOPS[p["precision"]]
