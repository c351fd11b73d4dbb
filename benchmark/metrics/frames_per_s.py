"""Frames read back into host memory in the window, over its seconds."""


def read(ctx):
    w = ctx.window
    if w.unit != "batch" or w.seconds <= 0:
        return None
    return w.units * w.per_unit / w.seconds
