"""Share of the traced window's wall time in which no kernel, memcpy or
memset ran on the card (the window, not the span of the device events, is
the denominator)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
