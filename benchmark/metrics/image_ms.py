"""The window's milliseconds over the images completed in it (uint8
upload to the float32 output on the host)."""


def read(ctx):
    w = ctx.window
    if w.unit != "image" or not w.units:
        return None
    return 1e3 * w.seconds / w.units
