"""95th percentile over every frame completed in the window of its
batch's time from submission (the upload starts) to its readback event
completing on the host, in ms."""

from benchmark.core.window import percentile


def read(ctx):
    w = ctx.window
    if w.unit != "batch" or not w.latencies_s:
        return None
    frames = [t for t in w.latencies_s for _ in range(w.per_unit)]
    return 1e3 * percentile(frames, 95)
