"""Host milliseconds of each program call in the window, from the call to
its return (the program enqueues its work on the card), averaged over
the window's batches."""

from benchmark.core.window import mean


def read(ctx):
    w = ctx.window
    if w.unit != "batch" or not w.enqueue_s:
        return None
    return 1e3 * mean(w.enqueue_s)
