"""A kernel's share of its roofline over a traced segment: the sum of its
launches' bounds (benchmark/counts, from the cell's shapes) over the sum
of their durations in the device trace, the launches matched by the
kernel's symbol name."""

from __future__ import annotations

from benchmark.core import peaks


def share(ctx, needles, launches_per_unit):
    """100 * bound / time, or None when the trace holds no such launch or
    another number of them than the counts predict for the traced units
    (a route the counts do not describe)."""
    t = ctx.trace
    if t is None or not launches_per_unit:
        return None
    n, secs = t.kernels(needles)
    want = len(launches_per_unit) * ctx.traced_units
    if n != want or secs <= 0:
        ctx.note(f"{needles}: {n} launches traced, {want} counted; "
                 "left out")
        return None
    bound = sum(peaks.bound_s(l.flop, l.nbytes) for l in launches_per_unit)
    return 100.0 * bound * ctx.traced_units / secs
