"""render_s.field: seconds a field in each stream chunk's renders into the
padded canvas (the order-3 spline and place): the program's 'render' span,
nested in 'deblend_render', timed on the card by a CUDA event before and
after it without waiting (utils/profiling.stage_timer's pending events,
added once 'deblend_render' has synchronised), summed over the measured
window's fields and divided by their count.  None where the program has no
such span."""

STAGE = 'render'


def read(ctx):
    stages = ctx.stats.get("stages_s")
    if not stages or not ctx.stats.get("fields") or STAGE not in stages:
        return None
    return stages[STAGE] / ctx.stats["fields"]
