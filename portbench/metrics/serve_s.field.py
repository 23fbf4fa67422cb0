"""serve_s.field: seconds a field in the serving route's chunk loop (its 'deblend_render' stage: cutouts, forward, render), from the program's own stage timers
(utils/profiling.stage_timer, which synchronises the card), summed over
the measured window's fields and divided by their count."""

STAGES = ['deblend_render']


def read(ctx):
    stages = ctx.stats.get("stages_s")
    if not stages or not ctx.stats.get("fields"):
        return None
    return sum(stages.get(k, 0.0) for k in STAGES) / ctx.stats["fields"]
