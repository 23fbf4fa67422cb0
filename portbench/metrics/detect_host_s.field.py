"""detect_host_s.field: seconds a field in tiled detection's host part (its 'tile_select', 'merge', 'segstats', 'clean' and 'reconstruct' stages), from the program's own stage timers
(utils/profiling.stage_timer, which synchronises the card), summed over
the measured window's fields and divided by their count."""

STAGES = ['tile_select', 'merge', 'segstats', 'clean', 'reconstruct']


def read(ctx):
    stages = ctx.stats.get("stages_s")
    if not stages or not ctx.stats.get("fields"):
        return None
    return sum(stages.get(k, 0.0) for k in STAGES) / ctx.stats["fields"]
