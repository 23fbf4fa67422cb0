"""unspanned_s.field: seconds a field that no top-level program span
covers: the measured window's seconds over its fields, less the
program's top-level stage timers (utils/profiling.stage_timer) summed
over those fields and divided by their count.  Nested spans ('cutouts',
'forward', 'render', inside 'deblend_render') and the ``count.`` entries
are left out.  What remains is the benchmark loop's own work and whatever
of the field's call no span names.  None where the program lacks the
field's whole span tree (no 'field_checksum' span)."""

TOP = ['field_copy', 'field_checksum', 'upload', 'tile_stack', 'core', 'download', 'merge', 'segstats', 'clean',
       'reconstruct', 'tile_select', 'deblend_render', 'field_download', 'catalog', 'residual_copy']


def read(ctx):
    stages = ctx.stats.get("stages_s")
    fields = ctx.stats.get("fields")
    if not stages or not fields or "field_checksum" not in stages:
        return None
    return (ctx.stats["window_s"] - sum(stages.get(k, 0.0) for k in TOP)) / fields
