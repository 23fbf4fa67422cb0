"""host_copies_s.field: seconds a field in the host's copies and passes over
the field and its products: the program's 'field_copy' (the float32 copy
and check when ``TiledDeblendField`` is built), 'field_checksum' (each of
the device memo's content checksums), 'catalog' (the record array) and
'residual_copy' (the host residual field) stage timers
(utils/profiling.stage_timer), summed over the measured window's fields
and divided by their count.  None where the program has none of these
spans."""

STAGES = ['field_copy', 'field_checksum', 'catalog', 'residual_copy']


def read(ctx):
    stages = ctx.stats.get("stages_s")
    if not stages or not ctx.stats.get("fields") or not any(k in stages for k in STAGES):
        return None
    return sum(stages.get(k, 0.0) for k in STAGES) / ctx.stats["fields"]
