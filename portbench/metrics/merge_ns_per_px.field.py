"""merge_ns_per_px.field: nanoseconds of detection's host merge per masked
pixel it takes: the program's 'merge' stage timer over its
``count.masked_px`` counter (the length of the masked-pixel COO that
detection downloads), both summed over the measured window's fields.
None where the program has no such counter."""


def read(ctx):
    stages = ctx.stats.get("stages_s")
    if not stages or not stages.get("count.masked_px") or "merge" not in stages:
        return None
    return 1e9 * stages["merge"] / stages["count.masked_px"]
