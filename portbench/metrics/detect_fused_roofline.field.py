"""detect_fused_roofline.field: the fused detect core's share of its
roofline in the traced fields, in percent: the least time the card could
take to move its bytes (work.detect_core_bytes of the tile stack, over
the HBM bandwidth) over the device time of ``detect_fused_kernel`` in the
trace."""

from portbench.reference.field import tile_origins
from portbench.work import HBM_BYTES_PER_S, detect_core_bytes

KERNEL = "detect_fused_kernel"


def read(ctx):
    if ctx.trace is None or "driver" not in ctx.trace:
        return None
    seconds = sum(s for name, s in ctx.trace["device_op_s"].items() if KERNEL in name)
    if not seconds > 0:
        return None
    mix = ctx.mix
    tile = min(int(mix["tile_size"]), int(mix["field_size"]))
    tiles = len(tile_origins(int(mix["field_size"]), int(mix["tile_size"]), int(mix["tile_overlap"]))) ** 2
    fields = len(ctx.trace["driver"]["fields"])
    return 100.0 * fields * detect_core_bytes(tiles, tile) / HBM_BYTES_PER_S / seconds
