"""place_roofline.field: the order-3 place's share of its roofline in the
traced fields, in percent: the least time the card could take to move its
bytes (work.place_bytes of the deblended sources' padded 79 x 79 patches,
chunk by chunk, over the HBM bandwidth) over the device time of the
``place_tile_kernel`` and ``place_generic_kernel`` launches in the
trace."""

import numpy as np

from portbench.work import HBM_BYTES_PER_S, place_bytes

KERNELS = ("place_tile_kernel", "place_generic_kernel")
PATCH_PAD = 10  # the order-3 spline's zero padding of a stamp on each side


def read(ctx):
    if ctx.trace is None or "driver" not in ctx.trace:
        return None
    seconds = sum(s for name, s in ctx.trace["device_op_s"].items() if any(k in name for k in KERNELS))
    if not seconds > 0:
        return None
    patch = int(ctx.config["model"]["stamp_size"]) + 2 * PATCH_PAD
    bands = int(ctx.config["model"]["nb_of_bands"])
    chunk = int(ctx.mix["source_chunk"])
    total = sum(place_bytes(np.floor(centres), index // chunk, patch, bands)
                for centres, index in ctx.trace["driver"]["fields"] if len(centres))
    return 100.0 * total / HBM_BYTES_PER_S / seconds
