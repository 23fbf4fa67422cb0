"""The yardstick's arithmetic: work counted from shapes, and the card's
published peaks.

``forward_macs`` is a frozen copy of ``debvader_tpu_torch/utils/flops.py``
(``per_layer_macs`` summed), taking the configuration file's ``model``
keys instead of the program's ``ModelConfig``, so that a later change to
the program cannot change what a share of the peak counts.  It counts the
useful multiply-accumulates of one stamp's forward: each encoder stage's
3x3 SAME conv at its input size and its 3x3 stride-2 conv at the
ceil-halved size, the latent Dense pair and the decoder's wide Dense, each
stride-2 transposed conv as input pixels x 9 x cin x cout and the
stride-1 one at the doubled size, and the band head on the 64 x 64 grid
before the crop.  For the default architecture that is 329,346,752.

The byte counts are those of the bound column of the port's kernel table
(PERF.md), each input byte read once and each output byte written once:
``detect_core_bytes`` for ``csrc/detect_fused.cu`` over a tile stack (the
image and the background read, the filtered field, the direction codes
and the parents written, 4 bytes each a pixel), ``place_bytes`` for
``csrc/render.cu``'s order-3 place (every padded patch read, and the
canvas pixels that a stream chunk's patches cover read and written once
for that chunk).
"""

from __future__ import annotations

import numpy as np

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "forward_macs", "detect_core_bytes", "place_bytes"]

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# the 700 W power limit): float32 outside the tensor cores, bfloat16 on
# them; HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def forward_macs(model: dict) -> int:
    """Multiply-accumulates of one stamp's forward for a configuration's
    ``model`` keys."""
    sp = model["stamp_size"]
    cin = model["nb_of_bands"]
    filters = model["filters"]
    latent = model["latent_dim"]
    head = latent + latent * (latent + 1) // 2
    k2 = 9
    total = 0
    for f in filters:
        total += sp * sp * k2 * cin * f
        sp = -(-sp // 2)
        total += sp * sp * k2 * f * f
        cin = f
    total += sp * sp * cin * head  # enc/Dense_0
    total += latent * head  # dec/Dense_0
    total += head * sp * sp * filters[-1]  # dec/Dense_1
    spd, cin = sp, filters[-1]
    for f in reversed(filters):
        total += spd * spd * k2 * cin * f
        spd *= 2
        total += spd * spd * k2 * f * f
        cin = f
    total += spd * spd * k2 * cin * 2 * model["nb_of_bands"]  # the band head
    return total


def detect_core_bytes(tiles: int, tile: int) -> int:
    """Bytes the fused detect core must move for ``tiles`` square tiles."""
    return 20 * tiles * tile * tile


def place_bytes(corners: np.ndarray, chunks: np.ndarray, patch: int, bands: int) -> int:
    """Bytes the place must move for patches of ``patch`` x ``patch`` x
    ``bands`` float32 at integer ``corners`` (N, 2), added chunk by chunk
    (``chunks`` (N,) gives each patch's chunk)."""
    total = len(corners) * patch * patch * bands * 4
    for c in np.unique(chunks):
        at = corners[chunks == c].astype(np.int64)
        at = at - at.min(axis=0)
        covered = np.zeros(tuple(at.max(axis=0) + patch), bool)
        for y, x in at:
            covered[y: y + patch, x: x + patch] = True
        total += 2 * int(covered.sum()) * bands * 4
    return total
