"""Subpixel shifts and field assembly.

The fractional part of each source's offset is applied to the small stamp
(bilinear, or the order-3 spline of ops/spline.py on a stamp zero-padded
by 10 px so the local prefilter equals the whole-canvas one); the integer
part places the shifted patch on a padded canvas.

At order 1, CUDA tensors render through the hand-written kernel of
kernels/render.py, which gathers into the field window of the canvas; CPU
tensors take its plain version.  Order 3 (an XLA scan in the JAX
package, no Pallas kernel) shifts with the PyTorch spline on both devices,
then places the patches with ``place_patches``: on a card its kernel adds
them in source order, as the scan does, so the canvas is the same from run
to run; on the CPU its plain version, a loop in the same order.
"""

from __future__ import annotations

import torch

from debvader_tpu_torch.kernels.render import (
    place_patches,
    render_field_kernel,
    render_into_canvas,
    subpixel_shift_const,
)
from debvader_tpu_torch.ops.spline import subpixel_shift_spline_const

__all__ = ["render_pad", "subpixel_shift_const", "render_field"]


def render_pad(stamp_size: int, order: int = 1) -> int:
    """Canvas padding render_field uses for (stamp_size, order): a caller
    that renders with ``crop=False`` crops the final canvas itself,
    ``canvas[pad : pad + field_size, pad : pad + field_size]``."""
    if order not in (1, 3):
        raise ValueError(f"render interpolation order must be 1 or 3, got {order}")
    return stamp_size + 2 * (1 if order == 1 else 10)


def render_field(
    stamps: torch.Tensor,
    offsets: torch.Tensor,
    field_size: int,
    mask: torch.Tensor | None = None,
    order: int = 1,
    canvas: torch.Tensor | None = None,
    crop: bool = True,
) -> torch.Tensor:
    """Sum of all stamps placed at (field centre + offset): (F, F, B), or
    the padded canvas when ``crop=False``.

    stamps (N, S, S, B); offsets (N, 2) float, the stamp moved by
    ``offset`` from being centred in the field; mask (N,) bool drops
    sources.  order 1 = bilinear, 3 = cubic B-spline (scipy's default).
    A source whose padded patch would leave the padded canvas contributes
    nothing (it is clipped into range and masked, never wrapped).

    ``canvas``/``crop`` render incrementally: pass ``crop=False`` to get
    the padded float32 canvas back ((F + 2 * render_pad,) * 2 + (B,)),
    hand it to the next call's ``canvas``, and crop the last one.  The
    canvas is accumulated into in place: keep only the returned tensor.
    The canvas's padding ring is scratch (the order-1 kernel leaves it
    zero, the order-3 place and the plain versions deposit the stamps' spill
    there)."""
    s, b = stamps.shape[1], stamps.shape[-1]
    dev = stamps.device
    pad = render_pad(s, order)
    canvas_size = field_size + 2 * pad
    if canvas is not None and (
        tuple(canvas.shape) != (canvas_size, canvas_size, b) or canvas.dtype != torch.float32
    ):
        raise ValueError(
            f"canvas must be float32 {(canvas_size, canvas_size, b)}, got "
            f"{canvas.dtype} {tuple(canvas.shape)}"
        )

    def window(c):
        return c[pad : pad + field_size, pad : pad + field_size]

    if order == 1 and dev.type == "cuda":
        if canvas is None and crop:
            return render_field_kernel(stamps, offsets, field_size, mask)
        if canvas is None:
            canvas = torch.zeros((canvas_size, canvas_size, b), dtype=torch.float32, device=dev)
        render_field_kernel(stamps, offsets, field_size, mask, out=window(canvas))
        return window(canvas) if crop else canvas

    if canvas is None:
        canvas = torch.zeros((canvas_size, canvas_size, b), dtype=torch.float32, device=dev)
    interp = subpixel_shift_const if order == 1 else subpixel_shift_spline_const
    render_into_canvas(canvas, stamps, offsets, mask, field_size, (pad - s) // 2, interp, place_patches)
    return window(canvas) if crop else canvas
