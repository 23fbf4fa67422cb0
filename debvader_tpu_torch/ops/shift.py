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

from debvader_tpu_torch.kernels import render as _render
from debvader_tpu_torch.kernels.render import field_hw, place_patches, render_field_kernel, render_into_canvas
from debvader_tpu_torch.ops.spline import subpixel_shift_spline_const

__all__ = ["render_pad", "subpixel_shift", "subpixel_shift_const", "shift_full", "render_field"]


def _one_image(img, shift):
    """(img as (H, W, C) float32, shift (2,) on its device, whether img
    was (H, W))."""
    img = torch.as_tensor(img, dtype=torch.float32)
    squeeze = img.ndim == 2
    shift = torch.as_tensor(shift, dtype=torch.float32, device=img.device).reshape(2)
    return (img[..., None] if squeeze else img), shift, squeeze


def subpixel_shift_const(img, shift) -> torch.Tensor:
    """Bilinear shift of one (H, W) or (H, W, C) image by a (2,) shift
    whose fractional parts lie in [0, 1): two shifted slices per axis with
    weights (f, 1 - f), zero outside (the JAX package's function of the
    same name; the renderer's batched form is kernels/render.py's)."""
    x, shift, squeeze = _one_image(img, shift)
    out = _render.subpixel_shift_const(x[None], shift[None])[0]
    return out[..., 0] if squeeze else out


def subpixel_shift(img, shift) -> torch.Tensor:
    """scipy.ndimage.shift(img, shift, order=1, mode='constant') of one
    (H, W) or (H, W, C) image: out[i, j] = img[i - dy, j - dx], taps at
    floor(i - dy), zero outside the image and where the sample point
    leaves it (the JAX package's function of the same name)."""
    x, shift, squeeze = _one_image(img, shift)
    c = x.shape[-1]
    out = _render.subpixel_shift(x.permute(2, 0, 1), shift.expand(c, 2)).permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def shift_full(img, shift) -> torch.Tensor:
    """Full-image bilinear shift: the reference's per-band
    scipy.ndimage.shift on a padded canvas."""
    return subpixel_shift(img, shift)


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
    field_size,
    mask: torch.Tensor | None = None,
    order: int = 1,
    canvas: torch.Tensor | None = None,
    crop: bool = True,
) -> torch.Tensor:
    """Sum of all stamps placed at (field centre + offset): (F, F, B), or
    the padded canvas when ``crop=False``.  ``field_size`` may be an
    (fy, fx) pair for a rectangular field (the row bands of the sharded
    serve): the result is (fy, fx, B), the canvas (fy + 2 * pad, fx + 2 *
    pad, B), and the centre is taken per axis.

    stamps (N, S, S, B); offsets (N, 2) float, the stamp moved by
    ``offset`` from being centred in the field; mask (N,) bool drops
    sources.  order 1 = bilinear, 3 = cubic B-spline (scipy's default).
    A source whose padded patch would leave the padded canvas contributes
    nothing (it is clipped into range and masked, never wrapped).

    ``canvas``/``crop`` render incrementally: pass ``crop=False`` to get
    the padded canvas back ((F + 2 * render_pad,) * 2 + (B,)), hand it to
    the next call's ``canvas``, and crop the last one.  The canvas is
    accumulated into in place: keep only the returned tensor.  The canvas's
    padding ring is scratch (the order-1 kernel leaves it alone, the
    order-3 place and the plain versions deposit the stamps' spill there).

    The canvas is float32, or bfloat16 (the serving path under
    ``device_dtype='bfloat16'``): a bfloat16 canvas takes bfloat16 stamps,
    and every shifted value and every add into it is rounded to bfloat16,
    in source order, as the JAX package's scan adds into a bfloat16 canvas.
    Without ``canvas``, bfloat16 stamps render into a new bfloat16 canvas
    and any other stamps into a float32 one.  A bfloat16 canvas is square."""
    s, b = stamps.shape[1], stamps.shape[-1]
    dev = stamps.device
    pad = render_pad(s, order)
    fy, fx = field_hw(field_size)
    canvas_shape = (fy + 2 * pad, fx + 2 * pad, b)
    dtype = torch.bfloat16 if stamps.dtype == torch.bfloat16 else torch.float32
    if canvas is not None and (
        tuple(canvas.shape) != canvas_shape or canvas.dtype not in (torch.float32, torch.bfloat16)
    ):
        raise ValueError(
            f"canvas must be float32 or bfloat16 {canvas_shape}, got {canvas.dtype} {tuple(canvas.shape)}"
        )
    if canvas is not None:
        dtype = canvas.dtype
    if dtype == torch.bfloat16 and stamps.dtype != torch.bfloat16:
        raise ValueError(f"a bfloat16 canvas takes bfloat16 stamps, got {stamps.dtype}")
    if dtype == torch.bfloat16 and fy != fx:
        raise ValueError(
            f"a bfloat16 render takes a square field, got ({fy}, {fx}): rectangular (row-band) canvases "
            f"are float32"
        )

    def window(c):
        return c[pad : pad + fy, pad : pad + fx]

    if order == 1 and dev.type == "cuda":
        if canvas is None and crop and dtype == torch.float32:
            return render_field_kernel(stamps, offsets, (fy, fx), mask)
        if canvas is None:
            canvas = torch.zeros(canvas_shape, dtype=dtype, device=dev)
        render_field_kernel(stamps, offsets, (fy, fx), mask, out=window(canvas))
        return window(canvas) if crop else canvas

    if canvas is None:
        canvas = torch.zeros(canvas_shape, dtype=dtype, device=dev)
    interp = _render.subpixel_shift_const if order == 1 else subpixel_shift_spline_const
    render_into_canvas(canvas, stamps, offsets, mask, (fy, fx), (pad - s) // 2, interp, place_patches)
    return window(canvas) if crop else canvas
