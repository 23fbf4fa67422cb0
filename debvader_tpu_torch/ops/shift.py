"""Subpixel shifts and field assembly.

The fractional part of each source's offset is applied to the small stamp
(bilinear, or the order-3 spline of ops/spline.py on a stamp zero-padded
by 10 px so the local prefilter equals the whole-canvas one); the integer
part places the shifted patch on a padded canvas.  All sources scatter
into the canvas in one ``index_put_(accumulate=True)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from debvader_tpu_torch.ops.spline import subpixel_shift_spline_const

__all__ = ["render_pad", "subpixel_shift_const", "render_field"]


def render_pad(stamp_size: int, order: int = 1) -> int:
    """Canvas padding render_field uses for (stamp_size, order)."""
    if order not in (1, 3):
        raise ValueError(f"render interpolation order must be 1 or 3, got {order}")
    return stamp_size + 2 * (1 if order == 1 else 10)


def subpixel_shift_const(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Bilinear shift of (N, H, W, C) images by per-image (N, 2) shifts with
    fractional parts in [0, 1): two shifted slices per axis with weights
    (f, 1 - f), zero outside."""
    n, h, w, _ = img.shape
    fy = shift[:, 0].reshape(n, 1, 1, 1)
    fx = shift[:, 1].reshape(n, 1, 1, 1)
    p = F.pad(img, (0, 0, 1, 0, 1, 0))
    tmp = fy * p[:, 0:h] + (1.0 - fy) * p[:, 1 : 1 + h]
    out = fx * tmp[:, :, 0:w] + (1.0 - fx) * tmp[:, :, 1 : 1 + w]
    rows = torch.arange(h, dtype=torch.float32, device=img.device).reshape(1, h, 1, 1)
    cols = torch.arange(w, dtype=torch.float32, device=img.device).reshape(1, 1, w, 1)
    return torch.where((rows >= fy) & (cols >= fx), out, torch.zeros((), dtype=out.dtype, device=out.device))


def render_field(
    stamps: torch.Tensor,
    offsets: torch.Tensor,
    field_size: int,
    mask: torch.Tensor | None = None,
    order: int = 1,
) -> torch.Tensor:
    """Sum of all stamps placed at (field centre + offset): (F, F, B).

    stamps (N, S, S, B); offsets (N, 2) float, the stamp moved by
    ``offset`` from being centred in the field; mask (N,) bool drops
    sources.  order 1 = bilinear, 3 = cubic B-spline (scipy's default).
    A source whose padded patch would leave the padded canvas contributes
    nothing (it is clipped into range and masked, never wrapped)."""
    n, s, _, b = stamps.shape
    dev = stamps.device
    pad_s = render_pad(s, order)
    interp_pad = (pad_s - s) // 2
    pad = pad_s
    canvas_size = field_size + 2 * pad
    canvas = torch.zeros((canvas_size, canvas_size, b), dtype=torch.float32, device=dev)
    if n == 0:
        return canvas[pad : pad + field_size, pad : pad + field_size]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    offsets = offsets.to(torch.float32)
    int_off = torch.floor(offsets)
    frac = offsets - int_off
    int_off = int_off.to(torch.int64)

    stamps_p = F.pad(
        stamps.to(torch.float32),
        (0, 0, interp_pad, interp_pad, interp_pad, interp_pad),
    )
    if order == 1:
        shifted = subpixel_shift_const(stamps_p, frac)
    else:
        shifted = subpixel_shift_spline_const(stamps_p, frac)

    pos0 = (field_size - s) // 2
    yu = pos0 + int_off[:, 0] - interp_pad + pad
    xu = pos0 + int_off[:, 1] - interp_pad + pad
    y = torch.clamp(yu, 0, canvas_size - pad_s)
    x = torch.clamp(xu, 0, canvas_size - pad_s)
    visible = mask & (yu == y) & (xu == x)
    shifted = torch.where(visible[:, None, None, None], shifted, torch.zeros((), device=dev))

    ar = torch.arange(pad_s, device=dev)
    rows = (y[:, None] + ar)[:, :, None]  # (N, P, 1)
    cols = (x[:, None] + ar)[:, None, :]  # (N, 1, P)
    flat = (rows * canvas_size + cols).reshape(-1)
    canvas.view(-1, b).index_put_((flat,), shifted.reshape(-1, b), accumulate=True)
    return canvas[pad : pad + field_size, pad : pad + field_size]

