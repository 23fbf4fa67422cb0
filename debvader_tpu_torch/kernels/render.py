"""Bilinear field render: CUDA kernel and plain version.

Port of the Pallas kernel debvader_tpu/kernels/render.py
(render_field_pallas), a drop-in for ``ops/shift.render_field`` at order 1:
the sum of N stamps, each shifted by the fractional part of its offset
(bilinear, two slices per axis with weights (f, 1 - f) on the stamp
zero-padded by one pixel) and placed at field centre + floor(offset).

The plain version shifts every stamp, then scatters all patches into a
padded canvas with one ``index_put_(accumulate=True)``; on a card that
scatter adds with atomics, in an order that changes from run to run.  The
CUDA kernel (csrc/render.cu) gathers instead, so its output is
deterministic: each output element starts from 0, adds the sources that
overlap its tile in ascending index and is added into ``out`` once.  It is
bound on the H100 by bytes (the stamps read once, the covered part of the
field read and written once).  For B = 6 a block owns a tile of 16 rows x
32 pixels and keeps its sums in registers; it lists the overlapping sources from the
offsets, stages each source's window into shared memory with 8-byte
``cp.async`` copies, double-buffered (TMA cannot address the stamps: a
59 x 6 float row is 1,416 bytes and a stamp 83,544, and TMA wants global
strides in multiples of 16 bytes; 16-byte copies would be misaligned on
every other pixel), and skips tiles that no padded patch touches: with
``out`` given they are neither read nor written.  Other band counts take a
16 x 16 tile kernel with the same sums.  The kernel writes the field window
only: the padding ring of a canvas stays zero on this route, where the
plain route deposits the spill of stamps that hang over the edge.  Every
caller crops the ring away.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from debvader_tpu_torch.kernels import _build

__all__ = [
    "subpixel_shift_const",
    "render_into_canvas",
    "render_field_kernel",
    "render_field_plain",
]

_INTERP_PAD = 1  # the bilinear shift reaches one pixel past the stamp


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


def render_into_canvas(canvas, stamps, offsets, mask, field_size: int, interp_pad: int, interp) -> None:
    """Shift and scatter: pad the stamps by ``interp_pad``, shift each by
    the fractional part of its offset with ``interp(padded, frac)``, and add
    the patches into the padded canvas in place, patch i at field centre +
    floor(offset i), in one ``index_put_(accumulate=True)``.  The canvas is
    padded by the patch size P on each side, so any placement that overlaps
    the field is unclipped; a patch entirely off the canvas is clipped into
    range and dropped, never wrapped."""
    n, s, _, b = stamps.shape
    if n == 0:
        return
    dev = canvas.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    offsets = offsets.to(torch.float32)
    int_off = torch.floor(offsets)
    frac = offsets - int_off
    int_off = int_off.to(torch.int64)
    shifted = interp(F.pad(stamps.to(torch.float32), (0, 0) + (interp_pad,) * 4), frac)

    pad_s = s + 2 * interp_pad
    canvas_size = canvas.shape[0]
    pos0 = (field_size - s) // 2
    yu = pos0 + int_off[:, 0] - interp_pad + pad_s
    xu = pos0 + int_off[:, 1] - interp_pad + pad_s
    y = torch.clamp(yu, 0, canvas_size - pad_s)
    x = torch.clamp(xu, 0, canvas_size - pad_s)
    visible = mask.to(torch.bool) & (yu == y) & (xu == x)
    shifted = torch.where(visible[:, None, None, None], shifted, torch.zeros((), device=dev))
    ar = torch.arange(pad_s, device=dev)
    rows = (y[:, None] + ar)[:, :, None]  # (N, P, 1)
    cols = (x[:, None] + ar)[:, None, :]  # (N, 1, P)
    flat = (rows * canvas_size + cols).reshape(-1)
    canvas.view(-1, b).index_put_((flat,), shifted.reshape(-1, b), accumulate=True)


def _check(stamps, offsets, mask):
    if stamps.ndim != 4 or stamps.shape[1] != stamps.shape[2]:
        raise ValueError(f"stamps must be (N, S, S, B), got {tuple(stamps.shape)}")
    n = stamps.shape[0]
    if tuple(offsets.shape) != (n, 2):
        raise ValueError(f"offsets must be ({n}, 2), got {tuple(offsets.shape)}")
    if mask is not None and tuple(mask.shape) != (n,):
        raise ValueError(f"mask must be ({n},), got {tuple(mask.shape)}")


def render_field_plain(stamps, offsets, field_size: int, mask=None, out=None):
    """Plain PyTorch version of :func:`render_field_kernel`: the shift of
    the padded stamps and one scatter into a padded canvas, cropped."""
    _check(stamps, offsets, mask)
    s, b = stamps.shape[1], stamps.shape[-1]
    pad = s + 2 * _INTERP_PAD
    canvas = torch.zeros((field_size + 2 * pad,) * 2 + (b,), dtype=torch.float32, device=stamps.device)
    render_into_canvas(canvas, stamps, offsets, mask, field_size, _INTERP_PAD, subpixel_shift_const)
    window = canvas[pad : pad + field_size, pad : pad + field_size]
    if out is None:
        return window
    out += window
    return out


def _launch(stamps, offsets, field_size, mask, out):
    n, s, _, b = stamps.shape
    accumulate = out is not None
    if out is None:
        out = torch.empty((field_size, field_size, b), dtype=torch.float32, device=stamps.device)
    fn = _build.launcher("render", "dvt_render", 4, 6)
    status = _build.call(
        fn, stamps.device, stamps.data_ptr(), offsets.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), n, s, b, field_size, out.stride(0), int(accumulate),
    )
    _build.check(status, "render")
    render_field_kernel.launches += 1
    return out


def render_field_kernel(
    stamps: torch.Tensor,
    offsets: torch.Tensor,
    field_size: int,
    mask: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum of all stamps placed at (field centre + offset): (F, F, B).

    stamps (N, S, S, B) float32; offsets (N, 2) float; mask (N,) bool drops
    sources.  ``out``, when given, is an (F, F, B) float32 tensor (or a
    window of a larger canvas: rows may be strided, pixels and bands are
    contiguous) that the render is added to in place and that is returned.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(stamps, offsets, mask)
    b = stamps.shape[-1]
    if out is not None:
        if tuple(out.shape) != (field_size, field_size, b) or out.dtype != torch.float32:
            raise ValueError(f"out must be float32 ({field_size}, {field_size}, {b})")
        if out.device != stamps.device:
            raise ValueError("out must lie on the stamps' device")
        if field_size > 1 and (out.stride(2) != 1 or out.stride(1) != b):
            raise ValueError("out must be contiguous along pixels and bands")
    if stamps.device.type == "cpu":
        return render_field_plain(stamps, offsets, field_size, mask, out)
    if stamps.device.type == "cuda":
        stamps = stamps.to(torch.float32).contiguous()
        offsets = offsets.to(torch.float32).contiguous()
        if mask is not None:
            mask = mask.to(torch.bool).contiguous()
        return _launch(stamps, offsets, field_size, mask, out)
    raise ValueError(f"unsupported device {stamps.device}")


render_field_kernel.launches = 0
