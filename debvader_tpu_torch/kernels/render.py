"""Bilinear field render: CUDA kernel and plain version.

Port of the Pallas kernel debvader_tpu/kernels/render.py
(render_field_pallas), a drop-in for ``ops/shift.render_field`` at order 1:
the sum of N stamps, each shifted by the fractional part of its offset
(bilinear, two slices per axis with weights (f, 1 - f) on the stamp
zero-padded by one pixel) and placed at field centre + floor(offset).

The plain version shifts every stamp, then adds the patches into a
padded canvas one at a time (:func:`place_patches_plain`).  The CUDA
kernel (csrc/render.cu) gathers instead, and its output is deterministic
too: each output element starts from 0, adds the sources that
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

The order-3 render (``ops/shift.render_field``) takes two steps here:
*shift* (the padded stamps through the PyTorch spline of ops/spline.py)
and *place* (:func:`place_patches`: add the shifted patches into the padded
canvas at integer corners).  Place has its plain version, the loop
above, and a CUDA kernel in csrc/render.cu (``dvt_place``) that gathers:
each canvas element starts from its own value and adds the patches that
cover it in ascending source index, the JAX package's sequential scan
order, so its canvas is bit-identical to the plain version's and the
same from run to run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from debvader_tpu_torch.kernels import _build

__all__ = [
    "subpixel_shift_const",
    "shift_patches",
    "place_corners",
    "place_patches",
    "place_patches_plain",
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


def shift_patches(stamps, offsets, interp_pad: int, interp):
    """The shift step: (patches (N, P, P, B) float32, int_off (N, 2) int64)
    with P = S + 2 * ``interp_pad``: each stamp zero-padded by
    ``interp_pad`` and shifted by the fractional part of its offset with
    ``interp(padded, frac)``, and the offsets' integer parts."""
    offsets = offsets.to(torch.float32)
    int_off = torch.floor(offsets)
    shifted = interp(F.pad(stamps.to(torch.float32), (0, 0) + (interp_pad,) * 4), offsets - int_off)
    return shifted, int_off.to(torch.int64)


def place_corners(int_off, mask, field_size: int, stamp_size: int, interp_pad: int, canvas_size: int):
    """(y, x, visible) of each padded patch (P = stamp_size + 2 *
    interp_pad) placed at field centre + ``int_off`` on a canvas padded by
    P on each side: its canvas corner, clipped into range, and whether it
    lands unclipped (so any placement that overlaps the field is kept; a
    patch entirely off the canvas is clipped into range and dropped, never
    wrapped) and is not masked out."""
    pad_s = stamp_size + 2 * interp_pad
    pos0 = (field_size - stamp_size) // 2
    yu = pos0 + int_off[:, 0] - interp_pad + pad_s
    xu = pos0 + int_off[:, 1] - interp_pad + pad_s
    y = torch.clamp(yu, 0, canvas_size - pad_s)
    x = torch.clamp(xu, 0, canvas_size - pad_s)
    visible = (yu == y) & (xu == x)
    if mask is not None:
        visible = visible & mask.to(torch.bool)
    return y, x, visible


def _check_place(canvas, patches, y, x, visible):
    if canvas.ndim != 3 or canvas.shape[0] != canvas.shape[1] or not canvas.is_contiguous():
        raise ValueError(f"canvas must be a contiguous (C, C, B) tensor, got {tuple(canvas.shape)}")
    if canvas.dtype != torch.float32 or patches.dtype != torch.float32:
        raise ValueError("canvas and patches must be float32")
    n, p = patches.shape[:2]
    if patches.ndim != 4 or patches.shape[2] != p or patches.shape[3] != canvas.shape[2]:
        raise ValueError(f"patches must be (N, P, P, {canvas.shape[2]}), got {tuple(patches.shape)}")
    if p > canvas.shape[0]:
        raise ValueError(f"patches of {p} pixels do not fit a canvas of {canvas.shape[0]}")
    for name, v in (("y", y), ("x", x), ("visible", visible)):
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(v.shape)}")
    if any(v.device != canvas.device for v in (patches, y, x, visible)):
        raise ValueError("canvas, patches, corners and visible must lie on one device")


def place_patches_plain(canvas, patches, y, x, visible) -> None:
    """Plain PyTorch version of :func:`place_patches`: the JAX package's
    scan, one slice add of where(visible, patch, 0) a source, in source
    order.  (One ``index_put_(accumulate=True)`` of all patches adds in
    another order once the CPU runs it on several threads, and PyTorch
    documents no order for it on a card.)"""
    p = patches.shape[1]
    patches = torch.where(visible[:, None, None, None], patches, torch.zeros((), device=canvas.device))
    for i, (yi, xi) in enumerate(zip(y.tolist(), x.tolist())):
        canvas[yi : yi + p, xi : xi + p] += patches[i]


def _launch_place(canvas, patches, y, x, visible):
    n, p, _, b = patches.shape
    corners = torch.stack([y, x], -1).to(torch.int32)
    fn = _build.launcher("render", "dvt_place", 4, 4)
    status = _build.call(
        fn, canvas.device, patches.data_ptr(), corners.data_ptr(), visible.to(torch.uint8).data_ptr(),
        canvas.data_ptr(), n, p, b, canvas.shape[0],
    )
    _build.check(status, "place")
    place_patches.launches += 1


def place_patches(canvas, patches, y, x, visible) -> None:
    """Add patches (N, P, P, B) float32 into a (C, C, B) float32 canvas in
    place: patch i at canvas rows y[i] .. y[i] + P - 1 and columns x[i] ..
    x[i] + P - 1 (the corners lie in range, as :func:`place_corners` clips
    them), +0.0 where visible[i] is False; the patches covering an element
    added in ascending index.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check_place(canvas, patches, y, x, visible)
    if canvas.device.type == "cpu":
        place_patches_plain(canvas, patches, y, x, visible)
    elif canvas.device.type == "cuda":
        if patches.shape[0]:
            _launch_place(canvas, patches.contiguous(), y, x, visible)
    else:
        raise ValueError(f"unsupported device {canvas.device}")


place_patches.launches = 0


def render_into_canvas(
    canvas, stamps, offsets, mask, field_size: int, interp_pad: int, interp, place=place_patches_plain
) -> None:
    """Shift, then place: pad the stamps by ``interp_pad``, shift each by
    the fractional part of its offset with ``interp(padded, frac)``, and add
    the patches into the padded canvas in place with ``place`` (the plain
    loop by default, or :func:`place_patches`), patch i at field centre +
    floor(offset i) (:func:`place_corners`)."""
    if stamps.shape[0] == 0:
        return
    shifted, int_off = shift_patches(stamps, offsets, interp_pad, interp)
    y, x, visible = place_corners(int_off, mask, field_size, stamps.shape[1], interp_pad, canvas.shape[0])
    place(canvas, shifted, y, x, visible)


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
    the padded stamps, their patches added into a padded canvas in source
    order (:func:`place_patches_plain`), cropped."""
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
