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

The float32 kernels also take a rectangular field (fy, fx) and a canvas
with strided rows: the row bands of the sharded serve
(pipeline/sharded_field.py), each rendered into a (band_h + 2 * halo +
2 * pad) x (F + 2 * pad) canvas, with the centre taken per axis as the JAX
package's ``render_field(..., (fy, fx))`` takes it.  A square field takes
the same arithmetic as before, so its canvas is unchanged bit for bit.

Both kernels also take a bfloat16 canvas (the serving path's canvases
under ``DeblendField(device_dtype='bfloat16')``), with bfloat16 stamps or
patches: each source's value is computed in float32, rounded to bfloat16
and added into the canvas with a rounding after every add, in ascending
source index, each element starting from the canvas's own value, which is
what the JAX package's scan computes on a bfloat16 canvas.  The plain
versions do the same adds in bfloat16 tensors; on the order-1 route the
plain version adds into a padded bfloat16 canvas and copies its window
back.  On a card, for B = 6, one launch a chunk of up to 1,024 sources:
a persistent grid walks the tiles, each warp scans the sources in
ascending index and adds the ones that touch its part of the tile with
packed bfloat16 arithmetic (csrc/render.cu).  Each bfloat16 launch counts
in the wrapper's ``launches_bf16``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from debvader_tpu_torch.kernels import _build

__all__ = [
    "field_hw",
    "subpixel_shift_const",
    "subpixel_shift",
    "shift_patches",
    "place_corners",
    "place_patches",
    "place_patches_plain",
    "render_into_canvas",
    "render_field_kernel",
    "render_field_plain",
]

_INTERP_PAD = 1  # the bilinear shift reaches one pixel past the stamp


def field_hw(field_size) -> tuple[int, int]:
    """(rows, columns) of a render's field: an int is a square field, a
    pair (fy, fx) a rectangle (a row band of the sharded serve)."""
    if isinstance(field_size, (tuple, list)):
        fy, fx = field_size
        return int(fy), int(fx)
    return int(field_size), int(field_size)


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


def subpixel_shift(img: torch.Tensor, shift: torch.Tensor, with_jacobian: bool = False):
    """Bilinear shift of (N, H, W) images by (N, 2) shifts, the JAX
    package's ``ops/shift.subpixel_shift`` (scipy.ndimage.shift at order 1):
    out[i, j] = img[i - dy, j - dx], taps at floor(i - dy), zero outside the
    image, and zero where the sample point itself leaves [0, H - 1] x
    [0, W - 1].  ``with_jacobian`` also returns d out / d dy and d out / d
    dx, each (N, H, W), in the rounding order of JAX's forward-mode
    derivative (floor's derivative is 0)."""
    n, h, w = img.shape
    dev = img.device
    dy = shift[:, 0].to(torch.float32).reshape(n, 1, 1)
    dx = shift[:, 1].to(torch.float32).reshape(n, 1, 1)
    yy = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1) - dy
    xx = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w) - dx
    yy, xx = torch.broadcast_to(yy, (n, h, w)), torch.broadcast_to(xx, (n, h, w))
    y0f, x0f = torch.floor(yy), torch.floor(xx)
    fy, fx = yy - y0f, xx - x0f
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    flat = img.reshape(n, h * w)

    def tap(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, -1)
        v = torch.gather(flat, 1, idx).reshape(n, h, w)
        return torch.where(ok, v, torch.zeros((), dtype=v.dtype, device=dev))

    t00, t01, t10, t11 = tap(y0, x0), tap(y0, x0 + 1), tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    gy, gx = 1 - fy, 1 - fx
    out = t00 * gy * gx + t01 * gy * fx + t10 * fy * gx + t11 * fy * fx
    inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.where(inside, out, zero)
    if not with_jacobian:
        return out
    d_dy = t00 * gx + t01 * fx - t10 * gx - t11 * fx
    d_dx = t00 * gy - t01 * gy + t10 * fy - t11 * fy
    return out, torch.where(inside, d_dy, zero), torch.where(inside, d_dx, zero)


def shift_patches(stamps, offsets, interp_pad: int, interp):
    """The shift step: (patches (N, P, P, B) float32, int_off (N, 2) int64)
    with P = S + 2 * ``interp_pad``: each stamp zero-padded by
    ``interp_pad`` and shifted by the fractional part of its offset with
    ``interp(padded, frac)``, and the offsets' integer parts."""
    offsets = offsets.to(torch.float32)
    int_off = torch.floor(offsets)
    shifted = interp(F.pad(stamps.to(torch.float32), (0, 0) + (interp_pad,) * 4), offsets - int_off)
    return shifted, int_off.to(torch.int64)


def place_corners(int_off, mask, field_size, stamp_size: int, interp_pad: int, canvas_size):
    """(y, x, visible) of each padded patch (P = stamp_size + 2 *
    interp_pad) placed at field centre + ``int_off`` on a canvas padded by
    P on each side: its canvas corner, clipped into range, and whether it
    lands unclipped (so any placement that overlaps the field is kept; a
    patch entirely off the canvas is clipped into range and dropped, never
    wrapped) and is not masked out.  ``field_size`` and ``canvas_size``
    are ints for a square or (rows, columns) pairs (:func:`field_hw`); the
    centre is taken per axis."""
    pad_s = stamp_size + 2 * interp_pad
    (fy, fx), (cy, cx) = field_hw(field_size), field_hw(canvas_size)
    yu = (fy - stamp_size) // 2 + int_off[:, 0] - interp_pad + pad_s
    xu = (fx - stamp_size) // 2 + int_off[:, 1] - interp_pad + pad_s
    y = torch.clamp(yu, 0, cy - pad_s)
    x = torch.clamp(xu, 0, cx - pad_s)
    visible = (yu == y) & (xu == x)
    if mask is not None:
        visible = visible & mask.to(torch.bool)
    return y, x, visible


_CANVAS_DTYPES = (torch.float32, torch.bfloat16)


def _check_place(canvas, patches, y, x, visible):
    if canvas.ndim != 3 or canvas.stride(2) != 1 or canvas.stride(1) != canvas.shape[2]:
        raise ValueError(
            f"canvas must be an (H, W, B) tensor contiguous along pixels and bands, got {tuple(canvas.shape)}"
        )
    if canvas.dtype == torch.bfloat16 and (canvas.shape[0] != canvas.shape[1] or not canvas.is_contiguous()):
        raise ValueError(
            f"a bfloat16 canvas must be a contiguous square (C, C, B), got {tuple(canvas.shape)}: the bfloat16 "
            f"place takes the square canvas of DeblendField(device_dtype='bfloat16') only"
        )
    if canvas.dtype not in _CANVAS_DTYPES or patches.dtype != canvas.dtype:
        raise ValueError(
            f"canvas and patches must both be float32 or both bfloat16, got {canvas.dtype} and {patches.dtype}"
        )
    n, p = patches.shape[:2]
    if patches.ndim != 4 or patches.shape[2] != p or patches.shape[3] != canvas.shape[2]:
        raise ValueError(f"patches must be (N, P, P, {canvas.shape[2]}), got {tuple(patches.shape)}")
    if p > min(canvas.shape[0], canvas.shape[1]):
        raise ValueError(f"patches of {p} pixels do not fit a canvas of {tuple(canvas.shape[:2])}")
    for name, v in (("y", y), ("x", x), ("visible", visible)):
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(v.shape)}")
    if any(v.device != canvas.device for v in (patches, y, x, visible)):
        raise ValueError("canvas, patches, corners and visible must lie on one device")


def place_patches_plain(canvas, patches, y, x, visible) -> None:
    """Plain PyTorch version of :func:`place_patches`: the JAX package's
    scan, one slice add of where(visible, patch, 0) a source, in source
    order (in the canvas's dtype: every bfloat16 add is rounded).  (One ``index_put_(accumulate=True)`` of all patches adds in
    another order once the CPU runs it on several threads, and PyTorch
    documents no order for it on a card.)"""
    p = patches.shape[1]
    patches = torch.where(visible[:, None, None, None], patches, torch.zeros((), device=canvas.device))
    for i, (yi, xi) in enumerate(zip(y.tolist(), x.tolist())):
        canvas[yi : yi + p, xi : xi + p] += patches[i]


# The bfloat16 kernels for B = 6 take at most this many sources a launch
# (csrc/render.cu kScanSources); a larger call takes several in turn.
_SCAN_SOURCES = 1024


def _aligned4(*tensors) -> bool:
    return all(t.data_ptr() % 4 == 0 for t in tensors)


def _launch_place(canvas, patches, y, x, visible):
    n, p, _, b = patches.shape
    c = canvas.shape[0]
    bf16 = canvas.dtype == torch.bfloat16
    if not bf16:
        corners = torch.stack([y, x], -1).to(torch.int32)
        fn = _build.launcher("render", "dvt_place", 4, 6)
        status = _build.call(fn, canvas.device, patches.data_ptr(), corners.data_ptr(),
                             visible.to(torch.uint8).data_ptr(), canvas.data_ptr(), n, p, b,
                             canvas.shape[0], canvas.shape[1], canvas.stride(0))
        _build.check(status, "dvt_place")
        place_patches.launches += 1
        return
    if not (b == 6 and _aligned4(patches, canvas)):
        corners = torch.stack([y, x], -1).to(torch.int32)
        fn = _build.launcher("render", "dvt_place_bf16_generic", 4, 4)
        status = _build.call(fn, canvas.device, patches.data_ptr(), corners.data_ptr(),
                             visible.to(torch.uint8).data_ptr(), canvas.data_ptr(), n, p, b, c)
        _build.check(status, "dvt_place_bf16_generic")
        place_patches.launches_bf16 += 1
        return
    # the corners and flags go as they come: no kernel a call to stack or
    # cast them
    ys, xs = y.to(torch.int64).contiguous(), x.to(torch.int64).contiguous()
    vis = visible.to(torch.bool).contiguous()
    fn = _build.launcher("render", "dvt_place_bf16", 5, 3)
    for i in range(0, n, _SCAN_SOURCES):
        m = min(n - i, _SCAN_SOURCES)
        status = _build.call(fn, canvas.device, patches[i:].data_ptr(), ys[i:].data_ptr(), xs[i:].data_ptr(),
                             vis[i:].data_ptr(), canvas.data_ptr(), m, p, c)
        _build.check(status, "place_bf16")
        place_patches.launches_bf16 += 1


def place_patches(canvas, patches, y, x, visible) -> None:
    """Add patches (N, P, P, B) into an (H, W, B) canvas of the same dtype
    in place: float32 (a square field's canvas, or a row band's rectangle;
    rows may be strided, pixels and bands contiguous), or a contiguous
    square bfloat16 canvas with every add rounded.  Patch i lands at
    canvas rows y[i] .. y[i] + P - 1 and columns x[i] .. x[i] + P - 1 (the
    corners lie in range, as :func:`place_corners` clips them), +0.0 where
    visible[i] is False; the patches covering an element added in
    ascending index.  CPU tensors take the plain version; CUDA
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
place_patches.launches_bf16 = 0


def render_into_canvas(
    canvas, stamps, offsets, mask, field_size, interp_pad: int, interp, place=place_patches_plain
) -> None:
    """Shift, then place: pad the stamps by ``interp_pad``, shift each by
    the fractional part of its offset with ``interp(padded, frac)``, and add
    the patches into the padded canvas in place with ``place`` (the plain
    loop by default, or :func:`place_patches`), patch i at field centre +
    floor(offset i) (:func:`place_corners`).  The patches are shifted in
    float32 and rounded to the canvas's dtype before the adds."""
    if stamps.shape[0] == 0:
        return
    shifted, int_off = shift_patches(stamps, offsets, interp_pad, interp)
    y, x, visible = place_corners(int_off, mask, field_size, stamps.shape[1], interp_pad, tuple(canvas.shape[:2]))
    place(canvas, shifted.to(canvas.dtype), y, x, visible)


def _check(stamps, offsets, mask):
    if stamps.ndim != 4 or stamps.shape[1] != stamps.shape[2]:
        raise ValueError(f"stamps must be (N, S, S, B), got {tuple(stamps.shape)}")
    n = stamps.shape[0]
    if tuple(offsets.shape) != (n, 2):
        raise ValueError(f"offsets must be ({n}, 2), got {tuple(offsets.shape)}")
    if mask is not None and tuple(mask.shape) != (n,):
        raise ValueError(f"mask must be ({n},), got {tuple(mask.shape)}")


def render_field_plain(stamps, offsets, field_size, mask=None, out=None):
    """Plain PyTorch version of :func:`render_field_kernel`: the shift of
    the padded stamps, their patches added into a padded canvas in source
    order (:func:`place_patches_plain`), cropped.  A bfloat16 ``out`` is the
    canvas the adds start from: its values go into the window of a padded
    bfloat16 canvas, the rounded patches are added there, and the window is
    copied back."""
    _check(stamps, offsets, mask)
    s, b = stamps.shape[1], stamps.shape[-1]
    fy, fx = field_hw(field_size)
    pad = s + 2 * _INTERP_PAD
    bf16 = out is not None and out.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    canvas = torch.zeros((fy + 2 * pad, fx + 2 * pad, b), dtype=dtype, device=stamps.device)
    window = canvas[pad : pad + fy, pad : pad + fx]
    if bf16:
        window.copy_(out)
    render_into_canvas(canvas, stamps, offsets, mask, field_size, _INTERP_PAD, subpixel_shift_const)
    if out is None:
        return window
    if bf16:
        out.copy_(window)
    else:
        out += window
    return out


def _launch(stamps, offsets, field_size, mask, out):
    n, s, _, b = stamps.shape
    fy, fx = field_hw(field_size)
    accumulate = out is not None
    if out is None:
        out = torch.empty((fy, fx, b), dtype=torch.float32, device=stamps.device)
    mask_ptr = None if mask is None else mask.data_ptr()
    if out.dtype == torch.bfloat16:
        fn = _build.launcher("render", "dvt_render_bf16", 4, 5)
        for i in range(0, n, _SCAN_SOURCES):
            m = min(n - i, _SCAN_SOURCES)
            status = _build.call(
                fn, stamps.device, stamps[i:].data_ptr(), offsets[i:].data_ptr(),
                None if mask is None else mask[i:].data_ptr(), out.data_ptr(), m, s, b, fy, out.stride(0),
            )
            _build.check(status, "render_bf16")
            render_field_kernel.launches_bf16 += 1
        return out
    fn = _build.launcher("render", "dvt_render", 4, 7)
    status = _build.call(
        fn, stamps.device, stamps.data_ptr(), offsets.data_ptr(), mask_ptr,
        out.data_ptr(), n, s, b, fy, fx, out.stride(0), int(accumulate),
    )
    _build.check(status, "render")
    render_field_kernel.launches += 1
    return out


def render_field_kernel(
    stamps: torch.Tensor,
    offsets: torch.Tensor,
    field_size,
    mask: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum of all stamps placed at (field centre + offset): (F, F, B), or
    (fy, fx, B) for a rectangular ``field_size`` (fy, fx) (a row band of
    the sharded serve; the centre is taken per axis).

    stamps (N, S, S, B) float32; offsets (N, 2) float; mask (N,) bool drops
    sources.  ``out``, when given, is a float32 tensor of the field's shape
    (or a window of a larger canvas: rows may be strided, pixels and bands
    are contiguous) that the render is added to in place and that is
    returned.  A bfloat16 ``out`` takes bfloat16 stamps and a square field,
    and every source's value and every add into it are rounded to bfloat16
    (module docstring).  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check(stamps, offsets, mask)
    b = stamps.shape[-1]
    fy, fx = field_hw(field_size)
    bf16 = out is not None and out.dtype == torch.bfloat16
    if bf16 and stamps.dtype != torch.bfloat16:
        raise ValueError(f"a bfloat16 out takes bfloat16 stamps, got {stamps.dtype}")
    if bf16 and fy != fx:
        raise ValueError(
            f"a bfloat16 out must be a square field, got ({fy}, {fx}): the bfloat16 render takes the square "
            f"canvas of DeblendField(device_dtype='bfloat16') only"
        )
    if out is not None:
        if tuple(out.shape) != (fy, fx, b) or out.dtype not in _CANVAS_DTYPES:
            raise ValueError(f"out must be float32 or bfloat16 ({fy}, {fx}, {b})")
        if out.device != stamps.device:
            raise ValueError("out must lie on the stamps' device")
        if fy * fx > 1 and (out.stride(2) != 1 or out.stride(1) != b):
            raise ValueError("out must be contiguous along pixels and bands")
    if stamps.device.type == "cpu":
        return render_field_plain(stamps, offsets, field_size, mask, out)
    if stamps.device.type == "cuda":
        stamps = stamps.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
        offsets = offsets.to(torch.float32).contiguous()
        if mask is not None:
            mask = mask.to(torch.bool).contiguous()
        return _launch(stamps, offsets, field_size, mask, out)
    raise ValueError(f"unsupported device {stamps.device}")


render_field_kernel.launches = 0
render_field_kernel.launches_bf16 = 0
