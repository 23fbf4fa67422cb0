"""Position registration: CUDA kernel and plain version.

The port's kernel for XLA code of the JAX package (no Pallas kernel):
debvader_tpu/ops/registration.py ``position_optimization_batch_windowed``
and its full-field branch ``position_optimization_batch``.  For every
source, a bounded Gauss-Newton fit of the shift x = (dy, dx) that moves the
source's predicted r-band stamp onto the field band:

- the stamp is placed at field centre + its detected offset (the integer
  part moves it, the fractional part is a bilinear shift), so ``base`` is
  the prediction where detection put it;
- each of ``iterations`` steps from x = 0 takes the residual
  r = field - shift(base, x) and its Jacobian J = -d shift(base, x) / dx,
  solves (J^T J + 1e-6 I) dx = -J^T r by LU with partial pivoting, rounded
  as LAPACK's getrf and getrs round on the CPU (a reciprocal of the pivot,
  fused multiply-adds in the triangular solves), and clips x + dx to
  [-bound, bound];
- non-finite field pixels count as 0.

The windowed form sums over a (win, win) window of the field around the
source (:func:`registration_window`): the Jacobian is exactly zero outside
it.  Its shift is the JAX package's gather-free form, a slice of the base
padded by ``ceil(bound) + 1`` and a two-tap blend with the fractional part
in (0, 1] (``ix = ceil(x) - 1``), masked outside the window's extent; its
Jacobian is written out here, where JAX takes ``jax.jacfwd``:

    d out / d x0 = f2x * (e[a] - e[a+1])[b] + (1 - f2x) * (e[a] - e[a+1])[b+1]
    d out / d x1 = tmp[a, b] - tmp[a, b+1]

both zero outside the mask.  The full-field form (fields smaller than the
window) shifts the whole field with the generic bilinear shift of
ops/shift.py (the floor convention) and its Jacobian.

The plain versions run every source at once in batched PyTorch, one loop of
``iterations`` steps.  The CUDA kernel (csrc/registration.cu) stages each
source's stamp and padded base in shared memory once; every thread keeps
its pixels' field values in registers for all the steps, and each step
ends in one barrier after which every thread reads the warps' five sums
and solves the 2x2 system itself; it is bound by its operations.  Its
sums add in another order than ``torch.sum``, so the two agree to a
tolerance, not bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from debvader_tpu_torch.kernels import _build
from debvader_tpu_torch.kernels.render import subpixel_shift, subpixel_shift_const

__all__ = [
    "registration_window",
    "lu_solve2",
    "shift_window",
    "windowed_setup",
    "register_windowed",
    "register_windowed_plain",
    "register_full",
    "register_full_plain",
]

_RIDGE = 1e-6  # the damping JAX adds to J^T J's diagonal


def registration_window(stamp_size: int, bound: float) -> int:
    """Window side of the windowed solve: the stamp, the fractional part of
    the detected offset, one bilinear tap for the base placement, the
    shift bound and one more tap for the inner shift, with a row to
    spare."""
    return stamp_size + 2 * (math.ceil(bound) + 3)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (through float64: the product of
    two float32 values is exact there)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def lu_solve2(a00, a01, a10, a11, y0, y1):
    """Solve [[a00, a01], [a10, a11]] x = y for batches of float32 2x2
    systems, rounded as LAPACK's sgetrf / sgetrs on the CPU, which
    ``jnp.linalg.solve`` calls: the row with the larger |first column|
    leads (the first on a tie), l = a10 * (1 / a00), u11 = a11 - l * a01,
    then z1 = fma(-l, y0, y1), x1 = z1 * (1 / u11), x0 = fma(-u01, x1, y0)
    * (1 / u00).  Returns (x0, x1)."""
    swap = a10.abs() > a00.abs()
    p00, p01 = torch.where(swap, a10, a00), torch.where(swap, a11, a01)
    p10, p11 = torch.where(swap, a00, a10), torch.where(swap, a01, a11)
    q0, q1 = torch.where(swap, y1, y0), torch.where(swap, y0, y1)
    one = torch.ones((), dtype=torch.float32, device=a00.device)
    lo = p10 * (one / p00)
    u11 = p11 - lo * p01
    z1 = _fma(-lo, q0, q1)
    x1 = z1 * (one / u11)
    x0 = _fma(-p01, x1, q0) * (one / p00)
    return x0, x1


def _check(band, preds, offsets):
    if band.ndim != 2:
        raise ValueError(f"field_band must be (H, W), got {tuple(band.shape)}")
    if preds.ndim != 3 or preds.shape[1] != preds.shape[2]:
        raise ValueError(f"pred_bands must be (N, S, S), got {tuple(preds.shape)}")
    if tuple(offsets.shape) != (preds.shape[0], 2):
        raise ValueError(f"detected_offsets must be ({preds.shape[0]}, 2), got {tuple(offsets.shape)}")
    if preds.device != band.device or offsets.device != band.device:
        raise ValueError("field_band, pred_bands and detected_offsets must lie on one device")


def _finite(band):
    return torch.where(torch.isfinite(band), band, torch.zeros((), dtype=band.dtype, device=band.device))


def windowed_setup(band, preds, offsets, bound: float, row_lo: int, row_hi: int):
    """The per-source inputs of the windowed solve: (field windows (N, win,
    win), padded bases (N, win + 2 bp, win + 2 bp), bp).  The window starts
    at pos0 + floor(offset) - margin, clamped to the rows [row_lo, row_hi)
    and the columns of the band; the stamp goes into a margin-padded canvas
    (so a border source is clipped by the window's edge, not moved), is
    shifted by the fractional part of its offset, and the window's part of
    it is padded by bp = ceil(bound) + 1."""
    h, w = band.shape
    n, s = preds.shape[:2]
    dev = band.device
    win = registration_window(s, bound)
    margin = (win - s) // 2
    big = win + 2 * margin
    bp = math.ceil(bound) + 1
    pos0 = torch.tensor([(h - s) // 2, (w - s) // 2], dtype=torch.int64, device=dev)
    io_f = torch.floor(offsets)
    frac = offsets - io_f
    io = io_f.to(torch.int64)
    lo = torch.tensor([row_lo, 0], dtype=torch.int64, device=dev)
    hi = torch.tensor([row_hi - win, w - win], dtype=torch.int64, device=dev)
    g = torch.minimum(torch.maximum(pos0 + io - margin, lo), hi)
    ar = torch.arange(win, device=dev)
    rows, cols = g[:, :1] + ar, g[:, 1:] + ar
    fw = _finite(band)[rows[:, :, None], cols[:, None, :]]
    # the stamp's corner in the padded canvas (a dynamic_update_slice
    # clamps it so the stamp fits)
    p = (pos0 + io - g + margin).clamp(0, big - s)
    cr = torch.arange(big, device=dev)
    sr, sc = cr[None, :] - p[:, :1], cr[None, :] - p[:, 1:]  # stamp row / column of each canvas one
    ok = ((sr >= 0) & (sr < s))[:, :, None] & ((sc >= 0) & (sc < s))[:, None, :]
    canvas = preds[torch.arange(n, device=dev)[:, None, None], sr.clamp(0, s - 1)[:, :, None], sc.clamp(0, s - 1)[:, None, :]]
    canvas = torch.where(ok, canvas, torch.zeros((), dtype=torch.float32, device=dev))
    base = subpixel_shift_const(canvas[..., None], frac)[:, margin : margin + win, margin : margin + win, 0]
    return fw, F.pad(base, (bp,) * 4), bp


def shift_window(base_p, x, bp: int, with_jacobian: bool = False):
    """shift(base, x) over the window, the JAX package's gather-free form:
    ix = ceil(x) - 1, f2 = x - ix in (0, 1], a (win + 1)-square slice e of
    the padded base at bp - ix - 1, the blend tmp = f2y e[:-1] + (1 - f2y)
    e[1:], out = f2x tmp[:, :-1] + (1 - f2x) tmp[:, 1:], zero where the
    sample point leaves the window.  ``with_jacobian`` also returns d out /
    d x0 and d out / d x1 (N, win, win), written out."""
    n, big = base_p.shape[:2]
    win = big - 2 * bp
    dev = base_p.device
    x = x.to(torch.float32)
    ix_f = torch.ceil(x) - 1
    f2 = x - ix_f
    start = (bp - ix_f.to(torch.int64) - 1).clamp(0, big - win - 1)
    ar = torch.arange(win + 1, device=dev)
    rows, cols = start[:, :1] + ar, start[:, 1:] + ar
    e = base_p[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    fy, fx = f2[:, 0].reshape(n, 1, 1), f2[:, 1].reshape(n, 1, 1)
    gy, gx = 1.0 - fy, 1.0 - fx
    tmp = fy * e[:, :win] + gy * e[:, 1:]
    out = fx * tmp[:, :, :win] + gx * tmp[:, :, 1:]
    it = torch.arange(win, dtype=torch.float32, device=dev)
    x0, x1 = x[:, 0].reshape(n, 1, 1), x[:, 1].reshape(n, 1, 1)
    inside = (
        ((it[None, :, None] >= x0) & (it[None, :, None] <= (win - 1) + x0))
        & ((it[None, None, :] >= x1) & (it[None, None, :] <= (win - 1) + x1))
    )
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.where(inside, out, zero)
    if not with_jacobian:
        return out
    d = e[:, :win] - e[:, 1:]
    d0 = fx * d[:, :, :win] + gx * d[:, :, 1:]
    d1 = tmp[:, :, :win] - tmp[:, :, 1:]
    return out, torch.where(inside, d0, zero), torch.where(inside, d1, zero)


def _gn_step(x, r, j0, j1, bound: float):
    """One Gauss-Newton update from the residuals and the Jacobian's two
    columns (N, ...) of every source."""
    dims = tuple(range(1, r.ndim))
    a00 = (j0 * j0).sum(dims) + _RIDGE
    a01 = (j0 * j1).sum(dims)
    a11 = (j1 * j1).sum(dims) + _RIDGE
    y0, y1 = (j0 * r).sum(dims), (j1 * r).sum(dims)
    s0, s1 = lu_solve2(a00, a01, a01, a11, y0, y1)
    return torch.clamp(x - torch.stack([s0, s1], -1), -bound, bound)


def register_windowed_plain(band, preds, offsets, bound: float = 3.0, iterations: int = 20, row_lo: int = 0,
                            row_hi: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`register_windowed`: every source at
    once, one loop of ``iterations`` steps."""
    row_hi = band.shape[0] if row_hi is None else row_hi
    fw, base_p, bp = windowed_setup(band, preds.to(torch.float32), offsets.to(torch.float32), bound, row_lo, row_hi)
    x = torch.zeros((preds.shape[0], 2), dtype=torch.float32, device=band.device)
    for _ in range(iterations):
        out, d0, d1 = shift_window(base_p, x, bp, with_jacobian=True)
        x = _gn_step(x, fw - out, -d0, -d1, bound)
    return x


def register_full_plain(band, preds, offsets, bound: float = 3.0, iterations: int = 20) -> torch.Tensor:
    """Plain PyTorch version of :func:`register_full`: each stamp centred
    in a field-sized canvas and shifted by its whole detected offset, then
    the fit over the whole field."""
    f = band.shape[0]
    n, s = preds.shape[:2]
    pos0 = (f - s) // 2
    canvas = torch.zeros((n, f, f), dtype=torch.float32, device=band.device)
    canvas[:, pos0 : pos0 + s, pos0 : pos0 + s] = preds.to(torch.float32)
    base = subpixel_shift(canvas, offsets.to(torch.float32))
    fb = _finite(band)[None]
    x = torch.zeros((n, 2), dtype=torch.float32, device=band.device)
    for _ in range(iterations):
        out, d0, d1 = subpixel_shift(base, x, with_jacobian=True)
        x = _gn_step(x, fb - out, -d0, -d1, bound)
    return x


def _launch_windowed(band, preds, offsets, bound, iterations, row_lo, row_hi):
    h, w = band.shape
    n, s = preds.shape[:2]
    out = torch.empty((n, 2), dtype=torch.float32, device=band.device)
    if n == 0:
        return out
    fn = _build.launcher("registration", "dvt_register_windowed", 4, 9)
    bits = _float_bits(bound)
    status = _build.call(
        fn, band.device, band.data_ptr(), preds.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        n, s, h, w, row_lo, row_hi, math.ceil(bound), bits, iterations,
    )
    _build.check(status, "registration")
    register_windowed.launches += 1
    return out


def _launch_full(band, preds, offsets, bound, iterations):
    f = band.shape[0]
    n, s = preds.shape[:2]
    out = torch.empty((n, 2), dtype=torch.float32, device=band.device)
    if n == 0:
        return out
    fn = _build.launcher("registration", "dvt_register_full", 4, 5)
    status = _build.call(
        fn, band.device, band.data_ptr(), preds.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        n, s, f, _float_bits(bound), iterations,
    )
    _build.check(status, "registration_full")
    register_full.launches += 1
    return out


def _float_bits(v: float) -> int:
    """The float32 bit pattern of ``v`` as a signed int (the launchers take
    ints only)."""
    return int(torch.tensor([v], dtype=torch.float32).view(torch.int32).item())


def _prepare(band, preds, offsets):
    _check(band, preds, offsets)
    return (
        band.to(torch.float32).contiguous(),
        preds.to(torch.float32).contiguous(),
        offsets.to(torch.float32).contiguous(),
    )


def register_windowed(band, preds, offsets, bound: float = 3.0, iterations: int = 20, row_lo: int = 0,
                      row_hi: int | None = None) -> torch.Tensor:
    """(N, 2) float32 shifts, the windowed Gauss-Newton fit of every
    source: band (H, W), preds (N, S, S) predicted stamps, offsets (N, 2)
    detected offsets from the band's centre ((H - S) // 2, (W - S) // 2),
    windows kept inside rows [row_lo, row_hi).  The band must hold a whole
    window: H and W at least :func:`registration_window`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    band, preds, offsets = _prepare(band, preds, offsets)
    row_hi = band.shape[0] if row_hi is None else int(row_hi)
    win = registration_window(preds.shape[1], bound)
    if row_hi - row_lo < win or band.shape[1] < win:
        raise ValueError(f"rows [{row_lo}, {row_hi}) x {band.shape[1]} columns hold no {win}px window")
    if band.device.type == "cpu":
        return register_windowed_plain(band, preds, offsets, bound, iterations, row_lo, row_hi)
    if band.device.type == "cuda":
        return _launch_windowed(band, preds, offsets, bound, iterations, int(row_lo), row_hi)
    raise ValueError(f"unsupported device {band.device}")


register_windowed.launches = 0


def register_full(band, preds, offsets, bound: float = 3.0, iterations: int = 20) -> torch.Tensor:
    """(N, 2) float32 shifts, the full-field Gauss-Newton fit of every
    source on a square band (F, F) with F >= S.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    band, preds, offsets = _prepare(band, preds, offsets)
    if band.shape[0] != band.shape[1] or band.shape[0] < preds.shape[1]:
        raise ValueError(f"the full-field fit takes a square band of at least the stamp, got {tuple(band.shape)}")
    if band.device.type == "cpu":
        return register_full_plain(band, preds, offsets, bound, iterations)
    if band.device.type == "cuda":
        return _launch_full(band, preds, offsets, bound, iterations)
    raise ValueError(f"unsupported device {band.device}")


register_full.launches = 0
