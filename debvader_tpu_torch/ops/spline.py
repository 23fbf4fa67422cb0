"""Cubic B-spline (order 3) subpixel shift with scipy.ndimage semantics,
batched over sources.

- Prefilter: the causal/anticausal pole filter (z = sqrt(3) - 2) with
  scipy's closed-form mirror-boundary init, along W then H.
- Constant-shift interpolation: with the fractional shift f in [0, 1) the
  same at every pixel, the 4x4 tap gather collapses into 5 + 5 separable
  shifted slices with scalar weights B3(k + f), k = -2..2, over the
  mirror-padded coefficients; sample positions left of 0 give 0
  (mode='constant').

The arithmetic follows the order in which XLA's CPU backend compiles the
JAX package's jitted, vmapped ``subpixel_shift_spline_const`` (its
optimized HLO and the machine code of each fusion), so that the two agree
bit for bit on a line of 43 or more pixels (every order-3 patch of a
stamp of 23 pixels or more; scripts/spline_fma_probe.py):

- the causal initial value is a dot product that LLVM vectorizes 8 lanes
  wide in 4 interleaved accumulators, then 4 lanes wide, then one by one,
  each step a fused multiply-add (``_xla_cpu_dot``);
- the causal recurrence and the anticausal initial value are fused
  multiply-adds, the anticausal recurrence is not;
- the B-spline weights' polynomial contracts into two fused
  multiply-adds, and their division by 6 is a multiply by 1/6;
- each 5-tap combine starts from the second tap's product and adds the
  first tap's, then the others, by fused multiply-adds.

A fused multiply-add is computed in float64 and rounded once to float32:
the float32 product is exact there, so only the add rounds, as in an FMA
(a double rounding can differ from it in the last bit; rare).  The same
torch ops run on the CPU and on a card.

The generic shift of one image, ``subpixel_shift_spline`` (the JAX
package's reference-signature function, which compat.py exposes), is bit
for bit the jitted JAX function on images of 50 px or more a side (below
that, XLA's dot for this unbatched layout runs in another order, and the
two agree to float32 rounding): its cubic weights are plain float32 ops except ``4 - 6 t^2``, one
fused multiply-add, and a multiply by 1/6; each 4-tap combine starts from
the second tap's product and adds the first tap's, then the others, by
fused multiply-adds (found by trying each contraction in turn against
jitted JAX; tests/test_torch_compat.py holds it on four image shapes).

The order is XLA's choice, not the algorithm's: it is the one that
jaxlib 0.9.0 compiles on an x86-64 host with AVX-512, where XLA's CPU
backend vectorizes the dot 256 bits (8 float32 lanes) wide.  Another vector width or another
XLA version can change that order, and then the two agree only to the
float32 rounding of each op.  The emulation costs time on a card: one
shift of 295 stamps of 79²×6 took 16.9 ms, against 10.7 ms for the plain
float32 order it replaced, on an NVIDIA H100 80GB HBM3 at 700 W
(scripts/ab_spline_order3.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["spline_prefilter", "subpixel_shift_spline_const", "subpixel_shift_spline"]

_POLE = float(np.sqrt(3.0) - 2.0)
# the float32 constants XLA computes with
_POLE32 = float(np.float32(_POLE))
_SIXTH32 = float(np.float32(1.0 / 6.0))


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (``b`` a tensor or a float32
    scalar)."""
    if isinstance(b, torch.Tensor):
        return torch.addcmul(c.double(), a.double(), b.double()).float()
    return torch.add(c.double(), a.double(), alpha=b).float()


def _xla_cpu_dot(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k c[..., k] w[k] in the order of XLA's CPU loop for the
    prefilter's fused dot: lanes of 8 in 4 accumulators over each 32
    elements (the first accumulator in order, the others reassociated last
    iteration first), the 8 lanes reduced as ((0+4)+(2+6))+((1+5)+(3+7));
    then lanes of 4 starting from that sum, reduced as (0+2)+(1+3); then
    the last elements one by one."""
    n = c.shape[-1]
    shp = c.shape[:-1]
    iters = n // 32
    r = None
    if iters:
        acc = None
        for j in range(4):
            groups = [4 * i + j for i in range(iters)]
            for g in groups if j == 0 else groups[::-1]:
                blk, wb = c[..., 8 * g : 8 * g + 8], w[8 * g : 8 * g + 8].expand(shp + (8,))
                acc = blk * wb if acc is None else _fma(blk, wb, acc)
        a = acc[..., 0:4] + acc[..., 4:8]
        r = (a[..., 0] + a[..., 2]) + (a[..., 1] + a[..., 3])
    k0 = 32 * iters
    quads = (n - k0) // 4
    if quads:
        m = torch.full(shp + (4,), -0.0, dtype=c.dtype, device=c.device)
        m[..., 0] = 0.0 if r is None else r
        for q in range(quads):
            s = k0 + 4 * q
            m = _fma(c[..., s : s + 4], w[s : s + 4].expand(shp + (4,)), m)
        r = (m[..., 0] + m[..., 2]) + (m[..., 1] + m[..., 3])
        k0 += 4 * quads
    for k in range(k0, n):
        r = c[..., k] * w[k] if r is None else _fma(c[..., k], w[k].expand(shp), r)
    return r


def _prefilter_last_axis(x: torch.Tensor) -> torch.Tensor:
    """B-spline coefficients along the last axis (mirror boundary)."""
    z = _POLE
    n = x.shape[-1]
    c = 6.0 * x
    # cp[0] = (c[0] + z^(n-1) c[n-1] + sum_m (z^m + z^(2n-2-m)) c[m])
    #         / (1 - z^(2n-2))
    k = np.arange(n)
    w = np.power(z, k) + np.power(z, 2 * n - 2 - k)
    w[0] = 1.0
    w[n - 1] = z ** (n - 1)
    w = w / (1.0 - z ** (2 * n - 2))
    cp = [_xla_cpu_dot(c, torch.as_tensor(w, dtype=c.dtype, device=c.device))]
    c64 = c.double()
    for i in range(1, n):
        # _fma(cp[-1], z, c[..., i]) with c in float64 once
        cp.append(torch.add(c64[..., i], cp[-1].double(), alpha=_POLE32).float())
    cm = [None] * n
    cm[n - 1] = (z / (z * z - 1.0)) * _fma(cp[n - 2], _POLE32, cp[n - 1])
    for i in range(n - 2, -1, -1):
        cm[i] = z * (cm[i + 1] - cp[i])
    return torch.stack(cm, dim=-1)


def spline_prefilter(img: torch.Tensor) -> torch.Tensor:
    """Spline coefficients of (..., H, W, C) images: filter W, then H."""
    c = _prefilter_last_axis(torch.movedim(img, -1, -3))  # (..., C, H, W)
    c = _prefilter_last_axis(c.transpose(-1, -2))  # (..., C, W, H)
    return torch.movedim(c.transpose(-1, -2), -3, -1)


def _bspline3(d: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline basis at distance d."""
    a = torch.abs(d)
    # 4 - 6 a^2 + 3 a^3, contracted as XLA's CPU backend contracts it
    inner = _fma((a * 3.0) * a, a, _fma(-(a * 6.0), a, torch.full_like(a, 4.0)))
    t = 2.0 - a
    outer = torch.where(a < 2.0, ((t * t) * t) * _SIXTH32, torch.zeros_like(a))
    return torch.where(a < 1.0, inner * _SIXTH32, outer)


def _taps(weights, slices) -> torch.Tensor:
    """sum_k weights[k] * slices[k] in XLA's contraction order."""
    acc = _fma(weights[0].expand_as(slices[0]), slices[0], weights[1] * slices[1])
    for wk, sl in zip(weights[2:], slices[2:]):
        acc = _fma(wk.expand_as(sl), sl, acc)
    return acc


def subpixel_shift_spline_const(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.shift(img[n], shift[n], order=3, mode='constant') for
    (N, H, W, C) images and per-image shifts (N, 2) with fractional parts
    in [0, 1)."""
    n, h, w, _ = img.shape
    coef = spline_prefilter(img)
    # mirror without edge repeat, on H and W
    coef_p = F.pad(coef.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="reflect").permute(0, 2, 3, 1)
    fy = shift[:, 0].reshape(n, 1, 1, 1)
    fx = shift[:, 1].reshape(n, 1, 1, 1)
    ks = range(-2, 3)
    tmp = _taps([_bspline3(k + fy) for k in ks], [coef_p[:, 2 + k : 2 + k + h, :, :] for k in ks])
    out = _taps([_bspline3(k + fx) for k in ks], [tmp[:, :, 2 + k : 2 + k + w, :] for k in ks])
    rows = torch.arange(h, dtype=torch.float32, device=img.device).reshape(1, h, 1, 1)
    cols = torch.arange(w, dtype=torch.float32, device=img.device).reshape(1, 1, w, 1)
    return torch.where((rows >= fy) & (cols >= fx), out, torch.zeros((), dtype=out.dtype, device=out.device))


def _bspline3_weights(t: torch.Tensor):
    """Cubic B-spline weights of the taps at -1, 0, 1, 2 from floor(pos),
    t = frac(pos) in [0, 1), in XLA's contraction of JAX's polynomial."""
    t2 = t * t
    t3 = t2 * t
    one = torch.ones_like(t)
    w0 = ((1.0 - 3.0 * t) + 3.0 * t2 - t3) * _SIXTH32
    w1 = (_fma(t2, -6.0, 4.0 * one) + 3.0 * t3) * _SIXTH32
    w2 = ((1.0 + 3.0 * t) + 3.0 * t2 - 3.0 * t3) * _SIXTH32
    return w0, w1, w2, t3 * _SIXTH32


def _combine(weights, values) -> torch.Tensor:
    """sum_k weights[k] * values[k] in XLA's contraction order."""
    acc = _fma(weights[0], values[0], weights[1] * values[1])
    for wk, vk in zip(weights[2:], values[2:]):
        acc = _fma(wk, vk, acc)
    return acc


def _mirror(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect indices into [0, n - 1] (period 2 (n - 1), no edge repeat)."""
    idx = idx.abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def subpixel_shift_spline(img: torch.Tensor, shift) -> torch.Tensor:
    """scipy.ndimage.shift(img, shift, order=3, mode='constant') of one
    (H, W) or (H, W, C) float32 image by a (2,) shift: out[i, j] is the
    spline of img at (i - dy, j - dx), 0 where that point leaves the
    image."""
    img = torch.as_tensor(img, dtype=torch.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, _ = img.shape
    dev = img.device
    shift = torch.as_tensor(shift, dtype=torch.float32, device=dev)
    coef = spline_prefilter(img)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w) - shift[0]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w) - shift[1]
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy = [q[..., None] for q in _bspline3_weights(yy - y0)]
    wx = [q[..., None] for q in _bspline3_weights(xx - x0)]
    yi, xi = y0.to(torch.int64), x0.to(torch.int64)
    cols = [_mirror(xi + (b - 1), w) for b in range(4)]
    rows = [_combine(wx, [coef[_mirror(yi + (a - 1), h), col] for col in cols]) for a in range(4)]
    out = _combine(wy, rows)
    inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
    out = torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype, device=dev))
    return out[..., 0] if squeeze else out
