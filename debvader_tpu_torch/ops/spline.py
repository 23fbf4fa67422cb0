"""Cubic B-spline (order 3) subpixel shift with scipy.ndimage semantics,
batched over sources.

- Prefilter: the causal/anticausal pole filter (z = sqrt(3) - 2) with
  scipy's closed-form mirror-boundary init, along W then H.
- Constant-shift interpolation: with the fractional shift f in [0, 1) the
  same at every pixel, the 4x4 tap gather collapses into 5 + 5 separable
  shifted slices with scalar weights B3(k + f), k = -2..2, over the
  mirror-padded coefficients; sample positions left of 0 give 0
  (mode='constant').
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["spline_prefilter", "subpixel_shift_spline_const"]

_POLE = float(np.sqrt(3.0) - 2.0)


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
    cp = [torch.tensordot(c, torch.as_tensor(w, dtype=c.dtype, device=c.device), dims=([-1], [0]))]
    for i in range(1, n):
        cp.append(c[..., i] + z * cp[-1])
    cm = [None] * n
    cm[n - 1] = (z / (z * z - 1.0)) * (cp[n - 1] + z * cp[n - 2])
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
    inner = (4.0 - 6.0 * a * a + 3.0 * a * a * a) / 6.0
    outer = torch.where(a < 2.0, (2.0 - a) ** 3 / 6.0, torch.zeros_like(a))
    return torch.where(a < 1.0, inner, outer)


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
    tmp = 0.0
    for k in range(-2, 3):
        tmp = tmp + _bspline3(k + fy) * coef_p[:, 2 + k : 2 + k + h, :, :]
    out = 0.0
    for k in range(-2, 3):
        out = out + _bspline3(k + fx) * tmp[:, :, 2 + k : 2 + k + w, :]
    rows = torch.arange(h, dtype=torch.float32, device=img.device).reshape(1, h, 1, 1)
    cols = torch.arange(w, dtype=torch.float32, device=img.device).reshape(1, 1, w, 1)
    return torch.where((rows >= fy) & (cols >= fx), out, torch.zeros((), dtype=out.dtype, device=out.device))
