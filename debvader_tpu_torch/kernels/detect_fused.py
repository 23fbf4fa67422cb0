"""Fused matched filter + threshold + watershed parents: CUDA kernel and
plain version.

Port of the Pallas kernel debvader_tpu/kernels/detect_fused.py
(matched_filter_parents).  For a stack of fields (T, F, F):

- filt = the 7x7 matched filter of image - background, zero outside the
  field (SAME padding), each product and sum rounded on its own: for a
  separable (rank-1) filter down the rows with wy, then along the columns
  with wx; else all 49 taps in row-major order;
- mask = filt > threshold[t];
- the steepest-ascent race over the 3x3 neighbourhood with (value, -index)
  tie-break, neighbours in (dy, dx) row-major order, masked-out and
  out-of-field pixels at -inf: dir_code (0..8, 4 = self) and the parent's
  per-field flat index.  Unmasked pixels carry dir_code 4 and parent 0.

The CUDA kernel (csrc/detect_fused.cu) is bound by bytes: it reads the
image and background once and writes the three maps once; a block stages
its 32x64 tile's 40x72 window in shared memory with cp.async and takes the
taps as a by-value parameter (:func:`host_taps`).  filt, dir_code and
parent are bit-identical to the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from debvader_tpu_torch.kernels import _build

__all__ = [
    "separate",
    "separable_filter",
    "full_filter",
    "filter_taps",
    "apply_filter",
    "parent_race",
    "matched_filter_parents",
    "matched_filter_parents_plain",
]

_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def separate(kernel: np.ndarray):
    """Rank-1 decomposition (wy, wx) of a 7x7 filter, or None when the
    filter is not separable (same rule as the JAX package)."""
    u, s, vt = np.linalg.svd(np.asarray(kernel, np.float32))
    if s[1] > 1e-4 * s[0]:
        return None
    wy = u[:, 0] * np.sqrt(s[0])
    wx = vt[0] * np.sqrt(s[0])
    if wy.sum() < 0:
        wy, wx = -wy, -wx
    return wy.astype(np.float32), wx.astype(np.float32)


def filter_taps(kernel: np.ndarray):
    """(separable, taps) of a 7x7 filter: wy then wx (14 values) when it is
    rank 1, else its 49 values in row-major order."""
    kernel = np.asarray(kernel, np.float32)
    if kernel.shape != (7, 7):
        raise ValueError("the matched-filter kernels expect a 7x7 filter")
    sep = separate(kernel)
    if sep is None:
        return False, np.ascontiguousarray(kernel.reshape(-1))
    return True, np.concatenate(sep)


def separable_filter(fore: torch.Tensor, wy: np.ndarray, wx: np.ndarray) -> torch.Tensor:
    """SAME 7x7 separable filter of (T, F, F): rows with wy, then columns
    with wx, accumulated from 0 in tap order."""
    t, f, _ = fore.shape
    p = F.pad(fore, (3, 3, 3, 3))
    tmp = torch.zeros((t, f, f + 6), dtype=fore.dtype, device=fore.device)
    for dy in range(7):
        tmp = tmp + float(wy[dy]) * p[:, dy : dy + f, :]
    out = torch.zeros((t, f, f), dtype=fore.dtype, device=fore.device)
    for dx in range(7):
        out = out + float(wx[dx]) * tmp[:, :, dx : dx + f]
    return out


def full_filter(fore: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """SAME 7x7 filter of (T, F, F) with all 49 taps, accumulated from 0 in
    row-major tap order."""
    t, f, _ = fore.shape
    p = F.pad(fore, (3, 3, 3, 3))
    out = torch.zeros((t, f, f), dtype=fore.dtype, device=fore.device)
    for dy in range(7):
        for dx in range(7):
            out = out + float(kernel[dy, dx]) * p[:, dy : dy + f, dx : dx + f]
    return out


def apply_filter(fore: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """The plain 7x7 filter of (T, F, F): separable when the filter is
    rank 1, else the 49 taps."""
    separable, taps = filter_taps(kernel)
    if separable:
        return separable_filter(fore, taps[:7], taps[7:])
    return full_filter(fore, taps.reshape(7, 7))


def parent_race(filt: torch.Tensor, thresholds: torch.Tensor):
    """(dir_code, parent) int32 (T, F, F) from filtered fields and (T,)
    thresholds."""
    t, f, _ = filt.shape
    mask = filt > thresholds.reshape(t, 1, 1)
    neg_inf = torch.tensor(float("-inf"), dtype=filt.dtype, device=filt.device)
    val = torch.where(mask, filt, neg_inf)
    idx = torch.arange(f * f, dtype=torch.int32, device=filt.device).reshape(1, f, f)
    vp = F.pad(val, (1, 1, 1, 1), value=float("-inf"))
    ip = F.pad(idx, (1, 1, 1, 1), value=-1)
    best_v, best_i = val, idx.expand(t, f, f)
    best_c = torch.full((t, f, f), 4, dtype=torch.int32, device=filt.device)
    for code, (dy, dx) in enumerate(_OFFSETS):
        if code == 4:
            continue
        nv = vp[:, 1 + dy : 1 + dy + f, 1 + dx : 1 + dx + f]
        ni = ip[:, 1 + dy : 1 + dy + f, 1 + dx : 1 + dx + f]
        better = (nv > best_v) | ((nv == best_v) & (ni < best_i))
        best_v = torch.where(better, nv, best_v)
        best_i = torch.where(better, ni, best_i)
        best_c = torch.where(better, torch.tensor(code, dtype=torch.int32, device=filt.device), best_c)
    dir_code = torch.where(mask, best_c, torch.full_like(best_c, 4))
    parent = torch.where(mask, best_i, torch.zeros_like(best_i))
    return dir_code, parent


def matched_filter_parents_plain(images, backgrounds, kernel, thresholds):
    """Plain PyTorch version of :func:`matched_filter_parents`."""
    filt = apply_filter(images - backgrounds, kernel)
    dir_code, parent = parent_race(filt, thresholds)
    return filt, dir_code, parent


_host_taps: dict = {}


def host_taps(kernel: np.ndarray):
    """(separable, taps as a ctypes float array) of :func:`filter_taps`, for
    the kernel's by-value tap parameter: decomposed once per filter, looked
    up by the filter's bytes (so a filter edited in place is decomposed
    again)."""
    key = np.asarray(kernel, np.float32).tobytes()
    entry = _host_taps.get(key)
    if entry is None:
        separable, taps = filter_taps(kernel)
        entry = (separable, (ctypes.c_float * taps.size)(*taps.tolist()))
        _host_taps[key] = entry
    return entry


def _launch(images, backgrounds, kernel, thresholds):
    t, f, _ = images.shape
    if f * f >= 2**31:
        raise ValueError("fields of 2^31 pixels or more overflow the int32 parent index")
    separable, taps = host_taps(kernel)
    fn = _build.launcher("detect_fused", "dvt_detect_fused", 7, 3)
    filt = torch.empty_like(images)
    dir_code = torch.empty(images.shape, dtype=torch.int32, device=images.device)
    parent = torch.empty_like(dir_code)
    status = _build.call(
        fn, images.device,
        images.data_ptr(), backgrounds.data_ptr(), thresholds.data_ptr(), ctypes.addressof(taps),
        filt.data_ptr(), dir_code.data_ptr(), parent.data_ptr(), t, f, int(separable),
    )
    _build.check(status, "detect_fused")
    matched_filter_parents.launches += 1
    return filt, dir_code, parent


def matched_filter_parents(
    images: torch.Tensor,
    backgrounds: torch.Tensor,
    kernel: np.ndarray,
    thresholds: torch.Tensor,
):
    """(filt float32, dir_code int32, parent int32), each (T, F, F).

    images, backgrounds: (T, F, F) float32 (non-finite pixels already set
    to the background); kernel: the 7x7 matched filter (separable or not);
    thresholds: (T,) float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if images.ndim != 3 or images.shape[1] != images.shape[2]:
        raise ValueError(f"images must be a (T, F, F) stack, got {tuple(images.shape)}")
    if backgrounds.shape != images.shape or thresholds.shape != images.shape[:1]:
        raise ValueError("backgrounds must match images and thresholds be (T,)")
    images = images.to(torch.float32).contiguous()
    backgrounds = backgrounds.to(torch.float32).contiguous()
    thresholds = thresholds.to(torch.float32).contiguous()
    if images.device.type == "cpu":
        return matched_filter_parents_plain(images, backgrounds, kernel, thresholds)
    if images.device.type == "cuda":
        return _launch(images, backgrounds, kernel, thresholds)
    raise ValueError(f"unsupported device {images.device}")


matched_filter_parents.launches = 0
