"""Fused matched filter + threshold + watershed parents: CUDA kernel and
plain version.

Port of the Pallas kernel debvader_tpu/kernels/detect_fused.py
(matched_filter_parents).  For a stack of fields (T, F, F):

- filt = the separable 7x7 matched filter of image - background, down the
  rows with wy, then along the columns with wx, each product and sum
  rounded on its own, zero outside the field (SAME padding);
- mask = filt > threshold[t];
- the steepest-ascent race over the 3x3 neighbourhood with (value, -index)
  tie-break, neighbours in (dy, dx) row-major order, masked-out and
  out-of-field pixels at -inf: dir_code (0..8, 4 = self) and the parent's
  per-field flat index.  Unmasked pixels carry dir_code 4 and parent 0.

The CUDA kernel (csrc/detect_fused.cu) is bound by bytes: it reads the
image and background once and writes the three maps once, staging each
32x32 tile's 40x40 window in shared memory.  filt is bit-identical to the
plain version; dir_code and parent are bit-identical to the plain race
on the same filt.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from debvader_tpu_torch.kernels import _build

__all__ = [
    "separate",
    "separable_filter",
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


def _taps(kernel: np.ndarray):
    kernel = np.asarray(kernel, np.float32)
    if kernel.shape != (7, 7):
        raise ValueError("the detect core expects a 7x7 filter")
    sep = separate(kernel)
    if sep is None:
        raise ValueError("the detect core takes a separable (rank-1) filter only")
    return sep


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
    wy, wx = _taps(kernel)
    filt = separable_filter(images - backgrounds, wy, wx)
    dir_code, parent = parent_race(filt, thresholds)
    return filt, dir_code, parent


_device_taps: dict = {}


def _taps_on(kernel: np.ndarray, device) -> torch.Tensor:
    """wy then wx as a (14,) device tensor, decomposed and uploaded once
    per (filter, device)."""
    key = (np.asarray(kernel, np.float32).tobytes(), str(device))
    taps = _device_taps.get(key)
    if taps is None:
        taps = torch.as_tensor(np.concatenate(_taps(kernel)), device=device)
        _device_taps[key] = taps
    return taps


def _launch(images, backgrounds, kernel, thresholds):
    t, f, _ = images.shape
    if f * f >= 2**31:
        raise ValueError("fields of 2^31 pixels or more overflow the int32 parent index")
    taps = _taps_on(kernel, images.device)
    fn = _build.launcher("detect_fused", "dvt_detect_fused", 7, 2)
    filt = torch.empty_like(images)
    dir_code = torch.empty(images.shape, dtype=torch.int32, device=images.device)
    parent = torch.empty_like(dir_code)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        status = fn(
            images.data_ptr(), backgrounds.data_ptr(), thresholds.data_ptr(),
            taps.data_ptr(), filt.data_ptr(), dir_code.data_ptr(),
            parent.data_ptr(), t, f, stream,
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
    to the background); kernel: the 7x7 separable matched filter;
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
