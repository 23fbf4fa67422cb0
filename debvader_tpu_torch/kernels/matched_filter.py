"""Stand-alone matched filter + threshold: CUDA kernel and plain version.

Port of the Pallas kernel debvader_tpu/kernels/matched_filter.py
(matched_filter_threshold), the filter backend of single-field detection
that ``DetectionConfig.use_pallas_filter`` selects.  For one field (F, F):

- filt = the 7x7 matched filter of image - background with SAME zero
  padding, separable (rows with wy, then columns with wx) when the filter
  is rank 1, else all 49 taps in row-major order, each product and sum
  rounded on its own;
- mask = filt > threshold.

The CUDA kernel (csrc/matched_filter.cu) is bound by bytes: it reads the
image and the background once and writes filt and a one-byte mask once,
staging each 32x32 tile's 38x38 window in shared memory.  filt is
bit-identical to the plain version, and the mask is ``filt > threshold`` of
that filt; a pixel whose filt sits within an ulp of the threshold can
still differ from a convolution library's answer, which sums in another
order.
"""

from __future__ import annotations

import numpy as np
import torch

from debvader_tpu_torch.kernels import _build
from debvader_tpu_torch.kernels.detect_fused import apply_filter, taps_on

__all__ = ["matched_filter_threshold", "matched_filter_threshold_plain"]


def matched_filter_threshold_plain(image, background, kernel, threshold):
    """Plain PyTorch version of :func:`matched_filter_threshold`."""
    filt = apply_filter((image - background)[None], kernel)[0]
    return filt, filt > threshold


def _launch(image, background, kernel, threshold):
    f = image.shape[0]
    separable, taps = taps_on(kernel, image.device)
    fn = _build.launcher("matched_filter", "dvt_matched_filter", 6, 2)
    filt = torch.empty_like(image)
    mask = torch.empty(image.shape, dtype=torch.bool, device=image.device)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        status = fn(
            image.data_ptr(), background.data_ptr(), threshold.data_ptr(),
            taps.data_ptr(), filt.data_ptr(), mask.data_ptr(), f, int(separable), stream,
        )
    _build.check(status, "matched_filter")
    matched_filter_threshold.launches += 1
    return filt, mask


def matched_filter_threshold(
    image: torch.Tensor,
    background: torch.Tensor,
    kernel: np.ndarray,
    threshold,
):
    """(filt float32 (F, F), mask bool (F, F)).

    image, background: (F, F) float32 (non-finite pixels already set to the
    background); kernel: the 7x7 matched filter; threshold: a float or a
    one-element tensor on the image's device.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if image.ndim != 2 or image.shape[0] != image.shape[1]:
        raise ValueError(f"image must be a square (F, F) field, got {tuple(image.shape)}")
    if background.shape != image.shape:
        raise ValueError("background must match image")
    image = image.to(torch.float32).contiguous()
    background = background.to(torch.float32).contiguous()
    threshold = torch.as_tensor(threshold, dtype=torch.float32, device=image.device).reshape(1)
    if image.device.type == "cpu":
        return matched_filter_threshold_plain(image, background, kernel, threshold)
    if image.device.type == "cuda":
        return _launch(image, background, kernel, threshold)
    raise ValueError(f"unsupported device {image.device}")


matched_filter_threshold.launches = 0
