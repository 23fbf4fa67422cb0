"""Steepest-ascent parent race of the detection chain: CUDA kernel and
plain version.

The chain of ``ops/detection._detect_core`` filters a field on its own
(the stand-alone matched-filter kernel or ``F.conv2d``), then runs the
race that the fused core (kernels/detect_fused.py) runs inside its kernel.
The JAX package computes it in XLA; this is the port's kernel for it.  For
filtered fields (T, F, F) and thresholds (T,):

- mask = filt > threshold[t]; masked-out and out-of-field pixels are -inf;
- each masked pixel's parent is the best of itself and its 8 neighbours
  in (value, -index) order, neighbours taken in (dy, dx) row-major order;
  dir_code is its position (dy + 1) * 3 + (dx + 1), 4 = self.  Unmasked
  pixels carry dir_code 4 and parent 0.

The plain version is ``detect_fused.parent_race`` (40 device kernels and 9
one-scalar uploads a call on an H100).  The CUDA kernel
(csrc/parent_race.cu) is bound by bytes: it reads filt once and writes
dir_code and parent once, and is bit-identical to the plain version.
"""

from __future__ import annotations

import torch

from debvader_tpu_torch.kernels import _build
from debvader_tpu_torch.kernels.detect_fused import parent_race

__all__ = ["parent_race_kernel", "parent_race"]


def _launch(filt, thresholds):
    t, f, _ = filt.shape
    if f * f >= 2**31:
        raise ValueError("fields of 2^31 pixels or more overflow the int32 parent index")
    fn = _build.launcher("parent_race", "dvt_parent_race", 4, 2)
    # one allocation for both int32 maps
    out = torch.empty((2, t, f, f), dtype=torch.int32, device=filt.device)
    dir_code, parent = out[0], out[1]
    status = _build.call(
        fn, filt.device, filt.data_ptr(), thresholds.data_ptr(), dir_code.data_ptr(), parent.data_ptr(), t, f,
    )
    _build.check(status, "parent_race")
    parent_race_kernel.launches += 1
    return dir_code, parent


def parent_race_kernel(filt: torch.Tensor, thresholds: torch.Tensor):
    """(dir_code, parent) int32 (T, F, F) from filtered fields (T, F, F)
    and thresholds (T,) on the same device.  CPU tensors take the plain
    version (``parent_race``); CUDA tensors launch the kernel."""
    if filt.ndim != 3 or filt.shape[1] != filt.shape[2]:
        raise ValueError(f"filt must be a (T, F, F) stack, got {tuple(filt.shape)}")
    if tuple(thresholds.shape) != (filt.shape[0],):
        raise ValueError(f"thresholds must be ({filt.shape[0]},), got {tuple(thresholds.shape)}")
    if thresholds.device != filt.device:
        raise ValueError("thresholds must lie on filt's device")
    filt = filt.to(torch.float32).contiguous()
    thresholds = thresholds.to(torch.float32).contiguous()
    if filt.device.type == "cpu":
        return parent_race(filt, thresholds)
    if filt.device.type == "cuda":
        return _launch(filt, thresholds)
    raise ValueError(f"unsupported device {filt.device}")


parent_race_kernel.launches = 0
