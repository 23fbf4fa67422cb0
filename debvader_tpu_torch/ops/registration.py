"""Subpixel position registration of deblended sources.

Port of debvader_tpu/ops/registration.py: per source, a bounded
Gauss-Newton fit of the (dy, dx) shift that best moves its predicted
r-band stamp onto the field's r band, within +-``bound`` over a fixed
``iterations`` steps from 0.  The fit runs in kernels/registration.py: a
CUDA kernel on a card, its plain PyTorch version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from debvader_tpu_torch.device import resolve_device
from debvader_tpu_torch.kernels.registration import register_full, register_windowed, registration_window

__all__ = [
    "position_optimization",
    "position_optimization_batch",
    "position_optimization_batch_windowed",
    "registration_window",
]


def position_optimization_batch(
    field_band: torch.Tensor,
    pred_bands: torch.Tensor,
    detected_offsets: torch.Tensor,
    bound: float = 3.0,
    iterations: int = 20,
) -> torch.Tensor:
    """(N, 2) shifts clipped to [-bound, bound], fitted over the whole
    square field: field_band (F, F), pred_bands (N, S, S) (not padded),
    detected_offsets (N, 2) from the field centre."""
    return register_full(field_band, pred_bands, detected_offsets, bound, iterations)


def position_optimization_batch_windowed(
    field_band: torch.Tensor,
    pred_bands: torch.Tensor,
    detected_offsets: torch.Tensor,
    bound: float = 3.0,
    iterations: int = 20,
    row_bounds: tuple | None = None,
) -> torch.Tensor:
    """``position_optimization_batch`` on per-source windows of
    :func:`registration_window` pixels: the same fit, O(N x window^2) a step
    instead of O(N x F^2), since the Jacobian is zero outside each source's
    window.  field_band may be rectangular (H, W); offsets are from the
    array centre ((H - S) // 2, (W - S) // 2).  ``row_bounds`` = (lo, hi)
    keeps the windows inside rows [lo, hi).  A field smaller than the
    window takes the full-field fit, which needs a square field and no
    ``row_bounds``."""
    h, w = field_band.shape
    win = registration_window(pred_bands.shape[1], bound)
    if win > min(h, w):
        if row_bounds is not None or h != w:
            raise ValueError(
                f"field ({h}, {w}) is smaller than the {win}px registration window and the "
                f"full-field fallback cannot honor row_bounds / rectangular bands: use a field "
                f"of at least {win}px or a smaller shift bound"
            )
        return register_full(field_band, pred_bands, detected_offsets, bound, iterations)
    lo, hi = (0, h) if row_bounds is None else row_bounds
    return register_windowed(field_band, pred_bands, detected_offsets, bound, iterations, lo, hi)



def position_optimization(
    field_image,
    output_image_mean_padded,
    galaxy_distance_to_center,
    bound: float = 3.0,
    iterations: int = 20,
    detection_band: int = 2,
    device="cuda",
):
    """The reference's single-source signature (optimization.py): the
    (dy, dx) shift, as two floats, that best moves the field-sized padded
    prediction ``output_image_mean_padded`` (F, F, B), shifted by
    ``galaxy_distance_to_center``, onto ``field_image``'s (F, F, B) band
    ``detection_band``.

    The full-field fit of :func:`position_optimization_batch` with the
    padded prediction as the stamp (S = F, so it is placed at the origin):
    the bilinear shift splits the sample position by ``floor`` and its
    Jacobian is written out, one-sided at the knots (kernels/registration.py).
    Non-finite field pixels count as 0.  On a card the full-field kernel
    stages three field-sized planes in shared memory, so F is at most 137
    there; the CPU takes any F."""
    dev = resolve_device(device)

    def band(a):
        a = np.asarray(a, np.float32)
        return torch.as_tensor(np.ascontiguousarray(a[..., detection_band]), device=dev)

    field, pred = band(field_image), band(output_image_mean_padded)
    offsets = torch.as_tensor(np.asarray(galaxy_distance_to_center, np.float32).reshape(1, 2), device=dev)
    out = register_full(field, pred[None], offsets, bound, iterations)[0].cpu().numpy()
    return float(out[0]), float(out[1])
