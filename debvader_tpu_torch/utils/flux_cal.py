"""Photometric calibration of reduced-precision serving arithmetic.

Port of debvader_tpu/utils/flux_cal.py.  A truncating limb scheme (bf16x3t,
the limb form of ``matmul_precision='high'``) drops a product that has the
sign of x * w, so every contraction underestimates magnitudes: a stable
multiplicative flux bias per band.  This module measures the model's
per-band flux gain against the forward of the same weights at the
``'highest'`` rung on simulated stamps, once at load, and divides it back
out of the served distribution.

The gain lives on the model as the buffer ``flux_cal_scale`` (bands,), so
it follows ``state_dict()``; without it :func:`apply_flux_calibration` is a
no-op.  Under the native rungs without ``limb_emulation`` both forwards are
the same float32 arithmetic and the gain is 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from debvader_tpu_torch.device import fp32_math
from debvader_tpu_torch.models.distributions import PixelNormal

__all__ = [
    "flux_gain",
    "compute_flux_calibration",
    "attach_flux_calibration",
    "apply_flux_calibration",
]


def _reference_model(model):
    """The same weights (shared, not copied) in float32 at the 'highest'
    rung with no per-layer overrides."""
    from debvader_tpu_torch.models.vae import DeblenderVAE

    cfg = dataclasses.replace(model.cfg, dtype="float32", matmul_precision="highest", layer_precision=None)
    ref = DeblenderVAE(cfg)
    weights = {k: v for k, v in model.state_dict().items() if k != "flux_cal_scale"}
    ref.load_state_dict(weights, assign=True)
    return ref.eval()


@torch.no_grad()
def flux_gain(model, stamps) -> torch.Tensor:
    """Per-band flux gain (B,) of ``model``'s forward against its reference
    forward on the given (N, S, S, B) stamps.  ``z_mode='mean'``, so the
    measurement is deterministic: the gain is a property of the layers'
    arithmetic, not of the latent draw."""
    device = model.encoder.bn.scale.device
    x = torch.as_tensor(np.asarray(stamps, np.float32), device=device)
    ref_model = _reference_model(model)
    with fp32_math():
        loc = model(x, z_mode="mean")[0].loc
        ref = ref_model(x, z_mode="mean")[0].loc
    return loc.sum(dim=(0, 1, 2)) / ref.sum(dim=(0, 1, 2))


def compute_flux_calibration(model, n: int = 128, seed: int = 11) -> torch.Tensor:
    """:func:`flux_gain` on ``n`` simulated blended stamps made from
    ``seed`` (data/simulate.py)."""
    from debvader_tpu_torch.data.simulate import simulate_batch

    cfg = model.cfg
    stamps = simulate_batch(seed, n, stamp=cfg.stamp_size, bands=cfg.nb_of_bands)[0]
    return flux_gain(model, stamps)


def attach_flux_calibration(model, scale=None, **kw):
    """Set ``model.flux_cal_scale`` to ``scale`` (bands,), or to
    ``compute_flux_calibration(model, **kw)`` when None; returns the
    model."""
    if scale is None:
        scale = compute_flux_calibration(model, **kw)
    device = model.encoder.bn.scale.device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(-1)
    if scale.numel() != model.cfg.nb_of_bands:
        raise ValueError(f"scale must have {model.cfg.nb_of_bands} entries, got {scale.numel()}")
    model.flux_cal_scale = scale
    return model


def apply_flux_calibration(dist: PixelNormal, model) -> PixelNormal:
    """Divide the calibrated gain out of a served distribution (no-op
    without a calibration).  Both loc and scale divide: a multiplicative
    gain of the arithmetic affects the whole distribution."""
    scale = getattr(model, "flux_cal_scale", None)
    if scale is None:
        return dist
    s = scale.to(dist.loc.dtype)
    return PixelNormal(dist.loc / s, dist.scale / s)
