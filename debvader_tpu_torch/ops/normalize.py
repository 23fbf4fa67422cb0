"""Flux normalization: tanh(arcsinh(x)) in, its exact inverse out, and the
delta-method push of a PixelNormal through the inverse (the intended
behaviour of the reference's ``normalise=True`` path)."""

from __future__ import annotations

import torch

from debvader_tpu_torch.models.distributions import PixelNormal

__all__ = [
    "normalize_non_linear",
    "denormalize_non_linear",
    "denormalize_distribution",
]


def normalize_non_linear(images: torch.Tensor) -> torch.Tensor:
    return torch.tanh(torch.asinh(images))


def denormalize_non_linear(images_normed: torch.Tensor) -> torch.Tensor:
    return torch.sinh(torch.atanh(images_normed))


def denormalize_distribution(dist: PixelNormal) -> PixelNormal:
    """Mean through the inverse map; stddev by the delta method,
    |d sinh(artanh(u))/du| = cosh(artanh(u)) / (1 - u^2) at the mean."""
    u = torch.clamp(dist.loc, -1.0 + 1e-7, 1.0 - 1e-7)
    mean = torch.sinh(torch.atanh(u))
    jac = torch.cosh(torch.atanh(u)) / (1.0 - torch.square(u))
    return PixelNormal(mean, dist.scale * jac)
