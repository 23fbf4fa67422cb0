"""Stamp-level deblending: the batched VAE forward.

``deblend(net, images)`` mirrors debvader_tpu.api.deblend: non-finite
pixels enter the network as 0, ``normalise=True`` brackets the forward with
tanh(arcsinh) in and the delta-method inverse out, and the result is
(mean images as numpy, output distribution on the device).  Eager PyTorch
needs no batch-size buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from debvader_tpu_torch.device import fp32_math, resolve_device
from debvader_tpu_torch.models.distributions import PixelNormal
from debvader_tpu_torch.models.vae import DeblenderVAE
from debvader_tpu_torch.ops.normalize import (
    denormalize_distribution,
    normalize_non_linear,
)

__all__ = ["deblend", "deblend_tensor"]


@torch.no_grad()
def deblend_tensor(
    net: DeblenderVAE,
    x: torch.Tensor,
    normalise: bool = False,
    generator: torch.Generator | None = None,
    z_mode: str = "sample",
) -> PixelNormal:
    """The forward on a (N, S, S, B) float32 tensor already on the model's
    device; returns the PixelNormal there."""
    x = torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))
    if normalise:
        x = normalize_non_linear(x)
    with fp32_math():
        dist, _ = net(x, generator=generator, z_mode=z_mode)
    if normalise:
        dist = denormalize_distribution(dist)
    return dist


def deblend(
    net: DeblenderVAE,
    images,
    normalise: bool = False,
    generator: torch.Generator | None = None,
    z_mode: str = "sample",
    device="cuda",
):
    """Drop-in for the reference deblend(): (mean images, distribution).

    images: (N, S, S, B) or one (S, S, B) stamp; ``net`` must live on
    ``device``.  ``z_mode='sample'`` draws the latent from ``generator``
    (a fresh one seeded 0 when None); ``'mean'`` is deterministic."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(images, np.float32), device=dev)
    if x.ndim == 3:
        x = x[None]
    if z_mode == "sample" and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dist = deblend_tensor(net, x, normalise, generator, z_mode)
    return dist.mean().cpu().numpy(), dist
