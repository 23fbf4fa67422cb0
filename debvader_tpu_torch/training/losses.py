"""Losses and metrics of VAE / deblender training, after
debvader_tpu/training/losses.py.

- reconstruction: the mean per-element negative log-likelihood of the
  pixel Normal (the reference's ``vae_loss``);
- KL of the posterior to N(0, I): analytic (default) or the single-sample
  estimate log q(z) - log p(z) at the sampled latent (``kl_mode='mc'``,
  the reference's Keras regularizer);
- ``mse``: the plain mean squared error of the mean.

``loss = nll + kl_weight * kl``.
"""

from __future__ import annotations

import math

import torch

from debvader_tpu_torch.models.distributions import MultivariateNormalTriL, PixelNormal

__all__ = ["mse", "nll", "kl_divergence", "elbo_terms"]


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(img1 - img2))


def nll(dist: PixelNormal, y: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel Gaussian negative log-likelihood."""
    return -torch.mean(dist.log_prob(y))


def _kl_per_sample(posterior: MultivariateNormalTriL, z: torch.Tensor | None, mode: str) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)) of each sample, shape (N,)."""
    if mode == "analytic":
        return posterior.kl_to_standard_normal()
    if mode == "mc":
        if z is None:
            raise ValueError("kl mode 'mc' requires the sampled latent z")
        n = posterior.event_dim
        log_q = posterior.log_prob(z)
        log_p = -0.5 * torch.sum(torch.square(z), -1) - 0.5 * n * math.log(2.0 * math.pi)
        return log_q - log_p
    raise ValueError(f"unknown kl mode {mode!r}")


def kl_divergence(posterior: MultivariateNormalTriL, z: torch.Tensor | None = None,
                  mode: str = "analytic") -> torch.Tensor:
    """Batch-mean KL(q(z|x) || N(0, I))."""
    return torch.mean(_kl_per_sample(posterior, z, mode))


def elbo_terms(
    dist: PixelNormal,
    posterior: MultivariateNormalTriL,
    y: torch.Tensor,
    z: torch.Tensor | None = None,
    kl_weight: float | torch.Tensor = 0.01,
    kl_mode: str = "analytic",
    weights: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """nll, kl, loss and mse of one batch.

    ``weights`` (N,) weights the batch reduction per sample,
    ``sum_i w_i term_i / sum_i w_i``: a zero-weight row drops out of every
    term and of the gradient."""
    if weights is None:
        rec = nll(dist, y)
        kl = kl_divergence(posterior, z=z, mode=kl_mode)
        m = mse(dist.mean(), y)
    else:
        w = weights.to(torch.float32)
        wsum = torch.sum(w)
        axes = tuple(range(1, y.ndim))

        def wmean(per_sample):
            return torch.sum(w * per_sample) / wsum

        rec = wmean(-torch.mean(dist.log_prob(y), dim=axes))
        kl = wmean(_kl_per_sample(posterior, z, kl_mode))
        m = wmean(torch.mean(torch.square(dist.mean() - y), dim=axes))
    return {"nll": rec, "kl": kl, "loss": rec + kl_weight * kl, "mse": m}
