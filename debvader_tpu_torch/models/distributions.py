"""The VAE's distributions in PyTorch: the MVN-TriL latent posterior and the
per-pixel Normal decoder head, with TFP's ``fill_triangular`` order, their
log densities and the analytic KL of the posterior to N(0, I) (the
training losses, training/losses.py)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "tril_size",
    "mvn_params_size",
    "fill_triangular",
    "softplus_tril",
    "MultivariateNormalTriL",
    "PixelNormal",
    "kl_mvn_tril_standard_normal",
]

_LOG_2PI = math.log(2.0 * math.pi)


def tril_size(n: int) -> int:
    return n * (n + 1) // 2


def mvn_params_size(latent_dim: int) -> int:
    """Flat size of an MVN-TriL head: latent_dim locs + the packed triangle."""
    return latent_dim + tril_size(latent_dim)


def _fill_triangular_gather(n: int) -> np.ndarray:
    """Flat (n*n,) gather indices into x extended by one trailing zero.

    TFP packs x (length m = n(n+1)/2) as tril(reshape(concat([x[n:],
    x[::-1]]), (n, n))); the lower triangle reads x through this map and
    the upper triangle reads the appended zero."""
    m = tril_size(n)
    x = np.arange(m)
    mat = np.concatenate([x[n:], x[::-1]]).reshape(n, n)
    rows, cols = np.tril_indices(n)
    idx = np.full((n, n), m, dtype=np.int64)
    idx[rows, cols] = mat[rows, cols]
    return idx.reshape(-1)


def fill_triangular(x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """(..., n(n+1)/2) -> (..., n, n) lower triangle, TFP element order
    (n=3: [1,2,3,4,5,6] -> [[4,0,0],[6,5,0],[3,2,1]])."""
    m = x.shape[-1]
    if n is None:
        n = (math.isqrt(8 * m + 1) - 1) // 2
    if tril_size(n) != m:
        raise ValueError(f"last dim {m} is not a triangular number for n={n}")
    gather = torch.as_tensor(_fill_triangular_gather(n), device=x.device)
    x_ext = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    return x_ext[..., gather].reshape(x.shape[:-1] + (n, n))


def softplus_tril(params: torch.Tensor, latent_dim: int, diag_shift: float = 1e-5):
    """(loc, scale_tril) from a flat head: fill_triangular on the tail, then
    softplus(diag) + diag_shift on the diagonal."""
    loc = params[..., :latent_dim]
    tril = fill_triangular(params[..., latent_dim:], latent_dim)
    diag = F.softplus(torch.diagonal(tril, dim1=-2, dim2=-1)) + diag_shift
    eye = torch.eye(latent_dim, dtype=tril.dtype, device=tril.device)
    tril = tril * (1.0 - eye) + diag[..., None] * eye * torch.ones_like(tril)
    return loc, tril


class MultivariateNormalTriL(NamedTuple):
    """Latent posterior q(z|x) = N(loc, L L^T), L lower triangular."""

    loc: torch.Tensor  # (..., n)
    scale_tril: torch.Tensor  # (..., n, n)

    def sample(
        self,
        generator: torch.Generator | None = None,
        eps: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """loc + L @ eps.  ``eps`` is drawn from ``generator`` unless given
        (tests hand both frameworks the same noise)."""
        if eps is None:
            eps = torch.randn(
                self.loc.shape,
                generator=generator,
                dtype=self.loc.dtype,
                device=self.loc.device,
            )
        return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, eps)

    def mean(self) -> torch.Tensor:
        return self.loc

    def stddev(self) -> torch.Tensor:
        return torch.sqrt(torch.sum(torch.square(self.scale_tril), dim=-1))

    @property
    def event_dim(self) -> int:
        return self.loc.shape[-1]

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        """log N(z; loc, L L^T): a triangular solve for L^-1 (z - loc)."""
        n = self.event_dim
        diff = z - self.loc
        batch = torch.broadcast_shapes(diff.shape[:-1], self.scale_tril.shape[:-2])
        tril = self.scale_tril.expand(batch + (n, n))
        diff = diff.expand(batch + (n,))
        sol = torch.linalg.solve_triangular(tril, diff[..., None], upper=False)[..., 0]
        half_log_det = torch.sum(torch.log(torch.diagonal(self.scale_tril, dim1=-2, dim2=-1)), dim=-1)
        return -0.5 * torch.sum(torch.square(sol), dim=-1) - half_log_det - 0.5 * n * _LOG_2PI

    def kl_to_standard_normal(self) -> torch.Tensor:
        return kl_mvn_tril_standard_normal(self.loc, self.scale_tril)


def kl_mvn_tril_standard_normal(loc: torch.Tensor, scale_tril: torch.Tensor) -> torch.Tensor:
    """Analytic KL(N(loc, L L^T) || N(0, I)) over the leading axes:
    0.5 (tr(L L^T) + |loc|^2 - n) - sum(log diag L)."""
    n = loc.shape[-1]
    tr = torch.sum(torch.square(scale_tril), dim=(-2, -1))
    sq = torch.sum(torch.square(loc), dim=-1)
    log_det = torch.sum(torch.log(torch.diagonal(scale_tril, dim1=-2, dim2=-1)), dim=-1)
    return 0.5 * (tr + sq - n) - log_det


class PixelNormal(NamedTuple):
    """Per-pixel independent Normal over (..., H, W, bands)."""

    loc: torch.Tensor
    scale: torch.Tensor

    def mean(self) -> torch.Tensor:
        return self.loc

    def stddev(self) -> torch.Tensor:
        return self.scale

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * torch.square(z) - torch.log(self.scale) - 0.5 * _LOG_2PI
