"""The VAE's distributions in PyTorch: the MVN-TriL latent posterior and the
per-pixel Normal decoder head, with TFP's ``fill_triangular`` order."""

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
]


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


class PixelNormal(NamedTuple):
    """Per-pixel independent Normal over (..., H, W, bands)."""

    loc: torch.Tensor
    scale: torch.Tensor

    def mean(self) -> torch.Tensor:
        return self.loc

    def stddev(self) -> torch.Tensor:
        return self.scale
