"""Photometry and shape measurement on deblended stamps.

Port of debvader_tpu.ops.measure: batched reductions over (N, S, S, B)
stamp tensors on their device.

- ``flux``: per-band aperture (or full-stamp) sums
- ``centroid``: flux-weighted first moments
- ``second_moments`` / ``ellipticity``: unweighted quadrupole moments about
  the centroid and the (e1, e2) distortion derived from them
- ``snr``: flux over noise from the per-pixel aleatoric stddev
"""

from __future__ import annotations

import torch

from debvader_tpu_torch.device import fp32_math

__all__ = ["flux", "centroid", "second_moments", "ellipticity", "snr", "measure_batch"]


def _grids(s: int, device):
    ar = torch.arange(s, dtype=torch.float32, device=device)
    return ar.reshape(s, 1).expand(s, s), ar.reshape(1, s).expand(s, s)


def flux(stamps: torch.Tensor, radius: float | None = None) -> torch.Tensor:
    """(N, S, S, B) -> (N, B) total flux; optional circular aperture around
    the stamp centre."""
    if radius is None:
        return stamps.sum(dim=(1, 2))
    s = stamps.shape[1]
    yy, xx = _grids(s, stamps.device)
    c = (s - 1) / 2.0
    ap = ((yy - c) ** 2 + (xx - c) ** 2 <= radius**2).to(stamps.dtype)
    return torch.einsum("nijb,ij->nb", stamps, ap)


def _positive_total(stamps: torch.Tensor):
    w = torch.clamp(stamps, min=0.0)
    return w, torch.clamp(w.sum(dim=(1, 2)), min=1e-20)


def centroid(stamps: torch.Tensor) -> torch.Tensor:
    """(N, S, S, B) -> (N, B, 2) flux-weighted centroids (y, x)."""
    yy, xx = _grids(stamps.shape[1], stamps.device)
    w, tot = _positive_total(stamps)
    cy = torch.einsum("nijb,ij->nb", w, yy) / tot
    cx = torch.einsum("nijb,ij->nb", w, xx) / tot
    return torch.stack([cy, cx], dim=-1)


def second_moments(stamps: torch.Tensor) -> torch.Tensor:
    """(N, S, S, B) -> (N, B, 3): (Qyy, Qxx, Qyx) about the centroid."""
    yy, xx = _grids(stamps.shape[1], stamps.device)
    w, tot = _positive_total(stamps)
    c = centroid(stamps)  # (N, B, 2)
    dy = yy[None, :, :, None] - c[..., 0][:, None, None, :]
    dx = xx[None, :, :, None] - c[..., 1][:, None, None, :]
    qyy = (w * dy * dy).sum(dim=(1, 2)) / tot
    qxx = (w * dx * dx).sum(dim=(1, 2)) / tot
    qyx = (w * dy * dx).sum(dim=(1, 2)) / tot
    return torch.stack([qyy, qxx, qyx], dim=-1)


def ellipticity(stamps: torch.Tensor) -> torch.Tensor:
    """(N, S, S, B) -> (N, B, 2): distortion (e1, e2) from quadrupole
    moments: e1 = (Qxx - Qyy) / (Qxx + Qyy), e2 = 2 Qyx / (Qxx + Qyy)."""
    q = second_moments(stamps)
    qyy, qxx, qyx = q[..., 0], q[..., 1], q[..., 2]
    denom = torch.clamp(qxx + qyy, min=1e-20)
    return torch.stack([(qxx - qyy) / denom, 2.0 * qyx / denom], dim=-1)


def snr(mean_stamps: torch.Tensor, stddev_stamps: torch.Tensor) -> torch.Tensor:
    """(N, S, S, B) x2 -> (N, B): flux over root-sum-square aleatoric
    noise."""
    f = mean_stamps.sum(dim=(1, 2))
    n = torch.sqrt(torch.square(stddev_stamps).sum(dim=(1, 2)))
    return f / torch.clamp(n, min=1e-20)


@torch.no_grad()
def measure_batch(mean_stamps: torch.Tensor, stddev_stamps: torch.Tensor | None = None) -> dict:
    """All measurements for a batch of deblended stamps, on their device
    (the weighted sums are matrix products: kept in full float32)."""
    with fp32_math():
        out = {
            "flux": flux(mean_stamps),
            "centroid": centroid(mean_stamps),
            "second_moments": second_moments(mean_stamps),
            "ellipticity": ellipticity(mean_stamps),
        }
        if stddev_stamps is not None:
            out["snr"] = snr(mean_stamps, stddev_stamps)
    return out
