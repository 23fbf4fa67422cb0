"""Seeded traffic made on the device, in torch.

A frozen copy of ``debvader_tpu_torch/data/simulate.py`` (``simulate_batch``:
a central galaxy with an elliptical two-Gaussian profile and a smooth band
SED, up to ``max_neighbors`` neighbours each present with probability 0.7,
a separable 7-tap Gaussian PSF of sigma 1.2 px with zero padding, Gaussian
pixel noise), rewritten on torch tensors so that set-up draws whole
batches on the card from a ``torch.Generator`` instead of on the host.
The draws cannot be numpy's, so the two agree in distribution
(tests/test_portbench_generators.py holds them together at a small size);
the profile and the blur are the same arithmetic.  The program under test
never sees this module: it receives the tensors.
"""

from __future__ import annotations

import torch

__all__ = ["make_generator", "simulate_batch", "make_field"]

_SEED_MASK = (1 << 64) - 1


def make_generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of a run: ``seed`` (any
    whole number) mixed with a small ``salt`` so that a run's streams
    (inputs, latent noise) are unrelated and every seed gives its own."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(salt) * 0xBF58476D1CE4E5B9) & _SEED_MASK
    return torch.Generator(device=device).manual_seed(mixed)


def _profile(stamp: int, cy, cx, flux, r50, e1, e2, bands_scale) -> torch.Tensor:
    """Elliptical two-Gaussian profiles per band: parameters (...,) and
    ``bands_scale`` (..., B) -> (..., stamp, stamp, B) float32."""
    cy, cx, flux, r50, e1, e2 = (v[..., None, None] for v in (cy, cx, flux, r50, e1, e2))
    axis = torch.arange(stamp, dtype=torch.float32, device=flux.device)
    dy = axis[:, None] - cy
    dx = axis[None, :] - cx
    q1 = (1 + e1) * dx * dx + (1 - e1) * dy * dy + 2 * e2 * dx * dy
    core = torch.exp(-q1 / (2 * (0.6 * r50) ** 2))
    wings = torch.exp(-q1 / (2 * (1.8 * r50) ** 2))
    prof = 0.7 * core + 0.3 * wings
    prof = prof / prof.sum(dim=(-2, -1), keepdim=True)
    return (flux * prof)[..., None] * bands_scale[..., None, None, :]


def _psf_blur(img: torch.Tensor, sigma: float = 1.2, width: int = 7) -> torch.Tensor:
    """Separable Gaussian PSF, zero padded, over the two axes before the
    band axis of (..., H, W, B), tap by tap as the numpy version adds."""
    r = torch.arange(width, dtype=torch.float32) - width // 2
    g = torch.exp(-(r**2) / (2 * sigma**2))
    g = (g / g.sum()).tolist()
    half = width // 2
    out = img
    for axis in (-3, -2):
        size = out.shape[axis]
        pad = [0, 0] * 3
        pad[2 * (-axis - 1)] = pad[2 * (-axis - 1) + 1] = half
        padded = torch.nn.functional.pad(out, pad)
        acc = torch.zeros_like(out)
        for t in range(width):
            acc += g[t] * padded.narrow(axis, t, size)
        out = acc
    return out


def _band_scale(slope: torch.Tensor, bands: int) -> torch.Tensor:
    scale = torch.exp(slope[..., None] * torch.arange(bands, dtype=torch.float32, device=slope.device))
    return scale / scale.mean(dim=-1, keepdim=True)


def simulate_batch(gen: torch.Generator, n: int, stamp: int = 59, bands: int = 6, max_neighbors: int = 3,
                   noise: float = 0.02):
    """(blended_noisy, isolated_noisy, isolated_clean), each (n, stamp,
    stamp, bands) float32 on ``gen``'s device."""
    dev = gen.device
    c = (stamp - 1) / 2.0

    def u(lo, hi, *shape):
        return torch.rand((n, *shape), generator=gen, device=dev) * (hi - lo) + lo

    central = _profile(stamp, torch.full((n,), c, device=dev), torch.full((n,), c, device=dev), u(5.0, 50.0),
                       u(1.5, 4.0), u(-0.3, 0.3), u(-0.3, 0.3), _band_scale(u(-0.15, 0.15), bands))
    k = max_neighbors
    present = torch.rand((n, k), generator=gen, device=dev) < 0.7
    off = u(-c * 0.8, c * 0.8, k, 2)
    neighbors = _profile(stamp, c + off[..., 0], c + off[..., 1], u(2.0, 30.0, k), u(1.0, 3.5, k),
                         u(-0.3, 0.3, k), torch.zeros((n, k), device=dev), _band_scale(u(-0.15, 0.15, k), bands))
    neighbors = torch.where(present[..., None, None, None], neighbors, 0.0).sum(dim=1)
    iso_clean = _psf_blur(central)
    blend_clean = iso_clean + _psf_blur(neighbors)
    eps1 = noise * torch.randn(blend_clean.shape, generator=gen, device=dev)
    eps2 = noise * torch.randn(blend_clean.shape, generator=gen, device=dev)
    return blend_clean + eps1, iso_clean + eps2, iso_clean


def make_field(gen: torch.Generator, size: int, n_gal: int, bands: int = 6, noise: float = 0.02):
    """(field, centres): the field (1, size, size, bands) float32 on
    ``gen``'s device, a frozen copy of ``chip_smoke.py``'s ``make_field`` in
    torch, and its truth catalogue, each galaxy's (y, x) centre in pixels,
    (n_gal, 2) float64.  ``n_gal`` elliptical
    two-Gaussian galaxies (centres uniform at least min(40, size // 4)
    pixels from the edges, flux U(5, 50), r50 U(1.5, 4), e1 and e2
    U(-0.3, 0.3), a smooth band SED) drawn on 41 x 41 stamps at their
    sub-pixel positions and added to the field one by one (a fixed order,
    so a seed gives the same field bit for bit), then the separable 7-tap
    Gaussian PSF (sigma 1.2 px, zero outside the field) and Gaussian pixel
    noise."""
    dev = gen.device
    half = 20
    margin = min(40, size // 4)

    def u(lo, hi, *shape):
        return torch.rand((n_gal, *shape), generator=gen, device=dev, dtype=torch.float64) * (hi - lo) + lo

    centre = u(margin, size - margin, 2)
    flux, r50 = u(5.0, 50.0), u(1.5, 4.0)
    e1, e2 = u(-0.3, 0.3), u(-0.3, 0.3)
    sed = torch.exp(u(-0.15, 0.15)[:, None] * torch.arange(bands, device=dev, dtype=torch.float64))
    sed = sed / sed.mean(dim=1, keepdim=True)
    corner = torch.floor(centre).to(torch.int64)
    frac = centre - corner
    grid = torch.arange(-half, half + 1, device=dev, dtype=torch.float64)
    dy = grid[None, :, None] - frac[:, 0, None, None]
    dx = grid[None, None, :] - frac[:, 1, None, None]
    e1, e2, r50 = e1[:, None, None], e2[:, None, None], r50[:, None, None]
    q = (1 + e1) * dx * dx + (1 - e1) * dy * dy + 2 * e2 * dx * dy
    prof = 0.7 * torch.exp(-q / (2 * (0.6 * r50) ** 2)) + 0.3 * torch.exp(-q / (2 * (1.8 * r50) ** 2))
    prof = prof / prof.sum(dim=(1, 2), keepdim=True)
    stamps = (flux[:, None, None, None] * prof[..., None] * sed[:, None, None, :]).to(torch.float32)
    field = torch.zeros((size, size, bands), dtype=torch.float32, device=dev)
    for k, (iy, ix) in enumerate((corner - half).tolist()):
        field[iy: iy + 2 * half + 1, ix: ix + 2 * half + 1] += stamps[k]
    field = _psf_blur(field)
    field += noise * torch.randn(field.shape, generator=gen, device=dev)
    return field[None], centre
