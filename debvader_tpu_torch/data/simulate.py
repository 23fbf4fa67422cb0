"""Synthetic blended stamps, in numpy: the twin of
debvader_tpu/data/simulate.py.

Same generative model as the JAX package's ``simulate_batch``: a central
galaxy with an elliptical two-Gaussian profile and a smooth band SED, up to
``max_neighbors`` neighbours (each present with probability 0.7) offset
from the centre, a separable Gaussian PSF (sigma 1.2 px, 7 taps) and
Gaussian pixel noise.  The random numbers come from an explicit
``numpy.random.Generator``; they cannot match the JAX package's threefry
streams, so the two agree in distribution and, given the same parameters,
in ``_profile`` and ``_psf_blur``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["simulate_batch", "make_dataset"]


def _profile(stamp: int, cy, cx, flux, r50, e1, e2, bands_scale) -> np.ndarray:
    """Elliptical two-Gaussian (crude Sersic) profiles, per band.

    The scalar parameters may carry leading batch axes (...,) and
    ``bands_scale`` is (..., B); returns (..., stamp, stamp, B) float32."""
    f32 = np.float32
    cy, cx, flux, r50, e1, e2 = (np.asarray(v, f32)[..., None, None] for v in (cy, cx, flux, r50, e1, e2))
    yy, xx = np.mgrid[:stamp, :stamp].astype(f32)
    dy = yy - cy
    dx = xx - cx
    q1 = (1 + e1) * dx * dx + (1 - e1) * dy * dy + 2 * e2 * dx * dy
    core = np.exp(-q1 / (2 * (f32(0.6) * r50) ** 2))
    wings = np.exp(-q1 / (2 * (f32(1.8) * r50) ** 2))
    prof = f32(0.7) * core + f32(0.3) * wings
    prof = prof / prof.sum(axis=(-2, -1), keepdims=True)
    return (flux * prof)[..., None] * np.asarray(bands_scale, f32)[..., None, None, :]


def _psf_blur(img: np.ndarray, sigma: float = 1.2, width: int = 7) -> np.ndarray:
    """Separable Gaussian PSF with zero padding over the two axes before
    the band axis (img: (..., H, W, B))."""
    r = np.arange(width, dtype=np.float32) - width // 2
    g = np.exp(-(r**2) / np.float32(2 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    half = width // 2
    out = np.asarray(img, np.float32)
    for axis in (-3, -2):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (half, half)
        padded = np.pad(out, pad)
        size = out.shape[axis]
        acc = np.zeros_like(out)
        for t in range(width):
            acc += g[t] * np.take(padded, np.arange(t, t + size), axis=axis)
        out = acc
    return out


def _band_scale(slope: np.ndarray, bands: int) -> np.ndarray:
    scale = np.exp(slope[..., None] * np.arange(bands, dtype=np.float32))
    return (scale / scale.mean(axis=-1, keepdims=True)).astype(np.float32)


def simulate_batch(
    rng,
    n: int,
    stamp: int = 59,
    bands: int = 6,
    max_neighbors: int = 3,
    noise: float = 0.02,
):
    """(blended_noisy, isolated_noisy, isolated_clean), each
    (n, stamp, stamp, bands) float32.  ``rng``: a ``numpy.random.Generator``
    or a seed for one."""
    rng = np.random.default_rng(rng)
    c = (stamp - 1) / 2.0

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, (n, *shape)).astype(np.float32)

    central = _profile(
        stamp, c, c, u(5.0, 50.0), u(1.5, 4.0), u(-0.3, 0.3), u(-0.3, 0.3),
        _band_scale(u(-0.15, 0.15), bands),
    )
    k = max_neighbors
    present = rng.random((n, k)) < 0.7
    off = u(-c * 0.8, c * 0.8, k, 2)
    neighbors = _profile(
        stamp, c + off[..., 0], c + off[..., 1], u(2.0, 30.0, k), u(1.0, 3.5, k),
        u(-0.3, 0.3, k), np.zeros((n, k), np.float32), _band_scale(u(-0.15, 0.15, k), bands),
    )
    neighbors = np.where(present[..., None, None, None], neighbors, 0.0).sum(axis=1)
    iso_clean = _psf_blur(central)
    blend_clean = iso_clean + _psf_blur(neighbors)
    shape = blend_clean.shape
    eps1 = noise * rng.standard_normal(shape, dtype=np.float32)
    eps2 = noise * rng.standard_normal(shape, dtype=np.float32)
    return (
        (blend_clean + eps1).astype(np.float32),
        (iso_clean + eps2).astype(np.float32),
        iso_clean.astype(np.float32),
    )


def make_dataset(rng=0, n_train: int = 256, n_val: int = 64, stamp: int = 59, bands: int = 6, **kw) -> dict:
    """Training and validation pairs for both stages of ``train_deblender``,
    in the reference's layout: stage 1 ("vae") maps noisy isolated stamps
    to clean ones, stage 2 ("deblender") noisy blends to the clean isolated
    galaxy.  ``rng``: a ``numpy.random.Generator`` or a seed for one; the
    training set is drawn before the validation set.  Returns
    ``{"vae": ((x, y), (x_val, y_val)), "deblender": (...)}``, float32."""
    rng = np.random.default_rng(rng)
    btr, itr, ctr = simulate_batch(rng, n_train, stamp, bands, **kw)
    bva, iva, cva = simulate_batch(rng, n_val, stamp, bands, **kw)
    return {"vae": ((itr, ctr), (iva, cva)), "deblender": ((btr, ctr), (bva, cva))}
