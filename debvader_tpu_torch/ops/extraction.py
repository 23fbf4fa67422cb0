"""Cutout extraction: one batched gather for all sources.

Semantics of debvader_tpu.ops.extraction: centres are truncated toward
zero (the reference's int()), the window starts at trunc(c) + F//2 - S//2,
a source is valid iff its whole window lies inside the field, the slice is
clamped so it is always legal, and invalid rows are zeroed.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["extract_cutouts", "extract_cutouts_np", "extract_cutouts_host"]


def extract_cutouts(field_image: torch.Tensor, centers, cutout_size: int = 59):
    """(cutouts (N, S, S, B), valid (N,) bool) from a (1, F, F, B) or
    (F, F, B) field tensor and (N, 2) centre offsets; both outputs on the
    field's device."""
    field = field_image[0] if field_image.ndim == 4 else field_image
    dev = field.device
    centers = torch.as_tensor(np.asarray(centers, np.float32), device=dev).reshape(-1, 2)
    b = field.shape[-1]
    if centers.shape[0] == 0:
        return (
            torch.zeros((0, cutout_size, cutout_size, b), dtype=field.dtype, device=dev),
            torch.zeros((0,), dtype=torch.bool, device=dev),
        )
    f = field.shape[0]
    starts = torch.trunc(centers).to(torch.int64) + (f // 2 - cutout_size // 2)
    valid = torch.all((starts >= 0) & (starts + cutout_size <= f), dim=-1)
    starts = torch.clamp(starts, 0, f - cutout_size)
    ar = torch.arange(cutout_size, device=dev)
    rows = starts[:, 0, None] + ar  # (N, S)
    cols = starts[:, 1, None] + ar
    cutouts = field[rows[:, :, None], cols[:, None, :]]  # (N, S, S, B)
    cutouts = torch.where(valid[:, None, None, None], cutouts, torch.zeros((), dtype=field.dtype, device=dev))
    return cutouts, valid


def extract_cutouts_np(field_image, centers, cutout_size: int = 59):
    """The same semantics in numpy, for host-resident fields."""
    field = np.asarray(field_image)
    if field.ndim == 4:
        field = field[0]
    if field.dtype == np.float64:
        field = field.astype(np.float32)
    field_size = field.shape[0]
    centers = np.trunc(np.asarray(centers, np.float32)).astype(np.int64).reshape(-1, 2)
    if centers.size == 0:
        return (
            np.zeros((0, cutout_size, cutout_size, field.shape[-1]), field.dtype),
            np.zeros((0,), bool),
        )
    starts = centers + (field_size // 2 - cutout_size // 2)
    valid = np.all((starts >= 0) & (starts + cutout_size <= field_size), axis=-1)
    clamped = np.clip(starts, 0, field_size - cutout_size)
    windows = np.lib.stride_tricks.sliding_window_view(
        field, (cutout_size, cutout_size), axis=(0, 1)
    )  # (F-S+1, F-S+1, B, S, S) view
    out = windows[clamped[:, 0], clamped[:, 1]].transpose(0, 2, 3, 1)
    out = np.ascontiguousarray(out)
    out[~valid] = 0.0
    return out, valid


def extract_cutouts_host(
    field_image,
    field_size=None,
    galaxy_distances_to_center=None,
    cutout_size: int = 59,
    nb_of_bands: int = 6,
):
    """The reference's signature (extract/extraction.py): (cutouts as
    numpy (N, S, S, B), list_idx, the Python list of the indices of the
    sources whose whole window lies in the field).  ``field_size`` and
    ``nb_of_bands`` are read from the field, as in the JAX package."""
    cutouts, valid = extract_cutouts_np(field_image, galaxy_distances_to_center, cutout_size)
    return cutouts, list(np.flatnonzero(valid))
