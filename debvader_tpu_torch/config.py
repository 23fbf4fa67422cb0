"""Configuration of the port: the fields of debvader_tpu's configs that the
detect -> deblend -> residual path reads, with the same defaults.

The port keeps its own copy because the JAX package's config module
imports ``jax.numpy``.  The model is float32 only; precision and
quantization knobs of the JAX ``ModelConfig`` belong to later slices.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "DetectionConfig", "PipelineConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the convolutional VAE (59x59xB input, latent 32,
    filters 32/64/128/256, 3x3 kernels, pixel-Normal scale floor 1e-4,
    TriL diagonal shift 1e-5)."""

    stamp_size: int = 59
    nb_of_bands: int = 6
    latent_dim: int = 32
    filters: tuple = (32, 64, 128, 256)
    kernels: tuple = (3, 3, 3, 3)
    scale_floor: float = 1e-4
    diag_shift: float = 1e-5

    def __post_init__(self):
        object.__setattr__(self, "filters", tuple(self.filters))
        object.__setattr__(self, "kernels", tuple(self.kernels))
        if len(self.filters) != len(self.kernels):
            raise ValueError("filters and kernels must have the same length")

    @property
    def input_shape(self) -> tuple[int, int, int]:
        return (self.stamp_size, self.stamp_size, self.nb_of_bands)


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """SExtractor-equivalent detection: watershed segmentation with the
    quantized multi-threshold merge, a 7x7 matched filter (the only size
    the fused detect kernel takes), 64-px background boxes.
    ``threshold_scaling`` is 'sep_conv' (thresh * rms, the reference's
    behaviour) or 'matched' (thresh * rms * ||k||_2)."""

    thresh: float = 1.5
    minarea: int = 4
    deblend_nthresh: int = 64
    deblend_cont: float = 1e-5
    background_box: int = 64
    filter_fwhm: float = 3.0  # of the 7x7 matched filter
    detection_band: int = 2
    threshold_scaling: str = "sep_conv"
    clean: bool = True
    clean_param: float = 1.0

    def __post_init__(self):
        if self.threshold_scaling not in ("sep_conv", "matched"):
            raise ValueError(
                f"unknown threshold_scaling {self.threshold_scaling!r}"
            )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Scene-pipeline defaults: 59-px cutouts, +-5 px centre window for the
    mse cut, order-3 spline render, forward batches of ``source_chunk``."""

    cutout_size: int = 59
    nb_of_bands: int = 6
    mse_window: int = 5
    interp_order: int = 3
    source_chunk: int = 8192
