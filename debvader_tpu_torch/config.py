"""Configuration of the port: the fields of debvader_tpu's configs that the
ported paths read, under the same names and with the same defaults.

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
    quantized multi-threshold merge, a ``filter_size`` x ``filter_size``
    Gaussian matched filter, 64-px background boxes.
    ``threshold_scaling`` is 'sep_conv' (thresh * rms, the reference's
    behaviour) or 'matched' (thresh * rms * ||k||_2).

    The three backend fields keep the JAX package's names, so a config
    carries over; what they select here:

    - ``use_pallas_fused``: None (default) or True runs the fused detect
      core (kernels/detect_fused.py: filter, threshold and parent race in
      one kernel) on either device, since every kernel wrapper of the port
      takes its plain version on the CPU itself.  False runs the chain
      background -> filter -> race -> labels step by step.  The fused core
      takes a 7x7 filter only; any other ``filter_size`` runs the chain.
    - ``use_pallas_filter``: True runs the chain with the stand-alone
      matched-filter kernel (kernels/matched_filter.py) as its filter, and
      wins over the fused core.  Otherwise the chain filters with
      ``F.conv2d``, as it does for any ``filter_size`` other than 7."""

    thresh: float = 1.5
    minarea: int = 4
    deblend_nthresh: int = 64
    deblend_cont: float = 1e-5
    background_box: int = 64
    filter_fwhm: float = 3.0
    filter_size: int = 7
    detection_band: int = 2
    threshold_scaling: str = "sep_conv"
    use_pallas_filter: bool = False
    use_pallas_fused: bool | None = None
    clean: bool = True
    clean_param: float = 1.0

    def __post_init__(self):
        if self.threshold_scaling not in ("sep_conv", "matched"):
            raise ValueError(
                f"unknown threshold_scaling {self.threshold_scaling!r}"
            )
        if self.filter_size < 1 or self.filter_size % 2 == 0:
            raise ValueError(f"filter_size must be odd and positive, got {self.filter_size}")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Scene-pipeline defaults: 59-px cutouts, +-5 px centre window for the
    mse cut, order-3 spline render (order 1 renders through the CUDA
    kernel on a card), per-source work in batches of ``source_chunk``.

    ``serving_hbm_bytes`` is the device memory the streaming serving path
    plans its chunk against; None asks the device
    (``torch.cuda.get_device_properties(...).total_memory``).
    ``render_cache_bytes`` caps the mean and stddev stamps that
    ``deblend_field`` keeps on the device for the renders that follow."""

    cutout_size: int = 59
    nb_of_bands: int = 6
    mse_window: int = 5
    interp_order: int = 3
    source_chunk: int = 8192
    serving_hbm_bytes: int | None = None
    render_cache_bytes: int = 1 << 30
