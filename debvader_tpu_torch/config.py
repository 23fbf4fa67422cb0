"""Configuration of the port: the fields of debvader_tpu's configs that the
ported paths read, under the same names and with the same defaults.

The port keeps its own copy because the JAX package's config module
imports ``jax.numpy``.  The model computes in float32; the precision knobs
(``matmul_precision``, ``layer_precision``, ``limb_emulation``) select the
explicit bf16-limb schemes of models/precision.py.  ``dtype``,
``strict_cast``, ``decoder_subpixel``, ``decoder_f32_stages`` and the
quantization knobs of the JAX ``ModelConfig`` belong to later slices.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "ModelConfig",
    "DetectionConfig",
    "PipelineConfig",
    "fidelity_serving_config",
    "FIDELITY_NEEDS_FLUX_CAL",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the convolutional VAE (59x59xB input, latent 32,
    filters 32/64/128/256, 3x3 kernels, pixel-Normal scale floor 1e-4,
    TriL diagonal shift 1e-5).

    ``matmul_precision`` (None, 'default', 'high', 'highest') and the
    per-layer ``layer_precision`` overrides name the JAX package's rungs.
    The native rungs count passes of a TPU's matrix unit and change nothing
    off a TPU: the JAX package's CPU backend runs them in true float32, and
    so does the port, on the CPU and on a card (TF32 off).  What changes the
    arithmetic, identically everywhere, is an explicit limb scheme
    ('bf16x1' ... 'bf16x9', models/precision.py) or ``limb_emulation=True``,
    which runs the native rungs through their limb equivalents
    (default -> bf16x1, high -> bf16x3t, highest -> bf16x6).

    ``layer_precision`` is ((layer_key, rung), ...) pairs (a dict is
    accepted and canonicalised to sorted pairs).  Layer keys, in
    application order: 'enc/Conv_0'..'enc/Conv_{2S-1}', 'enc/Dense_0',
    'dec/Dense_0', 'dec/Dense_1', 'dec/ConvT_0'..'dec/ConvT_{2S-1}'
    (0 = deepest), 'dec/Conv_0' (the band head).  Unlisted layers fall back
    to ``matmul_precision``."""

    stamp_size: int = 59
    nb_of_bands: int = 6
    latent_dim: int = 32
    filters: tuple = (32, 64, 128, 256)
    kernels: tuple = (3, 3, 3, 3)
    scale_floor: float = 1e-4
    diag_shift: float = 1e-5
    matmul_precision: str | None = None
    layer_precision: tuple | None = None
    limb_emulation: bool = False

    _RUNGS = ("default", "high", "highest", "bf16x1", "bf16x2", "bf16x2t",
              "bf16x3t", "bf16x3", "bf16x4", "bf16x5", "bf16x6", "bf16x9")

    def __post_init__(self):
        object.__setattr__(self, "filters", tuple(self.filters))
        object.__setattr__(self, "kernels", tuple(self.kernels))
        if len(self.filters) != len(self.kernels):
            raise ValueError("filters and kernels must have the same length")
        if self.matmul_precision not in (None, "default", "high", "highest"):
            raise ValueError(
                "matmul_precision must be None, 'default', 'high' or "
                f"'highest', got {self.matmul_precision!r}"
            )
        if self.layer_precision is not None:
            items = (
                tuple(sorted(self.layer_precision.items()))
                if isinstance(self.layer_precision, dict)
                else tuple(tuple(kv) for kv in self.layer_precision)
            )
            valid_keys = self.precision_layer_keys()
            for key, rung in items:
                if key not in valid_keys:
                    # a misspelt key would silently fall back to
                    # matmul_precision: a serving mode that is not the one
                    # the caller asked for
                    raise ValueError(
                        f"layer_precision key {key!r} names no MXU layer of "
                        f"this architecture; valid keys: {sorted(valid_keys)}"
                    )
                if rung not in self._RUNGS:
                    raise ValueError(
                        f"layer_precision[{key!r}] must be one of "
                        f"{self._RUNGS}, got {rung!r}"
                    )
            object.__setattr__(self, "layer_precision", items)

    def precision_layer_keys(self) -> frozenset:
        """The layer keys ``layer_precision`` may name (models/vae.py hands
        them to models/precision.resolve)."""
        s = len(self.filters)
        return frozenset(
            [f"enc/Conv_{i}" for i in range(2 * s)]
            + [f"dec/ConvT_{i}" for i in range(2 * s)]
            + ["enc/Dense_0", "dec/Dense_0", "dec/Dense_1", "dec/Conv_0"]
        )

    def layer_rung(self, key: str) -> str | None:
        """Precision rung of one layer, or None = use matmul_precision."""
        if self.layer_precision:
            for k, rung in self.layer_precision:
                if k == key:
                    return rung
        return None

    @property
    def input_shape(self) -> tuple[int, int, int]:
        return (self.stamp_size, self.stamp_size, self.nb_of_bands)


def fidelity_serving_config(**overrides) -> ModelConfig:
    """The fidelity serving configuration of the JAX package: float32 with
    ``matmul_precision='high'`` (whose limb form, bf16x3t, truncates and so
    carries a systematic per-band flux bias), to be loaded with
    ``load_deblender(..., cfg=fidelity_serving_config(), flux_calibration=True)``
    so that the bias is divided back out (utils/flux_cal.py).  Off a TPU the
    'high' rung is plain float32 unless ``limb_emulation=True``."""
    kw = dict(matmul_precision="high")
    kw.update(overrides)
    return ModelConfig(**kw)


# the fidelity mode above meets its flux-error clause only with the
# calibration attached at load
FIDELITY_NEEDS_FLUX_CAL = True


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
    ``render_cache_bytes`` caps the mean, stddev and epistemic stamps that
    ``deblend_field`` keeps on the device for the renders that follow.
    ``epistemic_samples`` is the number of stochastic decodes a source
    behind ``epistemic_uncertainty_estimation=True``."""

    cutout_size: int = 59
    nb_of_bands: int = 6
    epistemic_samples: int = 100
    mse_window: int = 5
    interp_order: int = 3
    source_chunk: int = 8192
    serving_hbm_bytes: int | None = None
    render_cache_bytes: int = 1 << 30
