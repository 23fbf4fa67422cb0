"""Configuration of the port: the fields of debvader_tpu's configs that the
ported paths read, under the same names and with the same defaults.

The port keeps its own copy because the JAX package's config module
imports ``jax.numpy``.  ``ModelConfig`` carries every field of the JAX
package's, so ``ModelConfig(**dataclasses.asdict(jax_cfg))`` builds the
same model; ``compute_dtype`` is a ``torch.dtype`` where JAX's is a numpy
dtype.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "ModelConfig",
    "DetectionConfig",
    "PipelineConfig",
    "TrainConfig",
    "fidelity_serving_config",
    "FIDELITY_NEEDS_FLUX_CAL",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the convolutional VAE (59x59xB input, latent 32,
    filters 32/64/128/256, 3x3 kernels, pixel-Normal scale floor 1e-4,
    TriL diagonal shift 1e-5, KL weight 0.01).

    ``dtype`` is the compute dtype of the conv and dense stacks, 'float32'
    or 'bfloat16'; the parameters stay float32 (models/vae.py follows the
    flax graph's rounding points).  ``strict_cast`` runs the decoder's big
    Dense (dec/Dense_1) in float32 under a bfloat16 ``dtype``, as the
    reference casts before it.  ``decoder_subpixel`` runs the decoder's
    stride-2 transposed convs and its band head in the sub-pixel
    formulation (models/layers.py), numerically equivalent and with the
    same parameters.  ``decoder_f32_stages`` = N runs the decoder's last N
    stage pairs, and the band head when N > 0, in float32 whatever
    ``dtype`` is.

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
    kl_weight: float = 0.01
    dtype: str = "float32"
    strict_cast: bool = True
    decoder_subpixel: bool = False
    decoder_f32_stages: int = 0
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
        if not 0 <= self.decoder_f32_stages <= len(self.filters):
            raise ValueError(
                f"decoder_f32_stages must be in [0, {len(self.filters)}], "
                f"got {self.decoder_f32_stages}"
            )
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {self.dtype!r}")
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

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def fidelity_serving_config(**overrides) -> ModelConfig:
    """The fidelity serving configuration of the JAX package: float32 with
    ``matmul_precision='high'`` (whose limb form, bf16x3t, truncates and so
    carries a systematic per-band flux bias), to be loaded with
    ``load_deblender(..., cfg=fidelity_serving_config(), flux_calibration=True)``
    so that the bias is divided back out (utils/flux_cal.py).  Off a TPU the
    'high' rung is plain float32 unless ``limb_emulation=True``."""
    kw = dict(dtype="float32", matmul_precision="high")
    kw.update(overrides)
    return ModelConfig(**kw)


# the fidelity mode above meets its flux-error clause only with the
# calibration attached at load
FIDELITY_NEEDS_FLUX_CAL = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training defaults, the JAX package's: Adam at 1e-4, batches of 5,
    10 epochs, the KL term weighted 0.01.

    ``kl_mode``: 'analytic' (the closed-form KL of the MVN posterior to
    N(0, I)) or 'mc' (the single-sample estimate at the sampled latent,
    what the reference's Keras regularizer computes).
    ``kl_anneal_steps`` > 0 ramps the KL weight linearly from 0 over that
    many steps.  ``seed`` seeds the initialisation, the latent noise, the
    validation noise and the host shuffle of each epoch's batches."""

    learning_rate: float = 1e-4
    batch_size: int = 5
    epochs: int = 10
    kl_weight: float = 0.01
    kl_mode: str = "analytic"
    kl_anneal_steps: int = 0
    seed: int = 0
    shuffle: bool = True


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """SExtractor-equivalent detection: watershed segmentation with the
    quantized multi-threshold merge, a ``filter_size`` x ``filter_size``
    Gaussian matched filter, 64-px background boxes.
    ``threshold_scaling`` is 'sep_conv' (thresh * rms, the reference's
    behaviour) or 'matched' (thresh * rms * ||k||_2).

    Every field of the JAX package's ``DetectionConfig`` is here, under
    its name and with its default, so a JAX config carries over
    (``DetectionConfig(**dataclasses.asdict(jax_cfg))``).  What the backend
    fields select in the port:

    - ``use_pallas_fused``: True runs the fused detect core
      (kernels/detect_fused.py: filter, threshold and parent race in one
      kernel); False runs the chain background -> filter -> race -> labels
      step by step.  None (default) is the JAX package's auto mode, with
      "on the accelerator" read as "on either device" (every kernel
      wrapper of the port takes its plain version on the CPU itself): the
      fused core runs iff ``use_pallas_select``, since in the JAX package
      it feeds the Pallas label step that this field switches off.  The
      fused core takes a 7x7 filter only; any other ``filter_size`` runs
      the chain.
    - ``use_pallas_filter``: True runs the chain with the stand-alone
      matched-filter kernel (kernels/matched_filter.py) as its filter, and
      wins over the fused core.  Otherwise the chain filters with
      ``F.conv2d``, as it does for any ``filter_size`` other than 7.  The
      chain's parent race is a kernel of its own (kernels/parent_race.py).
    - ``use_pallas_select`` and ``use_pallas_clip`` change no backend
      beyond the auto rule above: the port has no XLA chain to fall back
      to, so a card always runs the label kernel (kernels/label_select.py)
      and the clipped-statistics kernel (kernels/clipped_stats.py), and
      the CPU their plain versions.
    - ``deblend_algo``: 'watershed' (default) merges the watershed
      segments; 'lutz' replaces them with the multi-threshold tree.  Both
      run in the native host library (kernels/segmerge.py)."""

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
    use_pallas_select: bool = True
    use_pallas_clip: bool | None = None
    clean: bool = True
    clean_param: float = 1.0
    deblend_algo: str = "watershed"

    def __post_init__(self):
        if self.deblend_algo not in ("watershed", "lutz"):
            raise ValueError(
                f"deblend_algo must be 'watershed' or 'lutz', got "
                f"{self.deblend_algo!r}"
            )
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
    behind ``epistemic_uncertainty_estimation=True``.
    ``position_bounds`` and ``gn_iterations`` bound the registration of
    ``optimise_positions=True``: shifts within +-position_bounds pixels,
    fitted over gn_iterations Gauss-Newton steps.
    ``tile_size`` and ``tile_overlap`` cut a field larger than one tile
    into overlapping square tiles for detection (pipeline/tiles.py): the
    JAX package's defaults, 1024-pixel tiles overlapping by 64."""

    cutout_size: int = 59
    nb_of_bands: int = 6
    epistemic_samples: int = 100
    mse_window: int = 5
    position_bounds: float = 3.0
    gn_iterations: int = 20
    interp_order: int = 3
    tile_size: int = 1024
    tile_overlap: int = 64
    source_chunk: int = 8192
    serving_hbm_bytes: int | None = None
    render_cache_bytes: int = 1 << 30
