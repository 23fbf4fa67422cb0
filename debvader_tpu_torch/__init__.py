"""debvader_tpu_torch — the PyTorch / CUDA port of debvader_tpu.

Same public surface as the JAX package for the scene deblender's paths
ported so far: detect sources, deblend 59x59xB stamps with the
convolutional VAE, render the predicted stamps back and subtract, either
through the record array of ``DeblendField.deblend_field`` or through the
streaming serving entry points ``deblend_and_render`` /
``deblend_and_predict``, and measure the deblended stamps; the stochastic
stamp API (``deblend_samples``, ``deblend_sample_stats``) and the epistemic
options of ``DeblendField``; the precision schemes
(``ModelConfig.layer_precision``, ``fidelity_serving_config``) with the flux
calibration that ``load_deblender(..., flux_calibration=True)`` attaches.
Public functions keep the JAX package's NHWC layout.  Entry points run on the GPU
(``device="cuda"``) unless the caller passes ``device="cpu"``; the kernels
are hand-written CUDA (``csrc/``) built with ``nvcc`` at first use, and
every kernel has a plain PyTorch version that the CPU path runs.
"""

__version__ = "0.3.0"

from debvader_tpu_torch.api import deblend, deblend_sample_stats, deblend_samples
from debvader_tpu_torch.config import (
    DetectionConfig,
    ModelConfig,
    PipelineConfig,
    fidelity_serving_config,
)
from debvader_tpu_torch.kernels.decoder_tail import decoder_tail_params, fused_decoder_tail
from debvader_tpu_torch.kernels.matched_filter import matched_filter_threshold
from debvader_tpu_torch.kernels.render import render_field_kernel
from debvader_tpu_torch.kernels.tail_fused import fused_tail_pair, tail_pair_params
from debvader_tpu_torch.models.vae import DeblenderVAE
from debvader_tpu_torch.ops.detection import detect_objects, detect_sources
from debvader_tpu_torch.ops.measure import measure_batch
from debvader_tpu_torch.ops.shift import render_field, render_pad
from debvader_tpu_torch.pipeline.field import DeblendField
from debvader_tpu_torch.utils.profiling import stage_timer
from debvader_tpu_torch.weights import load_deblender

__all__ = [
    "deblend",
    "deblend_samples",
    "deblend_sample_stats",
    "detect_objects",
    "detect_sources",
    "DeblendField",
    "DeblenderVAE",
    "load_deblender",
    "measure_batch",
    "render_field",
    "render_pad",
    "render_field_kernel",
    "matched_filter_threshold",
    "fused_decoder_tail",
    "decoder_tail_params",
    "fused_tail_pair",
    "tail_pair_params",
    "stage_timer",
    "ModelConfig",
    "DetectionConfig",
    "PipelineConfig",
    "fidelity_serving_config",
    "__version__",
]
