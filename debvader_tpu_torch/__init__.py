"""debvader_tpu_torch — the PyTorch / CUDA port of debvader_tpu.

Same public surface as the JAX package for the scene deblender's paths
ported so far: detect sources, deblend 59x59xB stamps with the
convolutional VAE, render the predicted stamps back and subtract, either
through the record array of ``DeblendField.deblend_field`` or through the
streaming serving entry points ``deblend_and_render`` /
``deblend_and_predict``, and measure the deblended stamps; the stochastic
stamp API (``deblend_samples``, ``deblend_sample_stats``) and the epistemic
options of ``DeblendField``; position registration
(``optimise_positions=True``), bfloat16 residency of the field and the
serving canvases (``upload_dtype`` / ``device_dtype``), the iterative
detect -> deblend -> subtract loop (``IterativeDeblendField``, with its
device-resident server ``iterative_deblend_and_render``) and tiled
detection of fields larger than one tile (``detect_objects_tiled``,
``TiledDeblendField``); the precision schemes
(``ModelConfig.layer_precision``, ``fidelity_serving_config``) with the flux
calibration that ``load_deblender(..., flux_calibration=True)`` attaches;
and training: ``train_network`` / ``train_deblender`` (the two-stage
trainer with the decoder frozen in stage 2) with flax's train-mode
BatchNorm, optax's Adam, checkpoints, band-count transfer and the native
data loader (``training/``, ``runtime/loader.py``); and int8 quantized
serving (``models/quantized.py``: ``quantize_vae``, ``qat_finetune``,
``load_quantized('sim_demo_int8')``, ``DeblendField(quantized=)``) on the
int8 tensor cores (``csrc/int8_conv.cu``); the model options of the JAX
``ModelConfig`` (``dtype='bfloat16'``, ``strict_cast``,
``decoder_subpixel``, ``decoder_f32_stages``), export through
``torch.export`` (``utils/export.py``, ``DeblendField(artifact=)``), the
reference-shaped ``compat`` namespace and the command line
(``python -m debvader_tpu_torch``, cli.py); and multi-device serving and
training on a device mesh (``parallel/``: ``make_mesh``, the ``mesh=``
options, ``ShardedFieldDeblender``, the row-band sharded serve of
pipeline/sharded_field.py), driven by one process, or for training by
several processes on ``torch.distributed``.
Public functions keep the JAX package's NHWC layout.  Entry points run on the GPU
(``device="cuda"``) unless the caller passes ``device="cpu"``; the kernels
are hand-written CUDA (``csrc/``) built with ``nvcc`` at first use, and
every kernel has a plain PyTorch version that the CPU path runs.
Detection's segment merge and Lutz tree are host C++
(``csrc/segmerge.cpp``), built with ``g++`` at first use on either device.
"""

__version__ = "0.3.0"

from debvader_tpu_torch.api import deblend, deblend_sample_stats, deblend_samples
from debvader_tpu_torch.config import (
    DetectionConfig,
    ModelConfig,
    PipelineConfig,
    TrainConfig,
    fidelity_serving_config,
)
from debvader_tpu_torch.kernels.decoder_tail import decoder_tail_params, fused_decoder_tail
from debvader_tpu_torch.kernels.matched_filter import matched_filter_threshold
from debvader_tpu_torch.kernels.render import render_field_kernel
from debvader_tpu_torch.kernels.tail_fused import fused_tail_pair, tail_pair_params
from debvader_tpu_torch.models.vae import DeblenderVAE, create_decoder, create_encoder, create_model_vae, init_vae
from debvader_tpu_torch.ops.detection import detect_objects, detect_sources
from debvader_tpu_torch.ops.measure import measure_batch
from debvader_tpu_torch.ops.shift import render_field, render_pad
from debvader_tpu_torch.pipeline.field import DeblendField
from debvader_tpu_torch.pipeline.iterative import IterativeDeblendField
from debvader_tpu_torch.pipeline.sharded_field import ShardedFieldDeblender
from debvader_tpu_torch.pipeline.tiles import TiledDeblendField, detect_objects_tiled
from debvader_tpu_torch.training.train import train_deblender, train_network
from debvader_tpu_torch.utils.profiling import stage_timer
from debvader_tpu_torch.weights import load_deblender

__all__ = [
    "deblend",
    "deblend_samples",
    "deblend_sample_stats",
    "detect_objects",
    "detect_sources",
    "detect_objects_tiled",
    "DeblendField",
    "TiledDeblendField",
    "IterativeDeblendField",
    "ShardedFieldDeblender",
    "DeblenderVAE",
    "create_model_vae",
    "create_encoder",
    "create_decoder",
    "init_vae",
    "load_deblender",
    "train_network",
    "train_deblender",
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
    "TrainConfig",
    "fidelity_serving_config",
    "__version__",
]
