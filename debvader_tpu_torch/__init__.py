"""debvader_tpu_torch — the PyTorch / CUDA port of debvader_tpu.

Same public surface as the JAX package for the scene deblender's main path:
detect sources, deblend 59x59xB stamps with the convolutional VAE, render
the predicted stamps back and subtract.  Public functions keep the JAX
package's NHWC layout.  Entry points run on the GPU (``device="cuda"``)
unless the caller passes ``device="cpu"``; the detection kernels are
hand-written CUDA (``csrc/``) built with ``nvcc`` at first use, and every
kernel has a plain PyTorch version that the CPU path runs.
"""

__version__ = "0.1.0"

from debvader_tpu_torch.api import deblend
from debvader_tpu_torch.config import DetectionConfig, ModelConfig, PipelineConfig
from debvader_tpu_torch.models.vae import DeblenderVAE
from debvader_tpu_torch.ops.detection import detect_objects, detect_sources
from debvader_tpu_torch.pipeline.field import DeblendField
from debvader_tpu_torch.weights import load_deblender

__all__ = [
    "deblend",
    "detect_objects",
    "detect_sources",
    "DeblendField",
    "DeblenderVAE",
    "load_deblender",
    "ModelConfig",
    "DetectionConfig",
    "PipelineConfig",
    "__version__",
]
