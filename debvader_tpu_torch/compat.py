"""Reference-shaped namespace for drop-in migration.

The JAX package's ``compat`` module over the port: users of the reference
import from module paths like ``debvader.detect.detection``; this module
gives the same names in one place, so a port is an import change:

    from debvader_tpu_torch.compat import (
        DeblendField, IterativeDeblendField, detect_objects, extract_cutouts,
        deblend, position_optimization, normalize_non_linear,
        denormalize_non_linear, mse, vae_loss, create_model_vae,
        create_encoder, create_decoder, load_deblender, train_network,
        train_deblender, define_callbacks,
    )

``net`` is a DeblenderVAE (a torch module) where the reference takes a
Keras model; entry points run on ``device='cuda'`` unless given
``device='cpu'``.
"""

from debvader_tpu_torch.api import deblend
from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.models.vae import create_decoder, create_encoder, create_model_vae
from debvader_tpu_torch.ops.detection import detect_objects
from debvader_tpu_torch.ops.extraction import extract_cutouts_host as extract_cutouts
from debvader_tpu_torch.ops.normalize import denormalize_non_linear, normalize_non_linear
from debvader_tpu_torch.ops.registration import position_optimization
from debvader_tpu_torch.pipeline.field import DeblendField
from debvader_tpu_torch.pipeline.iterative import IterativeDeblendField
from debvader_tpu_torch.training.checkpoint import define_callbacks
from debvader_tpu_torch.training.losses import mse
from debvader_tpu_torch.training.train import train_deblender, train_network
from debvader_tpu_torch.weights import load_deblender as _load_deblender

__all__ = [
    "DeblendField",
    "IterativeDeblendField",
    "detect_objects",
    "extract_cutouts",
    "deblend",
    "position_optimization",
    "normalize_non_linear",
    "denormalize_non_linear",
    "mse",
    "vae_loss",
    "create_model_vae",
    "create_encoder",
    "create_decoder",
    "load_deblender",
    "train_network",
    "train_deblender",
    "define_callbacks",
]


def vae_loss(ground_truth, predicted_distribution):
    """The reference's reconstruction loss (training/metrics.py): -log_prob
    of the truth under the predicted per-pixel Normal, per pixel (the
    training loop takes its mean)."""
    return -predicted_distribution.log_prob(ground_truth)


def load_deblender(
    survey: str,
    input_shape=(59, 59, 6),
    latent_dim: int = 32,
    filters=(32, 64, 128, 256),
    kernels=(3, 3, 3, 3),
    return_encoder_decoder_z: bool = False,
    weights_dir=None,
    dtype: str = "float32",
    decoder_f32_stages: int = 0,
    matmul_precision: str | None = None,
    flux_calibration: bool = False,
    device="cuda",
):
    """The reference's (and the JAX package's) positional signature over
    ``weights.load_deblender``: the architecture from ``input_shape``,
    ``latent_dim``, ``filters`` and ``kernels``, then the survey's weights.
    Returns the model, or (model, encode, decode) with
    ``return_encoder_decoder_z``."""
    cfg = ModelConfig(
        stamp_size=input_shape[0],
        nb_of_bands=input_shape[-1],
        latent_dim=latent_dim,
        filters=tuple(filters),
        kernels=tuple(kernels),
        dtype=dtype,
        decoder_f32_stages=decoder_f32_stages,
        matmul_precision=matmul_precision,
    )
    return _load_deblender(
        survey, device=device, weights_dir=weights_dir, cfg=cfg, flux_calibration=flux_calibration,
        return_encoder_decoder_z=return_encoder_decoder_z,
    )
