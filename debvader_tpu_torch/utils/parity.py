"""DC2 pretrained-weight fidelity harness: the port's copy of
debvader_tpu/utils/parity.py.

The fidelity clause ("<= 1e-4 relative flux error against the Keras
weights"): the reference's TF checkpoint, imported into the port's VAE,
must reproduce the reference Keras model's deterministic (latent-mean)
forward on the bundled DC2 stamps.  ``dc2_parity_check`` runs that check
on any machine that holds the checkpoint.  The reference side is either a
precomputed outputs file (``reference_outputs``, or the environment's
``DEBVADER_REFERENCE_OUTPUTS``: the (10, 59, 59, 6) mean image of the
Keras model, written once on a machine with TF by
``save_reference_outputs``) or a live forward through the reference's own
model builder (``reference_forward_mean``), which needs TensorFlow,
TensorFlow Probability and the reference's source
(``DEBVADER_REFERENCE_SRC``) and raises ImportError without them.

``bundled_dc2_stamps`` reads ``DEBVADER_DC2_STAMPS``, else the stamps file
of the reference's source under ``DEBVADER_REFERENCE_SRC``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = [
    "bundled_dc2_stamps",
    "reference_forward_mean",
    "dc2_parity_check",
    "save_reference_outputs",
]

_STAMPS_IN_SOURCE = Path("debvader") / "data" / "dc2_imgs" / "imgs_dc2.npy"


def bundled_dc2_stamps() -> np.ndarray:
    """The 10 bundled DC2 stamps (10, 59, 59, 6) float32."""
    path = os.environ.get("DEBVADER_DC2_STAMPS")
    if path is None:
        src = os.environ.get("DEBVADER_REFERENCE_SRC")
        if src is None:
            raise FileNotFoundError(
                "the DC2 stamps: set DEBVADER_DC2_STAMPS to the .npy, or DEBVADER_REFERENCE_SRC to the "
                "reference's src directory"
            )
        path = Path(src) / _STAMPS_IN_SOURCE
    return np.load(path).astype(np.float32)


def reference_forward_mean(stamps: np.ndarray, ckpt_path: str) -> np.ndarray:
    """The deterministic Keras forward, decoder(z(stamps).mean()).mean(),
    through the reference's model builder (its model/model.py
    ``create_model_vae``) with the checkpoint loaded.  Needs TensorFlow,
    TensorFlow Probability and the reference's source on
    ``DEBVADER_REFERENCE_SRC``; raises ImportError without them."""
    import sys

    ref_src = os.environ.get("DEBVADER_REFERENCE_SRC")
    if ref_src is not None and ref_src not in sys.path:
        sys.path.insert(0, ref_src)
    from debvader.model.model import create_model_vae

    net, encoder, decoder, z = create_model_vae((59, 59, stamps.shape[-1]), 32, [32, 64, 128, 256], [3, 3, 3, 3])
    net.load_weights(ckpt_path).expect_partial()
    z_mean = z(stamps).mean()
    dist = decoder(z_mean)
    return np.asarray(dist.mean())


def save_reference_outputs(ckpt_path: str, out_path: str) -> None:
    """One-time capture of the reference outputs on a machine with TF, for
    machines that have the checkpoint but not TF."""
    np.save(out_path, reference_forward_mean(bundled_dc2_stamps(), ckpt_path))


def dc2_parity_check(
    ckpt_path: str,
    stamps: np.ndarray | None = None,
    reference_outputs: np.ndarray | str | None = None,
    tol: float = 1e-4,
    device="cuda",
) -> dict:
    """Import the reference checkpoint, run the stamps through the port's
    VAE on ``device`` (latent mean, float32) and compare with the Keras
    outputs.  Returns {max_rel_flux, rel_flux (per stamp), max_abs_pix};
    raises AssertionError when the per-stamp relative flux error exceeds
    ``tol``."""
    import torch

    from debvader_tpu_torch.config import ModelConfig
    from debvader_tpu_torch.device import fp32_math, resolve_device
    from debvader_tpu_torch.models.vae import DeblenderVAE
    from debvader_tpu_torch.utils.weight_import import import_reference_checkpoint

    if stamps is None:
        stamps = bundled_dc2_stamps()
    if reference_outputs is None:
        reference_outputs = os.environ.get("DEBVADER_REFERENCE_OUTPUTS")
    if isinstance(reference_outputs, (str, Path)):
        reference_outputs = np.load(reference_outputs)
    if reference_outputs is None:
        reference_outputs = reference_forward_mean(stamps, ckpt_path)

    dev = resolve_device(device)
    # 'highest', as the JAX harness asks: the port's float32 forward on
    # every device
    cfg = ModelConfig(nb_of_bands=stamps.shape[-1], matmul_precision="highest")
    model = DeblenderVAE(cfg)
    model.load_state_dict(import_reference_checkpoint(ckpt_path, cfg, strict=True))
    model = model.to(dev).eval()
    with torch.no_grad(), fp32_math():
        dist, _ = model(torch.as_tensor(np.asarray(stamps, np.float32), device=dev), z_mode="mean")
    ours = dist.mean().cpu().numpy()

    flux_ours = ours.sum(axis=(1, 2, 3), dtype=np.float64)
    flux_ref = np.asarray(reference_outputs).sum(axis=(1, 2, 3), dtype=np.float64)
    rel_flux = np.abs(flux_ours - flux_ref) / np.maximum(np.abs(flux_ref), 1e-30)
    max_abs_pix = float(np.abs(ours - reference_outputs).max())
    result = {
        "max_rel_flux": float(rel_flux.max()),
        "rel_flux": rel_flux.tolist(),
        "max_abs_pix": max_abs_pix,
    }
    assert rel_flux.max() <= tol, (
        f"DC2 flux parity FAILED: max rel flux {rel_flux.max():.3e} > {tol:.1e} "
        f"(per-stamp: {np.round(rel_flux, 6).tolist()})"
    )
    return result
