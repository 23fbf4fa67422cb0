"""Band-count transfer of a checkpoint, after
debvader_tpu/training/transfer.py.

The reference's warm start restores an identical weight tree, so weights
trained for one band count cannot seed a model with another.
``transfer_band_count`` carries over every tensor whose shape does not
depend on the band count (the latent head, the interior convs, the dense
layers, every PReLU) and draws fresh the band-shaped ones: the encoder's
input BatchNorm (scale, bias, mean, var), the encoder's first conv kernel
and the decoder's band head (kernel and bias).  Matching is by (path,
shape).  Weights are flat flax key-path dicts (weights.py).
"""

from __future__ import annotations

import numpy as np

from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.models.vae import DeblenderVAE, init_vae
from debvader_tpu_torch.weights import flax_from_state_dict

__all__ = ["checkpoint_band_count", "transfer_band_count"]


def checkpoint_band_count(variables: dict) -> int:
    """The band count a checkpoint was trained for (its input BatchNorm is
    shaped (B,))."""
    return int(np.shape(variables["params/encoder/BatchNorm_0/scale"])[0])


def transfer_band_count(variables: dict, model_cfg: ModelConfig, generator=None, return_info: bool = False):
    """Weights for ``model_cfg``: each leaf whose (path, shape) the source
    has is the source's, each other a fresh draw (models/vae.init_vae from
    ``generator``, a CPU ``torch.Generator`` or a seed).  With
    ``return_info`` also {"transferred": [paths], "reinitialized": [paths]}."""
    fresh = init_vae(DeblenderVAE(model_cfg), generator)
    fresh = flax_from_state_dict(fresh.state_dict(), model_cfg)
    out, info = {}, {"transferred": [], "reinitialized": []}
    for path, leaf in fresh.items():
        src = variables.get(path)
        if src is not None and np.shape(src) == leaf.shape:
            out[path] = np.asarray(src, leaf.dtype)
            info["transferred"].append(path)
        else:
            out[path] = leaf
            info["reinitialized"].append(path)
    if not info["transferred"]:
        raise ValueError(
            "no tensor carried over — the checkpoint does not match the target architecture beyond its band count"
        )
    return (out, info) if return_info else out
