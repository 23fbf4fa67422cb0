"""Weights: the flax variable tree of debvader_tpu mapped onto the port's
modules, and the packaged ``sim_demo`` deblender.

The packaged weights live in ``data/weights/<survey>.npz``, one array per
flax key path ("params/encoder/Conv_0/kernel", "batch_stats/...").
``scripts/convert_sim_demo_to_torch.py`` writes that file from the JAX
package's checkpoint.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.device import resolve_device
from debvader_tpu_torch.models.vae import DeblenderVAE

__all__ = [
    "default_weights_dir",
    "flatten_flax",
    "state_dict_from_flax",
    "load_flax_npz",
    "load_deblender",
]


def default_weights_dir() -> Path:
    return Path(__file__).resolve().parent / "data" / "weights"


def flatten_flax(variables, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested flax tree -> {"params/encoder/Conv_0/kernel": array, ...}."""
    out = {}
    for key, value in variables.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(value, "items"):
            out.update(flatten_flax(value, path))
        else:
            out[path] = np.asarray(value, np.float32)
    return out


def _conv(kernel: np.ndarray) -> np.ndarray:
    # HWIO conv kernel -> (out, in, kh, kw); TF convT (kh, kw, out, in) ->
    # (in, out, kh, kw): the same permutation
    return np.transpose(kernel, (3, 2, 0, 1))


def _alpha(alpha: np.ndarray) -> np.ndarray:
    # (H, W, C) activation-shaped alpha -> (C, H, W); vectors unchanged
    return np.transpose(alpha, (2, 0, 1)) if alpha.ndim == 3 else alpha


def state_dict_from_flax(flat: dict, cfg: ModelConfig | None = None) -> dict:
    """The port's state dict from a flax variable tree given as its flat
    key-path dict (:func:`flatten_flax` of what the JAX package's
    ``load_deblender`` or ``init_vae`` return, or a packaged npz).  A
    ``flux_cal/scale`` entry (the JAX package's calibration collection)
    comes across as the buffer ``flux_cal_scale``."""
    cfg = cfg or ModelConfig()

    def get(path):
        return flat[path]

    n = 2 * len(cfg.filters)
    sd = {
        "encoder.bn.mean": get("batch_stats/encoder/BatchNorm_0/mean"),
        "encoder.bn.var": get("batch_stats/encoder/BatchNorm_0/var"),
        "encoder.bn.scale": get("params/encoder/BatchNorm_0/scale"),
        "encoder.bn.bias": get("params/encoder/BatchNorm_0/bias"),
        "encoder.flat_prelu.alpha": get(f"params/encoder/PReLU_{n}/alpha"),
        "encoder.dense.kernel": get("params/encoder/Dense_0/kernel"),
        "encoder.dense.bias": get("params/encoder/Dense_0/bias"),
        "decoder.prelu_in.alpha": get("params/decoder/PReLU_0/alpha"),
        "decoder.dense0.kernel": get("params/decoder/Dense_0/kernel"),
        "decoder.dense0.bias": get("params/decoder/Dense_0/bias"),
        "decoder.prelu0.alpha": get("params/decoder/PReLU_1/alpha"),
        "decoder.dense1.kernel": get("params/decoder/Dense_1/kernel"),
        "decoder.dense1.bias": get("params/decoder/Dense_1/bias"),
        "decoder.prelu1.alpha": get("params/decoder/PReLU_2/alpha"),
        "decoder.head.weight": _conv(get("params/decoder/Conv_0/kernel")),
        "decoder.head.bias": get("params/decoder/Conv_0/bias"),
    }
    for i in range(n):
        enc = f"params/encoder/Conv_{i}"
        sd[f"encoder.convs.{i}.weight"] = _conv(get(f"{enc}/kernel"))
        sd[f"encoder.convs.{i}.bias"] = get(f"{enc}/bias")
        sd[f"encoder.prelus.{i}.alpha"] = _alpha(get(f"params/encoder/PReLU_{i}/alpha"))
        dec = f"params/decoder/ConvTranspose2DTF_{i}"
        sd[f"decoder.convts.{i}.weight"] = _conv(get(f"{dec}/kernel"))
        sd[f"decoder.convts.{i}.bias"] = get(f"{dec}/bias")
        sd[f"decoder.prelus.{i}.alpha"] = _alpha(get(f"params/decoder/PReLU_{i + 3}/alpha"))
    if "flux_cal/scale" in flat:
        sd["flux_cal_scale"] = get("flux_cal/scale")
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def load_flax_npz(path) -> dict[str, np.ndarray]:
    """The flat key-path dict stored in a packaged weights file."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_deblender(
    survey: str = "sim_demo",
    device="cuda",
    weights_dir=None,
    cfg: ModelConfig | None = None,
    matmul_precision: str | None = None,
    flux_calibration: bool = False,
) -> DeblenderVAE:
    """The packaged deblender for ``survey``, in eval mode on ``device``.

    ``cfg`` selects the precision configuration (the packaged weights have
    the default architecture); ``matmul_precision`` overrides its rung.
    ``flux_calibration=True`` measures the built model's per-band flux gain
    against its own 'highest'-rung forward on ``device`` and attaches the
    correction (utils/flux_cal.py): the fidelity serving mode is
    ``cfg=fidelity_serving_config(), flux_calibration=True``."""
    dev = resolve_device(device)
    path = Path(weights_dir or default_weights_dir()) / f"{survey}.npz"
    if not path.exists():
        raise FileNotFoundError(f"no weights for survey {survey!r} at {path}")
    cfg = cfg or ModelConfig()
    if matmul_precision is not None:
        cfg = dataclasses.replace(cfg, matmul_precision=matmul_precision)
    model = DeblenderVAE(cfg)
    model.load_state_dict(state_dict_from_flax(load_flax_npz(path), cfg))
    model = model.to(dev).eval()
    if flux_calibration:
        from debvader_tpu_torch.utils.flux_cal import attach_flux_calibration

        attach_flux_calibration(model)
    return model
