"""Weights: the flax variable tree of debvader_tpu mapped onto the port's
modules, and the packaged ``sim_demo`` deblender.

The port's weights format is the flax tree's flat key-path dict in an npz,
one array per path ("params/encoder/Conv_0/kernel", "batch_stats/...").
The packaged weights are ``data/weights/<survey>.npz``
(``scripts/convert_sim_demo_to_torch.py`` writes them from the JAX
package's checkpoint); training writes the same format
(training/checkpoint.py) under ``<weights_dir>/<survey>/.../ckpt.npz``.
``state_dict_from_flax`` and ``flax_from_state_dict`` map between that
dict and the port's state dict, exactly, both ways.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.device import fp32_math, resolve_device
from debvader_tpu_torch.models.vae import DeblenderVAE

__all__ = [
    "default_weights_dir",
    "flatten_flax",
    "state_dict_from_flax",
    "flax_from_state_dict",
    "load_flax_npz",
    "weights_file",
    "load_deblender",
    "quantized_from_jax",
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


def _flax_names(cfg: ModelConfig) -> dict[str, tuple[str, object]]:
    """state-dict key -> (flax path, layout: None, "conv" or "alpha")."""
    n = 2 * len(cfg.filters)
    names = {
        "encoder.bn.mean": ("batch_stats/encoder/BatchNorm_0/mean", None),
        "encoder.bn.var": ("batch_stats/encoder/BatchNorm_0/var", None),
        "encoder.bn.scale": ("params/encoder/BatchNorm_0/scale", None),
        "encoder.bn.bias": ("params/encoder/BatchNorm_0/bias", None),
        "encoder.flat_prelu.alpha": (f"params/encoder/PReLU_{n}/alpha", None),
        "encoder.dense.kernel": ("params/encoder/Dense_0/kernel", None),
        "encoder.dense.bias": ("params/encoder/Dense_0/bias", None),
        "decoder.prelu_in.alpha": ("params/decoder/PReLU_0/alpha", None),
        "decoder.dense0.kernel": ("params/decoder/Dense_0/kernel", None),
        "decoder.dense0.bias": ("params/decoder/Dense_0/bias", None),
        "decoder.prelu0.alpha": ("params/decoder/PReLU_1/alpha", None),
        "decoder.dense1.kernel": ("params/decoder/Dense_1/kernel", None),
        "decoder.dense1.bias": ("params/decoder/Dense_1/bias", None),
        "decoder.prelu1.alpha": ("params/decoder/PReLU_2/alpha", None),
        "decoder.head.weight": ("params/decoder/Conv_0/kernel", "conv"),
        "decoder.head.bias": ("params/decoder/Conv_0/bias", None),
    }
    for i in range(n):
        enc, dec = f"params/encoder/Conv_{i}", f"params/decoder/ConvTranspose2DTF_{i}"
        names[f"encoder.convs.{i}.weight"] = (f"{enc}/kernel", "conv")
        names[f"encoder.convs.{i}.bias"] = (f"{enc}/bias", None)
        names[f"encoder.prelus.{i}.alpha"] = (f"params/encoder/PReLU_{i}/alpha", "alpha")
        names[f"decoder.convts.{i}.weight"] = (f"{dec}/kernel", "conv")
        names[f"decoder.convts.{i}.bias"] = (f"{dec}/bias", None)
        names[f"decoder.prelus.{i}.alpha"] = (f"params/decoder/PReLU_{i + 3}/alpha", "alpha")
    names["flux_cal_scale"] = ("flux_cal/scale", None)
    return names


def flax_from_state_dict(sd: dict, cfg: ModelConfig | None = None) -> dict[str, np.ndarray]:
    """The flat flax key-path dict of the port's state dict (parameters,
    BatchNorm statistics and a flux calibration, if any): the inverse of
    :func:`state_dict_from_flax`, what ``load_flax_npz`` reads back."""
    out = {}
    for key, (path, layout) in _flax_names(cfg or ModelConfig()).items():
        if key not in sd or sd[key] is None:
            continue
        a = sd[key].detach().cpu().numpy().astype(np.float32)
        if layout == "conv":
            a = np.transpose(a, (2, 3, 1, 0))
        elif layout == "alpha" and a.ndim == 3:
            a = np.transpose(a, (1, 2, 0))
        out[path] = np.ascontiguousarray(a)
    return out


def state_dict_from_flax(flat: dict, cfg: ModelConfig | None = None) -> dict:
    """The port's state dict from a flax variable tree given as its flat
    key-path dict (:func:`flatten_flax` of what the JAX package's
    ``load_deblender`` or ``init_vae`` return, or a packaged npz).  A
    ``flux_cal/scale`` entry (the JAX package's calibration collection)
    comes across as the buffer ``flux_cal_scale``."""
    layouts = {"conv": _conv, "alpha": _alpha, None: lambda a: a}
    sd = {
        key: layouts[layout](np.asarray(flat[path]))
        for key, (path, layout) in _flax_names(cfg or ModelConfig()).items()
        if path in flat
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def quantized_from_jax(qv_or_parts) -> tuple[dict, dict]:
    """(arrays, meta) of a JAX ``QuantizedVAE`` (or a dict with its
    ``variables``, ``qweights``, ``act_scales``, ``cfg`` and flags) in the
    port's bundle format (models/quantized.py: ``load_quantized`` reads the
    two, ``_from_arrays`` builds the bundle from them): the float
    variables under their flax key paths, unchanged; each int8 kernel
    re-laid-out as the port's weight (conv HWIO -> (out, in, kh, kw), the
    transposed conv's TF (kh, kw, out, in) -> (in, out, kh, kw), the dense
    (in, out) as it is) beside its float32 scale; the activation scales,
    0-d or per channel; and the JAX package's meta.json keys."""
    def get(key, default=None):
        if isinstance(qv_or_parts, dict):
            return qv_or_parts.get(key, default)
        return getattr(qv_or_parts, key, default)

    arrays = flatten_flax(get("variables"))
    for name, (qk, wscale) in get("qweights").items():
        qk = np.asarray(qk)
        if qk.dtype != np.int8:
            raise ValueError(f"{name}: the int8 kernel has dtype {qk.dtype}")
        tag = name.replace("/", "|")
        arrays[f"qweights/{tag}/kernel"] = np.ascontiguousarray(_conv(qk) if qk.ndim == 4 else qk)
        arrays[f"qweights/{tag}/scale"] = np.asarray(wscale, np.float32)
    for name, scale in get("act_scales").items():
        arrays[f"act_scales/{name.replace('/', '|')}"] = np.asarray(scale, np.float32)
    meta = {
        "model_cfg": dataclasses.asdict(get("cfg")),
        "quantize_dense": bool(get("quantize_dense", True)),
        "quantize_final_conv": bool(get("quantize_final_conv", False)),
        "calib_stats": dict(get("calib_stats", {}) or {}),
        "normalise": bool(get("normalise", False)),
        "teacher_fingerprint": get("teacher_fingerprint"),
        "act_granularity": get("act_granularity", "per_tensor"),
    }
    return arrays, meta


def load_flax_npz(path) -> dict[str, np.ndarray]:
    """The flat key-path dict stored in a packaged weights file."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def weights_file(survey: str, weights_dir=None) -> Path:
    """The weights file of ``survey`` under ``weights_dir`` (default: the
    packaged ``data/weights``): the newest ``ckpt.npz`` below
    ``<weights_dir>/<survey>/`` that training wrote (on equal times the
    ``val_loss`` monitor's, then the first path, as the JAX package's
    ``load_weights`` orders its checkpoints), else ``<weights_dir>/<survey>.npz``."""
    base = Path(weights_dir or default_weights_dir())
    survey_dir = base / survey
    found = sorted(survey_dir.rglob("ckpt.npz")) if survey_dir.is_dir() else []
    if found:
        return min(found, key=lambda p: (-p.stat().st_mtime, p.parent.name != "val_loss", str(p)))
    path = base / f"{survey}.npz"
    if not path.exists():
        raise FileNotFoundError(f"no weights for survey {survey!r} under {base}")
    return path


def load_deblender(
    survey: str = "sim_demo",
    device="cuda",
    weights_dir=None,
    cfg: ModelConfig | None = None,
    matmul_precision: str | None = None,
    flux_calibration: bool = False,
    return_encoder_decoder_z: bool = False,
    dtype: str | None = None,
    decoder_f32_stages: int | None = None,
):
    """The deblender for ``survey`` (its weights file, :func:`weights_file`),
    in eval mode on ``device``.

    ``cfg`` selects the precision configuration (the packaged weights have
    the default architecture); ``matmul_precision``, ``dtype`` ('float32'
    or 'bfloat16') and ``decoder_f32_stages`` override its fields, as the
    JAX package's loader builds its config from them before loading.
    ``flux_calibration=True`` measures the built model's per-band flux gain
    against its own 'highest'-rung forward on ``device`` and attaches the
    correction (utils/flux_cal.py): the fidelity serving mode is
    ``cfg=fidelity_serving_config(), flux_calibration=True``.
    ``return_encoder_decoder_z=True`` returns (model, encode, decode) as the
    JAX package's form does: ``encode(x)`` gives the posterior of (N, S, S,
    B) stamps, ``decode(z)`` the PixelNormal of latents, tensors on
    ``device``, without autograd and with TF32 off."""
    dev = resolve_device(device)
    path = weights_file(survey, weights_dir)
    cfg = cfg or ModelConfig()
    overrides = dict(matmul_precision=matmul_precision, dtype=dtype, decoder_f32_stages=decoder_f32_stages)
    overrides = {k: v for k, v in overrides.items() if v is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = DeblenderVAE(cfg)
    model.load_state_dict(state_dict_from_flax(load_flax_npz(path), cfg))
    model = model.to(dev).eval()
    if flux_calibration:
        from debvader_tpu_torch.utils.flux_cal import attach_flux_calibration

        attach_flux_calibration(model)
    if return_encoder_decoder_z:
        def encode(x):
            with torch.no_grad(), fp32_math():
                return model.encode(x)

        def decode(z):
            with torch.no_grad(), fp32_math():
                return model.decode(z)

        return model, encode, decode
    return model
