"""int8 quantized serving of the deblender: the port of
debvader_tpu/models/quantized.py.

Symmetric post-training quantization of the VAE's convs, transposed convs
and two large dense layers:

- **weights** per output channel, ``scale = max|w| / 127``; with
  per-input-channel activation scales (``act_granularity='per_channel'``)
  the scales are folded into the weights before they are quantized
  (``_quant_weight_folded``), so the runtime path is the same;
- **activations** ``clip(round(h / s), -127, 127)`` at each quantization
  point, ``s`` calibrated as the abs-max (or a quantile) over a batch;
- **accumulation** s8 x s8 -> s32 on the int8 tensor cores
  (kernels/int8_conv.py, ``csrc/int8_conv.cu``), dequantized as
  ``float32(acc) * (dq * wscale) + bias``; where the next quantization
  point is int8 too, the same launch applies the PReLU(s) between them and
  the next quantizer, and writes the next layer's int8 input
  (``_int8_forward``).

BatchNorm, PReLU, the latent head, the decoder's small dense layer and, by
default, the final band conv stay float.  Under ``ModelConfig.dtype=
'bfloat16'`` the route rounds where JAX's does: the stamps and the
BatchNorm's output, each int8 layer's output after the bias and each
PReLU in bfloat16 (dec/Dense_1 under ``strict_cast`` in float32, rounded
once at the decoder's reshape), the float layers as the bfloat16 model
computes them; the encoder's and the band head's outputs are widened to
float32.  The layer names are the JAX
package's ("enc/Conv_0", "enc/Dense_0", "dec/Dense_1",
"dec/ConvTranspose2DTF_0", "dec/Conv_0"); each int8 kernel is kept in the
port's layout of its float weight (conv (out, in, kh, kw), transposed conv
(in, out, kh, kw), dense (in, out)).

What is held to the JAX package:

- ``_forward`` with no quantized layers is bit-identical to
  ``DeblenderVAE.forward`` (the same module calls), as JAX's is to its
  Flax model.
- The int8 layers give JAX's int32 accumulators bit for bit, and the
  dequantization multiplies and adds as JAX's eager ``quantized_forward``
  does (no fused multiply-add).  JAX's jitted ``make_quantized_forward``
  may contract the dequantization into an FMA: the port is held to it
  within a tolerance.
- Divisions by the constant 127: ``quantize_vae`` and the requantization
  run eagerly in JAX, where they are true divisions; the QAT step is
  jitted, where XLA multiplies by the float32 reciprocal instead
  (``_fake_quant_weight`` does the same).
- Latent noise (calibration's sampled forward and the ELBO loss of QAT)
  comes from ``_latent_noise`` (training/train.py's), which the tests
  replace in this module to replay JAX's draws; threefry's stream cannot
  be reproduced.
- ``params_fingerprint`` hashes the float parameters in JAX's tree-flatten
  order and layouts, so a teacher fingerprint is the same in both
  packages.

``make_sharded_quantized_forward`` splits the batch over a mesh's 'data'
axis (parallel/mesh.py), the bundle copied to each shard's device.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.device import fp32_math, resolve_device
from debvader_tpu_torch.kernels import int8_conv
from debvader_tpu_torch.models.distributions import MultivariateNormalTriL, PixelNormal, softplus_tril
from debvader_tpu_torch.models.layers import Dense, conv2d_same, conv_transpose2d_tf
from debvader_tpu_torch.models.vae import DeblenderVAE, _reduced, _widened
from debvader_tpu_torch.ops.normalize import denormalize_distribution, normalize_non_linear
from debvader_tpu_torch.training.train import _latent_noise

__all__ = [
    "QuantizedVAE",
    "params_fingerprint",
    "quantize_vae",
    "quantized_forward",
    "make_quantized_forward",
    "qat_finetune",
    "save_quantized",
    "load_quantized",
]

# XLA's float32 reciprocal of the constant 127 (a jitted x / 127.0)
_INV127 = float(np.float32(1.0) / np.float32(127.0))


# --------------------------------------------------------------------- utils


def _axes(name: str) -> tuple[int, int]:
    """(out_axis, in_axis) of the layer's weight in the port's layout."""
    layer = name.split("/")[1]
    if layer.startswith("ConvTranspose"):
        return 1, 0
    if layer.startswith("Conv"):
        return 0, 1
    return 1, 0


def _kind(name: str) -> str:
    layer = name.split("/")[1]
    return "convT" if layer.startswith("ConvTranspose") else "conv" if layer.startswith("Conv") else "dense"


def _module(model: DeblenderVAE, name: str):
    """The port's module of a JAX layer name."""
    scope, layer = name.split("/")
    index = int(layer.rsplit("_", 1)[1])
    if scope == "enc":
        if layer.startswith("Conv_"):
            return model.encoder.convs[index]
        if layer == "Dense_0":
            return model.encoder.dense
    elif scope == "dec":
        if layer.startswith("ConvTranspose2DTF_"):
            return model.decoder.convts[index]
        if layer == "Conv_0":
            return model.decoder.head
        if layer in ("Dense_0", "Dense_1"):
            return (model.decoder.dense0, model.decoder.dense1)[index]
    raise KeyError(f"no layer named {name!r}")


def _weight(module) -> torch.Tensor:
    return module.kernel if isinstance(module, Dense) else module.weight


def _along(v: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


def _quant_weight(kernel: torch.Tensor, out_axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: (int8 kernel, float32 scale
    (C_out,)), the scale a true division by 127."""
    k = kernel.detach().to(torch.float32)
    axes = tuple(a for a in range(k.ndim) if a != out_axis)
    absmax = torch.amax(torch.abs(k), dim=axes)
    scale = torch.clamp(absmax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(k / _along(scale, k.ndim, out_axis)), -127, 127).to(torch.int8)
    return q, scale


def _quant_weight_folded(kernel: torch.Tensor, out_axis: int, in_axis: int,
                         s_in: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weight quantization with per-input-channel activation scales folded
    in: quantize ``w * s_in[cin]`` per output channel, so that the int8
    product of ``round(h / s_in)`` dequantizes with one multiply per
    output channel.  A 0-d ``s_in`` quantizes the weight alone."""
    if s_in.ndim == 0:
        return _quant_weight(kernel, out_axis)
    k = kernel.detach().to(torch.float32) * _along(s_in.to(torch.float32), kernel.ndim, in_axis)
    return _quant_weight(k, out_axis)


def _quant_act(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``clip(round(h / scale), -127, 127)``, channels last
    (kernels/int8_conv.quant_act)."""
    return int8_conv.quant_act(h, scale)


def _bcast(scale: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """A per-tensor or per-channel (axis 1) scale shaped to broadcast on h."""
    return scale if scale.ndim == 0 else _along(scale, h.ndim, 1)


def _act_grid(hf: torch.Tensor, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the dequantized int8 grid point of each float32 activation, whether
    it lies inside the clip range)."""
    q = torch.clamp(torch.round(hf / s), -127, 127) * s
    return q, torch.abs(hf) <= 127.0 * s


def _fake_quant_act(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Differentiable int8 activation quantization (clipped straight-through
    estimator): the value of the dequantized int8 grid point, gradient 1
    inside the clip range and 0 outside."""
    hf = h.to(torch.float32)
    q, inside = _act_grid(hf, _bcast(scale.to(torch.float32), hf))
    return torch.where(inside, hf + (q - hf).detach(), q.detach())


def _fake_quant_weight(kernel: torch.Tensor, out_axis: int, in_axis: int | None = None,
                       s_in: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable per-output-channel weight quantization (STE), the
    scale tracking the live weights without a gradient; with a vector
    ``s_in``, the folded grid: unfold(ste_quant(w * s_in)).  The division
    by 127 is the multiply by its float32 reciprocal that XLA compiles in
    JAX's jitted QAT step."""
    k = kernel.to(torch.float32)
    fold = s_in is not None and s_in.ndim > 0
    if fold:
        sb = _along(s_in.to(torch.float32), k.ndim, in_axis).detach()
        k = k * sb
    axes = tuple(a for a in range(k.ndim) if a != out_axis)
    absmax = torch.amax(torch.abs(k), dim=axes, keepdim=True)
    scale = (torch.clamp(absmax, min=1e-30) * _INV127).detach()
    q = torch.clamp(torch.round(k / scale), -127, 127) * scale
    out = k + (q - k).detach()
    if fold:
        out = out / sb
    return out


def _quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """jnp.quantile(a, q, axis=0) with linear interpolation, by two order
    statistics (``kthvalue``, no 2^24-element limit): the position
    q * (n - 1) and its weights in float32 as JAX computes them, then
    v[lo] * (1 - w) + v[hi] * w with the first product fused into the add,
    as XLA compiles jnp.quantile (a jitted function)."""
    n = a.shape[0]
    pos = np.float32(q) * (np.float32(n) - np.float32(1.0))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo)
    w_lo = np.float32(np.float32(1.0) - w_hi)
    top = np.float32(n) - np.float32(1.0)
    lo, hi = int(min(max(lo, 0), top)), int(min(max(hi, 0), top))
    v_lo = torch.kthvalue(a, lo + 1, dim=0).values
    v_hi = v_lo if hi == lo else torch.kthvalue(a, hi + 1, dim=0).values
    return torch.add((v_hi * float(w_hi)).double(), v_lo.double(), alpha=float(w_lo)).float()


def _calib_stat(h: torch.Tensor, q: float = 1.0, per_channel: bool = False) -> torch.Tensor:
    """Calibration statistic of |h|: the max (q >= 1) or the q-quantile,
    over everything or (``per_channel``) per channel, the channel axis 1
    (NCHW activations, (N, F) dense inputs)."""
    a = torch.abs(h.detach().to(torch.float32))
    if per_channel:
        if q >= 1.0:
            return torch.amax(a, dim=tuple(d for d in range(a.ndim) if d != 1))
        return _quantile(torch.movedim(a, 1, -1).reshape(-1, a.shape[1]), q)
    if q >= 1.0:
        return torch.amax(a)
    return _quantile(a.reshape(-1), q)


class _Collect(dict):
    """Calibration statistics by layer name, and how to take them."""

    def __init__(self, q: float, per_channel: bool):
        super().__init__()
        self.q, self.per_channel = q, per_channel


# ----------------------------------------------------------------- container


@dataclass
class QuantizedVAE:
    """A quantized serving bundle: the float model and its calibrated int8
    data.  ``qweights[name] = (int8 kernel, float32 wscale (Cout,))`` and
    ``act_scales[name]`` the input scale of layer ``name``, 0-d (per
    tensor) or (Cin,) (per channel, folded into ``qweights``).  Layers
    absent from ``qweights`` run in float.  ``normalise``: calibration saw
    tanh(arcsinh(x)) stamps, and serving must too (DeblendField checks).
    ``teacher_fingerprint`` is set by ``qat_finetune`` (the fingerprint of
    the float teacher) and arms its re-teaching guard."""

    model: DeblenderVAE
    qweights: dict
    act_scales: dict
    quantize_dense: bool = True
    quantize_final_conv: bool = False
    calib_stats: dict = field(default_factory=dict)
    normalise: bool = False
    teacher_fingerprint: str | None = None
    act_granularity: str = "per_tensor"
    _layers: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.model.encoder.bn.scale.device

    def to(self, device) -> "QuantizedVAE":
        """The bundle with its model and int8 data on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            model=copy.deepcopy(self.model).to(dev),
            qweights={k: (q.to(dev), s.to(dev)) for k, (q, s) in self.qweights.items()},
            act_scales={k: v.to(dev) for k, v in self.act_scales.items()},
            _layers={},
        )

    def int8_layers(self) -> dict:
        """{name: kernels/int8_conv.Int8Layer} of the quantized layers,
        packed once for the model's device; each epilogue computes in its
        module's dtype and hands on the model's compute dtype."""
        dev = self.device
        if dev not in self._layers:
            layers = {}
            for name, (qk, wscale) in self.qweights.items():
                module = _module(self.model, name)
                layers[name] = int8_conv.make_layer(
                    _kind(name), qk.to(dev), wscale.to(dev), self.act_scales[name].to(dev), module.bias,
                    getattr(module, "stride", 1), module.dtype, self.cfg.compute_dtype,
                )
            self._layers[dev] = layers
        return self._layers[dev]


def _jax_param_items(model: DeblenderVAE) -> list:
    """The float parameters as (flax path, float32 array in JAX's layout),
    in jax.tree_util's flatten order (keys sorted at every level)."""
    from debvader_tpu_torch.weights import flax_from_state_dict

    flat = flax_from_state_dict(model.state_dict(), model.cfg)
    paths = sorted((p for p in flat if p.startswith("params/")), key=lambda p: tuple(p.split("/")))
    return [(p, flat[p]) for p in paths]


def params_fingerprint(model: DeblenderVAE) -> str:
    """16-hex-digit sha256 prefix of the float parameters' bytes in JAX's
    tree-flatten order and layouts: the JAX package's
    ``params_fingerprint(variables['params'])`` of the same weights."""
    h = hashlib.sha256()
    for _, leaf in _jax_param_items(model):
        h.update(np.ascontiguousarray(leaf, np.float32).tobytes())
    return h.hexdigest()[:16]


# ------------------------------------------------------------------- layers


def _quant_point(h, name, module, qw, ascales, collect, fake):
    """One conv, transposed conv or dense layer of the float, calibration
    or QAT forward: float (its module) or, with ``fake`` and ``name`` in
    ``qw``, the differentiable QAT form on the int8 grid (float32
    accumulation and bias, STE gradients), rounded once to the module's
    dtype as JAX's ``(y + bias).astype(dtype)``."""
    if collect is not None:
        collect[name] = _calib_stat(h, collect.q, collect.per_channel)
    if qw is None or name not in qw:
        return module(h)
    s = ascales[name]
    out_axis, in_axis = _axes(name)
    w = _fake_quant_weight(_weight(module), out_axis, in_axis, s)
    x = _fake_quant_act(h, s)
    if module.dtype == torch.float32:
        key = "kernel" if isinstance(module, Dense) else "weight"
        return torch.func.functional_call(module, {key: w}, (x,))
    if isinstance(module, Dense):
        y = x @ w
    else:
        tf_layer = conv2d_same if _kind(name) == "conv" else conv_transpose2d_tf
        y = tf_layer(x, w, module.stride)
    bias = module.bias.view((-1,) + (1,) * (y.ndim - 2))
    return (y + bias).to(module.dtype)


# ------------------------------------------------------------------ forward


def _latent(h: torch.Tensor, cfg: ModelConfig, z_mode: str, generator, eps):
    """The posterior of the encoder's output and its latent: its mean, or
    'sample' with ``eps`` or a draw through ``_latent_noise``."""
    loc, tril = softplus_tril(h, cfg.latent_dim, cfg.diag_shift)
    posterior = MultivariateNormalTriL(loc, tril)
    if z_mode == "sample":
        if eps is None:
            eps = _latent_noise(generator, tuple(loc.shape), loc)
        return posterior, posterior.sample(eps=eps)
    if z_mode == "mean":
        return posterior, posterior.mean()
    raise ValueError(f"unknown z_mode {z_mode!r}")


def _head(h: torch.Tensor, cfg: ModelConfig) -> PixelNormal:
    """The band head's ReLU output, cropped to the stamp and widened to
    float32, as a PixelNormal."""
    h = F.relu(h)
    crop = h.shape[-1] - cfg.stamp_size
    if crop > 0:
        lo = crop // 2
        hi = h.shape[-1] - (crop - lo)
        h = h[:, :, lo:hi, lo:hi]
    h = _widened(h.permute(0, 2, 3, 1))
    return PixelNormal(h[..., : cfg.nb_of_bands], cfg.scale_floor + h[..., cfg.nb_of_bands :])


def _forward(model: DeblenderVAE, x: torch.Tensor, z_mode: str, qw=None, ascales=None, collect=None,
             fake: bool = False, generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
    """The VAE forward with each conv, transposed conv and large dense
    layer a quantization point; x (N, S, S, B).  ``qw=None`` is
    bit-identical to ``DeblenderVAE.forward`` (the same module calls);
    ``qw`` maps the quantized layers' names to Int8Layers (int8, through
    ``_int8_forward``) or, with ``fake=True``, names the layers that run
    the QAT form.  'sample' takes ``eps`` or draws it through
    ``_latent_noise``."""
    model = _stock_layers(model)
    if qw is not None and not fake:
        return _int8_forward(model, x, z_mode, qw, ascales, generator, eps)
    cfg = model.cfg
    dtype = cfg.compute_dtype
    enc, dec = model.encoder, model.decoder
    h = enc.bn(_reduced(x, dtype).permute(0, 3, 1, 2))
    for i, act in enumerate(enc.prelus):
        h = act(_quant_point(h, f"enc/Conv_{i}", enc.convs[i], qw, ascales, collect, fake))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = _quant_point(enc.flat_prelu(h), "enc/Dense_0", enc.dense, qw, ascales, collect, fake)
    posterior, z = _latent(_widened(h), cfg, z_mode, generator, eps)

    # the small dense layer (latent -> 560) always runs in float
    h = dec.prelu0(_quant_point(dec.prelu_in(_reduced(z, dtype)), "dec/Dense_0", dec.dense0, None, None, collect,
                                fake))
    h = dec.prelu1(_quant_point(h, "dec/Dense_1", dec.dense1, qw, ascales, collect, fake))
    # the cast at the reshape (a float32 dec/Dense_1 under strict_cast),
    # which the transposed conv's own input cast repeats in the float path
    h = h.to(dtype).reshape(h.shape[0], dec.width, dec.width, cfg.filters[-1]).permute(0, 3, 1, 2)
    for j, act in enumerate(dec.prelus):
        h = act(_quant_point(h, f"dec/ConvTranspose2DTF_{j}", dec.convts[j], qw, ascales, collect, fake))
    return _head(_quant_point(h, "dec/Conv_0", dec.head, qw, ascales, collect, fake), cfg), posterior


def _stock_layers(model: DeblenderVAE) -> DeblenderVAE:
    """The model whose layers the int8 route calls.  JAX's int8 forward
    reads no ``decoder_subpixel``: its float layers are the stock convs.
    So a sub-pixel model runs through a twin built without it on the meta
    device (no allocation) that holds the model's own parameters and
    buffers: gradients reach them, and nothing is copied."""
    if not model.cfg.decoder_subpixel:
        return model
    with torch.device("meta"):
        twin = DeblenderVAE(dataclasses.replace(model.cfg, decoder_subpixel=False))
    twin.load_state_dict(model.state_dict(keep_vars=True), assign=True)
    return twin.train(model.training)


def _int8_step(h, name, module, qw, ascales, act=None, flat_act=None, nxt=None):
    """One conv, transposed conv or dense layer of the int8 forward and
    the PReLU ``act`` after it (then, for the encoder's last conv, the
    flatten to (h, w, c) order and the PReLU ``flat_act``).  ``h`` is
    float32 (NCHW, or (N, F)) or the int8 channels-last input that the
    layer before wrote.  Where this layer and the next quantization point
    ``nxt`` are both int8, one ``conv_fused`` launch applies the PReLUs
    and nxt's quantizer and returns nxt's int8 input ((N, H, W, C), or (N,
    F) after the flatten): the float32 activation never reaches memory.
    Otherwise the result is float32, as the float forward's."""
    if name in qw:
        if h.dtype != torch.int8:
            h = _quant_act(h, ascales[name])
        alpha = None if act is None else act.alpha
        if nxt in qw:
            q = int8_conv.conv_fused(h, qw[name], alpha, None if flat_act is None else flat_act.alpha, ascales[nxt])
            return q if flat_act is None else q.reshape(q.shape[0], -1)
        h = int8_conv.conv_fused(h, qw[name], alpha)
    else:
        h = module(h)
        if act is not None:
            h = act(h)
    if flat_act is not None:
        h = flat_act(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))
    return h


def _int8_forward(model: DeblenderVAE, x: torch.Tensor, z_mode: str, qw: dict, ascales: dict, generator, eps):
    """``_forward`` with the Int8Layers ``qw``: each int8 layer writes the
    next layer's int8 input where that layer is int8 too.  Where a float
    layer comes before an int8 one, its elementwise tail and the quantizer
    are one kernel: the BatchNorm before enc/Conv_0 (``bn_quant``) and the
    float dec/Dense_0's bias and PReLU before dec/Dense_1
    (``bias_prelu_quant``, after dec/Dense_0's product); the stand-alone
    quantizer runs only after another float layer."""
    cfg = model.cfg
    dtype = cfg.compute_dtype
    enc, dec = model.encoder, model.decoder
    if "enc/Conv_0" in qw:
        h = int8_conv.bn_quant(x.contiguous(), enc.bn, ascales["enc/Conv_0"])
    else:
        h = enc.bn(_reduced(x, dtype).permute(0, 3, 1, 2))
    last = len(enc.convs) - 1
    for i, act in enumerate(enc.prelus):
        h = _int8_step(h, f"enc/Conv_{i}", enc.convs[i], qw, ascales, act, enc.flat_prelu if i == last else None,
                       "enc/Dense_0" if i == last else f"enc/Conv_{i + 1}")
    h = _widened(_int8_step(h, "enc/Dense_0", enc.dense, qw, ascales))
    posterior, z = _latent(h, cfg, z_mode, generator, eps)

    h = dec.prelu_in(_reduced(z, dtype))
    if "dec/Dense_1" in qw and dec.dense0.scheme is None:
        # dec/Dense_0's product in its dtype, as Dense.forward forms it
        mm = h.to(dec.dense0.dtype) @ dec.dense0.kernel.to(dec.dense0.dtype)
        h = int8_conv.bias_prelu_quant(mm.contiguous(), dec.dense0.bias, dec.prelu0.alpha, ascales["dec/Dense_1"])
    else:
        h = dec.prelu0(dec.dense0(h))
    h = _int8_step(h, "dec/Dense_1", dec.dense1, qw, ascales, dec.prelu1, None, "dec/ConvTranspose2DTF_0")
    shape = (h.shape[0], dec.width, dec.width, cfg.filters[-1])
    # the cast at the reshape (a float32 dec/Dense_1 under strict_cast)
    h = h.view(shape) if h.dtype == torch.int8 else h.to(dtype).reshape(shape).permute(0, 3, 1, 2)
    last = len(dec.convts) - 1
    for j, act in enumerate(dec.prelus):
        h = _int8_step(h, f"dec/ConvTranspose2DTF_{j}", dec.convts[j], qw, ascales, act, None,
                       "dec/Conv_0" if j == last else f"dec/ConvTranspose2DTF_{j + 1}")
    return _head(_int8_step(h, "dec/Conv_0", dec.head, qw, ascales), cfg), posterior


# ----------------------------------------------------------------- user API


def _layer_names(cfg: ModelConfig, quantize_dense: bool, quantize_final_conv: bool) -> list:
    nf = len(cfg.filters)
    names = [f"enc/Conv_{i}" for i in range(2 * nf)]
    names += [f"dec/ConvTranspose2DTF_{i}" for i in range(2 * nf)]
    if quantize_dense:
        names += ["enc/Dense_0", "dec/Dense_1"]
    if quantize_final_conv:
        names += ["dec/Conv_0"]
    return names


def _guard(images, dev: torch.device) -> torch.Tensor:
    if not isinstance(images, torch.Tensor):
        images = np.array(images, np.float32)  # a writable copy
    x = torch.as_tensor(images, dtype=torch.float32, device=dev)
    return torch.where(torch.isfinite(x), x, torch.zeros((), device=dev))


def quantize_vae(
    model: DeblenderVAE,
    calib_images,
    generator: torch.Generator | None = None,
    quantize_dense: bool = True,
    quantize_final_conv: bool = False,
    normalise: bool = False,
    layers: "list[str] | None" = None,
    calib_quantile: float = 1.0,
    act_granularity: str = "per_tensor",
) -> QuantizedVAE:
    """Calibrate activation scales on ``calib_images`` (N, S, S, B) and
    quantize the weights of ``model`` (on its device).

    Calibration runs the float forward once in 'sample' mode (latents drawn
    through ``_latent_noise`` from ``generator``, seeded 0 by default) and
    records the abs-max (or the ``calib_quantile`` quantile) of |h| at every
    quantization point; ``scale = max(stat, 1e-30) / 127``.
    ``normalise=True`` calibrates on tanh(arcsinh(x)) stamps; ``layers``
    names the quantization points explicitly; ``act_granularity`` is
    'per_tensor' or 'per_channel' (scales folded into the weights).  The
    JAX package's measured notes on each option apply
    (debvader_tpu/models/quantized.py)."""
    cfg = model.cfg
    if cfg.decoder_f32_stages:
        raise ValueError(
            "quantize_vae does not support ModelConfig.decoder_f32_stages: "
            "int8 PTQ and the fp32-tail fidelity mode are opposite "
            "trade-offs, and the quantized forward does not implement the "
            "per-stage dtype split — build the model with "
            "decoder_f32_stages=0 to quantize"
        )
    if act_granularity not in ("per_tensor", "per_channel"):
        raise ValueError(
            "act_granularity must be 'per_tensor' or 'per_channel', got "
            f"{act_granularity!r}"
        )
    if layers is not None:
        valid = set(_layer_names(cfg, quantize_dense=True, quantize_final_conv=True))
        unknown = sorted(set(layers) - valid)
        if unknown:
            raise ValueError(f"unknown quantization layers {unknown}; valid names: {sorted(valid)}")
    dev = model.encoder.bn.scale.device
    x = _guard(calib_images, dev)
    if normalise:
        x = normalize_non_linear(x)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    collect = _Collect(float(calib_quantile), act_granularity == "per_channel")
    with torch.no_grad(), fp32_math():
        _forward(model, x, "sample", collect=collect, generator=generator)
    act_scales = {name: torch.clamp(a, min=1e-30) / 127.0 for name, a in collect.items()}

    names = list(layers) if layers is not None else _layer_names(cfg, quantize_dense, quantize_final_conv)
    qweights = _requantize(model, names, act_scales)
    calib_stats = {k: (float(v) if v.ndim == 0 else v.double().cpu().tolist()) for k, v in collect.items()}
    return QuantizedVAE(
        model=model, qweights=qweights, act_scales=act_scales, quantize_dense=quantize_dense,
        quantize_final_conv=quantize_final_conv, calib_stats=calib_stats, normalise=normalise,
        act_granularity=act_granularity,
    )


def quantized_forward(qv: QuantizedVAE, images, generator: torch.Generator | None = None, z_mode: str = "sample",
                      quant: bool = True, eps: torch.Tensor | None = None):
    """One int8 (or, with ``quant=False``, float) forward on the bundle's
    device: (PixelNormal, posterior).  Non-finite pixels enter as 0; no
    normalisation and no flux calibration, as in the JAX package."""
    x = _guard(images, qv.device)
    with torch.no_grad(), fp32_math():
        return _forward(
            qv.model, x, z_mode, qv.int8_layers() if quant else None, qv.act_scales if quant else None,
            generator=generator, eps=eps,
        )


def make_quantized_forward(qv: QuantizedVAE, z_mode: str = "sample"):
    """The serving closure ``fwd(images, generator=None) -> (loc, scale)``:
    the finite guard, the tanh(arcsinh) bracket when the bundle was
    calibrated with ``normalise=True``, and the int8 forward; no flux
    calibration.  ``images`` (N, S, S, B) on the bundle's device."""
    normalise = qv.normalise

    def fwd(images, generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
        x = _guard(images, qv.device)
        if normalise:
            x = normalize_non_linear(x)
        with torch.no_grad(), fp32_math():
            dist, _ = _forward(qv.model, x, z_mode, qv.int8_layers(), qv.act_scales, generator=generator, eps=eps)
        if normalise:
            dist = denormalize_distribution(dist)
        return dist.loc, dist.scale

    return fwd


def make_sharded_quantized_forward(qv: QuantizedVAE, mesh, z_mode: str = "sample"):
    """Batch-sharded int8 serving fan-out: ``make_quantized_forward``'s
    closure contract over ``parallel.make_sharded_apply``, whose per-shard
    forward is the int8 forward here.  The bundle (model, int8 kernels and
    activation scales) is copied once to each distinct shard device; the
    stamp batch (guarded and normalised once) is padded to a multiple of
    the mesh's 'data' axis and split over it.  Under 'sample' the noise of
    the real rows is drawn once, as the single-device forward draws it,
    and split with the batch.  Host images go to the mesh's first device,
    as the single-device closure takes them to the bundle's; the outputs
    lie on the images' device."""
    from debvader_tpu_torch.parallel.mesh import require_single_process
    from debvader_tpu_torch.parallel.sharded import make_sharded_apply, sharded_forward

    require_single_process(mesh, "make_sharded_quantized_forward")

    def shard_forward(replica, x, eps):
        with fp32_math():
            return _forward(replica.model, x, z_mode, replica.int8_layers(), replica.act_scales, eps=eps)[0]

    apply = make_sharded_apply(qv, mesh, z_mode, shard_forward)

    def fwd(images, generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
        x = images.to(torch.float32) if isinstance(images, torch.Tensor) else _guard(images, mesh.device)
        dist = sharded_forward(apply, x, mesh, qv.normalise, generator, eps)
        return dist.loc, dist.scale

    return fwd


def _requantize(model: DeblenderVAE, names, act_scales: dict) -> dict:
    """{name: (int8 kernel, wscale)} of the model's current weights."""
    out = {}
    for name in names:
        out_axis, in_axis = _axes(name)
        out[name] = _quant_weight_folded(_weight(_module(model, name)), out_axis, in_axis, act_scales[name])
    return out


def _qat_loss(student, teacher, x, y, names, ascales, loss: str, kl_weight: float,
              generator: torch.Generator | None = None):
    """(loss, terms) of one QAT step: the fake-quant student against the
    frozen float teacher at the posterior mean ('distill'), or the ELBO
    with a sampled latent ('elbo')."""
    from debvader_tpu_torch.training import losses

    qw = dict.fromkeys(names)
    if loss == "distill":
        dist, _ = _forward(student, x, "mean", qw, ascales, fake=True)
        with torch.no_grad():
            t_dist, _ = _forward(teacher, x, "mean")
        recon = torch.mean(torch.sum(torch.square(dist.loc - t_dist.loc), dim=(1, 2, 3)))
        return recon, {"loss": recon}
    dist, posterior = _forward(student, x, "sample", qw, ascales, fake=True, generator=generator)
    terms = losses.elbo_terms(dist, posterior, y, kl_weight=kl_weight, kl_mode="analytic")
    return terms["loss"], terms


def _default_make_batch(cfg: ModelConfig, batch: int):
    from debvader_tpu_torch.data.simulate import simulate_batch

    def make_batch(rng: np.random.Generator):
        blended, isolated, _ = simulate_batch(rng, batch, stamp=cfg.stamp_size, bands=cfg.nb_of_bands)
        return blended, isolated

    return make_batch


def qat_finetune(
    qv: QuantizedVAE,
    steps: int = 2000,
    batch: int = 256,
    learning_rate: float = 2e-5,
    seed: int = 0,
    kl_weight: float = 0.01,
    steps_per_dispatch: int = 100,
    make_batch=None,
    recalibrate: bool = False,
    loss: str = "distill",
    teacher_variables=None,
    generator: torch.Generator | None = None,
) -> QuantizedVAE:
    """Quantization-aware fine-tuning: adapt the float weights to the int8
    grid through the fake-quant forward (STE), with flax-faithful Adam
    (training/train._adam_update) at ``learning_rate``; BatchNorm frozen in
    inference mode.  ``loss='distill'`` matches the original float
    forward (the teacher: ``teacher_variables``, a DeblenderVAE whose
    parameters are taken, else the bundle's own model) at the posterior
    mean; ``'elbo'`` minimizes NLL + ``kl_weight`` KL with latents drawn
    from ``generator`` (seeded ``seed``) through ``_latent_noise``.

    Step ``i``'s batch is ``make_batch(np.random.default_rng((seed, i)))``
    -> (blended, isolated), by default the port's simulator;
    ``recalibrate=True`` recalibrates on ``make_batch(
    np.random.default_rng(seed + 999))``.  ``steps_per_dispatch`` is
    accepted for the JAX package's signature: eager PyTorch runs the steps
    one by one.  Returns a new bundle: the fine-tuned model, the weights
    requantized from it, the same activation scales unless recalibrated,
    and the teacher's fingerprint, which makes a later call without
    ``teacher_variables`` raise (re-teaching from drifted weights diverges,
    as the JAX package measured)."""
    from debvader_tpu_torch.training.train import _adam_update

    if loss not in ("distill", "elbo"):
        raise ValueError(f"loss must be 'distill' or 'elbo', got {loss!r}")
    if teacher_variables is None and qv.teacher_fingerprint is not None:
        raise ValueError(
            "qat_finetune on an already-fine-tuned bundle (teacher "
            f"fingerprint {qv.teacher_fingerprint}) without an explicit "
            "teacher_variables would re-teach from the drifted weights — "
            "measured to diverge (int8-vs-original flux error 0.025 after "
            "one 500-step call, 0.53 after four chained re-teaching calls; "
            "BASELINE.md r4).  Pass teacher_variables= the ORIGINAL float "
            "variables the first fine-tune used."
        )
    cfg, dev = qv.cfg, qv.device
    make_batch = make_batch or _default_make_batch(cfg, batch)
    student = copy.deepcopy(qv.model)
    # the teacher keeps the bundle's BatchNorm statistics, as JAX's does
    teacher = copy.deepcopy(qv.model)
    if teacher_variables is not None:
        src = dict(teacher_variables.named_parameters())
        with torch.no_grad():
            for name, p in teacher.named_parameters():
                p.copy_(src[name])
    teacher_fp = params_fingerprint(teacher)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    params = list(student.parameters())
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    names = list(qv.qweights)
    for step in range(steps):
        x, y = (_guard(a, dev) for a in make_batch(np.random.default_rng((seed, step))))
        if qv.normalise:
            x, y = normalize_non_linear(x), normalize_non_linear(y)
        with fp32_math():
            value, _ = _qat_loss(student, teacher, x, y, names, qv.act_scales, loss, kl_weight, generator)
            grads = torch.autograd.grad(value, params)
            _adam_update(params, list(grads), mu, nu, step + 1, learning_rate)

    out = dataclasses.replace(
        qv, model=student, qweights=_requantize(student, names, qv.act_scales), teacher_fingerprint=teacher_fp,
        _layers={},
    )
    if recalibrate:
        out = quantize_vae(
            student, make_batch(np.random.default_rng(seed + 999))[0], quantize_dense=qv.quantize_dense,
            quantize_final_conv=qv.quantize_final_conv, normalise=qv.normalise, layers=names,
            act_granularity=qv.act_granularity,
        )
        out = dataclasses.replace(out, teacher_fingerprint=teacher_fp)
    return out


# -------------------------------------------------------------- persistence


def _port_cfg(model_cfg: dict) -> ModelConfig:
    """The port's ModelConfig from a meta.json ``model_cfg`` (the JAX
    package's fields, all of which the port's config carries).
    ``kl_weight`` and ``decoder_subpixel`` change nothing in the int8
    forward, nor does ``strict_cast`` in float32."""
    kw = dict(model_cfg)
    if kw.get("decoder_f32_stages", 0):
        raise ValueError("a quantized bundle cannot carry ModelConfig.decoder_f32_stages")
    for key in ("filters", "kernels"):
        kw[key] = tuple(kw[key])
    if kw.get("layer_precision") is not None:
        kw["layer_precision"] = tuple(tuple(kv) for kv in kw["layer_precision"])
    return ModelConfig(**kw)


def _bundle_paths(path) -> tuple[Path, Path]:
    p = Path(path)
    if p.suffix == ".npz":
        p = p.with_suffix("")
    return p.with_name(p.name + ".npz"), p.with_name(p.name + ".json")


def _meta(qv: QuantizedVAE) -> dict:
    return {
        "model_cfg": dataclasses.asdict(qv.cfg),
        "quantize_dense": qv.quantize_dense,
        "quantize_final_conv": qv.quantize_final_conv,
        "calib_stats": qv.calib_stats,
        "normalise": qv.normalise,
        "teacher_fingerprint": qv.teacher_fingerprint,
        "act_granularity": qv.act_granularity,
    }


def _to_arrays(qv: QuantizedVAE) -> dict:
    """The bundle file's arrays: the float variables under their flax key
    paths in JAX's layouts, ``qweights/<layer>/kernel`` (int8, the port's
    layout) and ``qweights/<layer>/scale``, ``act_scales/<layer>``, with '|'
    for '/' in layer names."""
    from debvader_tpu_torch.weights import flax_from_state_dict

    arrays = flax_from_state_dict(qv.model.state_dict(), qv.cfg)
    arrays.pop("flux_cal/scale", None)
    for name, (qk, wscale) in qv.qweights.items():
        tag = name.replace("/", "|")
        arrays[f"qweights/{tag}/kernel"] = qk.detach().cpu().numpy()
        arrays[f"qweights/{tag}/scale"] = wscale.detach().cpu().numpy().astype(np.float32)
    for name, s in qv.act_scales.items():
        arrays[f"act_scales/{name.replace('/', '|')}"] = s.detach().cpu().numpy().astype(np.float32)
    return arrays


def save_quantized(qv: QuantizedVAE, path) -> None:
    """Write the bundle as ``<path>.npz`` (``_to_arrays``) and
    ``<path>.json`` (the JAX package's meta.json keys)."""
    npz, meta_path = _bundle_paths(path)
    npz.parent.mkdir(parents=True, exist_ok=True)
    np.savez(npz, **_to_arrays(qv))
    meta_path.write_text(json.dumps(_meta(qv), indent=1))


def _from_arrays(arrays: dict, meta: dict) -> QuantizedVAE:
    """A CPU bundle from the arrays of a bundle file and its meta.json."""
    from debvader_tpu_torch.weights import state_dict_from_flax

    cfg = _port_cfg(meta["model_cfg"])
    arrays = dict(arrays)
    act_scales = {
        k.split("/", 1)[1].replace("|", "/"): torch.from_numpy(np.array(arrays.pop(k), np.float32))
        for k in [k for k in arrays if k.startswith("act_scales/")]
    }
    qweights = {}
    for key in [k for k in arrays if k.startswith("qweights/") and k.endswith("/kernel")]:
        tag = key.split("/")[1]
        qk, wscale = np.array(arrays.pop(key), np.int8), np.array(arrays.pop(f"qweights/{tag}/scale"), np.float32)
        qweights[tag.replace("|", "/")] = (torch.from_numpy(qk), torch.from_numpy(wscale))
    model = DeblenderVAE(cfg)
    model.load_state_dict(state_dict_from_flax(arrays, cfg))
    return QuantizedVAE(
        model=model.eval(), qweights=qweights, act_scales=act_scales, quantize_dense=meta["quantize_dense"],
        quantize_final_conv=meta["quantize_final_conv"], calib_stats=meta["calib_stats"],
        normalise=meta["normalise"], teacher_fingerprint=meta.get("teacher_fingerprint"),
        act_granularity=meta.get("act_granularity", "per_tensor"),
    )


def load_quantized(path="sim_demo_int8", device="cuda") -> QuantizedVAE:
    """A bundle written by ``save_quantized``: ``path`` is a path (with or
    without ``.npz``), or the name of a packaged bundle under
    ``data/weights`` (``load_quantized('sim_demo_int8')``, converted from
    the JAX package's by scripts/convert_sim_demo_int8_to_torch.py), on
    ``device``."""
    from debvader_tpu_torch.weights import default_weights_dir

    dev = resolve_device(device)
    npz, meta_path = _bundle_paths(path)
    if not npz.exists() and Path(path).name == str(path):
        npz, meta_path = _bundle_paths(default_weights_dir() / str(path))
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    qv = _from_arrays(arrays, json.loads(meta_path.read_text()))
    return qv.to(dev) if dev.type != "cpu" else qv
