"""The deblending convolutional VAE in PyTorch.

Same graph as debvader_tpu.models.vae (the reference Keras model):

- Encoder: BatchNorm -> 4 x [Conv3x3 SAME + PReLU + Conv3x3 stride-2 SAME
  + PReLU] (59 -> 30 -> 15 -> 8 -> 4) -> Flatten -> PReLU -> Dense.
- Latent: MultivariateNormalTriL(32) from fill_triangular + softplus(diag)
  + 1e-5.
- Decoder: PReLU -> Dense(560) -> PReLU -> Dense(4*4*256) -> PReLU ->
  Reshape -> 4 x [ConvT stride 2 + PReLU + ConvT stride 1 + PReLU]
  (4 -> 64) -> Conv3x3 to 2*bands + ReLU -> crop 64 -> 59 (the extra pixel
  at the end) -> Normal(loc, 1e-4 + raw scale).

Inputs and outputs are NHWC like the JAX package; the convolutions run
NCHW.  Flatten and Reshape go through NHWC order so the Dense kernels of
the checkpoint line up.  In memory, bfloat16 activations stay
channels-last (the encoder's input is a permuted NHWC batch, the
decoder's a reshaped dense output), and so do float32 ones on the CPU;
on a card float32 ones are NCHW-dense: each convolution lays out its
input for its engines (``layers.conv_input``).  The cropped output is
made dense in NHWC order.  Parameters and buffers: 8,318,452 for the
default configuration.

``init_vae`` draws a fresh model with the JAX package's initializers
(flax's, not torch's): lecun_normal (truncated normal) for the conv and
dense kernels, glorot_uniform with the TF (kh, kw, out, in) fans for the
transposed convs, zeros for biases and PReLU alphas, BatchNorm scale 1,
bias 0, running mean 0 and variance 1.  The numbers come from a
``torch.Generator``; they cannot be threefry's, so a fresh port model and a
fresh JAX model agree in distribution only.

Every conv, transposed conv and dense layer gets its precision scheme from
``models.precision.resolve(cfg, key)``, the keys in application order
('enc/Conv_i', 'enc/Dense_0', 'dec/Dense_0', 'dec/Dense_1', 'dec/ConvT_i',
'dec/Conv_0'); without a scheme a layer is the plain float32 one.  The
parameters do not depend on the configuration.

On a card, outside autograd and tracing, each scheme-less conv, transposed
conv and biased dense layer that a PReLU follows runs without its bias, and
kernels/bias_prelu.py adds the bias and applies the PReLU in one pass, bit
for bit the layers' own ops (``_layer_prelu``); CPU tensors, a forward that
autograd records (training) and ``torch.export``'s tracing run the ops.

The compute dtype (``cfg.dtype``) follows the flax graph's rounding points:
the input is cast to it before the encoder's BatchNorm (computed in
float32, its output cast back); every conv, transposed conv and dense
layer without a scheme casts its input to its own dtype; the encoder's
output is float32; the decoder's dec/Dense_1 runs in float32 under
``strict_cast``; a decoder stage with filter index i <
``decoder_f32_stages`` runs in float32, and so does the band head when
``decoder_f32_stages`` > 0; the output is cast to float32 after the crop.
The scheme layers take no dtype: they contract float32 limbs and return
float32, as the JAX package's MP layers do.  ``decoder_subpixel`` swaps
the stride-2 transposed convs and the band head for their sub-pixel forms
(models/layers.py).  ``DeblenderVAE`` may carry
a per-band flux calibration (utils/flux_cal.py) as the buffer
``flux_cal_scale``, which follows ``state_dict()``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.kernels.bias_prelu import bias_prelu
from debvader_tpu_torch.models.distributions import (
    MultivariateNormalTriL,
    PixelNormal,
    mvn_params_size,
    softplus_tril,
)
from debvader_tpu_torch.models.layers import (
    BatchNorm,
    Conv2dSame,
    ConvTranspose2dTF,
    Dense,
    PReLU,
    SubpixelConv2d,
)
from debvader_tpu_torch.models.precision import resolve

__all__ = [
    "Encoder",
    "Decoder",
    "DeblenderVAE",
    "create_model_vae",
    "create_encoder",
    "create_decoder",
    "init_vae",
]


def _reduced(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x cast to a bfloat16 compute dtype; a float32 model takes x as it
    is (its layers compute in their parameters' dtype)."""
    return x if dtype == torch.float32 else x.to(dtype)


def _widened(h: torch.Tensor) -> torch.Tensor:
    """A bfloat16 output cast to float32, as the flax graph casts it."""
    return h.to(torch.float32) if h.dtype == torch.bfloat16 else h


def _fusable(x: torch.Tensor, layer: nn.Module, act: PReLU) -> bool:
    """Whether ``act(layer(x))`` may run as the layer without its bias,
    then the bias and the PReLU in one pass: a plain tensor (``torch.export``
    traces subclasses), a scheme-less layer, and nothing that autograd
    records (training keeps the ops and their backward)."""
    if type(x) is not torch.Tensor or layer.scheme is not None:
        return False
    params = (*layer.parameters(), act.alpha)
    return not (torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)))


def _one_pass(x: torch.Tensor, layer: nn.Module, act: PReLU) -> bool:
    """Whether ``act(layer(x))`` launches the kernel: a CUDA tensor that
    ``_fusable`` lets through.  CPU tensors run the ops."""
    return x.is_cuda and _fusable(x, layer, act)


def _layer_prelu(layer: nn.Module, act: PReLU, x: torch.Tensor) -> torch.Tensor:
    """``act(layer(x))``; where ``_one_pass`` allows, the layer's forward
    without its bias (its hooks run, the PReLU module's do not), then the
    bias and the PReLU in one kernel."""
    if _one_pass(x, layer, act):
        return bias_prelu(layer(x, bias=False), layer.bias, act.alpha)
    return act(layer(x))


class Encoder(nn.Module):
    """x (N, S, S, B) -> flat MVN params (N, latent + tril)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dtype = cfg.compute_dtype
        self.bn = BatchNorm(cfg.nb_of_bands, dtype=dtype)
        convs, prelus = [], []
        cin, size = cfg.nb_of_bands, cfg.stamp_size
        for f, k in zip(cfg.filters, cfg.kernels):
            for stride in (1, 2):
                scheme = resolve(cfg, f"enc/Conv_{len(convs)}")[1]
                convs.append(Conv2dSame(cin, f, k, stride, scheme=scheme, dtype=dtype))
                size = -(-size // stride)
                prelus.append(PReLU((f, size, size)))
                cin = f
        self.convs = nn.ModuleList(convs)
        self.prelus = nn.ModuleList(prelus)
        flat = cin * size * size
        self.flat_prelu = PReLU((flat,))
        self.dense = Dense(
            flat, mvn_params_size(cfg.latent_dim), scheme=resolve(cfg, "enc/Dense_0")[1], dtype=dtype
        )
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.bn(_reduced(x, self.dtype).permute(0, 3, 1, 2), train=train)
        for conv, act in zip(self.convs, self.prelus):
            h = _layer_prelu(conv, act, h)
        # row-major (H, W, C) flatten == Keras Flatten on channels-last
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return _widened(self.dense(self.flat_prelu(h)))


class Decoder(nn.Module):
    """z (N, latent) -> PixelNormal over (N, S, S, B)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        self.dtype = dtype
        self.width = int(math.ceil(cfg.stamp_size / 2 ** len(cfg.filters)))
        hidden = mvn_params_size(cfg.latent_dim)
        top = self.width * self.width * cfg.filters[-1]
        self.prelu_in = PReLU((cfg.latent_dim,))
        self.dense0 = Dense(cfg.latent_dim, hidden, scheme=resolve(cfg, "dec/Dense_0")[1], dtype=dtype)
        self.prelu0 = PReLU((hidden,))
        # the reference casts to float32 before this Dense; strict_cast=False
        # keeps it in the compute dtype
        self.dense1 = Dense(hidden, top, scheme=resolve(cfg, "dec/Dense_1")[1],
                            dtype=torch.float32 if cfg.strict_cast else dtype)
        self.prelu1 = PReLU((top,))
        convts, prelus = [], []
        cin, size = cfg.filters[-1], self.width
        for i in range(len(cfg.filters) - 1, -1, -1):
            stage_dtype = torch.float32 if i < cfg.decoder_f32_stages else dtype
            for stride in (2, 1):
                scheme = resolve(cfg, f"dec/ConvT_{len(convts)}")[1]
                convts.append(
                    ConvTranspose2dTF(cin, cfg.filters[i], cfg.kernels[i], stride, scheme=scheme, dtype=stage_dtype,
                                      subpixel=cfg.decoder_subpixel and stride == 2)
                )
                size *= stride
                prelus.append(PReLU((cfg.filters[i], size, size)))
                cin = cfg.filters[i]
        self.convts = nn.ModuleList(convts)
        self.prelus = nn.ModuleList(prelus)
        head_dtype = torch.float32 if cfg.decoder_f32_stages > 0 else dtype
        head_scheme = resolve(cfg, "dec/Conv_0")[1]
        if head_scheme is None and cfg.decoder_subpixel:
            self.head = SubpixelConv2d(cin, 2 * cfg.nb_of_bands, dtype=head_dtype)
        else:
            self.head = Conv2dSame(cin, 2 * cfg.nb_of_bands, 3, 1, scheme=head_scheme, dtype=head_dtype)

    def forward(self, z: torch.Tensor) -> PixelNormal:
        cfg = self.cfg
        h = _layer_prelu(self.dense0, self.prelu0, self.prelu_in(_reduced(z, self.dtype)))
        # each layer casts its input to its own dtype: dec/Dense_1 to
        # float32 under strict_cast, the first transposed conv back
        h = _layer_prelu(self.dense1, self.prelu1, h)
        h = h.reshape(h.shape[0], self.width, self.width, cfg.filters[-1])
        h = h.permute(0, 3, 1, 2)
        for convt, act in zip(self.convts, self.prelus):
            h = _layer_prelu(convt, act, h)
        h = F.relu(self.head(h))
        # odd crops take the extra pixel at the end (Keras Cropping2D)
        crop = h.shape[-1] - cfg.stamp_size
        if crop > 0:
            lo = crop // 2
            hi = h.shape[-1] - (crop - lo)
            h = h[:, :, lo:hi, lo:hi]
        h = _widened(h.permute(0, 2, 3, 1)).contiguous()
        loc = h[..., : cfg.nb_of_bands]
        scale = cfg.scale_floor + h[..., cfg.nb_of_bands :]
        return PixelNormal(loc, scale)


class DeblenderVAE(nn.Module):
    """Encode to an MVN-TriL posterior, take a latent, decode.

    ``z_mode='sample'`` draws the latent (the reference's stochastic
    forward) from ``generator``, or uses the given ``eps``; ``'mean'``
    decodes the posterior mean."""

    def __init__(self, cfg: ModelConfig | None = None):
        super().__init__()
        self.cfg = cfg or ModelConfig()
        self.encoder = Encoder(self.cfg)
        self.decoder = Decoder(self.cfg)
        # (bands,) flux gain that utils/flux_cal.apply_flux_calibration
        # divides out of a served distribution; None = no calibration
        self.register_buffer("flux_cal_scale", None)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a state dict that carries a calibration brings the buffer with it
        key = prefix + "flux_cal_scale"
        if key in state_dict and self.flux_cal_scale is None:
            self.flux_cal_scale = torch.ones_like(
                state_dict[key], device=self.encoder.bn.scale.device
            )
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def encode(self, x: torch.Tensor, train: bool = False) -> MultivariateNormalTriL:
        """The posterior; ``train=True`` runs the input BatchNorm in train
        mode (batch statistics, running statistics updated)."""
        loc, tril = softplus_tril(
            self.encoder(x, train=train), self.cfg.latent_dim, self.cfg.diag_shift
        )
        return MultivariateNormalTriL(loc, tril)

    def decode(self, z: torch.Tensor) -> PixelNormal:
        return self.decoder(z)

    def forward(
        self,
        x: torch.Tensor,
        generator: torch.Generator | None = None,
        z_mode: str = "sample",
        eps: torch.Tensor | None = None,
    ) -> tuple[PixelNormal, MultivariateNormalTriL]:
        posterior = self.encode(x)
        if z_mode == "sample":
            z = posterior.sample(generator=generator, eps=eps)
        elif z_mode == "mean":
            z = posterior.mean()
        else:
            raise ValueError(f"unknown z_mode {z_mode!r}")
        return self.decode(z), posterior


def create_model_vae(cfg: ModelConfig | None = None) -> DeblenderVAE:
    """The VAE module (reference create_model_vae); its parameters are
    zeros until ``init_vae`` or a state dict fills them."""
    return DeblenderVAE(cfg or ModelConfig())


def create_encoder(cfg: ModelConfig | None = None) -> Encoder:
    """The encoder alone: x -> flat MVN params; ``softplus_tril`` of its
    output gives the posterior."""
    return Encoder(cfg or ModelConfig())


def create_decoder(cfg: ModelConfig | None = None) -> Decoder:
    """The decoder alone: z -> PixelNormal over stamps."""
    return Decoder(cfg or ModelConfig())


# flax's lecun_normal: a normal truncated at 2 standard deviations, its
# scale raised by this factor so that the truncated variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def init_vae(model: nn.Module, generator: torch.Generator | int | None = None) -> nn.Module:
    """Fill ``model`` (a DeblenderVAE, Encoder or Decoder) with fresh
    parameters drawn as the JAX package's ``init_vae`` draws them, from
    ``generator`` (a CPU ``torch.Generator`` or a seed; default seed 0), in
    place; returns the model.  The draws are made on the CPU and copied to
    the model's device, so a seed gives the same model on every device."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(0 if generator is None else int(generator))
    def draw(param, fill, *args):
        w = torch.empty(param.shape)
        fill(w, *args)
        param.copy_(w)

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Conv2dSame):  # (out, in, kh, kw)
                draw(module.weight, _lecun_normal_, module.weight[0].numel(), generator)
            elif isinstance(module, Dense):  # (in, out)
                draw(module.kernel, _lecun_normal_, module.kernel.shape[0], generator)
            elif isinstance(module, ConvTranspose2dTF):
                # (in, out, kh, kw) is TF's (kh, kw, out, in): in_axis 3, out_axis 2
                cin, cout, kh, kw = module.weight.shape
                limit = math.sqrt(6.0 / (kh * kw * (cin + cout)))
                draw(module.weight, lambda w: w.uniform_(-limit, limit, generator=generator))
            elif isinstance(module, PReLU):
                module.alpha.zero_()
            elif isinstance(module, BatchNorm):
                module.scale.fill_(1.0)
                module.bias.zero_()
                module.mean.zero_()
                module.var.fill_(1.0)
            if isinstance(module, (Conv2dSame, Dense, ConvTranspose2dTF)):
                module.bias.zero_()
    return model
