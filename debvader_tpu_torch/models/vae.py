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
the checkpoint line up.  Parameters and buffers: 8,318,452 for the default
configuration.

Every conv, transposed conv and dense layer gets its precision scheme from
``models.precision.resolve(cfg, key)``, the keys in application order
('enc/Conv_i', 'enc/Dense_0', 'dec/Dense_0', 'dec/Dense_1', 'dec/ConvT_i',
'dec/Conv_0'); without a scheme a layer is the plain float32 one.  The
parameters do not depend on the configuration.  ``DeblenderVAE`` may carry
a per-band flux calibration (utils/flux_cal.py) as the buffer
``flux_cal_scale``, which follows ``state_dict()``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.models.distributions import (
    MultivariateNormalTriL,
    PixelNormal,
    mvn_params_size,
    softplus_tril,
)
from debvader_tpu_torch.models.layers import (
    BatchNormInference,
    Conv2dSame,
    ConvTranspose2dTF,
    Dense,
    PReLU,
)
from debvader_tpu_torch.models.precision import resolve

__all__ = ["Encoder", "Decoder", "DeblenderVAE"]


class Encoder(nn.Module):
    """x (N, S, S, B) -> flat MVN params (N, latent + tril)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.bn = BatchNormInference(cfg.nb_of_bands)
        convs, prelus = [], []
        cin, size = cfg.nb_of_bands, cfg.stamp_size
        for f, k in zip(cfg.filters, cfg.kernels):
            for stride in (1, 2):
                scheme = resolve(cfg, f"enc/Conv_{len(convs)}")[1]
                convs.append(Conv2dSame(cin, f, k, stride, scheme=scheme))
                size = -(-size // stride)
                prelus.append(PReLU((f, size, size)))
                cin = f
        self.convs = nn.ModuleList(convs)
        self.prelus = nn.ModuleList(prelus)
        flat = cin * size * size
        self.flat_prelu = PReLU((flat,))
        self.dense = Dense(
            flat, mvn_params_size(cfg.latent_dim), scheme=resolve(cfg, "enc/Dense_0")[1]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn(x.permute(0, 3, 1, 2))
        for conv, act in zip(self.convs, self.prelus):
            h = act(conv(h))
        # row-major (H, W, C) flatten == Keras Flatten on channels-last
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.dense(self.flat_prelu(h))


class Decoder(nn.Module):
    """z (N, latent) -> PixelNormal over (N, S, S, B)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.width = int(math.ceil(cfg.stamp_size / 2 ** len(cfg.filters)))
        hidden = mvn_params_size(cfg.latent_dim)
        top = self.width * self.width * cfg.filters[-1]
        self.prelu_in = PReLU((cfg.latent_dim,))
        self.dense0 = Dense(cfg.latent_dim, hidden, scheme=resolve(cfg, "dec/Dense_0")[1])
        self.prelu0 = PReLU((hidden,))
        self.dense1 = Dense(hidden, top, scheme=resolve(cfg, "dec/Dense_1")[1])
        self.prelu1 = PReLU((top,))
        convts, prelus = [], []
        cin, size = cfg.filters[-1], self.width
        for i in range(len(cfg.filters) - 1, -1, -1):
            for stride in (2, 1):
                scheme = resolve(cfg, f"dec/ConvT_{len(convts)}")[1]
                convts.append(
                    ConvTranspose2dTF(cin, cfg.filters[i], cfg.kernels[i], stride, scheme=scheme)
                )
                size *= stride
                prelus.append(PReLU((cfg.filters[i], size, size)))
                cin = cfg.filters[i]
        self.convts = nn.ModuleList(convts)
        self.prelus = nn.ModuleList(prelus)
        self.head = Conv2dSame(
            cin, 2 * cfg.nb_of_bands, 3, 1, scheme=resolve(cfg, "dec/Conv_0")[1]
        )

    def forward(self, z: torch.Tensor) -> PixelNormal:
        cfg = self.cfg
        h = self.prelu0(self.dense0(self.prelu_in(z)))
        h = self.prelu1(self.dense1(h))
        h = h.reshape(h.shape[0], self.width, self.width, cfg.filters[-1])
        h = h.permute(0, 3, 1, 2)
        for convt, act in zip(self.convts, self.prelus):
            h = act(convt(h))
        h = F.relu(self.head(h))
        # odd crops take the extra pixel at the end (Keras Cropping2D)
        crop = h.shape[-1] - cfg.stamp_size
        if crop > 0:
            lo = crop // 2
            hi = h.shape[-1] - (crop - lo)
            h = h[:, :, lo:hi, lo:hi]
        h = h.permute(0, 2, 3, 1)
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

    def encode(self, x: torch.Tensor) -> MultivariateNormalTriL:
        loc, tril = softplus_tril(
            self.encoder(x), self.cfg.latent_dim, self.cfg.diag_shift
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
