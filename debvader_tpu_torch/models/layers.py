"""Layers with exact Keras/TF semantics, in PyTorch (NCHW inside the model).

- ``Conv2dSame``: TF 'SAME' padding.  It is asymmetric for stride 2
  (59 -> 30 -> 15 -> 8 -> 4: the extra pixel goes bottom/right), which
  torch's ``padding='same'`` does not offer.
- ``ConvTranspose2dTF``: TF ``Conv2DTranspose(padding='same')``, the
  gradient of a SAME conv: full transposed conv, then crop ``pad_lo``
  from the top/left to ``in * stride``.
- ``PReLU``: Keras-default per-element alpha, shaped like the activation
  without the batch axis (e.g. (32, 59, 59) here for a (59, 59, 32) map).
- ``BatchNormInference``: Keras BatchNorm at inference, eps 1e-3.
- ``Dense``: kernel kept in the (in, out) layout of the checkpoint.

``Conv2dSame``, ``ConvTranspose2dTF`` and ``Dense`` take an optional
``scheme`` (models/precision.py): the layer then contracts the bf16 limbs
of its input and its weight without the bias and adds the bias after, in
float32.  The parameters are the same with and without a scheme, so one
state dict serves every precision configuration.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from debvader_tpu_torch.models.precision import SCHEMES, apply_scheme

__all__ = [
    "tf_same_pads",
    "Conv2dSame",
    "ConvTranspose2dTF",
    "PReLU",
    "BatchNormInference",
    "Dense",
]


def _check_scheme(scheme):
    if scheme is not None and scheme not in SCHEMES:
        raise ValueError(f"scheme must be None or one of {sorted(SCHEMES)}, got {scheme!r}")
    return scheme


def tf_same_pads(in_size: int, k: int, s: int) -> tuple[int, int]:
    """(lo, hi) padding of a TF 'SAME' conv along one axis."""
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Module):
    """Conv2d with TF 'SAME' padding; weight (out, in, kh, kw)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, scheme: str | None = None):
        super().__init__()
        self.stride = stride
        self.scheme = _check_scheme(scheme)
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        lo_h, hi_h = tf_same_pads(x.shape[-2], k, self.stride)
        lo_w, hi_w = tf_same_pads(x.shape[-1], k, self.stride)
        x = F.pad(x, (lo_w, hi_w, lo_h, hi_h))
        if self.scheme is None:
            return F.conv2d(x, self.weight, self.bias, stride=self.stride)
        y = apply_scheme(
            x, self.weight, self.scheme, 0,
            lambda xl, wl: F.conv2d(xl, wl, stride=self.stride), out_axis=1,
        )
        return y + self.bias.view(1, -1, 1, 1)


class ConvTranspose2dTF(nn.Module):
    """TF-semantics transposed conv; weight (in, out, kh, kw), which is the
    TF (kh, kw, out, in) kernel transposed (3, 2, 0, 1)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, scheme: str | None = None):
        super().__init__()
        self.stride = stride
        self.scheme = _check_scheme(scheme)
        self.weight = nn.Parameter(torch.zeros(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        out_h = x.shape[-2] * self.stride
        out_w = x.shape[-1] * self.stride
        lo_h, _ = tf_same_pads(out_h, k, self.stride)
        lo_w, _ = tf_same_pads(out_w, k, self.stride)
        if self.scheme is None:
            y = F.conv_transpose2d(x, self.weight, self.bias, stride=self.stride)
            return y[..., lo_h : lo_h + out_h, lo_w : lo_w + out_w]
        # the bias joins after the limb terms are summed: inside the
        # contraction it would be added once a term
        y = apply_scheme(
            x, self.weight, self.scheme, 1,
            lambda xl, wl: F.conv_transpose2d(xl, wl, stride=self.stride), out_axis=1,
        )
        return y[..., lo_h : lo_h + out_h, lo_w : lo_w + out_w] + self.bias.view(1, -1, 1, 1)


class PReLU(nn.Module):
    """max(x, 0) + alpha * min(x, 0) with a per-element alpha."""

    def __init__(self, shape):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(tuple(shape)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, min=0) + self.alpha * torch.clamp(x, max=0)


class BatchNormInference(nn.Module):
    """(x - mean) * (rsqrt(var + eps) * scale) + bias over channel axis 1,
    in the order flax applies it."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - self.mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class Dense(nn.Module):
    """x @ kernel + bias with the checkpoint's (in, out) kernel."""

    def __init__(self, fin: int, fout: int, scheme: str | None = None):
        super().__init__()
        self.scheme = _check_scheme(scheme)
        self.kernel = nn.Parameter(torch.zeros(fin, fout))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scheme is None:
            return x @ self.kernel + self.bias
        return apply_scheme(x, self.kernel, self.scheme, 1, torch.matmul) + self.bias
