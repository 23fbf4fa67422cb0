"""Layers with exact Keras/TF semantics, in PyTorch (NCHW inside the model).

- ``Conv2dSame``: TF 'SAME' padding.  It is asymmetric for stride 2
  (59 -> 30 -> 15 -> 8 -> 4: the extra pixel goes bottom/right), which
  torch's ``padding='same'`` does not offer.
- ``ConvTranspose2dTF``: TF ``Conv2DTranspose(padding='same')``, the
  gradient of a SAME conv: full transposed conv, then crop ``pad_lo``
  from the top/left to ``in * stride``.
- ``PReLU``: Keras-default per-element alpha, shaped like the activation
  without the batch axis (e.g. (32, 59, 59) here for a (59, 59, 32) map).
- ``BatchNorm``: Keras BatchNorm, eps 1e-3, in inference mode (the
  running statistics) or in flax's train mode (the batch's statistics,
  the running ones updated with momentum 0.99).
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
    "conv2d_same",
    "conv_transpose2d_tf",
    "Conv2dSame",
    "ConvTranspose2dTF",
    "prelu",
    "PReLU",
    "BatchNorm",
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


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.conv2d`` with TF 'SAME' padding; weight (out, in, kh, kw)."""
    k = weight.shape[-1]
    lo_h, hi_h = tf_same_pads(x.shape[-2], k, stride)
    lo_w, hi_w = tf_same_pads(x.shape[-1], k, stride)
    return F.conv2d(F.pad(x, (lo_w, hi_w, lo_h, hi_h)), weight, bias, stride=stride)


def conv_transpose2d_tf(x: torch.Tensor, weight: torch.Tensor, stride: int,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """TF ``Conv2DTranspose(padding='same')``: the full transposed conv,
    cropped ``pad_lo`` from the top/left to ``in * stride``; weight (in,
    out, kh, kw)."""
    k = weight.shape[-1]
    out_h = x.shape[-2] * stride
    out_w = x.shape[-1] * stride
    lo_h, _ = tf_same_pads(out_h, k, stride)
    lo_w, _ = tf_same_pads(out_w, k, stride)
    y = F.conv_transpose2d(x, weight, bias, stride=stride)
    return y[..., lo_h : lo_h + out_h, lo_w : lo_w + out_w]


class Conv2dSame(nn.Module):
    """Conv2d with TF 'SAME' padding; weight (out, in, kh, kw)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, scheme: str | None = None):
        super().__init__()
        self.stride = stride
        self.scheme = _check_scheme(scheme)
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scheme is None:
            return conv2d_same(x, self.weight, self.stride, self.bias)
        y = apply_scheme(
            x, self.weight, self.scheme, 0,
            lambda xl, wl: conv2d_same(xl, wl, self.stride), out_axis=1,
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
        if self.scheme is None:
            return conv_transpose2d_tf(x, self.weight, self.stride, self.bias)
        # the bias joins after the limb terms are summed: inside the
        # contraction it would be added once a term
        y = apply_scheme(
            x, self.weight, self.scheme, 1,
            lambda xl, wl: conv_transpose2d_tf(xl, wl, self.stride), out_axis=1,
        )
        return y + self.bias.view(1, -1, 1, 1)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + alpha * min(x, 0), as ``PReLU`` computes it: a NaN
    propagates, and a zero keeps ``torch.maximum``'s sign."""
    zero = x.new_zeros(())
    return torch.maximum(x, zero) + alpha * torch.minimum(x, zero)


class PReLU(nn.Module):
    """max(x, 0) + alpha * min(x, 0) with a per-element alpha.

    ``torch.maximum`` / ``torch.minimum`` split the gradient of a tie
    evenly, as ``jnp.maximum`` / ``jnp.minimum`` do; ``torch.clamp`` passes
    all of it.  Ties are common in training: a PReLU whose alpha is 0 (the
    initial value) outputs exact zeros, which the next PReLU (the encoder's
    flatten PReLU) receives."""

    def __init__(self, shape):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(tuple(shape)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(x, self.alpha)


class BatchNorm(nn.Module):
    """(x - mean) * (rsqrt(var + eps) * scale) + bias over channel axis 1,
    in the order flax applies it.

    ``train=False`` normalises with the running statistics.  ``train=True``
    is flax 0.12's train mode (``_compute_stats``): the batch's mean and
    its fast, biased variance E[x^2] - E[x]^2 clipped at 0, taken over
    every axis but the channel's, normalise the batch, and the running
    statistics move to ``momentum * running + (1 - momentum) * batch``.
    ``torch.nn.BatchNorm2d`` keeps an unbiased running variance instead.
    The gradient flows through the batch statistics (autograd); the
    running update is outside the graph and happens whatever the optimizer
    freezes, as flax's ``mutable=["batch_stats"]`` does."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if train:
            axes = (0,) + tuple(range(2, x.ndim))
            mean = x.mean(dim=axes)
            var = torch.clamp(torch.square(x).mean(dim=axes) - torch.square(mean), min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


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
