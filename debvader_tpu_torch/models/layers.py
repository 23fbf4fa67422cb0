"""Layers with exact Keras/TF semantics, in PyTorch (NCHW inside the model).

- ``Conv2dSame``: TF 'SAME' padding.  It is asymmetric for stride 2 on
  an even input (30 -> 15, 8 -> 4: the extra pixel goes bottom/right),
  which torch's ``padding='same'`` does not offer; ``conv2d_same`` copies
  the input padded there, and elsewhere lets the convolution pad.
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

Without a scheme they take a compute ``dtype``, as flax's ``nn.Conv`` /
``nn.Dense`` do: the input is cast to it (``_compute_in``; "float32" means
the parameters' own dtype, so a model cast with ``.double()`` computes in
float64).  A convolution's input is also laid out for its engines
(``conv_input``): on a card NCHW-dense in float32, as it comes (the
forward's channels-last) in bfloat16 and on the CPU.  In float32 the bias
joins the contraction.  In bfloat16 the input and the weight are cast to
bfloat16, the contraction's bfloat16 result (rounded once from a float32
accumulation) and the bias cast to bfloat16 are added in bfloat16: two
roundings, where ``F.conv2d(bias=...)`` would round once.  A forward
called with ``bias=False`` leaves the bias out, for models/vae.py's
one-pass bias and PReLU (kernels/bias_prelu.py).  ``PReLU``
computes in its input's dtype, its alpha cast to it; ``BatchNorm``
computes in float32 and casts its output to its ``dtype`` (flax promotes a
bfloat16 input against the float32 statistics).

``ConvTranspose2dTF(subpixel=True)`` and ``SubpixelConv2d`` run the
sub-pixel formulation of the JAX package's ``models/layers.py``: a dense
conv whose output channels are the phases of a 2x2 output patch, then a
depth-to-space.  The packed kernels (``pack_subpixel_kernel*``, in the JAX
package's HWIO / TF layouts) are built in the forward from the stored
kernel, so the parameters do not change.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from debvader_tpu_torch.models.precision import SCHEMES, apply_scheme

__all__ = [
    "tf_same_pads",
    "conv_input",
    "conv2d_same",
    "conv_transpose2d_tf",
    "Conv2dSame",
    "ConvTranspose2dTF",
    "prelu",
    "PReLU",
    "BatchNorm",
    "Dense",
    "SubpixelConv2d",
    "pack_subpixel_kernel",
    "pack_subpixel_kernel_s1",
    "pack_subpixel_kernel_fwd",
]


def _check_scheme(scheme):
    if scheme is not None and scheme not in SCHEMES:
        raise ValueError(f"scheme must be None or one of {sorted(SCHEMES)}, got {scheme!r}")
    return scheme


def _compute_in(x: torch.Tensor, dtype: torch.dtype, param: torch.Tensor) -> torch.Tensor:
    """x cast to a layer's compute dtype: bfloat16, or for float32 the
    dtype of the layer's parameters."""
    return x.to(param.dtype if dtype == torch.float32 else dtype)


def _nchw_engines(x: torch.Tensor) -> bool:
    """Whether x's convolutions in a dtype other than bfloat16 run on
    engines that take NCHW: cuDNN's, on a card.  The CPU's convolutions
    take the forward's channels-last as it comes, and there sum as the
    JAX package's XLA convolutions do on the CPU (NCHW would sum in
    another order, one that also depends on the batch)."""
    return x.is_cuda


def conv_input(x: torch.Tensor, dtype: torch.dtype, param: torch.Tensor) -> torch.Tensor:
    """A 4-D convolution's input cast to its compute dtype
    (``_compute_in``), in the layout its engines take.

    bfloat16 keeps the input's layout: the forward's activations are
    channels-last, as the sm90 bf16 tensor-core kernels want them.  On a
    card every other dtype gets an NCHW-dense input, since cuDNN's float32
    engines are NCHW ones: a channels-last input would be transposed to
    NCHW and the output back around every convolution.  The output follows
    the input's layout, so in an all-float32 forward only the encoder's
    first input and the decoder's reshaped dense output are copied
    (``conv_input.copies``: inputs already in the compute dtype whose
    layout changes); a cast changes the layout in the same copy.  CPU
    tensors keep their layout (``_nchw_engines``).  Each convolution's
    input is counted by layout in ``conv_input.nchw`` and
    ``conv_input.channels_last``."""
    dt = param.dtype if dtype == torch.float32 else dtype
    if dt == torch.bfloat16 or not _nchw_engines(x):
        y = x.to(dt)
    else:
        conv_input.copies += int(x.dtype == dt and not x.is_contiguous())
        y = x.to(dt, memory_format=torch.contiguous_format)
    if y.is_contiguous():
        conv_input.nchw += 1
    elif y.is_contiguous(memory_format=torch.channels_last):
        conv_input.channels_last += 1
    return y


conv_input.nchw = 0
conv_input.channels_last = 0
conv_input.copies = 0


def _contract(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype, fn):
    """fn(x, weight, bias) of a convolution in ``dtype``, x laid out by
    ``conv_input``: float32 folds the bias into the contraction; bfloat16
    adds it to the bfloat16 result after.  A None bias is left out."""
    x = conv_input(x, dtype, weight)
    if dtype == torch.float32:
        return fn(x, weight, bias)
    y = fn(x, weight.to(dtype), None)
    return y if bias is None else y + bias.to(dtype).view((-1,) + (1,) * (y.ndim - 2))


def tf_same_pads(in_size: int, k: int, s: int) -> tuple[int, int]:
    """(lo, hi) padding of a TF 'SAME' conv along one axis."""
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.conv2d`` with TF 'SAME' padding; weight (out, in, kh, kw).

    Where the pads are symmetric on both axes (every stride-1 conv, and
    stride 2 on an odd input) the convolution pads inside its own loads
    and no padded copy is made (counted in ``conv2d_same.in_conv``); the
    (0, 1) pads of stride 2 on an even input are materialised with
    ``F.pad`` first (``conv2d_same.pad_copies``).  Both sum the same
    products: only the zeros differ in where they come from."""
    k = weight.shape[-1]
    lo_h, hi_h = tf_same_pads(x.shape[-2], k, stride)
    lo_w, hi_w = tf_same_pads(x.shape[-1], k, stride)
    if lo_h == hi_h and lo_w == hi_w:
        conv2d_same.in_conv += 1
        return F.conv2d(x, weight, bias, stride=stride, padding=(lo_h, lo_w))
    conv2d_same.pad_copies += 1
    return F.conv2d(F.pad(x, (lo_w, hi_w, lo_h, hi_h)), weight, bias, stride=stride)


conv2d_same.in_conv = 0
conv2d_same.pad_copies = 0


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

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, scheme: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.scheme = _check_scheme(scheme)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def _conv(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        return conv2d_same(x, w, self.stride, b)

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        b = self.bias if bias else None
        if self.scheme is None:
            return _contract(x, self.weight, b, self.dtype, self._conv)
        y = apply_scheme(x, self.weight, self.scheme, 0, self._conv, out_axis=1)
        return y if b is None else y + b.view(1, -1, 1, 1)


class ConvTranspose2dTF(nn.Module):
    """TF-semantics transposed conv; weight (in, out, kh, kw), which is the
    TF (kh, kw, out, in) kernel transposed (3, 2, 0, 1).

    ``subpixel=True`` with a 3x3 kernel runs stride 2 as a dense 2x2 conv
    to the four output phases, and stride 1 on an even input as a stride-2
    4x4 conv to them, each then a depth-to-space; stride 1 on an odd input
    falls back to the transposed conv."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, scheme: str | None = None,
                 dtype: torch.dtype = torch.float32, subpixel: bool = False):
        super().__init__()
        self.stride = stride
        self.scheme = _check_scheme(scheme)
        self.dtype = dtype
        self.subpixel = subpixel
        self.weight = nn.Parameter(torch.zeros(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def _subpixel_fn(self, x: torch.Tensor):
        """The sub-pixel contraction for this input, or None."""
        if not self.subpixel or self.weight.shape[-2:] != (3, 3):
            return None
        if self.stride == 2:
            def fn(xx, w, b):
                packed = _torch_conv_weight(pack_subpixel_kernel(w.permute(2, 3, 1, 0)))
                return _depth_to_space(F.conv2d(F.pad(xx, (1, 0, 1, 0)), packed, None))
            return fn
        if self.stride == 1 and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0:
            def fn(xx, w, b):
                packed = _torch_conv_weight(pack_subpixel_kernel_s1(w.permute(2, 3, 1, 0)))
                return _depth_to_space(F.conv2d(F.pad(xx, (1, 1, 1, 1)), packed, None, stride=2))
            return fn
        return None

    def _conv(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        return conv_transpose2d_tf(x, w, self.stride, b)

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        b = self.bias if bias else None
        if self.scheme is None:
            sub = self._subpixel_fn(x)
            if sub is None:
                return _contract(x, self.weight, b, self.dtype, self._conv)
            # the packed contraction leaves the bias out in float32 too,
            # as the JAX layer adds it after the depth-to-space
            w = _compute_in(self.weight, self.dtype, self.weight)
            y = sub(conv_input(x, self.dtype, self.weight), w, None)
            return y if b is None else y + b.to(w.dtype).view(1, -1, 1, 1)
        # the bias joins after the limb terms are summed: inside the
        # contraction it would be added once a term
        y = apply_scheme(x, self.weight, self.scheme, 1, self._conv, out_axis=1)
        return y if b is None else y + b.view(1, -1, 1, 1)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + alpha * min(x, 0) in x's dtype, alpha cast to it, as
    ``PReLU`` computes it: a NaN propagates, and a zero keeps
    ``torch.maximum``'s sign."""
    zero = x.new_zeros(())
    return torch.maximum(x, zero) + alpha.to(x.dtype) * torch.minimum(x, zero)


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
    freezes, as flax's ``mutable=["batch_stats"]`` does.

    Statistics and normalisation are in the parameters' dtype (float32)
    whatever the input's dtype (flax's ``force_float32_reductions``); a
    bfloat16 ``dtype`` casts the output to it."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.99,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        x = x.to(self.scale.dtype)
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
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y if self.dtype == torch.float32 else y.to(self.dtype)


class Dense(nn.Module):
    """x @ kernel + bias with the checkpoint's (in, out) kernel."""

    def __init__(self, fin: int, fout: int, scheme: str | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scheme = _check_scheme(scheme)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(fin, fout))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        if self.scheme is not None:
            y = apply_scheme(x, self.kernel, self.scheme, 1, torch.matmul)
            return y + self.bias if bias else y
        if self.dtype == torch.float32:
            y = _compute_in(x, self.dtype, self.kernel) @ self.kernel
            return y + self.bias if bias else y
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y + self.bias.to(self.dtype) if bias else y


# ------------------------------------------------------------ sub-pixel


def _torch_conv_weight(hwio: torch.Tensor) -> torch.Tensor:
    """HWIO kernel -> F.conv2d's (out, in, kh, kw)."""
    return hwio.permute(3, 2, 0, 1)


def pack_subpixel_kernel(w: torch.Tensor) -> torch.Tensor:
    """A (3, 3, out, in) TF-layout stride-2 transposed-conv kernel packed
    for the sub-pixel formulation: (2, 2, in, 4 * out) HWIO, the JAX
    package's ``pack_subpixel_kernel``.  Output pixel (2i + p) reads the
    input through the taps k = p (mod 2): tap d in {0, 1} of a dense 2x2
    conv padded ((1, 0), (1, 0)) reads x[i - 1 + d], so the slot of phase
    p is w[p + 2 (1 - d)], empty when that is 3.  Phase channels are
    (py, px) row-major, as :func:`_depth_to_space` reads them."""
    kh, kw, cout, cin = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"subpixel pack requires a 3x3 kernel, got {kh}x{kw}")
    empty = w.new_zeros((cin, cout))
    taps = []
    for dy in range(2):
        for dx in range(2):
            phases = []
            for py in range(2):
                for px in range(2):
                    ky, kx = py + 2 * (1 - dy), px + 2 * (1 - dx)
                    phases.append(w[ky, kx].T if ky < 3 and kx < 3 else empty)
            taps.append(torch.stack(phases, dim=1))  # (in, 4, out)
    return torch.stack(taps, dim=0).reshape(2, 2, cin, 4 * cout)


def pack_subpixel_kernel_s1(w: torch.Tensor) -> torch.Tensor:
    """A (3, 3, out, in) TF-layout stride-1 transposed-conv kernel packed
    for the output-patch sub-pixel formulation on an even input: (4, 4, in,
    4 * out) HWIO for a stride-2 conv padded ((1, 1), (1, 1)).  A stride-1
    transposed conv is the correlation with the kernel turned 180 degrees
    and its channels swapped, so this is :func:`pack_subpixel_kernel_fwd`
    of that forward kernel."""
    kh, kw = w.shape[:2]
    if (kh, kw) != (3, 3):
        raise ValueError(f"subpixel pack requires a 3x3 kernel, got {kh}x{kw}")
    return pack_subpixel_kernel_fwd(torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2))


def pack_subpixel_kernel_fwd(w: torch.Tensor) -> torch.Tensor:
    """A (3, 3, in, out) HWIO stride-1 SAME conv kernel packed for the
    output-patch sub-pixel formulation: (4, 4, in, 4 * out), tap d of
    phase p holding w[d - p] for 0 <= d - p <= 2."""
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"subpixel pack requires a 3x3 kernel, got {kh}x{kw}")
    empty = w.new_zeros((cin, cout))
    taps = []
    for dy in range(4):
        for dx in range(4):
            phases = []
            for py in range(2):
                for px in range(2):
                    my, mx = dy - py, dx - px
                    phases.append(w[my, mx] if 0 <= my <= 2 and 0 <= mx <= 2 else empty)
            taps.append(torch.stack(phases, dim=1))  # (in, 4, out)
    return torch.stack(taps, dim=0).reshape(4, 4, cin, 4 * cout)


def _depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """(N, 4 C, S, S) phase channels, (py, px) row-major -> (N, C, 2S, 2S)."""
    n, c4, h, w = y.shape
    c = c4 // 4
    return y.reshape(n, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2).reshape(n, c, 2 * h, 2 * w)


class SubpixelConv2d(Conv2dSame):
    """Stride-1 3x3 SAME conv in the output-patch sub-pixel formulation
    (a stride-2 4x4 conv to the four phases, then a depth-to-space) on an
    even input, the stock conv on an odd one; the parameters of
    :class:`Conv2dSame`.  The bias is added after the contraction in
    either dtype, as the JAX ``SubpixelConv2D`` adds it."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, 3, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xd, w = conv_input(x, self.dtype, self.weight), _compute_in(self.weight, self.dtype, self.weight)
        if x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0:
            packed = _torch_conv_weight(pack_subpixel_kernel_fwd(w.permute(2, 3, 1, 0)))
            y = _depth_to_space(F.conv2d(F.pad(xd, (1, 1, 1, 1)), packed, None, stride=2))
        else:
            y = conv2d_same(xd, w, 1)
        return y + self.bias.to(w.dtype).view(1, -1, 1, 1)
