"""Bias and PReLU in one pass: CUDA kernel and plain version.

Each conv, transposed conv and biased dense layer of the stamp forward is
followed by its PReLU (models/vae.py).  Computed op by op, the two are five
to eight launches over the whole activation; ``bias_prelu`` is one:

    out = max(t, 0) + alpha * min(t, 0),  t = y + bias

for a layer's output y (N, C, H, W) or (N, C) of dtype float32 or bfloat16
without its bias, the layer's float32 bias (C,) and the PReLU's float32
alpha (C, H, W) or (C,).  Every op rounds as the layers' ops round it
(models/layers.py): the bias cast to y's dtype and added, then the PReLU in
y's dtype with alpha cast to it, so in bfloat16 the sum, the product and
the PReLU's sum are each rounded to bfloat16.  On a card the result is bit
for bit the plain version's, which is those ops: ``bias_prelu_plain``.
There is no TPU kernel behind it; XLA fuses these ops into the JAX
package's convolutions.

CPU tensors take the plain version.  CUDA tensors launch
csrc/bias_prelu.cu (``dvt_bias_prelu``).  The result has the layout the
plain ops give it (``output_like``): a y whose samples are dense blocks, in
any order of its dims (the stamp forward's convolutions write NCHW in
float32 and channels-last in bfloat16, ``layers.conv_input``), is
overwritten in place; a strided y (the crop view of a TF transposed conv)
is read where it lies and the result written to a new tensor, dense in the
order of y's dims.
"""

from __future__ import annotations

import torch

from debvader_tpu_torch.kernels import _build
from debvader_tpu_torch.models.layers import prelu

__all__ = ["bias_prelu", "bias_prelu_plain", "output_like"]

_INT_MAX = 2**31 - 1


def bias_prelu_plain(y: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """prelu(y + bias, alpha) with the bias cast to y's dtype: the ops the
    layers run, and the kernel's plain version."""
    return prelu(y + bias.to(y.dtype).view((-1,) + (1,) * (y.ndim - 2)), alpha)


def _order(t: torch.Tensor) -> list[int]:
    """The dims after the batch, from the largest stride to the smallest."""
    return sorted(range(1, t.ndim), key=lambda d: -t.stride(d))


def _dense(t: torch.Tensor) -> bool:
    """Whether each sample of t is one dense block, in any order of its
    dims (dims of size 1 take any stride)."""
    expect = 1
    for d in reversed(_order(t)):
        if t.shape[d] > 1 and t.stride(d) != expect:
            return False
        expect *= t.shape[d]
    return t.shape[0] <= 1 or t.stride(0) == expect


def output_like(y: torch.Tensor) -> torch.Tensor:
    """The tensor the kernel writes: y when its samples are dense, else a
    new one laid out as the plain ops lay out their result (dense, y's dims
    in the same order)."""
    return y if _dense(y) else torch.empty_like(y)


def consecutive(y: torch.Tensor, out: torch.Tensor, v: int) -> bool:
    """Whether every run of v elements of out's innermost dim that starts
    at a multiple of v lies consecutive in y at an offset v divides."""
    if y.stride() == out.stride():
        return True
    inner = _order(out)[-1]
    return (y.stride(inner) == 1 and y.shape[inner] % v == 0
            and all(y.stride(d) % v == 0 for d in range(y.ndim) if d != inner))


def _launch(y, bias, alpha):
    out = output_like(y)
    n, c = y.shape[:2]
    h, w = y.shape[2:] if y.ndim == 4 else (1, 1)
    strides = list(y.stride()) + [0, 0] * (y.ndim == 2)
    order = [d - 1 for d in _order(out)] + [1, 2] * (y.ndim == 2)
    if max(n, c * h * w, *strides) > _INT_MAX:
        raise ValueError(f"y {tuple(y.shape)} at strides {y.stride()} overflows the kernel's int32 sizes")
    fn = _build.launcher("bias_prelu", "dvt_bias_prelu", 4, 13)
    status = _build.call(
        fn, y.device, y.data_ptr(), out.data_ptr(), bias.data_ptr(), alpha.data_ptr(), n, c, h, w, *strides, *order,
        int(consecutive(y, out, 16 // y.element_size())), int(y.dtype == torch.bfloat16),
    )
    _build.check(status, "bias_prelu")
    if y.dtype == torch.bfloat16:
        bias_prelu.launches_bf16 += 1
    else:
        bias_prelu.launches += 1
    return out


def bias_prelu(y: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """prelu(y + bias, alpha) for y (N, C, H, W) or (N, C), float32 or
    bfloat16; bias (C,) and alpha y.shape[1:], float32, on y's device.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which overwrites a y whose samples are dense (counted in
    ``bias_prelu.launches``, bfloat16 ones in ``launches_bf16``)."""
    if y.ndim not in (2, 4):
        raise ValueError(f"y must be (N, C, H, W) or (N, C), got {tuple(y.shape)}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"y must be float32 or bfloat16, got {y.dtype}")
    if tuple(bias.shape) != (y.shape[1],) or tuple(alpha.shape) != tuple(y.shape[1:]):
        raise ValueError(f"bias must be ({y.shape[1]},) and alpha {tuple(y.shape[1:])}, "
                         f"got {tuple(bias.shape)} and {tuple(alpha.shape)}")
    if bias.dtype != torch.float32 or alpha.dtype != torch.float32:
        raise ValueError(f"bias and alpha must be float32, got {bias.dtype} and {alpha.dtype}")
    if bias.device != y.device or alpha.device != y.device:
        raise ValueError("bias and alpha must lie on y's device")
    if y.device.type == "cpu":
        return bias_prelu_plain(y, bias, alpha)
    if y.device.type == "cuda":
        return _launch(y, bias.contiguous(), alpha.contiguous())
    raise ValueError(f"unsupported device {y.device}")


bias_prelu.launches = 0
bias_prelu.launches_bf16 = 0
