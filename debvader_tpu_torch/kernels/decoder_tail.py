"""Fused decoder tail: CUDA kernel and plain version.

Port of the Pallas kernel debvader_tpu/kernels/decoder_tail.py
(fused_decoder_tail): the decoder's last three layers on its largest
activation map, channels-last,

    x (N, S, S, C) -> stride-1 ConvTranspose 3x3 (C -> C) + bias
                   -> per-element PReLU
                   -> SAME Conv 3x3 (C -> O) + bias -> ReLU -> (N, S, S, O),

with the (S, S, C) intermediate kept on the chip.  As in the JAX package
the function stands alone: ``Decoder.forward`` does not call it.
``decoder_tail_params`` reads its five parameter tensors from the port's
``Decoder``.

The function computes in x's dtype, as the JAX kernel does.  float32 x:
float32 throughout.  bfloat16 x: the weights k2 and k3 rounded to bf16
(nearest even), products of bf16 values summed in float32, b2, a2 and b3
in float32, the intermediate rounded to bf16 after the PReLU and the
output rounded to bf16 after the ReLU; the result is bfloat16.  Other
dtypes raise.

On a card, float32 x launches csrc/decoder_tail.cu: float32 FMAs on the
CUDA cores, a persistent grid that keeps both weight sets in shared memory
and walks 16x32 output tiles.  bfloat16 x launches the one-limb instance
of the tensor-core tail core in csrc/tail_fused.cu (``dvt_decoder_tail_bf16``).
Both take C = 32 and O <= 16 (the default model has C = 32, O = 12) and are
held to the plain version within a tolerance: they sum in other orders.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from debvader_tpu_torch.device import fp32_math
from debvader_tpu_torch.kernels import _build
from debvader_tpu_torch.kernels.tail_fused import pack_b_operand

__all__ = ["fused_decoder_tail", "decoder_tail_plain", "decoder_tail_params"]


def decoder_tail_params(decoder):
    """(k2, b2, a2, k3, b3) of a ``models.vae.Decoder`` in the layouts
    :func:`fused_decoder_tail` takes: k2 (3, 3, C, C) in the TF transposed-
    conv layout (kh, kw, out, in), a2 (S, S, C), k3 (3, 3, C, O) HWIO."""
    convt, prelu, head = decoder.convts[-1], decoder.prelus[-1], decoder.head
    if convt.stride != 1:
        raise ValueError("the decoder's last transposed conv must have stride 1")
    return (
        convt.weight.detach().permute(2, 3, 1, 0).contiguous(),
        convt.bias.detach().contiguous(),
        prelu.alpha.detach().permute(1, 2, 0).contiguous(),
        head.weight.detach().permute(2, 3, 1, 0).contiguous(),
        head.bias.detach().contiguous(),
    )


def decoder_tail_plain(x, k2, b2, a2, k3, b3):
    """Plain PyTorch version of :func:`fused_decoder_tail`: the op chain
    ``Decoder.forward`` runs for these layers, in float32, with the JAX
    kernel's bf16 roundings when x is bfloat16 (the products of bf16
    values are exact in float32, so float32 convolutions on bf16-valued
    operands compute them)."""
    low = x.dtype == torch.bfloat16
    if low:
        k2, k3 = k2.to(torch.bfloat16), k3.to(torch.bfloat16)
    x, k2, b2, a2, k3, b3 = (t.to(torch.float32) for t in (x, k2, b2, a2, k3, b3))
    with fp32_math():
        h = x.permute(0, 3, 1, 2)
        # TF transposed conv at stride 1, SAME: the full transposed conv
        # cropped by one pixel at the top and left
        h = F.conv_transpose2d(h, k2.permute(3, 2, 0, 1), b2)[..., 1:-1, 1:-1]
        alpha = a2.permute(2, 0, 1)
        h = torch.clamp(h, min=0) + alpha * torch.clamp(h, max=0)
        if low:
            h = h.to(torch.bfloat16).to(torch.float32)
        h = F.relu(F.conv2d(h, k3.permute(3, 2, 0, 1), b3, padding=1))
    out = h.permute(0, 2, 3, 1).contiguous()
    return out.to(torch.bfloat16) if low else out


def _launch(x, k2, b2, a2, k3, b3):
    n, size, _, c = x.shape
    o = k3.shape[-1]
    if c != 32 or o > 16:
        raise ValueError(f"the CUDA decoder tail takes C = 32 and O <= 16, got C = {c}, O = {o}")
    # the transposed conv at stride 1 as a conv: flipped taps, (ci, co) last
    w2 = k2.flip(0, 1).permute(0, 1, 3, 2).contiguous()
    out = torch.empty((n, size, size, o), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        # one bf16 limb of each weight set in the tensor-core B layout
        w2b, k3b = pack_b_operand(w2, 32, 1), pack_b_operand(k3, 16, 1)
        fn = _build.launcher("tail_fused", "dvt_decoder_tail_bf16", 7, 5)
        args = (x.data_ptr(), w2b.data_ptr(), b2.data_ptr(), a2.data_ptr(), k3b.data_ptr(), b3.data_ptr(),
                out.data_ptr(), n, size, size, c, o)
    else:
        fn = _build.launcher("decoder_tail", "dvt_decoder_tail", 7, 4)
        args = (x.data_ptr(), w2.data_ptr(), b2.data_ptr(), a2.data_ptr(), k3.data_ptr(), b3.data_ptr(),
                out.data_ptr(), n, size, c, o)
    _build.check(_build.call(fn, x.device, *args), "decoder_tail")
    fused_decoder_tail.launches += 1
    return out


def fused_decoder_tail(x, k2, b2, a2, k3, b3) -> torch.Tensor:
    """x (N, S, S, C) -> (N, S, S, O) with O = k3.shape[-1], in x's dtype
    (float32 or bfloat16).

    k2: (3, 3, C, C) TF transposed-conv layout (kh, kw, out, in); b2: (C,);
    a2: (S, S, C) PReLU alphas; k3: (3, 3, C, O) HWIO; b3: (O,).  CPU
    tensors take the plain version; CUDA tensors launch a kernel."""
    if x.ndim != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(f"x must be (N, S, S, C), got {tuple(x.shape)}")
    n, size, _, c = x.shape
    o = k3.shape[-1]
    want = {"k2": (3, 3, c, c), "b2": (c,), "a2": (size, size, c), "k3": (3, 3, c, o), "b3": (o,)}
    for name, t in (("k2", k2), ("b2", b2), ("a2", a2), ("k3", k3), ("b3", b3)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} must lie on x's device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    k2, b2, a2, k3, b3 = (t.to(torch.float32).contiguous() for t in (k2, b2, a2, k3, b3))
    if x.device.type == "cpu":
        return decoder_tail_plain(x, k2, b2, a2, k3, b3)
    if x.device.type == "cuda":
        return _launch(x, k2, b2, a2, k3, b3)
    raise ValueError(f"unsupported device {x.device}")


fused_decoder_tail.launches = 0
