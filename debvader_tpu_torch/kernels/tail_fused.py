"""Fused decoder-tail conv pair at fidelity precision: CUDA kernel and
plain version.

Port of the Pallas kernel debvader_tpu/kernels/tail_fused.py
(fused_tail_pair):

    x (B, H, W, c_in) -> SAME 3x3 conv (c_in -> c1) + b1 -> per-element PReLU
                      -> SAME 3x3 conv (c1 -> c2) + b2 -> ReLU -> (B, H, W, c2),

each conv as the 3-term round-to-nearest bf16-limb product
``xh*wh + xh*wm + xm*wh`` with float32 accumulation (the 'bf16x3' scheme of
models/precision.py), the intermediate kept on the chip.  In the decoder
these are ``dec/ConvT_7`` (a stride-1 transposed conv, written as a conv
with flipped taps) and the band head ``dec/Conv_0``;
``tail_pair_params`` reads the five tensors from the port's ``Decoder``.
As in the JAX package the function stands alone: ``Decoder.forward`` does
not call it.

The CUDA kernel (csrc/tail_fused.cu) is bound by operations; it runs the
limb products on the tensor cores (``mma.sync`` m16n8k16, bf16 in, float32
out), one block per (image, 16x16 tile).  It takes c_in = c1 = 32 and
c2 <= 16 (the default model has 32, 32, 12) and is held to the plain
version within a tolerance: same limbs, same exact products, another order
of the float32 sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from debvader_tpu_torch.device import fp32_math
from debvader_tpu_torch.kernels import _build
from debvader_tpu_torch.models.precision import apply_scheme, split_limbs

__all__ = ["fused_tail_pair", "tail_pair_plain", "tail_pair_params"]

_SCHEME = "bf16x3"
# a weight row in the kernel's shared memory: 9 taps x 32 channels and 8
# values of padding (csrc/tail_fused.cu kKs)
_K_PAD = 9 * 32 + 8
_C2_PAD = 16


def tail_pair_params(decoder):
    """(w1, b1, alpha1, w2, b2) of a ``models.vae.Decoder`` in the layouts
    :func:`fused_tail_pair` takes: w1 (3, 3, C, C) HWIO, the last transposed
    conv at stride 1 written as a SAME conv (taps flipped, in and out
    swapped); alpha1 (S, S, C); w2 (3, 3, C, O) HWIO."""
    convt, prelu, head = decoder.convts[-1], decoder.prelus[-1], decoder.head
    if convt.stride != 1:
        raise ValueError("the decoder's last transposed conv must have stride 1")
    return (
        convt.weight.detach().flip(2, 3).permute(2, 3, 0, 1).contiguous(),
        convt.bias.detach().contiguous(),
        prelu.alpha.detach().permute(1, 2, 0).contiguous(),
        head.weight.detach().permute(2, 3, 1, 0).contiguous(),
        head.bias.detach().contiguous(),
    )


def _limb_conv(h: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 stride-1 conv of NCHW ``h`` under the limb scheme, no bias."""
    return apply_scheme(
        F.pad(h, (1, 1, 1, 1)), w_hwio.permute(3, 2, 0, 1), _SCHEME, 0, F.conv2d, out_axis=1
    )


def tail_pair_plain(x, w1, b1, alpha1, w2, b2):
    """Plain PyTorch version of :func:`fused_tail_pair`: the two layers
    through ``models.precision.apply_scheme`` under 'bf16x3', bias, PReLU,
    the second conv's zero padding, ReLU."""
    with fp32_math():
        h = _limb_conv(x.permute(0, 3, 1, 2), w1) + b1.view(1, -1, 1, 1)
        alpha = alpha1.permute(2, 0, 1)
        h = torch.clamp(h, min=0) + alpha * torch.clamp(h, max=0)
        h = F.relu(_limb_conv(h, w2) + b2.view(1, -1, 1, 1))
    return h.permute(0, 2, 3, 1).contiguous()


def _pack(w_hwio: torch.Tensor, rows: int):
    """The two bf16 limbs of a (3, 3, cin, cout) kernel as (rows, _K_PAD)
    bfloat16 matrices [cout][tap * cin + ci], zero beyond cout and beyond
    9 * cin: the layout the kernel copies into shared memory."""
    cout = w_hwio.shape[-1]
    flat = w_hwio.permute(3, 0, 1, 2).reshape(cout, -1)
    out = []
    for limb in split_limbs(flat, 2, "rne"):
        m = torch.zeros((rows, _K_PAD), dtype=torch.bfloat16, device=flat.device)
        m[:cout, : flat.shape[1]] = limb.to(torch.bfloat16)  # exact: the limb is bf16-valued
        out.append(m)
    return out


def _launch(x, w1, b1, alpha1, w2, b2):
    n, height, width, cin = x.shape
    c1, c2 = w1.shape[-1], w2.shape[-1]
    if cin != 32 or c1 != 32 or c2 > _C2_PAD:
        raise ValueError(
            f"the CUDA tail pair takes c_in = c1 = 32 and c2 <= 16, got {cin}, {c1}, {c2}"
        )
    w1h, w1m = _pack(w1, c1)
    w2h, w2m = _pack(w2, _C2_PAD)
    fn = _build.launcher("tail_fused", "dvt_tail_fused", 9, 6)
    out = torch.empty((n, height, width, c2), dtype=torch.float32, device=x.device)
    # the grid's last axis holds at most 65535 images
    for s0 in range(0, n, 65535):
        xs, outs = x[s0 : s0 + 65535], out[s0 : s0 + 65535]
        status = _build.call(
            fn, x.device, xs.data_ptr(), w1h.data_ptr(), w1m.data_ptr(), b1.data_ptr(), alpha1.data_ptr(),
            w2h.data_ptr(), w2m.data_ptr(), b2.data_ptr(), outs.data_ptr(),
            xs.shape[0], height, width, cin, c1, c2,
        )
        _build.check(status, "tail_fused")
        fused_tail_pair.launches += 1
    return out


def fused_tail_pair(x, w1, b1, alpha1, w2, b2) -> torch.Tensor:
    """relu(conv2(prelu(conv1(x) + b1, alpha1)) + b2) in one fused pass.

    x: (B, H, W, c_in) float32; w1: (3, 3, c_in, c1) HWIO; b1: (c1,);
    alpha1: (H, W, c1) per-element PReLU alpha; w2: (3, 3, c1, c2) HWIO;
    b2: (c2,).  Both convs are SAME, stride 1, under the 'bf16x3' limb
    scheme.  Returns (B, H, W, c2) float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, c_in), got {tuple(x.shape)}")
    _, height, width, cin = x.shape
    if w1.ndim != 4 or w2.ndim != 4:
        raise ValueError("w1 and w2 must be (3, 3, in, out) HWIO kernels")
    c1, c2 = w1.shape[-1], w2.shape[-1]
    want = {
        "w1": (3, 3, cin, c1), "b1": (c1,), "alpha1": (height, width, c1),
        "w2": (3, 3, c1, c2), "b2": (c2,),
    }
    given = (("w1", w1), ("b1", b1), ("alpha1", alpha1), ("w2", w2), ("b2", b2))
    for name, t in given:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} must lie on x's device")
    x, w1, b1, alpha1, w2, b2 = (
        t.to(torch.float32).contiguous() for t in (x, w1, b1, alpha1, w2, b2)
    )
    if x.device.type == "cpu":
        return tail_pair_plain(x, w1, b1, alpha1, w2, b2)
    if x.device.type == "cuda":
        return _launch(x, w1, b1, alpha1, w2, b2)
    raise ValueError(f"unsupported device {x.device}")


fused_tail_pair.launches = 0
