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
limb products on the tensor cores (``wgmma``, bf16 in, float32 out), a
persistent grid whose blocks keep the weight limbs in shared memory and
walk 16x16 output tiles.  It takes c_in = c1 = 32 and
c2 <= 16 (the default model has 32, 32, 12) and is held to the plain
version within a tolerance: same limbs, same exact products, another order
of the float32 sums.  The same source holds the one-limb instance that
runs the bfloat16 decoder tail (kernels/decoder_tail.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from debvader_tpu_torch.device import fp32_math
from debvader_tpu_torch.kernels import _build
from debvader_tpu_torch.models.precision import apply_scheme, split_limbs

__all__ = ["fused_tail_pair", "tail_pair_plain", "tail_pair_params", "pack_b_operand"]

_SCHEME = "bf16x3"
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


def pack_b_operand(w_hwio: torch.Tensor, n_pad: int, limbs: int) -> torch.Tensor:
    """The ``limbs`` bf16 limbs of a (3, 3, cin, cout) kernel (round to
    nearest even, as models.precision.split_limbs) as the B operand of the
    kernel's tensor-core products, in the layout ``wgmma`` reads without
    swizzling.  B[n][k] has n = l * n_pad + o for limb l and output channel
    o (zero from cout up to n_pad) and k = tap * cin + ci (zero up to a
    multiple of 16); it is cut into 8x8 core matrices of 128 contiguous
    bytes (8 rows n, 16 bytes of k each), element (n, k) at

        (k // 16) * N * 16 + (n // 8) * 128 + ((k % 16) // 8) * 64 + (n % 8) * 8 + k % 8

    with N = limbs * n_pad, so that one k-step of 16 is N * 32 contiguous
    bytes (leading byte offset 128 between the two k halves, stride byte
    offset 256 between groups of 8 rows) and one product of N columns
    gives the high x limb times every weight limb at once.  The kernel
    copies it into shared memory as it is."""
    cout = w_hwio.shape[-1]
    flat = w_hwio.to(torch.float32).permute(3, 0, 1, 2).reshape(cout, -1)
    k = flat.shape[1]
    k_pad = -(-k // 16) * 16
    m = torch.zeros((limbs, n_pad, k_pad), dtype=torch.bfloat16, device=flat.device)
    for l, limb in enumerate(split_limbs(flat, limbs, "rne")):
        m[l, :cout, :k] = limb.to(torch.bfloat16)  # exact: the limb is bf16-valued
    core = m.reshape(limbs * n_pad // 8, 8, k_pad // 16, 2, 8).permute(2, 0, 3, 1, 4)
    return core.contiguous().reshape(-1)


def _launch(x, w1, b1, alpha1, w2, b2):
    n, height, width, cin = x.shape
    c1, c2 = w1.shape[-1], w2.shape[-1]
    if cin != 32 or c1 != 32 or c2 > _C2_PAD:
        raise ValueError(
            f"the CUDA tail pair takes c_in = c1 = 32 and c2 <= 16, got {cin}, {c1}, {c2}"
        )
    wb1, wb2 = pack_b_operand(w1, c1, 2), pack_b_operand(w2, _C2_PAD, 2)
    fn = _build.launcher("tail_fused", "dvt_tail_fused", 7, 6)
    out = torch.empty((n, height, width, c2), dtype=torch.float32, device=x.device)
    status = _build.call(
        fn, x.device, x.data_ptr(), wb1.data_ptr(), b1.data_ptr(), alpha1.data_ptr(), wb2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), n, height, width, cin, c1, c2,
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
