"""The plain reference of the deblending VAE's forward, in plain PyTorch
on the flax-layout weights file.

Written from the reference Keras model (astrodeepnet/debvader
``model/model.py``), not from the port: NHWC stamps; the encoder is BatchNorm (eps 1e-3) then four stages of
[3x3 SAME conv + PReLU, 3x3 stride-2 SAME conv + PReLU], a PReLU on the
flattened (H, W, C) map and a Dense to the MVN-TriL head (32 locs and the
528-entry triangle in TFP's ``fill_triangular`` order, softplus on the
diagonal plus 1e-5); the decoder is PReLU, Dense(560), PReLU,
Dense(4*4*256), PReLU, four stages of [3x3 stride-2 transposed conv +
PReLU, 3x3 transposed conv + PReLU] (TF 'same' semantics), a 3x3 conv to
2 x bands, ReLU, the crop of 64 to 59 (the odd pixel at the end) and a
pixel Normal with scale 1e-4 + its second half.  PReLU alphas are
per-element.

It imports nothing of the program.  Every contraction (conv, transposed
conv, Dense) runs in float32 with TF32 off; ``precision`` rounds the
contraction's two operands first, which is how the lower precisions are
computed: 'float32' (none), 'tf32' (10 mantissa bits, as TF32 tensor cores
read float32), 'bfloat16', and 'fp8' (float8 e4m3 with a per-tensor scale
to its largest finite value).  A configuration's own precision is
'float32' or 'bfloat16'; the next lower one is the control.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["PRECISIONS", "load_params", "round_operand", "forward", "float32_math"]

PRECISIONS = ("float32", "tf32", "bfloat16", "fp8")
_FP8_MAX = 448.0


@contextlib.contextmanager
def float32_math():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def load_params(path, device) -> dict:
    """The weights file as {flax key path: float32 tensor on ``device``}."""
    with np.load(path) as z:
        return {k: torch.tensor(np.asarray(z[k], np.float32), device=device) for k in z.files}


def _rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        # round to nearest even at bit 13, keeping 10 mantissa bits
        bits = x.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        rounded = ((bits + 0xFFF + lsb) >> 13) << 13
        return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        scale = _FP8_MAX / torch.amax(torch.abs(x)).clamp(min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x (float32) rounded to ``precision``'s significand, returned as
    float32."""
    return x if precision == "float32" else _rounded(x, precision)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(h, kernel_hwio, bias, stride, precision):
    """TF 'SAME' conv, NCHW activations, HWIO kernel."""
    k = kernel_hwio.shape[0]
    lo_h, hi_h = _same_pads(h.shape[-2], k, stride)
    lo_w, hi_w = _same_pads(h.shape[-1], k, stride)
    w = round_operand(kernel_hwio, precision).permute(3, 2, 0, 1)
    return F.conv2d(F.pad(round_operand(h, precision), (lo_w, hi_w, lo_h, hi_h)), w, stride=stride) + bias.view(
        1, -1, 1, 1)


def _conv_transpose(h, kernel, bias, stride, precision):
    """TF ``Conv2DTranspose(padding='same')`` with the (kh, kw, out, in)
    kernel: the gradient of a SAME conv to ``in * stride``, i.e. the full
    transposed conv cropped by the SAME conv's leading pad."""
    k = kernel.shape[0]
    out_h, out_w = h.shape[-2] * stride, h.shape[-1] * stride
    lo_h = _same_pads(out_h, k, stride)[0]
    lo_w = _same_pads(out_w, k, stride)[0]
    w = round_operand(kernel, precision).permute(3, 2, 0, 1)  # (in, out, kh, kw)
    y = F.conv_transpose2d(round_operand(h, precision), w, stride=stride)
    return y[..., lo_h: lo_h + out_h, lo_w: lo_w + out_w] + bias.view(1, -1, 1, 1)


def _dense(h, kernel, bias, precision):
    return round_operand(h, precision) @ round_operand(kernel, precision) + bias


def _prelu(h, alpha):
    """Per-element PReLU; an (H, W, C) alpha meets an NCHW map."""
    a = alpha.permute(2, 0, 1) if alpha.ndim == 3 else alpha
    return torch.clamp(h, min=0) + a * torch.clamp(h, max=0)


def _batchnorm(h, p):
    """Inference BatchNorm over NCHW's channel axis (the running
    statistics)."""
    mean, var = p["batch_stats/encoder/BatchNorm_0/mean"], p["batch_stats/encoder/BatchNorm_0/var"]
    mul = torch.rsqrt(var + 1e-3) * p["params/encoder/BatchNorm_0/scale"]
    return (h - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + p["params/encoder/BatchNorm_0/bias"].view(1, -1, 1, 1)


def _encode(p, x, precision):
    """x (N, S, S, B) -> the flat MVN head (N, 560)."""
    h = _batchnorm(x.permute(0, 3, 1, 2), p)
    for i in range(8):
        h = _conv(h, p[f"params/encoder/Conv_{i}/kernel"], p[f"params/encoder/Conv_{i}/bias"], 1 + i % 2, precision)
        h = _prelu(h, p[f"params/encoder/PReLU_{i}/alpha"])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = _prelu(h, p["params/encoder/PReLU_8/alpha"])
    return _dense(h, p["params/encoder/Dense_0/kernel"], p["params/encoder/Dense_0/bias"], precision)


def _decode(p, z, precision, bands: int, stamp: int):
    h = _prelu(z, p["params/decoder/PReLU_0/alpha"])
    h = _prelu(_dense(h, p["params/decoder/Dense_0/kernel"], p["params/decoder/Dense_0/bias"], precision),
               p["params/decoder/PReLU_1/alpha"])
    h = _prelu(_dense(h, p["params/decoder/Dense_1/kernel"], p["params/decoder/Dense_1/bias"], precision),
               p["params/decoder/PReLU_2/alpha"])
    top = p["params/decoder/ConvTranspose2DTF_0/kernel"].shape[3]
    width = int(math.isqrt(h.shape[1] // top))
    h = h.reshape(-1, width, width, top).permute(0, 3, 1, 2)
    for i in range(8):
        h = _conv_transpose(h, p[f"params/decoder/ConvTranspose2DTF_{i}/kernel"],
                            p[f"params/decoder/ConvTranspose2DTF_{i}/bias"], 2 if i % 2 == 0 else 1, precision)
        h = _prelu(h, p[f"params/decoder/PReLU_{i + 3}/alpha"])
    h = F.relu(_conv(h, p["params/decoder/Conv_0/kernel"], p["params/decoder/Conv_0/bias"], 1, precision))
    crop = h.shape[-1] - stamp
    lo = crop // 2
    h = h[:, :, lo: lo + stamp, lo: lo + stamp].permute(0, 2, 3, 1)
    return h[..., :bands], 1e-4 + h[..., bands:]


def forward(p: dict, x: torch.Tensor, precision: str = "float32"):
    """The deterministic forward (the posterior mean decoded) of (N, S, S,
    B) float32 stamps: (loc, scale) of the pixel Normal, each (N, S, S, B).
    Non-finite pixels enter as 0."""
    x = torch.where(torch.isfinite(x), x, torch.zeros((), device=x.device))
    with float32_math():
        head = _encode(p, x, precision)
        latent = p["params/decoder/PReLU_0/alpha"].shape[0]
        return _decode(p, head[:, :latent], precision, x.shape[-1], x.shape[1])
