"""The int8 layers of quantized serving: CUDA kernels and plain versions.

The JAX package's quantized forward (debvader_tpu/models/quantized.py)
runs its quantized convs, transposed convs and dense layers as XLA
contractions of int8 operands with ``preferred_element_type=int32``
(``:340-347``, ``:399-407``, ``:447-452``); it has no Pallas kernel.
PyTorch has no int8 convolution on CUDA, so the port has its own,
``csrc/int8_conv.cu``, on the int8 tensor cores (``mma.sync`` m16n8k32
s8 x s8 -> s32), in two steps:

- ``quant_act(h, scale)``: float32 activations (N, C, H, W) or (N, F) to
  int8 ``clip(round_half_even(h / scale), -127, 127)``, channels last
  ((N, H, W, C) or (N, F)); ``scale`` is a 0-d tensor (per tensor) or a
  (C,) vector (per input channel);
- ``conv_s8(q, layer)``: the int8 product of those activations with a
  layer's int8 kernel, dequantized as JAX does,
  ``float32(acc) * dqw[c] + bias[c]`` (``dqw = dq * wscale`` formed once,
  by ``make_layer``), as float32 NCHW or (N, Cout); ``raw=True`` returns
  the int32 accumulators.

The int32 sums are exact in any order (|acc| <= K * 127^2 < 2^31), so the
kernel, the plain version and XLA agree bit for bit.  The plain versions
convolve the int8 values in float64 (exact: every partial sum is below
2^53) and apply the same epilogue in float32 ops.  A wrapper takes them
only for CPU tensors; a CUDA tensor launches the kernel, and a failed build
or launch raises.  ``quant_act.launches`` and ``conv_s8.launches`` count
the launches.
"""

from __future__ import annotations

import dataclasses

import torch

from debvader_tpu_torch.kernels import _build
from debvader_tpu_torch.models.layers import conv2d_same, conv_transpose2d_tf, tf_same_pads

__all__ = ["Int8Layer", "make_layer", "pack_kernel", "quant_act", "quant_act_plain", "conv_s8", "conv_s8_plain"]

KINDS = ("conv", "convT", "dense")
_BN, _BK = 64, 32


@dataclasses.dataclass(frozen=True)
class Int8Layer:
    """One quantized layer: ``qk`` the int8 kernel in the port's layout
    (conv (out, in, kh, kw), convT (in, out, kh, kw), dense (in, out)),
    ``packed`` the same as (Cout rounded up to 64, K rounded up to 32)
    rows ordered (ky, kx, ci), which the kernel reads; ``dqw`` and
    ``bias`` float32 (Cout,)."""

    kind: str
    qk: torch.Tensor
    packed: torch.Tensor
    dqw: torch.Tensor
    bias: torch.Tensor
    stride: int = 1

    @property
    def cout(self) -> int:
        return self.qk.shape[1] if self.kind in ("convT", "dense") else self.qk.shape[0]

    @property
    def ksize(self) -> int:
        return 1 if self.kind == "dense" else self.qk.shape[-1]


def pack_kernel(qk: torch.Tensor, kind: str) -> torch.Tensor:
    """The int8 kernel as (Cout, K) rows, K ordered (ky, kx, ci), padded
    with zeros to (multiple of 64, multiple of 32)."""
    if kind == "conv":
        rows = qk.permute(0, 2, 3, 1)
    elif kind == "convT":
        rows = qk.permute(1, 2, 3, 0)
    else:
        rows = qk.t()
    rows = rows.reshape(rows.shape[0], -1)
    cout, k = rows.shape
    out = torch.zeros((-(-cout // _BN) * _BN, -(-k // _BK) * _BK), dtype=torch.int8, device=qk.device)
    out[:cout, :k] = rows
    return out


def make_layer(kind: str, qk: torch.Tensor, wscale: torch.Tensor, s_in: torch.Tensor, bias: torch.Tensor,
               stride: int = 1) -> Int8Layer:
    """The layer's dequantization folded once, as JAX forms it: per-tensor
    ``dqw = s_in * wscale`` in float32; per-channel scales are already in
    ``wscale`` (``dq = 1``)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if qk.dtype != torch.int8:
        raise ValueError(f"the kernel must be int8, got {qk.dtype}")
    wscale = wscale.to(torch.float32)
    dqw = s_in.to(torch.float32) * wscale if s_in.ndim == 0 else wscale.clone()
    return Int8Layer(kind, qk, pack_kernel(qk, kind), dqw, bias.detach().to(torch.float32).contiguous(), stride)


def _channels(h: torch.Tensor, scale: torch.Tensor) -> int:
    if h.ndim not in (2, 4):
        raise ValueError(f"activations must be (N, C, H, W) or (N, F), got {tuple(h.shape)}")
    c = h.shape[1]
    if scale.ndim not in (0, 1) or (scale.ndim == 1 and scale.shape[0] != c):
        raise ValueError(f"scale must be 0-d or ({c},), got {tuple(scale.shape)}")
    return c


def quant_act_plain(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(h / scale), -127, 127) as int8, channels last; a NaN
    gives 0."""
    c = _channels(h, scale)
    s = scale.to(torch.float32)
    if s.ndim:
        s = s.view((1, c) + (1,) * (h.ndim - 2))
    q = torch.round(h.to(torch.float32) / s)
    q = torch.clamp(torch.where(torch.isnan(q), torch.zeros((), device=q.device), q), -127, 127).to(torch.int8)
    return q.permute(0, 2, 3, 1).contiguous() if q.ndim == 4 else q


def quant_act(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version for CPU tensors; the ``dvt_quant_act`` kernel for CUDA
    tensors."""
    c = _channels(h, scale)
    if scale.device != h.device:
        raise ValueError("scale must lie on the activations' device")
    if h.device.type == "cpu":
        return quant_act_plain(h, scale)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    h = h.to(torch.float32).contiguous()
    scale = scale.to(torch.float32).contiguous()
    n, hw = h.shape[0], (h.shape[2] * h.shape[3] if h.ndim == 4 else 1)
    out_shape = (n, h.shape[2], h.shape[3], c) if h.ndim == 4 else (n, c)
    q = torch.empty(out_shape, dtype=torch.int8, device=h.device)
    fn = _build.launcher("int8_conv", "dvt_quant_act", 3, 4)
    status = _build.call(fn, h.device, h.data_ptr(), scale.data_ptr(), q.data_ptr(), n, c, hw, int(scale.ndim == 1))
    _build.check(status, "int8_quant_act")
    quant_act.launches += 1
    return q


quant_act.launches = 0


def _geometry(q: torch.Tensor, layer: Int8Layer) -> tuple:
    """(n, h, w, cin, ho, wo, pad_top, pad_left) of the layer on q."""
    k, s = layer.ksize, layer.stride
    if layer.kind == "dense":
        if q.ndim != 2 or q.shape[1] != layer.qk.shape[0]:
            raise ValueError(f"dense input must be (N, {layer.qk.shape[0]}), got {tuple(q.shape)}")
        return q.shape[0], 1, 1, q.shape[1], 1, 1, 0, 0
    cin = layer.qk.shape[0] if layer.kind == "convT" else layer.qk.shape[1]
    if q.ndim != 4 or q.shape[3] != cin:
        raise ValueError(f"{layer.kind} input must be (N, H, W, {cin}), got {tuple(q.shape)}")
    n, h, w, _ = q.shape
    if layer.kind == "conv":
        return n, h, w, cin, -(-h // s), -(-w // s), tf_same_pads(h, k, s)[0], tf_same_pads(w, k, s)[0]
    return n, h, w, cin, h * s, w * s, tf_same_pads(h * s, k, s)[0], tf_same_pads(w * s, k, s)[0]


def _epilogue(acc: torch.Tensor, layer: Int8Layer, raw: bool) -> torch.Tensor:
    if raw:
        return acc
    shape = (1, -1) + (1,) * (acc.ndim - 2)
    return acc.to(torch.float32) * layer.dqw.view(shape) + layer.bias.view(shape)


def conv_s8_plain(q: torch.Tensor, layer: Int8Layer, raw: bool = False) -> torch.Tensor:
    """The layer on int8 activations by float64 convolutions of the int8
    values, then the float32 epilogue."""
    _geometry(q, layer)
    if layer.kind == "dense":
        acc = q.double() @ layer.qk.double()
    else:
        tf_layer = conv2d_same if layer.kind == "conv" else conv_transpose2d_tf
        acc = tf_layer(q.permute(0, 3, 1, 2).double(), layer.qk.double(), layer.stride)
    return _epilogue(acc.to(torch.int32), layer, raw)


def _launch(q: torch.Tensor, layer: Int8Layer, raw: bool) -> torch.Tensor:
    n, h, w, cin, ho, wo, top, left = _geometry(q, layer)
    kp = layer.packed.shape[1]
    if layer.ksize * layer.ksize * cin * 127 * 127 >= 2**31:
        raise ValueError("K is too large for exact int32 accumulation")
    if n * ho * wo >= 2**31:
        raise ValueError("too many output pixels for one launch")
    out_shape = (n, layer.cout) if layer.kind == "dense" else (n, layer.cout, ho, wo)
    out = torch.empty(out_shape, dtype=torch.int32 if raw else torch.float32, device=q.device)
    fn = _build.launcher("int8_conv", "dvt_conv_s8", 5, 14)
    status = _build.call(
        fn, q.device, q.data_ptr(), layer.packed.data_ptr(), layer.dqw.data_ptr(), layer.bias.data_ptr(),
        out.data_ptr(), n, h, w, cin, ho, wo, layer.cout, layer.ksize, layer.stride, top, left,
        int(layer.kind == "convT"), kp, int(raw),
    )
    _build.check(status, "int8_conv")
    conv_s8.launches += 1
    return out


def conv_s8(q: torch.Tensor, layer: Int8Layer, raw: bool = False) -> torch.Tensor:
    """The layer on int8 channels-last activations (quant_act's output):
    float32 NCHW or (N, Cout), or with ``raw=True`` the int32 accumulators.
    Plain version for CPU tensors; the ``dvt_conv_s8`` kernel for CUDA
    tensors."""
    if q.dtype != torch.int8:
        raise ValueError(f"activations must be int8, got {q.dtype}")
    if any(t.device != q.device for t in (layer.qk, layer.packed, layer.dqw, layer.bias)):
        raise ValueError("the layer must lie on the activations' device")
    if q.device.type == "cpu":
        return conv_s8_plain(q, layer, raw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q.contiguous(), layer, raw)


conv_s8.launches = 0
