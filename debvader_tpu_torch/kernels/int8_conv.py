"""The int8 layers of quantized serving: CUDA kernels and plain versions.

The JAX package's quantized forward (debvader_tpu/models/quantized.py)
runs its quantized convs, transposed convs and dense layers as XLA
contractions of int8 operands with ``preferred_element_type=int32``
(``:340-347``, ``:399-407``, ``:447-452``), each followed by ``_prelu``
(``:115``) and the next layer's ``_quant_act`` (``:172``); it has no
Pallas kernel.  PyTorch has no int8 convolution on CUDA, so the port has
its own, ``csrc/int8_conv.cu`` (its bfloat16 epilogues' instances compiled
apart, ``csrc/int8_conv_bf16.cu``):

- ``quant_act(h, scale)``: float32 activations (N, C, H, W) or (N, F) to
  int8 ``clip(round_half_even(h / scale), -127, 127)``, channels last
  ((N, H, W, C) or (N, F)); ``scale`` is a 0-d tensor (per tensor) or a
  (C,) vector (per input channel).  The forward needs it only where
  another float layer comes before an int8 one;
- ``bn_quant(x, bn, scale)`` and ``bias_prelu_quant(mm, bias, alpha,
  scale)``: the quantizer fused with the float tail before it, channels
  last in and out, at the two points of the sim_demo forward: the
  inference BatchNorm ``bn`` on the stamps (N, H, W, C) before
  enc/Conv_0, and dec/Dense_0's bias and the PReLU after it on the
  product ``mm`` (N, F) before dec/Dense_1 (``dvt_quant_point``);
- ``conv_fused(q, layer, alpha, flat_alpha, next_scale)``: one launch of
  the layer on int8 channels-last activations, dequantized as JAX does,
  ``float32(acc) * dqw[c] + bias[c]`` (``dqw = dq * wscale`` formed once,
  by ``make_layer``), then the PReLU ``alpha`` (per element of the
  layer's (C, H, W) output, or (C,) for a dense layer), then, over the
  output flattened channels last, the PReLU ``flat_alpha``, then the next
  layer's quantizer: ``next_scale`` 0-d or a vector of L values, element
  f of the flattened output taking ``next_scale[f % L]``.  With
  ``next_scale`` it returns the next layer's int8 input, channels last
  ((N, Ho, Wo, C) or (N, C)); without it float32 NCHW or (N, C);
  ``raw=True`` returns the int32 accumulators (NCHW).  ``conv_s8(q,
  layer, raw)`` is the same kernel with no epilogue beyond the
  dequantization.

The kernel computes a layer as one or more tap classes (``tap_classes``):
a stride-2 transposed conv as four stride-1 sub-convolutions, one for
each output parity, each with only the taps whose input index is
integral; a conv or a stride-1 transposed conv as one class of all its
taps; a dense layer as one 1 x 1 tap.  Each class's weights are packed in
the order the tensor cores read them (``pack_operand``).

bfloat16 models round where JAX's int8 forward rounds under a bfloat16
compute dtype.  A layer carries two dtypes (``make_layer``): ``dtype``,
the one its output and the PReLU(s) after it compute in (JAX's
``(y + bias).astype(dtype)`` and ``_prelu``), and ``out_dtype``, the one
it hands on (the cast at the decoder's reshape, :518).  With ``dtype``
bfloat16, ``conv_fused`` rounds y after the bias and runs the PReLUs in
bfloat16 arithmetic; with ``out_dtype`` bfloat16 it rounds before the
quantizer and writes a float output as bfloat16.  dec/Dense_1 under
``strict_cast`` is the one layer with a float32 ``dtype`` and a bfloat16
``out_dtype``.  ``bn_quant`` follows ``bn.dtype`` (the stamps rounded to
bfloat16, the BatchNorm in float32, rounded) and ``bias_prelu_quant`` a
bfloat16 product (the bias added and the PReLU in bfloat16).

The int32 sums are exact in any order (|acc| <= K * 127^2 < 2^31), so the
kernel, the plain version and XLA agree bit for bit.  The plain versions
convolve the int8 values in float64 (exact: every partial sum is below
2^53) and apply the same epilogue in float32 ops, each rounding a
``.to(torch.bfloat16)``.  A wrapper takes them only for CPU tensors; a
CUDA tensor launches the kernel, and a failed build or launch raises.
``quant_act.launches``, ``bn_quant.launches``,
``bias_prelu_quant.launches``, ``conv_fused.launches`` and
``conv_s8.launches`` count the launches; of them, the bfloat16 kinds also
add to ``bn_quant.launches_bf16``, ``bias_prelu_quant.launches_bf16`` and
``conv_fused.launches_bf16_<kind>`` (conv, convT, dense).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from debvader_tpu_torch.kernels import _build
from debvader_tpu_torch.models.layers import conv2d_same, conv_transpose2d_tf, prelu, tf_same_pads

__all__ = [
    "Int8Layer", "TapClass", "make_layer", "pack_kernel", "pack_operand", "tap_classes", "quant_act",
    "quant_act_plain", "bn_quant", "bn_quant_plain", "bias_prelu_quant", "bias_prelu_quant_plain", "conv_fused",
    "conv_fused_plain", "conv_s8", "conv_s8_plain",
]

KINDS = ("conv", "convT", "dense")
_BM, _BK = 64, 32
# epilogue modes of dvt_conv_fused, and its rounding bits: the layer's
# dtype bfloat16, the dtype it hands on bfloat16
_FLOAT, _INT8, _RAW = 0, 1, 2
_ROUND_EACH, _ROUND_OUT = 64, 128
_DTYPES = (torch.float32, torch.bfloat16)
# the per-class table the launcher reads: oy0, ox0, taps, kp, operand offset, 9 dy, 9 dx
_TABLE_INTS = 23
_MAX_CLASSES, _MAX_TAPS = 4, 9


@dataclasses.dataclass(frozen=True)
class Int8Layer:
    """One quantized layer: ``qk`` the int8 kernel in the port's layout
    (conv (out, in, kh, kw), convT (in, out, kh, kw), dense (in, out)),
    ``rows`` the same as (Cout, K) rows ordered (ky, kx, ci); ``dqw`` and
    ``bias`` float32 (Cout,); ``dtype`` and ``out_dtype`` the epilogue's
    (module docstring).  ``plans`` caches the kernel's packed operands and
    launch geometry by input shape."""

    kind: str
    qk: torch.Tensor
    rows: torch.Tensor
    dqw: torch.Tensor
    bias: torch.Tensor
    stride: int = 1
    dtype: torch.dtype = torch.float32
    out_dtype: torch.dtype = torch.float32
    plans: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def rounding(self) -> int:
        """dvt_conv_fused's rounding bits for this layer's epilogue."""
        return (_ROUND_EACH if self.dtype == torch.bfloat16 else 0) | (
            _ROUND_OUT if self.out_dtype == torch.bfloat16 else 0)

    @property
    def cout(self) -> int:
        return self.qk.shape[1] if self.kind in ("convT", "dense") else self.qk.shape[0]

    @property
    def cin(self) -> int:
        return self.qk.shape[0] if self.kind in ("convT", "dense") else self.qk.shape[1]

    @property
    def ksize(self) -> int:
        return 1 if self.kind == "dense" else self.qk.shape[-1]


@dataclasses.dataclass(frozen=True)
class TapClass:
    """Output pixels (oy0 + ostep * qy, ox0 + ostep * qx) of one class and
    its taps (ky, kx, dy, dx): input pixel (istride * qy + dy, istride *
    qx + dx) times kernel tap (ky, kx), where that pixel lies in the
    input."""

    oy0: int
    ox0: int
    taps: tuple


def pack_kernel(qk: torch.Tensor, kind: str) -> torch.Tensor:
    """The int8 kernel as (Cout, K) rows, K ordered (ky, kx, ci)."""
    if kind == "conv":
        rows = qk.permute(0, 2, 3, 1)
    elif kind == "convT":
        rows = qk.permute(1, 2, 3, 0)
    else:
        rows = qk.t()
    return rows.reshape(rows.shape[0], -1).contiguous()


def _block_n(cout: int) -> int:
    """The kernel's output-channel tile: 32, 64 or 128."""
    return 32 if cout <= 32 else 64 if cout <= 64 else 128


def pack_operand(rows: torch.Tensor, cin: int, ksize: int, taps) -> torch.Tensor:
    """One tap class's weights as the kernel's B operand: B[co, t * cin +
    ci] = rows[co, (ky_t * ksize + kx_t) * cin + ci], padded with zeros to
    (Cout rounded up to the channel tile, K rounded up to 32), in the
    order of wgmma's K-major shared-memory layout without swizzle: k-step
    of 32 bytes, group of 8 rows, 16-byte half of the k-step, row, byte."""
    cout = rows.shape[0]
    np_pad = -(-cout // _block_n(cout)) * _block_n(cout)
    index = torch.tensor([ky * ksize + kx for ky, kx, _, _ in taps], dtype=torch.long, device=rows.device)
    b = rows.view(cout, ksize * ksize, cin).index_select(1, index).reshape(cout, -1)
    kp = -(-b.shape[1] // _BK) * _BK
    out = torch.zeros((np_pad, kp), dtype=torch.int8, device=rows.device)
    out[:cout, : b.shape[1]] = b
    return out.view(np_pad // 8, 8, kp // _BK, 2, 16).permute(2, 0, 3, 1, 4).reshape(-1)


def tap_classes(kind: str, ksize: int, stride: int, h: int, w: int) -> tuple:
    """(ho, wo, hq, wq, istride, ostep, classes) of a layer on an (h, w)
    input.  A TF-SAME conv is one class: output (oy, ox) reads input (s *
    oy - top + ky, s * ox - left + kx).  A TF transposed conv sums, at
    output oy, the taps ky whose (oy + lo - ky) / s is integral (lo the
    crop of ConvTranspose2dTF): at stride s that set depends on oy mod s
    only, so the layer is s * s stride-1 sub-convolutions over the input's
    grid, class (py, px) with the taps ky = py + lo mod s, reading input
    qy + (py + lo - ky) / s.  A dense layer is one 1 x 1 tap."""
    if kind == "dense":
        return 1, 1, 1, 1, 1, 1, (TapClass(0, 0, ((0, 0, 0, 0),)),)
    k, s = ksize, stride
    if kind == "conv":
        ho, wo = -(-h // s), -(-w // s)
        top, left = tf_same_pads(h, k, s)[0], tf_same_pads(w, k, s)[0]
        taps = tuple((ky, kx, ky - top, kx - left) for ky in range(k) for kx in range(k))
        return ho, wo, ho, wo, s, 1, (TapClass(0, 0, taps),)
    ho, wo = h * s, w * s
    lo_h, lo_w = tf_same_pads(ho, k, s)[0], tf_same_pads(wo, k, s)[0]
    classes = []
    for py in range(s):
        for px in range(s):
            taps = tuple(
                (ky, kx, (py + lo_h - ky) // s, (px + lo_w - kx) // s)
                for ky in range(k) if (py + lo_h - ky) % s == 0
                for kx in range(k) if (px + lo_w - kx) % s == 0
            )
            classes.append(TapClass(py, px, taps))
    return ho, wo, h, w, 1, s, tuple(classes)


def make_layer(kind: str, qk: torch.Tensor, wscale: torch.Tensor, s_in: torch.Tensor, bias: torch.Tensor,
               stride: int = 1, dtype: torch.dtype = torch.float32, out_dtype: torch.dtype | None = None) -> Int8Layer:
    """The layer's dequantization folded once, as JAX forms it: per-tensor
    ``dqw = s_in * wscale`` in float32; per-channel scales are already in
    ``wscale`` (``dq = 1``).  ``dtype`` is the epilogue's compute dtype,
    ``out_dtype`` (by default ``dtype``) the one it hands on, each
    float32 or bfloat16."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if qk.dtype != torch.int8:
        raise ValueError(f"the kernel must be int8, got {qk.dtype}")
    out_dtype = dtype if out_dtype is None else out_dtype
    if dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"the epilogue's dtypes must be float32 or bfloat16, got {dtype} and {out_dtype}")
    wscale = wscale.to(torch.float32)
    dqw = s_in.to(torch.float32) * wscale if s_in.ndim == 0 else wscale.clone()
    return Int8Layer(kind, qk, pack_kernel(qk, kind), dqw, bias.detach().to(torch.float32).contiguous(), stride,
                     dtype, out_dtype)


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
    _quant_act.launches += 1
    return q


# the counters live on the functions themselves, which a caller may wrap
_quant_act = quant_act
quant_act.launches = 0


# the kinds of dvt_quant_point
_BN_QUANT, _BIAS_PRELU_QUANT, _BN_QUANT_BF16, _BIAS_PRELU_QUANT_BF16 = 0, 1, 2, 3


def _check_point(x: torch.Tensor, ndim: int, params: tuple, scale: torch.Tensor, dtypes=(torch.float32,)) -> int:
    """Validate a fused quantization point's operands; returns C, the
    channels (the last dimension of x)."""
    if x.dtype not in dtypes:
        raise ValueError(f"activations must be {' or '.join(str(d) for d in dtypes)}, got {x.dtype}")
    if x.ndim != ndim or not x.is_contiguous():
        raise ValueError(f"activations must be a contiguous {ndim}-d tensor, channels last, got {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    c = x.shape[-1]
    for t in params:
        if tuple(t.shape) != (c,):
            raise ValueError(f"channel parameters must be ({c},), got {tuple(t.shape)}")
    if scale.ndim not in (0, 1) or (scale.ndim == 1 and scale.shape[0] != c):
        raise ValueError(f"scale must be 0-d or ({c},), got {tuple(scale.shape)}")
    if any(t.device != x.device for t in params + (scale,)):
        raise ValueError("the parameters and scale must lie on the activations' device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return c


def _launch_point(kind: int, x: torch.Tensor, p0, p1, p2, scale: torch.Tensor) -> torch.Tensor:
    if x.data_ptr() % 16:  # a view into another tensor: the kernel reads 16- or 8-byte vectors
        x = x.clone()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    p0, p1, scale = (t.detach().to(torch.float32).contiguous() for t in (p0, p1, scale))
    p2 = None if p2 is None else p2.detach().to(torch.float32).contiguous()
    n, c = x.shape[0], x.shape[-1]
    fn = _build.launcher("int8_conv", "dvt_quant_point", 6, 5)
    status = _build.call(fn, x.device, x.data_ptr(), p0.data_ptr(), p1.data_ptr(), 0 if p2 is None else p2.data_ptr(),
                         scale.data_ptr(), q.data_ptr(), kind, n, c, x.numel() // (n * c) if n else 0,
                         int(scale.ndim == 1))
    _build.check(status, "int8_quant_point")
    return q


def bn_quant_plain(x: torch.Tensor, bn, scale: torch.Tensor) -> torch.Tensor:
    """quant_act_plain(bn(x.permute(0, 3, 1, 2)), scale): the forward's
    inference BatchNorm on the stamps (N, H, W, C), then the quantizer;
    (N, H, W, C) int8.  A bfloat16 ``bn`` takes the stamps rounded to
    bfloat16 and rounds its float32 result, as the bfloat16 encoder does."""
    x = x if bn.dtype == torch.float32 else x.to(bn.dtype)
    return quant_act_plain(bn(x.permute(0, 3, 1, 2)), scale)


def bn_quant(x: torch.Tensor, bn, scale: torch.Tensor) -> torch.Tensor:
    """enc/Conv_0's int8 input from the stamps x (N, H, W, C) float32,
    contiguous: the inference BatchNorm ``bn`` (a ``models.layers.BatchNorm``,
    float32 or bfloat16) and the quantizer by ``scale``, (N, H, W, C) int8.
    Plain version for CPU tensors; one ``dvt_quant_point`` launch for CUDA
    tensors, whose mul is formed by the same torch ops as
    ``BatchNorm.forward``."""
    _check_point(x, 4, (bn.mean, bn.var, bn.scale, bn.bias), scale)
    if bn.dtype not in _DTYPES:
        raise ValueError(f"the BatchNorm's dtype must be float32 or bfloat16, got {bn.dtype}")
    if x.device.type == "cpu":
        return bn_quant_plain(x, bn, scale)
    with torch.no_grad():
        mul = torch.rsqrt(bn.var + bn.eps) * bn.scale
    bf16 = bn.dtype == torch.bfloat16
    q = _launch_point(_BN_QUANT_BF16 if bf16 else _BN_QUANT, x, bn.mean, mul, bn.bias, scale)
    _bn_quant.launches += 1
    _bn_quant.launches_bf16 += bf16
    return q


_bn_quant = bn_quant
bn_quant.launches = bn_quant.launches_bf16 = 0


def bias_prelu_quant_plain(mm: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """quant_act_plain(prelu(mm + bias, alpha), scale): a dense layer's bias
    and the PReLU after it on the product mm (N, F), in mm's dtype (the
    bias cast to it), then the quantizer; (N, F) int8."""
    return quant_act_plain(prelu(mm + bias.to(mm.dtype), alpha), scale)


def bias_prelu_quant(mm: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """dec/Dense_1's int8 input from dec/Dense_0's product mm (N, F)
    float32 or bfloat16, contiguous: its ``bias``, the PReLU ``alpha`` (F,)
    and the quantizer by ``scale``, (N, F) int8; a bfloat16 mm adds the
    bias and runs the PReLU in bfloat16.  Plain version for CPU tensors;
    one ``dvt_quant_point`` launch for CUDA tensors."""
    _check_point(mm, 2, (bias, alpha), scale, _DTYPES)
    if mm.device.type == "cpu":
        return bias_prelu_quant_plain(mm, bias, alpha, scale)
    bf16 = mm.dtype == torch.bfloat16
    q = _launch_point(_BIAS_PRELU_QUANT_BF16 if bf16 else _BIAS_PRELU_QUANT, mm, bias, alpha, None, scale)
    _bias_prelu_quant.launches += 1
    _bias_prelu_quant.launches_bf16 += bf16
    return q


_bias_prelu_quant = bias_prelu_quant
bias_prelu_quant.launches = bias_prelu_quant.launches_bf16 = 0


def _geometry(q: torch.Tensor, layer: Int8Layer) -> tuple:
    """(n, h, w, ho, wo) of the layer on q."""
    if layer.kind == "dense":
        if q.ndim != 2 or q.shape[1] != layer.cin:
            raise ValueError(f"dense input must be (N, {layer.cin}), got {tuple(q.shape)}")
        return q.shape[0], 1, 1, 1, 1
    if q.ndim != 4 or q.shape[3] != layer.cin:
        raise ValueError(f"{layer.kind} input must be (N, H, W, {layer.cin}), got {tuple(q.shape)}")
    n, h, w, _ = q.shape
    ho, wo = tap_classes(layer.kind, layer.ksize, layer.stride, h, w)[:2]
    return n, h, w, ho, wo


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


def _check_epilogue(shape: tuple, alpha, flat_alpha, next_scale) -> int:
    """Validate the fused epilogue's tensors for an output of ``shape``
    ((N, C, Ho, Wo) or (N, C)); returns L, the length of next_scale."""
    per_sample = tuple(shape[1:])
    if alpha is not None and tuple(alpha.shape) != per_sample:
        raise ValueError(f"alpha must be {per_sample}, got {tuple(alpha.shape)}")
    flat = int(np.prod(per_sample))
    if flat_alpha is not None:
        if next_scale is None:
            raise ValueError("flat_alpha needs next_scale: only a quantized output is flattened")
        if tuple(flat_alpha.shape) != (flat,):
            raise ValueError(f"flat_alpha must be ({flat},), got {tuple(flat_alpha.shape)}")
    if next_scale is None:
        return 0
    if next_scale.ndim == 0:
        return 1
    if next_scale.ndim != 1 or flat % next_scale.shape[0]:
        raise ValueError(f"next_scale must be 0-d or (L,) with L dividing {flat}, got {tuple(next_scale.shape)}")
    return next_scale.shape[0]


def conv_fused_plain(q: torch.Tensor, layer: Int8Layer, alpha: torch.Tensor | None = None,
                     flat_alpha: torch.Tensor | None = None, next_scale: torch.Tensor | None = None) -> torch.Tensor:
    """quant_act_plain(prelu(conv_s8_plain(q, layer)), next_scale), laid out
    as the kernel writes it: the output rounded to the layer's ``dtype``,
    the PReLU ``alpha`` on the NCHW output, then the output flattened
    channels last, the PReLU ``flat_alpha`` (each PReLU in ``dtype``), the
    cast to ``out_dtype`` and the quantizer with ``next_scale[f % L]`` at
    flat index f; NCHW in ``out_dtype`` when ``next_scale`` is None."""
    y = conv_s8_plain(q, layer)
    length = _check_epilogue(tuple(y.shape), alpha, flat_alpha, next_scale)
    y = y.to(layer.dtype)
    if alpha is not None:
        y = prelu(y, alpha)
    if next_scale is None:
        return y.to(layer.out_dtype)
    nhwc = y.permute(0, 2, 3, 1) if y.ndim == 4 else y
    flat = nhwc.reshape(y.shape[0], -1)
    if flat_alpha is not None:
        flat = prelu(flat, flat_alpha)
    return quant_act_plain(flat.to(layer.out_dtype).reshape(-1, length), next_scale).reshape(nhwc.shape)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What the launcher needs of a layer on one input shape."""

    operand: torch.Tensor
    table: np.ndarray
    dims: tuple  # n, h, w, cin, ho, wo, cout, hq, wq, istride, ostep, nclass, np_pad
    splits: int
    ws_ints: int


def _plan(q: torch.Tensor, layer: Int8Layer, sms: int) -> _Plan:
    """The packed operands, class table and split of the layer on q's
    shape for a card of ``sms`` multiprocessors, made once and cached on
    the layer."""
    key = (tuple(q.shape), q.device)
    plan = layer.plans.get(key)
    if plan is not None:
        return plan
    n, h, w, ho, wo = _geometry(q, layer)
    _, _, hq, wq, istride, ostep, classes = tap_classes(layer.kind, layer.ksize, layer.stride, h, w)
    if len(classes) > _MAX_CLASSES or layer.ksize > 3:
        raise ValueError(f"the kernel takes at most {_MAX_CLASSES} tap classes of at most {_MAX_TAPS} taps "
                         f"(a stride of 2 or less, kernels up to 3 x 3), got stride {layer.stride}, "
                         f"kernel {layer.ksize}")
    cin, cout = layer.cin, layer.cout
    bn = _block_n(cout)
    np_pad = -(-cout // bn) * bn
    table = np.zeros((len(classes), _TABLE_INTS), np.int32)
    operands, offset = [], 0
    for c, cls in enumerate(classes):
        operand = pack_operand(layer.rows, cin, layer.ksize, cls.taps)
        kp = operand.numel() // np_pad
        table[c, :5] = (cls.oy0, cls.ox0, len(cls.taps), kp, offset)
        for t, (_, _, dy, dx) in enumerate(cls.taps):
            table[c, 5 + t], table[c, 5 + _MAX_TAPS + t] = dy, dx
        operands.append(operand)
        offset += operand.numel()
    m = n * hq * wq
    tiles = -(-m // _BM) * (np_pad // bn) * len(classes)
    steps = max(int(t) for t in table[:, 3]) // _BK
    # K slices where the output tiles leave SMs idle, at least 8 k-steps a slice
    splits = 1 if tiles >= sms else max(1, min(-(-sms // tiles), steps // 8))
    ws_ints = len(classes) * (m * np_pad + tiles // len(classes)) if splits > 1 else 0
    plan = _Plan(torch.cat(operands), table, (n, h, w, cin, ho, wo, cout, hq, wq, istride, ostep, len(classes),
                                              np_pad), splits, ws_ints)
    layer.plans[key] = plan
    return plan


def _launch(q: torch.Tensor, layer: Int8Layer, mode: int, alpha, flat_alpha, next_scale,
            rounding: int = 0) -> torch.Tensor:
    if layer.ksize * layer.ksize * layer.cin * 127 * 127 >= 2**31:
        raise ValueError("K is too large for exact int32 accumulation")
    plan = _plan(q, layer, _sm_count(q.device.index if q.device.index is not None else torch.cuda.current_device()))
    n, h, w, cin, ho, wo, cout, hq, wq, istride, ostep, nclass, np_pad = plan.dims
    if n * ho * wo * cout >= 2**31:
        raise ValueError("too many outputs for one launch")
    dev = q.device
    if mode == _INT8:
        shape = (n, cout) if layer.kind == "dense" else (n, ho, wo, cout)
        dtype = torch.int8
    else:
        shape = (n, cout) if layer.kind == "dense" else (n, cout, ho, wo)
        dtype = torch.int32 if mode == _RAW else torch.bfloat16 if rounding & _ROUND_OUT else torch.float32
    out = torch.empty(shape, dtype=dtype, device=dev)
    length = _check_epilogue((n, cout) + (() if layer.kind == "dense" else (ho, wo)), alpha, flat_alpha, next_scale)
    ptrs = []
    for t in (alpha, flat_alpha, next_scale):
        if t is None:
            ptrs.append(None)
            continue
        if t.device != dev:
            raise ValueError("the epilogue's tensors must lie on the activations' device")
        t = t.detach().to(torch.float32).contiguous()
        ptrs.append(t)
    # split K's partial sums and tile counters, zeroed by the launcher
    ws = torch.empty(plan.ws_ints, dtype=torch.int32, device=dev) if plan.ws_ints else None
    # the bfloat16 epilogues' instances are csrc/int8_conv_bf16.cu's
    fn = (_build.launcher("int8_conv_bf16", "dvt_conv_fused_bf16", 10, 17) if rounding else
          _build.launcher("int8_conv", "dvt_conv_fused", 10, 17))
    status = _build.call(
        fn, dev, q.data_ptr(), plan.operand.data_ptr(), layer.dqw.data_ptr(), layer.bias.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in ptrs), out.data_ptr(), 0 if ws is None else ws.data_ptr(),
        plan.table.ctypes.data,
        n, h, w, cin, ho, wo, cout, hq, wq, istride, ostep, nclass, np_pad, mode, length, plan.splits, rounding,
    )
    _build.check(status, "int8_conv")
    return out


def _check_operands(q: torch.Tensor, layer: Int8Layer) -> None:
    if q.dtype != torch.int8:
        raise ValueError(f"activations must be int8, got {q.dtype}")
    if any(t.device != q.device for t in (layer.qk, layer.rows, layer.dqw, layer.bias)):
        raise ValueError("the layer must lie on the activations' device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def conv_fused(q: torch.Tensor, layer: Int8Layer, alpha: torch.Tensor | None = None,
               flat_alpha: torch.Tensor | None = None, next_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The layer on int8 channels-last activations with its epilogue fused
    (module docstring): the next layer's int8 input with ``next_scale``,
    NCHW or (N, Cout) in the layer's ``out_dtype`` without.  Plain version
    for CPU tensors; one ``dvt_conv_fused`` launch for CUDA tensors."""
    _check_operands(q, layer)
    if q.device.type == "cpu":
        return conv_fused_plain(q, layer, alpha, flat_alpha, next_scale)
    out = _launch(q.contiguous(), layer, _FLOAT if next_scale is None else _INT8, alpha, flat_alpha, next_scale,
                  layer.rounding)
    _conv_fused.launches += 1
    if layer.rounding:
        name = f"launches_bf16_{layer.kind}"
        setattr(_conv_fused, name, getattr(_conv_fused, name) + 1)
    return out


_conv_fused = conv_fused
conv_fused.launches = conv_fused.launches_bf16_conv = conv_fused.launches_bf16_convT = 0
conv_fused.launches_bf16_dense = 0


def conv_s8(q: torch.Tensor, layer: Int8Layer, raw: bool = False) -> torch.Tensor:
    """The layer on int8 channels-last activations: float32 NCHW or (N,
    Cout) (the dequantization and the bias in float32, whatever the
    layer's dtypes), or with ``raw=True`` the int32 accumulators.  Plain
    version for CPU tensors; ``dvt_conv_fused`` with no PReLU, no rounding
    and no quantizer for CUDA tensors."""
    _check_operands(q, layer)
    if q.device.type == "cpu":
        return conv_s8_plain(q, layer, raw)
    out = _launch(q.contiguous(), layer, _RAW if raw else _FLOAT, None, None, None)
    _conv_s8.launches += 1
    return out


_conv_s8 = conv_s8
conv_s8.launches = 0
