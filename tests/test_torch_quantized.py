"""The port's int8 quantized serving (debvader_tpu_torch/models/quantized.py,
kernels/int8_conv.py) held against the JAX package's models/quantized.py
on the CPU, on the same numpy inputs.

What is exact and what is held to a tolerance:

- **int8 layers**: s8 x s8 -> s32 sums are exact in any order (|acc| <=
  K * 127^2 < 2^31), so the int8 activations, the int32 accumulators and
  the dequantized float32 outputs equal JAX's eager ones bit for bit.
- **Weights and scales**: ``_quant_weight(_folded)`` and ``_calib_stat``
  equal JAX's eager functions bit for bit (eager JAX divides by 127 truly;
  its jitted code multiplies by the reciprocal).
- **Whole forward** on JAX's TINY model: the int8 activations at every
  quantization point and ``loc`` equal JAX's eager ``quantized_forward``
  (read: 0 differing), held at ``LOC_TOL`` of the output scale with no
  differing int8 activation before dec/Dense_1 (the first point after the
  float dec/Dense_0, whose summation order may differ).  JAX's jitted
  closure may contract the dequantization into FMAs: held at ``LOC_TOL``.
- **Calibration** replays JAX's latent draws through
  ``quantized._latent_noise``; JAX's calibration forward is jitted XLA, so
  the scales are held at ``SCALE_RTOL`` relative (read 3.9e-5 per channel,
  3e-7 per tensor) and the int8 kernels equal but for at most
  ``FLIP_SHARE`` of +-1 flips (read 0).
- **QAT**: gradients of one step per leaf within ``GRAD_TOL`` of the
  leaf's scale against JAX's jitted step, on TINY with non-trivial
  weights (at flax's init, exact-zero pre-activations put ReLU kinks at
  the mercy of summation order; see ``_qat_bundles``).  Adam's first step
  is a sign function: the updated parameters equal JAX's within 1e-6 but
  for a counted share of at most ``FLIP_SHARE``.
- **bfloat16** (``ModelConfig.dtype='bfloat16'``, cases suffixed ``_bf16``,
  ``_bf16_loose`` for ``strict_cast=False``): each int8 layer's bfloat16
  epilogue, dec/Dense_1's float32 one rounded once under ``strict_cast``,
  both float -> int8 points, bfloat16 halfway points and values past the
  largest bfloat16, bit for bit JAX's eager functions.  The whole forward
  holds loc and scale within ``BF16_ULPS`` bfloat16 ulps of their scale and
  the int8 codes that differ to ``FLIP_SHARE``: the float bfloat16 layers
  between the int8 ones (dec/Dense_0's contraction, the band head) round
  their own contraction once, within one bfloat16 ulp of JAX's (read: 0
  codes differing and loc equal on TINY and on sim_demo at full width,
  scale one ulp off on 1 of 62,658 elements there).  Calibration: JAX's
  statistics come from its jitted forward, so each scale is held within
  one bfloat16 ulp of its statistic (``_calib_stat`` of bfloat16
  activations is a bfloat16 value), the weights bit for bit given JAX's
  scales.  QAT gradients against JAX's jitted step within
  ``BF16_GRAD_TOL`` of each leaf's scale.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from debvader_tpu.config import ModelConfig as JaxModelConfig
from debvader_tpu.models import quantized as jq
from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
from debvader_tpu.models.vae import init_vae as jax_init_vae
from debvader_tpu.training import losses as jlosses

from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.kernels import int8_conv
from debvader_tpu_torch.models import quantized as tq
from debvader_tpu_torch.models.vae import DeblenderVAE
from debvader_tpu_torch.weights import (
    flatten_flax,
    flax_from_state_dict,
    quantized_from_jax,
    state_dict_from_flax,
)

torch.set_num_threads(1)

TINY_KW = dict(stamp_size=23, nb_of_bands=3, latent_dim=8, filters=(8, 16), kernels=(3, 3))
LOC_TOL = 1e-5
SCALE_RTOL = 1e-4
FLIP_SHARE = 1e-3
GRAD_TOL = 1e-3
BF16_ULPS = 2
# bfloat16 QAT gradients against JAX's eager step, relative to each leaf's
# largest magnitude: read 2.7e-2 and 4.7e-2 (distill, per tensor and per
# channel), 6.3e-3 and 7.4e-3 (ELBO).  The distillation residual
# (student - teacher, about 1e-3) is a few bfloat16 ulps of the outputs
# (0.14), and the float bfloat16 layers and one float32 conv summation
# are within one ulp of JAX's, not bit for bit; JAX's own jitted step is
# 7e-3 to 1.23 off its eager one.
BF16_GRAD_TOL = 0.1
REPO = Path(__file__).resolve().parent.parent


def _dtype_case(case: str) -> tuple:
    """(case, dtype, strict_cast) of a case name: a ``_bf16`` suffix is a
    bfloat16 model, ``_bf16_loose`` one with strict_cast=False."""
    if case.endswith("_bf16_loose"):
        return case[: -len("_bf16_loose")], "bfloat16", False
    if case.endswith("_bf16"):
        return case[: -len("_bf16")], "bfloat16", True
    return case, "float32", True


@functools.lru_cache(maxsize=None)
def _tiny(dtype="float32", strict=True):
    """JAX's TINY model of tests/test_quantized.py (init from PRNGKey(0)),
    the port's on the same variables, and the calibration stamps; with
    ``dtype`` and ``strict_cast`` in both configs."""
    kw = dict(TINY_KW, dtype=dtype, strict_cast=strict)
    jmodel = JaxVAE(JaxModelConfig(**kw))
    if dtype == "float32" and strict:
        # jitted: the same values as eager, without an op-by-op compile
        variables = jax.jit(lambda key: jax_init_vae(jmodel, key))(jax.random.PRNGKey(0))
    else:
        variables = _tiny()[1]
    tmodel = DeblenderVAE(ModelConfig(**kw))
    tmodel.load_state_dict(state_dict_from_flax(flatten_flax(variables), tmodel.cfg))
    x = np.random.default_rng(0).normal(size=(4, 23, 23, 3)).astype(np.float32)
    return jmodel, variables, tmodel.eval(), x


@functools.lru_cache(maxsize=None)
def _bundles(granularity="per_tensor", normalise=False, dtype="float32", strict=True):
    """A JAX bundle calibrated by JAX and the port's copy of it
    (quantized_from_jax): the same int8 kernels and scales."""
    jmodel, variables, _, x = _tiny(dtype, strict)
    jqv = jq.quantize_vae(jmodel, variables, jnp.asarray(x), rng=jax.random.PRNGKey(1),
                          act_granularity=granularity, normalise=normalise)
    return jqv, tq._from_arrays(*quantized_from_jax(jqv))


def _stamps(n=6, seed=5):
    return np.random.default_rng(seed).normal(size=(n, 23, 23, 3)).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _bf16_bits(a) -> np.ndarray:
    """The 16-bit patterns of a bfloat16 torch tensor or JAX array, every
    NaN as one pattern (PyTorch and XLA write different NaN payloads)."""
    bits = a.view(torch.int16).numpy().view(np.uint16) if isinstance(a, torch.Tensor) else np.asarray(a).view(
        np.uint16)
    return np.where((bits & 0x7FFF) > 0x7F80, 0x7FC0, bits)


def _torch_bf16(a) -> torch.Tensor:
    """An array of bfloat16 values (a JAX bfloat16 array, or float32 that
    holds bfloat16 values) as a torch bfloat16 tensor, bit for bit."""
    b = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
    return torch.from_numpy(np.ascontiguousarray(b.view(np.int16))).view(torch.bfloat16)


def _bf16_ulp(x: float) -> float:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (int(np.floor(np.log2(abs(x)))) - 7)


# ------------------------------------------------------------ the int8 layers

_LAYERS = [
    # kind, stride, (n, size, cin, cout)
    ("conv", 1, (2, 9, 6, 16)),  # K = 54, padded to 64 on a card
    ("conv", 2, (2, 9, 32, 24)),
    ("convT", 2, (2, 5, 32, 16)),
    ("convT", 1, (2, 6, 16, 8)),
    ("dense", 1, (3, 0, 160, 40)),
]


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel", "per_tensor_bf16", "per_channel_bf16"])
@pytest.mark.parametrize("kind, stride, dims", _LAYERS, ids=[f"{k}{s}" for k, s, _ in _LAYERS])
def test_int8_layer_matches_jax(kind, stride, dims, granularity):
    """quant_act and conv_s8's plain versions against JAX's _quant_act and
    its int32 lax contraction and dequantization (quantized.py:340-349,
    :399-409, :447-454): the int8 activations, the int32 accumulators and
    the float32 outputs bit for bit.  ``_bf16``: conv_fused's bfloat16
    epilogue on bfloat16 activations against JAX's eager layer under a
    bfloat16 compute dtype, bit for bit (the dense also with a float32
    epilogue cast once, dec/Dense_1 under strict_cast)."""
    granularity, dtype, _ = _dtype_case(granularity)
    n, size, cin, cout = dims
    rng = np.random.default_rng([cin, cout, stride, granularity == "per_channel"])
    shape = (n, cin) if kind == "dense" else (n, size, size, cin)
    h = (rng.normal(size=shape) * 2.0).astype(np.float32)
    s_in = (rng.uniform(0.01, 0.05, cin) if granularity == "per_channel" else rng.uniform(0.01, 0.05, ())).astype(
        np.float32)
    kshape = {"conv": (3, 3, cin, cout), "convT": (3, 3, cout, cin), "dense": (cin, cout)}[kind]
    qk = rng.integers(-127, 128, kshape).astype(np.int8)
    wscale = rng.uniform(1e-3, 1e-2, cout).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    if dtype == "bfloat16":
        _check_bf16_layer(kind, stride, h, s_in, qk, wscale, bias)
        return

    jqa = jq._quant_act(jnp.asarray(h), jnp.asarray(s_in))
    if kind == "conv":
        acc = lax.conv_general_dilated(jqa, jnp.asarray(qk), (stride, stride), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    elif kind == "convT":
        acc = lax.conv_transpose(jqa, jnp.asarray(qk), strides=(stride, stride), padding="SAME",
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"), transpose_kernel=True,
                                 preferred_element_type=jnp.int32)
    else:
        acc = lax.dot_general(jqa, jnp.asarray(qk), (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    dq = jnp.asarray(s_in) if granularity == "per_tensor" else 1.0
    want = acc.astype(jnp.float32) * (dq * jnp.asarray(wscale))
    want = np.asarray(want + jnp.asarray(bias))
    acc = np.asarray(acc)
    if kind != "dense":
        acc, want = np.moveaxis(acc, -1, 1), np.moveaxis(want, -1, 1)

    th = torch.from_numpy(h if kind == "dense" else np.ascontiguousarray(np.moveaxis(h, -1, 1)))
    tqk = torch.from_numpy(np.ascontiguousarray(qk if kind == "dense" else np.transpose(qk, (3, 2, 0, 1))))
    layer = int8_conv.make_layer(kind, tqk, torch.from_numpy(wscale), torch.from_numpy(s_in),
                                 torch.from_numpy(bias), stride)
    q = int8_conv.quant_act(th, torch.from_numpy(s_in))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqa))
    np.testing.assert_array_equal(int8_conv.conv_s8(q, layer, raw=True).numpy(), acc)
    np.testing.assert_array_equal(_bits(int8_conv.conv_s8(q, layer).numpy()), _bits(want))


def _check_bf16_layer(kind, stride, h, s_in, qk, wscale, bias):
    """JAX's eager _apply_conv / _apply_convT / _apply_dense with a
    bfloat16 compute dtype on bfloat16 activations (and, for the dense, a
    float32 one cast to bfloat16 after, dec/Dense_1 under strict_cast)
    against conv_fused's plain version with the same epilogue dtypes."""
    name = {"conv": "enc/Conv_0", "convT": "dec/ConvTranspose2DTF_0", "dense": "dec/Dense_1"}[kind]
    params = {name.split("/")[1]: {"bias": jnp.asarray(bias)}}
    qw, ascales = {name: (jnp.asarray(qk), jnp.asarray(wscale))}, {name: jnp.asarray(s_in)}
    hb = jnp.asarray(h).astype(jnp.bfloat16)
    th = _torch_bf16(hb if kind == "dense" else jnp.moveaxis(hb, -1, 1))
    q = int8_conv.quant_act(th, torch.from_numpy(s_in))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq._quant_act(hb, jnp.asarray(s_in))))
    tqk = torch.from_numpy(np.ascontiguousarray(qk if kind == "dense" else np.transpose(qk, (3, 2, 0, 1))))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),) + (((jnp.float32, torch.float32),) if kind == "dense" else ()):
        if kind == "conv":
            want = jq._apply_conv(hb, name, params, (stride, stride), qw, ascales, None, jdt)
        elif kind == "convT":
            want = jq._apply_convT(hb, name, params, (stride, stride), qw, ascales, None, jdt)
        else:
            want = jq._apply_dense(hb, name, params, qw, ascales, None, jdt)
        want = want.astype(jnp.bfloat16)
        layer = int8_conv.make_layer(kind, tqk, torch.from_numpy(wscale), torch.from_numpy(s_in),
                                     torch.from_numpy(bias), stride, tdt, torch.bfloat16)
        got = int8_conv.conv_fused(q, layer)
        assert got.dtype == torch.bfloat16
        want = want if kind == "dense" else jnp.moveaxis(want, -1, 1)
        np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


def test_int8_layer_extremes_and_packing():
    """All-(+-127) operands give the largest |acc| exactly; the kernel
    rows are the (Cout, (ky, kx, ci)) rows of the port's layout, and a tap
    class's operand, which the card reads, holds B[co, t * cin + ci] =
    rows[co, tap t's (ky, kx), ci] at wgmma's K-major offset without
    swizzle (k-step of 32 bytes, 8-row group of 256, 16-byte half of 128,
    row of 16), zeros up to the channel tile and a multiple of 32."""
    q = torch.full((2, 5, 5, 256), -127, dtype=torch.int8)
    qk = torch.full((256, 256, 3, 3), -127, dtype=torch.int8)
    layer = int8_conv.make_layer("conv", qk, torch.ones(256), torch.tensor(1.0), torch.zeros(256), 1)
    acc = int8_conv.conv_s8(q, layer, raw=True)
    assert int(acc.max()) == 9 * 256 * 127 * 127
    rng = np.random.default_rng(3)
    for kind, shape, cin in (("conv", (5, 6, 3, 3), 6), ("convT", (6, 5, 3, 3), 6), ("dense", (54, 5), 54),
                             ("convT", (16, 40, 3, 3), 16)):
        qk = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        rows = int8_conv.pack_kernel(qk, kind)
        cout = rows.shape[0]
        if kind == "dense":
            want = qk.t()
        else:
            want = (qk.permute(0, 2, 3, 1) if kind == "conv" else qk.permute(1, 2, 3, 0)).reshape(cout, -1)
        assert torch.equal(rows, want)
        ksize = 1 if kind == "dense" else 3
        for cls in int8_conv.tap_classes(kind, ksize, 2 if kind == "convT" else 1, 4, 4)[-1]:
            op = int8_conv.pack_operand(rows, cin, ksize, cls.taps).numpy()
            np_pad = 32 if cout <= 32 else 64
            kp = -(-len(cls.taps) * cin // 32) * 32
            assert op.size == np_pad * kp
            b = np.zeros((np_pad, kp), np.int8)
            for t, (ky, kx, _, _) in enumerate(cls.taps):
                b[:cout, t * cin:(t + 1) * cin] = rows.numpy()[:, (ky * ksize + kx) * cin:(ky * ksize + kx + 1) * cin]
            co, k = np.meshgrid(np.arange(np_pad), np.arange(kp), indexing="ij")
            at = (k // 32) * np_pad * 32 + (co // 8) * 256 + ((k % 32) // 16) * 128 + (co % 8) * 16 + k % 16
            np.testing.assert_array_equal(op[at], b)


# ----------------------------------------------------- weights and scales

_KINDS = [("conv", (3, 3, 8, 16), 3, 2, (16, 8, 3, 3)), ("convT", (3, 3, 16, 8), 2, 3, (8, 16, 3, 3)),
          ("dense", (40, 24), 1, 0, (40, 24))]


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
@pytest.mark.parametrize("kind, jshape, out_axis, in_axis, tshape", _KINDS, ids=[k[0] for k in _KINDS])
def test_quant_weight_matches_jax(kind, jshape, out_axis, in_axis, tshape, granularity):
    """_quant_weight_folded bit for bit (the int8 kernel after the port's
    re-layout, and the float32 scales: a true division by 127, as JAX's
    eager code divides)."""
    rng = np.random.default_rng(7)
    k = rng.normal(size=jshape).astype(np.float32)
    cin = jshape[in_axis]
    s_in = np.asarray(rng.uniform(0.01, 2.0, cin) if granularity == "per_channel" else 0.3, np.float32)
    jqk, jscale = jq._quant_weight_folded(jnp.asarray(k), out_axis, in_axis, jnp.asarray(s_in))
    tk = k if kind == "dense" else np.transpose(k, (3, 2, 0, 1))
    assert tk.shape == tshape
    t_out, t_in = tq._axes({"conv": "enc/Conv_0", "convT": "dec/ConvTranspose2DTF_0", "dense": "enc/Dense_0"}[kind])
    tqk, tscale = tq._quant_weight_folded(torch.from_numpy(np.ascontiguousarray(tk)), t_out, t_in,
                                          torch.from_numpy(s_in))
    want = np.asarray(jqk) if kind == "dense" else np.transpose(np.asarray(jqk), (3, 2, 0, 1))
    np.testing.assert_array_equal(tqk.numpy(), want)
    np.testing.assert_array_equal(_bits(tscale.numpy()), _bits(jscale))


@pytest.mark.parametrize("q, per_channel", [(1.0, False), (1.0, True), (0.999, False), (0.97, True)])
def test_calib_stat_matches_jax(q, per_channel):
    """_calib_stat against JAX's eager one, bit for bit: the abs-max or
    jnp.quantile's linear interpolation, over all or per channel."""
    h = np.random.default_rng(11).normal(size=(3, 9, 9, 5)).astype(np.float32)
    want = np.asarray(jq._calib_stat(jnp.asarray(h), q, per_channel))
    got = tq._calib_stat(torch.from_numpy(np.ascontiguousarray(np.moveaxis(h, -1, 1))), q, per_channel).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_calib_quantile_above_2_24_elements():
    """A quantile over more than 2^24 elements (torch.quantile refuses
    them; the port takes two order statistics) equals jnp.quantile's."""
    n = (1 << 24) + 37
    a = ((np.arange(n, dtype=np.int64) * 7919) % 1_000_003).astype(np.float32) / np.float32(1e6)
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(a), 0.5)
    want = np.asarray(jq._calib_stat(jnp.asarray(a), 0.9999))
    got = tq._calib_stat(torch.from_numpy(a), 0.9999).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ------------------------------------------------------------- the forward


@pytest.mark.parametrize("z_mode", ["mean", "sample"])
def test_float_path_bit_identical(z_mode):
    """_forward with no quantized layer is the model's own forward, bit for
    bit (as JAX asserts for its own, tests/test_quantized.py:35)."""
    _, _, model, _ = _tiny()
    x = torch.from_numpy(_stamps())
    eps = torch.from_numpy(np.random.default_rng(2).normal(size=(6, 8)).astype(np.float32))
    with torch.no_grad():
        d0, p0 = model(x, z_mode=z_mode, eps=eps)
        d1, p1 = tq._forward(model, x, z_mode, eps=eps)
    for a, b in ((d0.loc, d1.loc), (d0.scale, d1.scale), (p0.loc, p1.loc), (p0.scale_tril, p1.scale_tril)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))


def _record_quant_act(monkeypatch, module, sink):
    orig = module._quant_act

    def rec(h, scale):
        out = orig(h, scale)
        sink.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "_quant_act", rec)


def _record_int8_inputs(monkeypatch, sink):
    """The port's int8 activations at every quantization point: the input
    of each int8 layer, in forward order (only two come from ``_quant_act``:
    every other one is written by the int8 layer before it)."""
    orig = int8_conv.conv_fused

    def rec(q, *args):
        sink.append(np.asarray(q))
        return orig(q, *args)

    monkeypatch.setattr(int8_conv, "conv_fused", rec)


@pytest.mark.parametrize("z_mode", ["mean", "sample"])
@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel", "per_tensor_bf16", "per_channel_bf16",
                                         "per_tensor_bf16_loose"])
def test_int8_forward_matches_jax_eager(monkeypatch, granularity, z_mode):
    """The int8 forward against JAX's eager quantized_forward on the same
    bundle and stamps ('sample': JAX's eps injected): the share of int8
    activations that differ at each quantization point, 0 before
    dec/Dense_1; loc and scale within LOC_TOL of their scale.  ``_bf16``
    (``_loose``: strict_cast=False): JAX's own bfloat16 bundle loaded into
    the port; the int8 codes that differ held to FLIP_SHARE at every point
    (read: 0), loc and scale to BF16_ULPS bfloat16 ulps of their scale
    (read: equal), the posterior bit for bit."""
    granularity, dtype, strict = _dtype_case(granularity)
    jqv, tqv = _bundles(granularity, dtype=dtype, strict=strict)
    assert tqv.cfg.dtype == dtype and tqv.cfg.strict_cast == strict
    x = _stamps()
    rng = jax.random.PRNGKey(7)
    eps = torch.from_numpy(np.asarray(jax.random.normal(rng, (6, 8)))) if z_mode == "sample" else None
    jacts, tacts = [], []
    _record_quant_act(monkeypatch, jq, jacts)
    _record_int8_inputs(monkeypatch, tacts)
    jd, jpost = jq.quantized_forward(jqv, jnp.asarray(x), rng, z_mode=z_mode)
    td, tpost = tq.quantized_forward(tqv, x, z_mode=z_mode, eps=eps)
    names = ["enc/Conv_0", "enc/Conv_1", "enc/Conv_2", "enc/Conv_3", "enc/Dense_0", "dec/Dense_1",
             "dec/ConvTranspose2DTF_0", "dec/ConvTranspose2DTF_1", "dec/ConvTranspose2DTF_2",
             "dec/ConvTranspose2DTF_3"]
    assert len(jacts) == len(tacts) == len(names)
    shares = {n: float((a != b.reshape(a.shape)).mean()) for n, a, b in zip(names, jacts, tacts)}
    print(f"{granularity} {dtype} strict_cast={strict} {z_mode}: int8 activations differing from JAX's {shares}")
    if dtype == "float32":
        assert all(shares[n] == 0.0 for n in names[:5])
    else:
        assert all(share <= FLIP_SHARE for share in shares.values())
    for got, want in ((td.loc, jd.loc), (td.scale, jd.scale)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        print(f"{granularity} {dtype} {z_mode}: max abs difference {err} of scale {float(np.abs(want).max())}")
        tol = LOC_TOL * float(np.abs(want).max()) if dtype == "float32" else BF16_ULPS * _bf16_ulp(
            float(np.abs(want).max()))
        assert got.dtype == torch.float32 and err <= tol
    np.testing.assert_array_equal(_bits(tpost.loc.numpy()), _bits(jpost.loc))


@pytest.mark.parametrize("granularity, normalise", [("per_tensor", False), ("per_channel", False),
                                                    ("per_channel", True)])
def test_closure_matches_jax_jitted(granularity, normalise):
    """make_quantized_forward against JAX's jitted closure (finite guard
    and normalisation bracket inside; XLA may contract the dequantization
    into FMAs): loc and scale within LOC_TOL of their scale."""
    jqv, tqv = _bundles(granularity, normalise)
    x = _stamps(seed=9) * 3.0
    x[0, 3, 4, 1] = np.nan
    jloc, jscale = jq.make_quantized_forward(jqv, z_mode="mean")(jnp.asarray(x), jax.random.PRNGKey(0))
    tloc, tscale = tq.make_quantized_forward(tqv, z_mode="mean")(x)
    for got, want in ((tloc, jloc), (tscale, jscale)):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all()
        err = float(np.abs(got.numpy() - want).max())
        print(f"jitted closure, {granularity}, normalise={normalise}: max abs difference {err}")
        assert err <= LOC_TOL * float(np.abs(want).max())


# ------------------------------------------------------------- calibration


def _check_bf16_calibration(tqv, jqv, model) -> None:
    """A bfloat16 calibration against JAX's: the same layers; each
    statistic within one bfloat16 ulp of JAX's (the abs-max of bfloat16
    activations is a bfloat16 value; JAX's jitted forward may keep a
    float32 intermediate), the share that is bit-equal printed; the scales
    the port forms from its statistics; the int8 weights and their scales
    bit for bit JAX's when quantized with JAX's activation scales."""
    assert sorted(tqv.act_scales) == sorted(jqv.act_scales) and list(tqv.qweights) == list(jqv.qweights)
    equal = total = 0
    for name, js in jqv.calib_stats.items():
        js, ts = np.asarray(js, np.float64), np.asarray(tqv.calib_stats[name], np.float64)
        assert ts.shape == js.shape, name
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(js), 1e-30))) - 7)
        assert (np.abs(ts - js) <= ulp).all(), name
        equal, total = equal + int((ts == js).sum()), total + js.size
    print(f"bfloat16 calibration: {equal} of {total} statistics bit-equal to JAX's, the rest within one ulp")
    scales = {n: torch.from_numpy(np.asarray(v, np.float32)) for n, v in jqv.act_scales.items()}
    for name, (qk, ws) in tq._requantize(model, list(jqv.qweights), scales).items():
        jk, jw = (np.asarray(a) for a in jqv.qweights[name])
        np.testing.assert_array_equal(qk.numpy(), jk if jk.ndim == 2 else np.transpose(jk, (3, 2, 0, 1)))
        np.testing.assert_array_equal(_bits(ws.numpy()), _bits(jw))


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel", "per_tensor_bf16", "per_channel_bf16"])
def test_quantize_vae_matches_jax(monkeypatch, granularity):
    """quantize_vae with JAX's latent draws replayed: every activation
    scale within SCALE_RTOL of JAX's, the int8 kernels equal but for a
    counted share of +-1 flips, the same layers, statistics and flags.
    ``_bf16``: a bfloat16 model's calibration held by
    _check_bf16_calibration, also with a layer subset."""
    granularity, dtype, _ = _dtype_case(granularity)
    if dtype == "bfloat16":
        jmodel, variables, model, x = _tiny(dtype)
        eps = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 8))))
        monkeypatch.setattr(tq, "_latent_noise", lambda generator, shape, like: eps)
        for layers in (None, ["enc/Conv_0", "enc/Conv_3", "dec/Dense_1", "dec/ConvTranspose2DTF_2"]):
            jqv = jq.quantize_vae(jmodel, variables, jnp.asarray(x), rng=jax.random.PRNGKey(1),
                                  act_granularity=granularity, layers=layers)
            tqv = tq.quantize_vae(model, x, act_granularity=granularity, layers=layers)
            _check_bf16_calibration(tqv, jqv, model)
            assert tqv.act_granularity == granularity and tqv.cfg.dtype == "bfloat16"
        return
    jqv, _ = _bundles(granularity)
    _, _, model, x = _tiny()
    eps = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 8))))
    monkeypatch.setattr(tq, "_latent_noise", lambda generator, shape, like: eps)
    tqv = tq.quantize_vae(model, x, act_granularity=granularity)
    assert sorted(tqv.act_scales) == sorted(jqv.act_scales) and list(tqv.qweights) == list(jqv.qweights)
    worst = 0.0
    for name, js in jqv.act_scales.items():
        js = np.asarray(js)
        assert tqv.act_scales[name].shape == js.shape
        worst = max(worst, float(np.max(np.abs(tqv.act_scales[name].numpy() / js - 1))))
    flips = total = 0
    for name, (jk, jw) in jqv.qweights.items():
        jk = np.asarray(jk)
        want = jk if jk.ndim == 2 else np.transpose(jk, (3, 2, 0, 1))
        d = tqv.qweights[name][0].numpy().astype(np.int32) - want
        assert np.abs(d).max() <= 1, name
        flips, total = flips + int(np.count_nonzero(d)), total + d.size
        np.testing.assert_allclose(tqv.qweights[name][1].numpy(), np.asarray(jw), rtol=SCALE_RTOL)
    print(f"{granularity}: scales within {worst} of JAX's, {flips} of {total} int8 weights flipped")
    assert worst <= SCALE_RTOL and flips <= FLIP_SHARE * total
    assert tqv.act_granularity == granularity and tqv.teacher_fingerprint is None


def test_quantize_vae_layers_and_quantile(monkeypatch):
    """layers= picks the quantized layers (none: the int8 forward is the
    float one); calib_quantile < 1 calibrates quantiles as JAX's jitted
    calibration does, within SCALE_RTOL."""
    jmodel, variables, model, x = _tiny()
    monkeypatch.setattr(tq, "_latent_noise", lambda generator, shape, like: torch.from_numpy(
        np.asarray(jax.random.normal(jax.random.PRNGKey(1), shape))))
    none = tq.quantize_vae(model, x, layers=[])
    assert none.qweights == {}
    a, _ = tq.quantized_forward(none, _stamps(), z_mode="mean")
    b, _ = tq.quantized_forward(none, _stamps(), z_mode="mean", quant=False)
    np.testing.assert_array_equal(_bits(a.loc.numpy()), _bits(b.loc.numpy()))
    sub = tq.quantize_vae(model, x, layers=["enc/Conv_0", "dec/ConvTranspose2DTF_1"])
    assert sorted(sub.qweights) == ["dec/ConvTranspose2DTF_1", "enc/Conv_0"]
    jqv = jq.quantize_vae(jmodel, variables, jnp.asarray(x), rng=jax.random.PRNGKey(1), calib_quantile=0.999)
    tqv = tq.quantize_vae(model, x, calib_quantile=0.999)
    for name, js in jqv.act_scales.items():
        np.testing.assert_allclose(tqv.act_scales[name].numpy(), np.asarray(js), rtol=SCALE_RTOL, err_msg=name)


_SUBSETS = {
    "fused_then_float": ["enc/Conv_0", "enc/Conv_1", "enc/Dense_0", "dec/ConvTranspose2DTF_1"],
    "flat_and_head": ["enc/Conv_2", "enc/Conv_3", "dec/Dense_1", "dec/ConvTranspose2DTF_3", "dec/Conv_0"],
    # a float dec/Dense_1 into an int8 dec/ConvTranspose2DTF_0 (the cast at
    # the reshape before the quantizer, under strict_cast)
    "float_dense_into_int8": ["enc/Conv_1", "dec/ConvTranspose2DTF_0", "dec/ConvTranspose2DTF_1"],
}


@pytest.mark.parametrize("layers", ["fused_then_float", "flat_and_head", "fused_then_float_bf16",
                                    "flat_and_head_bf16", "float_dense_into_int8_bf16",
                                    "flat_and_head_bf16_loose"])
def test_int8_forward_with_a_layer_subset_matches_jax(layers):
    """A bundle that quantizes some layers only: each int8 layer fuses its
    PReLU and the next quantizer where the next point is int8 too, writes
    float32 where it is not, and quantizes its input alone after a float
    layer (here: int8 into int8, int8 into float, float into int8 through
    the flatten, the band head int8).  The int8 activations at every point
    and loc equal JAX's eager quantized_forward (loc within LOC_TOL).
    ``_bf16`` (``_loose``: strict_cast=False): a bfloat16 model, the int8
    layers writing bfloat16 where the next point is float, loc within
    BF16_ULPS bfloat16 ulps of its scale."""
    layers, dtype, strict = _dtype_case(layers)
    layers = _SUBSETS[layers]
    jmodel, variables, _, x = _tiny(dtype, strict)
    jqv = jq.quantize_vae(jmodel, variables, jnp.asarray(x), rng=jax.random.PRNGKey(1), layers=layers)
    tqv = tq._from_arrays(*quantized_from_jax(jqv))
    assert sorted(tqv.qweights) == sorted(layers)
    stamps = _stamps()
    jacts, tacts = [], []
    saved_j, saved_t = jq._quant_act, int8_conv.conv_fused
    try:
        def jrec(h, scale):
            out = saved_j(h, scale)
            jacts.append(np.asarray(out))
            return out

        def trec(q, *args):
            tacts.append(np.asarray(q))
            return saved_t(q, *args)

        jq._quant_act, int8_conv.conv_fused = jrec, trec
        jd, _ = jq.quantized_forward(jqv, jnp.asarray(stamps), jax.random.PRNGKey(0), z_mode="mean")
        td, _ = tq.quantized_forward(tqv, stamps, z_mode="mean")
    finally:
        jq._quant_act, int8_conv.conv_fused = saved_j, saved_t
    assert len(jacts) == len(tacts) == len(layers)
    for a, b in zip(jacts, tacts):
        np.testing.assert_array_equal(b.reshape(a.shape), a)
    want = np.asarray(jd.loc)
    err = float(np.abs(td.loc.numpy() - want).max())
    if dtype == "float32":
        assert err <= LOC_TOL * float(np.abs(want).max())
    else:
        print(f"layer subset {layers} in bfloat16 (strict_cast={strict}): loc {err} off JAX's")
        assert err <= BF16_ULPS * _bf16_ulp(float(np.abs(want).max()))


# --------------------------------------------------------------------- QAT


def _unflatten(flat: dict) -> dict:
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@functools.lru_cache(maxsize=None)
def _qat_bundles(granularity, dtype="float32"):
    """JAX's bundle and the port's copy for TINY with non-trivial weights:
    flax's init plus noise (positive BatchNorm variances), as
    tests/test_torch_model.py perturbs them.  At the init itself (zero
    biases and PReLU alphas) the fake-quant forward sums exact grid values
    to exact zeros, whose float sign, and with it a ReLU kink, follows the
    summation order: one such pre-activation moved a leaf's gradient by 4%
    of its scale (read on TINY)."""
    jmodel, variables, _, x = _tiny(dtype)
    rng = np.random.default_rng(3)
    flat = {}
    for k, v in flatten_flax(jax.tree_util.tree_map(np.asarray, variables)).items():
        noise = 0.05 * rng.normal(size=v.shape).astype(np.float32)
        flat[k] = (np.abs(v) + 0.5 + noise if k.endswith("/var") else v + noise).astype(np.float32)
    jqv = jq.quantize_vae(jmodel, _unflatten(flat), jnp.asarray(x), rng=jax.random.PRNGKey(1),
                          act_granularity=granularity)
    return jqv, tq._from_arrays(*quantized_from_jax(jqv))


def _jax_qat_grads(jqv, x, y, loss, key, jit=True):
    """JAX's jitted (or, ``jit=False``, eager) gradients of qat_finetune's
    loss (its loss_fn, quantized.py:797-829) at the bundle's own
    weights."""
    cfg, stats, params = jqv.cfg, jqv.variables["batch_stats"], jqv.variables["params"]

    def loss_fn(p, x, y):
        mode = "mean" if loss == "distill" else "sample"
        dist, post = jq._forward(cfg, {"params": p, "batch_stats": stats}, x, key, mode,
                                 dict.fromkeys(jqv.qweights), jqv.act_scales, None, fake=True)
        if loss == "distill":
            t, _ = jq._forward(cfg, {"params": params, "batch_stats": stats}, x, None, "mean", None, None, None)
            return jnp.mean(jnp.sum(jnp.square(dist.loc - lax.stop_gradient(t.loc)), axis=(1, 2, 3)))
        return jlosses.elbo_terms(dist, post, y, kl_weight=0.01, kl_mode="analytic")["loss"]

    grad = jax.grad(loss_fn)
    grads = (jax.jit(grad) if jit else grad)(params, jnp.asarray(x), jnp.asarray(y))
    return flatten_flax({"params": jax.device_get(grads)})


def _qat_batch(n=8):
    rng = np.random.default_rng(21)
    x = np.abs(rng.normal(size=(n, 23, 23, 3))).astype(np.float32)
    return x, (0.8 * x).astype(np.float32)


def _worst(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k] - b[k]).max()) / max(float(np.abs(b[k]).max()), 1e-30) for k in b)


@pytest.mark.parametrize("loss", ["distill", "elbo"])
@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel", "per_tensor_bf16", "per_channel_bf16"])
def test_qat_gradients_match_jax(monkeypatch, granularity, loss):
    """One QAT step's gradients per leaf (the STE forward through
    ``.detach()``, BatchNorm frozen), JAX's latent draw injected, against
    JAX's jitted step (the step qat_finetune runs): every leaf within
    GRAD_TOL of its largest magnitude (read 1.2e-4 at most; JAX's own eager
    step reads 1.6e-4 off its jitted one).  ``_bf16``: the fake-quant
    forward of a bfloat16 model ((y + bias_f32).astype(bfloat16) at each
    point, quantized.py:334, :395, :443) against JAX's eager step, which
    rounds where the port does, within BF16_GRAD_TOL; JAX's jitted step
    keeps float32 where its eager one rounds and is off that by more (its
    worst leaf printed)."""
    granularity, dtype, _ = _dtype_case(granularity)
    jqv, tqv = _qat_bundles(granularity, dtype)
    x, y = _qat_batch()
    key = jax.random.PRNGKey(3)
    jit = _jax_qat_grads(jqv, x, y, loss, key, jit=dtype == "float32")
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (8, 8))))
    monkeypatch.setattr(tq, "_latent_noise", lambda generator, shape, like: eps)
    student = tqv.model
    value, _ = tq._qat_loss(student, tqv.model, torch.from_numpy(x), torch.from_numpy(y), list(tqv.qweights),
                            tqv.act_scales, loss, 0.01)
    grads = torch.autograd.grad(value, list(student.parameters()))
    got = flax_from_state_dict(dict(zip([k for k, _ in student.named_parameters()], grads)), student.cfg)
    worst = _worst(got, jit)
    print(f"QAT {granularity} {dtype} {loss}: worst leaf {worst} of its scale off JAX's "
          f"{'jitted' if dtype == 'float32' else 'eager'} step")
    if dtype == "bfloat16":
        print(f"QAT {granularity} {dtype} {loss}: JAX's jitted step, worst leaf "
              f"{_worst(_jax_qat_grads(jqv, x, y, loss, key), jit)} off its eager one")
    assert worst <= (GRAD_TOL if dtype == "float32" else BF16_GRAD_TOL)


def _jax_eager_adam_step(jqv, x, y, lr):
    """One step of qat_finetune's update, optax's Adam on JAX's eager
    distillation gradients (its jitted step keeps float32 where a bfloat16
    eager forward rounds)."""
    import optax

    grads = _unflatten({k.split("/", 1)[1]: v for k, v in _jax_qat_grads(jqv, x, y, "distill", None,
                                                                          jit=False).items()})
    params = jqv.variables["params"]
    tx = optax.adam(lr)
    updates, _ = tx.update(grads, tx.init(params), params)
    return flatten_flax({"params": jax.device_get(optax.apply_updates(params, updates))})


# bfloat16: the share of parameters that Adam's first step moves otherwise
# than JAX's eager step (a gradient of the other sign, BF16_GRAD_TOL above):
# read 2.5e-3 (219 of 86,120; JAX's jitted qat_finetune moves 6,135 of
# them otherwise than the port, 7.1%)
BF16_STEP_SHARE = 5e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qat_step_matches_jax(dtype):
    """qat_finetune for one step on an injected batch, both packages:
    Adam's first step moves each parameter by lr g / (|g| + eps), about
    lr sign(g), so the parameters are held within 1e-6 but for at most
    FLIP_SHARE of them (a sign flip, or a gradient near Adam's eps), each
    within 2 lr (read: 1 of 86,120, by 1.2e-6); the activation scales
    kept, the weights requantized from the new floats, and the teacher's
    fingerprint JAX's.  bfloat16: against optax's Adam on JAX's eager
    gradients (BF16_STEP_SHARE), JAX's jitted qat_finetune printed beside
    it."""
    jqv, tqv = _qat_bundles("per_channel", dtype)
    x, y = _qat_batch()
    lr = 1e-4
    jout = jq.qat_finetune(jqv, steps=1, batch=8, learning_rate=lr, steps_per_dispatch=1,
                           make_batch=lambda key: (jnp.asarray(x), jnp.asarray(y)))
    tout = tq.qat_finetune(tqv, steps=1, batch=8, learning_rate=lr, make_batch=lambda rng: (x, y))
    assert tout.teacher_fingerprint == jout.teacher_fingerprint == jq.params_fingerprint(jqv.variables["params"])
    jitted = flatten_flax({"params": jax.device_get(jout.variables["params"])})
    want = jitted if dtype == "float32" else _jax_eager_adam_step(jqv, x, y, lr)
    got = {k: v for k, v in flax_from_state_dict(tout.model.state_dict(), tout.cfg).items() if k in want}
    n_off = n_all = n_jit = 0
    for k in want:
        d = np.abs(got[k] - want[k])
        n_all += d.size
        n_off += int((d > 1e-6).sum())
        n_jit += int((np.abs(got[k] - jitted[k]) > 1e-6).sum())
        assert float(d.max()) <= 2.1 * lr, k
    print(f"QAT step ({dtype}): {n_off} of {n_all} parameters more than 1e-6 off JAX's "
          f"{'jitted' if dtype == 'float32' else 'eager'} step ({n_jit} off its jitted qat_finetune)")
    assert n_off <= (FLIP_SHARE if dtype == "float32" else BF16_STEP_SHARE) * n_all
    for name in jqv.act_scales:
        assert torch.equal(tout.act_scales[name], tqv.act_scales[name])
    requant = tq._requantize(tout.model, list(tout.qweights), tout.act_scales)
    for name, (qk, ws) in tout.qweights.items():
        assert torch.equal(requant[name][0], qk) and torch.equal(requant[name][1], ws)


def test_qat_elbo_with_recalibration():
    """qat_finetune(loss='elbo', recalibrate=True): the ELBO step runs with
    the latents of ``_latent_noise``, the scales are recalibrated on
    ``make_batch(np.random.default_rng(seed + 999))`` (equal to a fresh
    quantize_vae of the fine-tuned model on it), and the teacher's
    fingerprint survives the recalibration, as in JAX (quantized.py:900-912)."""
    _, tqv = _qat_bundles("per_tensor")
    x, y = _qat_batch(4)
    seen = []

    def make_batch(rng):
        seen.append(rng)
        return x, y

    out = tq.qat_finetune(tqv, steps=1, learning_rate=1e-4, make_batch=make_batch, loss="elbo", recalibrate=True)
    assert len(seen) == 2 and out.teacher_fingerprint == tq.params_fingerprint(tqv.model)
    fresh = tq.quantize_vae(out.model, x, layers=list(tqv.qweights))
    for name, s in fresh.act_scales.items():
        assert torch.equal(out.act_scales[name], s)
    for name, (qk, _) in fresh.qweights.items():
        assert torch.equal(out.qweights[name][0], qk)
    assert any(not torch.equal(out.act_scales[n], tqv.act_scales[n]) for n in tqv.act_scales)



# ------------------------------------------- the fused layer and its classes


@functools.lru_cache(maxsize=None)
def _packaged_layers(dtype="float32"):
    """JAX's eager int8 forward of the packaged sim_demo_int8 bundle on 4
    simulated stamps (3 in bfloat16, whose eager forward takes 18 s on the
    CPU) with every int8 layer's float input and output recorded ({name:
    (h, y)}, JAX's layouts), and the port's bundle.  ``dtype='bfloat16'``
    serves the same bundle (its weights and scales) with a bfloat16 compute
    dtype in both packages (JAX's bundle with its model's config replaced,
    the port's loaded from it through quantized_from_jax); ``seen`` then
    also holds the int8 activations ("acts") and the output ("dist")."""
    from debvader_tpu.data.simulate import simulate_batch

    jqv = jq.load_quantized(REPO / "debvader_tpu" / "data" / "weights" / "sim_demo_int8")
    if dtype == "float32":
        tqv = tq.load_quantized("sim_demo_int8", device="cpu")
    else:
        jqv = dataclasses.replace(jqv, model=JaxVAE(dataclasses.replace(jqv.cfg, dtype=dtype)))
        tqv = tq._from_arrays(*quantized_from_jax(jqv))
    seen = {"acts": []}

    def recording(fn):
        def apply(h, name, *args, **kwargs):
            y = fn(h, name, *args, **kwargs)
            if name in jqv.qweights:
                seen[name] = (np.asarray(h), np.asarray(y))
            return y
        return apply

    def quant(h, scale):
        out = saved_quant(h, scale)
        seen["acts"].append(np.asarray(out))
        return out

    saved = jq._apply_conv, jq._apply_convT, jq._apply_dense
    saved_quant = jq._quant_act
    jq._apply_conv, jq._apply_convT, jq._apply_dense = (recording(f) for f in saved)
    jq._quant_act = quant
    try:
        x = np.asarray(simulate_batch(jax.random.PRNGKey(123), 4)[0])[: 4 if dtype == "float32" else 3]
        seen["x"] = x
        seen["dist"] = jq.quantized_forward(jqv, x, jax.random.PRNGKey(0), z_mode="mean")
    finally:
        jq._apply_conv, jq._apply_convT, jq._apply_dense = saved
        jq._quant_act = saved_quant
    return jqv, tqv, seen


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1) if a.ndim == 4 else a))


# (layer, its PReLU(s) in the port's model, the next quantization point)
_FUSED = {
    "conv": ("enc/Conv_2", lambda m: (m.encoder.prelus[2].alpha, None), "enc/Conv_3"),
    "convT_stride2": ("dec/ConvTranspose2DTF_2", lambda m: (m.decoder.prelus[2].alpha, None),
                      "dec/ConvTranspose2DTF_3"),
    "dense_to_convT": ("dec/Dense_1", lambda m: (m.decoder.prelu1.alpha, None), "dec/ConvTranspose2DTF_0"),
    "conv7_to_dense": ("enc/Conv_7", lambda m: (m.encoder.prelus[7].alpha, m.encoder.flat_prelu.alpha),
                       "enc/Dense_0"),
}


@pytest.mark.parametrize("case", list(_FUSED) + [f"{c}_bf16" for c in _FUSED] + ["dense_to_convT_bf16_loose"])
def test_fused_layer_matches_jax(case):
    """conv_fused's plain version, on the packaged bundle's real
    activations, bit for bit JAX's _quant_act(_prelu(<layer>, alpha),
    next_scale) as its eager forward computes it (the next int8 layer's
    quantized input): a conv, a stride-2 transposed conv, dec/Dense_1 into
    the (h, w, c) reshape before dec/ConvTranspose2DTF_0, and enc/Conv_7
    through its PReLU, the flatten and the flat PReLU into enc/Dense_0.
    The wrapper on CPU tensors is the plain version.  ``_bf16``: the bundle
    served in bfloat16 (dec/Dense_1's float32 epilogue rounded once at the
    reshape); ``_bf16_loose``: dec/Dense_1 under strict_cast=False, its
    bfloat16 epilogue against JAX's _apply_dense in bfloat16 on the same
    input.  The float output (bfloat16 there) bit for bit too."""
    case, dtype, strict = _dtype_case(case)
    jqv, tqv, seen = _packaged_layers(dtype)
    name, alphas, nxt = _FUSED[case]
    h, _ = seen[name]
    h_next, _ = seen[nxt]
    layer = tqv.int8_layers()[name]
    q = int8_conv.quant_act(_nchw(h) if dtype == "float32" else _torch_bf16(np.moveaxis(h, -1, 1) if h.ndim == 4
                                                                             else h), tqv.act_scales[name])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq._quant_act(jnp.asarray(h), jqv.act_scales[name])))
    alpha, flat_alpha = alphas(tqv.model)
    jalpha = jnp.asarray(np.moveaxis(alpha.detach().numpy(), 0, -1) if alpha.ndim == 3 else alpha.detach().numpy())
    _, y = seen[name]
    if not strict:
        # dec/Dense_1 in bfloat16 (JAX quantized.py:513-517 with dense2_dtype bfloat16)
        layer = dataclasses.replace(layer, dtype=torch.bfloat16)
        dec = jax.tree_util.tree_map(jnp.asarray, jqv.variables["params"]["decoder"])
        y = jq._apply_dense(jnp.asarray(h), name, dec, jqv.qweights, jqv.act_scales, None, jnp.bfloat16)
        h_next = jq._prelu(y, jalpha).reshape(h_next.shape)
    with torch.no_grad():
        got = int8_conv.conv_fused(q, layer, alpha, flat_alpha, tqv.act_scales[nxt])
    want = np.asarray(jq._quant_act(jnp.asarray(h_next), jqv.act_scales[nxt]))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    # the same layer's float output with its PReLU, before the quantizer
    with torch.no_grad():
        out = int8_conv.conv_fused(q, layer, alpha)
    want_f = jq._prelu(jnp.asarray(y), jalpha)
    if dtype == "float32":
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(_nchw(np.asarray(want_f)).numpy()))
    else:
        want_f = want_f.astype(jnp.bfloat16)
        np.testing.assert_array_equal(_bf16_bits(out), _bf16_bits(want_f if want_f.ndim == 2 else
                                                                   jnp.moveaxis(want_f, -1, 1)))


def test_packaged_bundle_in_bf16_matches_jax():
    """The packaged bundle served in bfloat16 at full width on 3 stamps,
    z_mode='mean', against JAX's eager quantized_forward of the same
    bundle: the int8 codes at the 18 points (read: none differ) to
    FLIP_SHARE, the posterior bit for bit, loc and scale within BF16_ULPS
    bfloat16 ulps of their scale (the band head's bfloat16 contraction:
    read, loc equal, scale one ulp off on 1 of 62,658 elements)."""
    jqv, tqv, seen = _packaged_layers("bfloat16")
    acts = []
    saved = int8_conv.conv_fused

    def rec(q, *args):
        acts.append(np.asarray(q))
        return saved(q, *args)

    int8_conv.conv_fused = rec
    try:
        td, tpost = tq.quantized_forward(tqv, seen["x"], z_mode="mean")
    finally:
        int8_conv.conv_fused = saved
    jd, jpost = seen["dist"]
    assert len(acts) == len(seen["acts"]) == 18
    flips = [int(np.count_nonzero(a != b.reshape(a.shape))) for a, b in zip(seen["acts"], acts)]
    total = sum(a.size for a in acts)
    print(f"sim_demo_int8 in bfloat16: int8 codes differing from JAX's {flips} of {total}")
    assert sum(flips) <= FLIP_SHARE * total
    np.testing.assert_array_equal(_bits(tpost.loc.numpy()), _bits(jpost.loc))
    for what, got, want in (("loc", td.loc, jd.loc), ("scale", td.scale, jd.scale)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        print(f"sim_demo_int8 in bfloat16: {what} max abs difference {err} of scale {float(np.abs(want).max())}, "
              f"share differing {float((got.numpy() != want).mean())}")
        assert got.dtype == torch.float32 and err <= BF16_ULPS * _bf16_ulp(float(np.abs(want).max()))


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel", "per_tensor_bf16", "per_channel_bf16"])
def test_fused_layer_scales_and_nan(granularity):
    """The fused epilogue with per-tensor and per-channel scales on JAX's
    TINY bundles: bit for bit JAX's _quant_act(_prelu(dequantized layer,
    alpha), next_scale); a NaN (dqw NaN on one channel) gives 0 in the
    quantized output and stays NaN in the float32 one, as in JAX.
    ``_bf16``: the bfloat16 epilogue ((y + bias).astype(bfloat16), the
    PReLU in bfloat16) bit for bit JAX's, the float output bfloat16, also
    on bfloat16 halfway points (dqw 0, bias 1 + 2^-8 and 1 + 3 * 2^-8:
    ties to the even 1 and 1 + 2^-6) and values past the largest bfloat16
    (bias +-3.4e38: +-inf)."""
    granularity, dtype, _ = _dtype_case(granularity)
    jqv, tqv = _bundles(granularity, dtype=dtype)
    x = _stamps(4, seed=3)
    layer = tqv.int8_layers()["enc/Conv_0"]
    with torch.no_grad():
        hin = tqv.model.encoder.bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    q = int8_conv.quant_act(hin, tqv.act_scales["enc/Conv_0"])
    dqw = layer.dqw.clone()
    dqw[1] = float("nan")
    nan_layer = dataclasses.replace(layer, dqw=dqw)
    layers = [layer, nan_layer]
    if dtype == "bfloat16":
        dqw, bias = layer.dqw.clone(), layer.bias.clone()
        dqw[2:6] = 0.0
        bias[2:6] = torch.tensor([1 + 2**-8, 1 + 3 * 2**-8, 3.4e38, -3.4e38])
        layers.append(dataclasses.replace(layer, dqw=dqw, bias=bias))
    alpha = tqv.model.encoder.prelus[0].alpha.detach()
    s_next = tqv.act_scales["enc/Conv_1"]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for lay in layers:
        acc = int8_conv.conv_s8(q, lay, raw=True).numpy()
        y = jnp.asarray(np.moveaxis(acc, 1, -1)).astype(jnp.float32) * jnp.asarray(lay.dqw.numpy())
        y = (y + jnp.asarray(lay.bias.numpy())).astype(jdt)
        y = jq._prelu(y, jnp.asarray(np.moveaxis(alpha.numpy(), 0, -1)))
        want = np.asarray(jq._quant_act(y, jnp.asarray(s_next.numpy())))
        got = int8_conv.conv_fused(q, lay, alpha, None, s_next)
        np.testing.assert_array_equal(got.numpy(), want)
        out = int8_conv.conv_fused(q, lay, alpha)
        if dtype == "bfloat16":
            assert out.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bf16_bits(out), _bf16_bits(jnp.moveaxis(y, -1, 1)))
            out = out.float()
        f32 = out.numpy()
        np.testing.assert_array_equal(np.isnan(f32), np.isnan(np.moveaxis(np.asarray(y, np.float32), -1, 1)))
        if lay is nan_layer:
            assert np.isnan(f32[:, 1]).all() and not np.isnan(f32[:, 0]).any()
            assert (got.numpy()[..., 1] == 0).all()
        if lay is layers[-1] and dtype == "bfloat16":
            assert (f32[:, 2] == 1.0).all() and (f32[:, 3] == 1 + 2**-6).all() and np.isposinf(f32[:, 4]).all()


@pytest.mark.parametrize("size", [4, 8, 16, 32], ids=lambda s: f"{s}to{2 * s}")
def test_parity_classes_cover_the_gather_taps(size):
    """The four parity sub-convolutions of a stride-2 3x3 transposed conv
    (sim_demo's dec/ConvTranspose2DTF_0, 2, 4, 6 geometry): at every
    output pixel their taps, with the input pixels they read, are exactly
    the gather form's taps whose input index (o + lo - k) / 2 is integral
    and in range, where lo is ConvTranspose2dTF's crop; 9 taps over the
    four classes (4, 2, 2, 1), not 36."""
    k, s = 3, 2
    ho, wo, hq, wq, istride, ostep, classes = int8_conv.tap_classes("convT", k, s, size, size)
    assert (ho, wo, hq, wq, istride, ostep) == (2 * size, 2 * size, size, size, 1, 2)
    assert sorted(len(c.taps) for c in classes) == [1, 2, 2, 4]
    lo = int8_conv.tf_same_pads(ho, k, s)[0]
    got = {}
    for cls in classes:
        for qy in range(hq):
            for qx in range(wq):
                oy, ox = cls.oy0 + ostep * qy, cls.ox0 + ostep * qx
                assert (oy, ox) not in got
                got[oy, ox] = {(ky, kx, istride * qy + dy, istride * qx + dx) for ky, kx, dy, dx in cls.taps
                               if 0 <= istride * qy + dy < size and 0 <= istride * qx + dx < size}
    for oy in range(ho):
        for ox in range(wo):
            want = {(ky, kx, (oy + lo - ky) // s, (ox + lo - kx) // s)
                    for ky in range(k) for kx in range(k)
                    if (oy + lo - ky) % s == 0 and (ox + lo - kx) % s == 0
                    and 0 <= (oy + lo - ky) // s < size and 0 <= (ox + lo - kx) // s < size}
            assert got[oy, ox] == want, (oy, ox)


def _emulate_kernel(q, layer, sms=132):
    """What dvt_conv_fused sums, from the plan the wrapper hands it: for
    each tap class and K slice, the A rows gathered through the class's
    (dy, dx) table with zeros off the input, times B read back from the
    packed operand at wgmma's K-major offsets; the raw int32 sums (NCHW, or
    (N, Cout))."""
    plan = int8_conv._plan(q, layer, sms)
    n, h, w, cin, ho, wo, cout, hq, wq, istride, ostep, nclass, np_pad = plan.dims
    # float64 products and sums of int8 values are exact (below 2^53)
    qa = q.numpy().reshape(n, h, w, cin).astype(np.float64)
    op = plan.operand.numpy().astype(np.float64)
    out = np.zeros((n, cout, ho, wo), np.float64)
    for c in range(nclass):
        oy0, ox0, ntaps, kp, off = (int(v) for v in plan.table[c, :5])
        dy, dx = plan.table[c, 5:14], plan.table[c, 14:23]
        co, k = np.meshgrid(np.arange(np_pad), np.arange(kp), indexing="ij")
        b = op[off + (k // 32) * np_pad * 32 + (co // 8) * 256 + ((k % 32) // 16) * 128 + (co % 8) * 16 + k % 16]
        a = np.zeros((n, hq, wq, kp), np.float64)
        qy, qx = np.arange(hq), np.arange(wq)
        for t in range(ntaps):
            iy, ix = istride * qy + dy[t], istride * qx + dx[t]
            oky, okx = (iy >= 0) & (iy < h), (ix >= 0) & (ix < w)
            a[:, oky[:, None] & okx[None, :], t * cin:(t + 1) * cin] = \
                qa[:, iy[oky]][:, :, ix[okx]].reshape(n, -1, cin)
        steps = kp // 32
        acc = 0
        for split in range(plan.splits):  # the K slices add in any order
            lo, hi = steps * split // plan.splits * 32, steps * (split + 1) // plan.splits * 32
            acc = acc + a[..., lo:hi] @ b[:, lo:hi].T
        out[:, :, oy0::ostep, ox0::ostep] = np.moveaxis(acc[..., :cout], -1, 1)
    return out.reshape((n, cout) if layer.kind == "dense" else (n, cout, ho, wo)).astype(np.int64)


@pytest.mark.parametrize("sms, batch", [(132, 3), (1, 2)], ids=["split_k", "whole_k"])
def test_kernel_plan_sums_as_the_plain_version(sms, batch):
    """The kernel's launch plan for each of the packaged bundle's 18 int8
    layers on a few stamps (the tap classes' (dy, dx) tables, the packed
    operands, the K slices), summed as the kernel sums it, gives
    conv_s8_plain's int32 accumulators: on a 132-SM card, where the plans
    split K (2 to 32 slices), and on a card of one SM, where none does
    (as at a 128-stamp chunk's larger layers).  Random int8 inputs (the
    plan does not depend on the values; a layer caches its plan by input
    shape, so each card takes its own batch)."""
    _, tqv, seen = _packaged_layers()
    rng = np.random.default_rng(sms)
    splits = []
    for name, layer in tqv.int8_layers().items():
        h, _ = seen[name]
        q = torch.from_numpy(rng.integers(-127, 128, (batch,) + h.shape[1:]).astype(np.int8))
        want = int8_conv.conv_s8_plain(q, layer, raw=True).numpy()
        np.testing.assert_array_equal(_emulate_kernel(q, layer, sms), want, err_msg=name)
        splits.append(layer.plans[(tuple(q.shape), q.device)].splits)
    assert (max(splits) > 1) == (sms > 1), splits


def test_kernel_plan_rejects_what_it_cannot_launch():
    """The kernel takes at most four tap classes of at most nine taps: a
    stride-3 transposed conv (nine parity classes) or a 5 x 5 kernel raise
    before any launch; the plain version serves both on the CPU."""
    rng = np.random.default_rng(4)
    for kind, stride, k in (("convT", 3, 3), ("conv", 1, 5)):
        shape = (8, 8, k, k)
        layer = int8_conv.make_layer(kind, torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)),
                                     torch.ones(8), torch.tensor(0.5), torch.zeros(8), stride)
        q = torch.from_numpy(rng.integers(-127, 128, (1, 5, 5, 8)).astype(np.int8))
        assert int8_conv.conv_s8(q, layer).shape[1] == 8
        with pytest.raises(ValueError, match="tap classes"):
            int8_conv._plan(q, layer, 132)


# ------------------------------- the fused float -> int8 points of the forward


def _point_edges() -> np.ndarray:
    """The edge values of chip_smoke.py's phase 19: NaN (both signs), the
    infinities, signed zeros, the largest floats and a subnormal."""
    return np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 3.4e38, -3.4e38, 1e-40, -1e-45], np.float32)


def _with_edges(a: np.ndarray, seed: int) -> np.ndarray:
    a = a.copy()
    flat = a.reshape(-1)
    idx = np.random.default_rng(seed).choice(flat.size, 4 * len(_point_edges()), replace=False)
    flat[idx] = np.tile(_point_edges(), 4)
    return a


def _jax_bn(x, bn):
    """JAX's eager _batchnorm_inference with the port's BatchNorm's
    parameters, in the BatchNorm's dtype (the stamps cast to it first, as
    the forward casts them, quantized.py:485)."""
    dtype = jnp.bfloat16 if bn.dtype == torch.bfloat16 else jnp.float32
    p = {"scale": jnp.asarray(bn.scale.detach().numpy()), "bias": jnp.asarray(bn.bias.detach().numpy())}
    stats = {"mean": jnp.asarray(bn.mean.numpy()), "var": jnp.asarray(bn.var.numpy())}
    return jq._batchnorm_inference(jnp.asarray(x).astype(dtype), p, stats, dtype)


# bfloat16 halfway points and values past the largest bfloat16, as a
# BatchNorm's bias and (less 50) a bias added to 50 (scale 0.5: 50.375 ties
# to the even 50.5, quotient 101; 50.125 to 50.0, quotient 100)
_BF16_TIES = [50.375, -50.375, 50.125, -50.125, 3.4e38, -3.4e38]


def _halves_bn(channels: int, dtype=torch.float32):
    """A BatchNorm whose output is its bias exactly (scale 0): quotients on
    .5 (round half to even), saturation at +-127 and a -0 that stays 0;
    in bfloat16, bfloat16 halfway points and overflow (_BF16_TIES)."""
    from debvader_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(channels, dtype=dtype)
    bias = _BF16_TIES if dtype == torch.bfloat16 else [5.0, -2.5, 1.75, 126.5, 127.5, -1e4]
    with torch.no_grad():
        bn.scale.zero_()
        bn.bias.copy_(torch.tensor(bias[:channels]))
        bn.mean.copy_(torch.linspace(-1.0, 1.0, channels))
    return bn


@pytest.mark.parametrize("case", ["packaged", "tiny_per_tensor", "tiny_per_channel", "halves", "packaged_bf16",
                                  "tiny_per_tensor_bf16", "tiny_per_channel_bf16", "halves_bf16"])
def test_bn_quant_matches_jax(case):
    """bn_quant on CPU tensors (its plain version, bn_quant_plain: the
    forward's BatchNorm, then quant_act_plain) bit for bit JAX's eager
    _quant_act(_batchnorm_inference(x), scale): on the packaged bundle's
    real stamps against the BatchNorm output its eager forward computed,
    on TINY's bundles (per tensor, per channel) with phase 19's edge values
    in the stamps, and on a BatchNorm that outputs quotients on .5 and past
    +-127 (scales 1, then per channel 2 / 1 / 0.5).  ``_bf16``: the
    bfloat16 model's point (the stamps rounded to bfloat16, the BatchNorm
    in float32, its output rounded), on bfloat16 halfway points and
    overflow for halves_bf16 (scales 0.5, then per channel)."""
    case, dtype, _ = _dtype_case(case)
    if case == "packaged":
        jqv, tqv, seen = _packaged_layers(dtype)
        x = seen["x"]
        bn, scale = tqv.model.encoder.bn, tqv.act_scales["enc/Conv_0"]
        wants = [np.asarray(jq._quant_act(jnp.asarray(seen["enc/Conv_0"][0]), jqv.act_scales["enc/Conv_0"]))]
        scales = [scale]
    elif case.startswith("tiny"):
        jqv, tqv = _bundles(case.split("_", 1)[1], dtype=dtype)
        x = _with_edges(_stamps(5, seed=11) * 4.0, seed=1)
        bn = tqv.model.encoder.bn
        scales = [tqv.act_scales["enc/Conv_0"]]
        wants = [np.asarray(jq._quant_act(_jax_bn(x, bn), jqv.act_scales["enc/Conv_0"]))]
    else:
        x = _with_edges(_stamps(3, seed=12)[..., :3], seed=2)
        x = np.concatenate([x, x], -1)
        bn = _halves_bn(6, getattr(torch, dtype))
        scales = [torch.tensor(1.0 if dtype == "float32" else 0.5), torch.tensor([2.0, 1.0, 0.5, 1.0, 1.0, 1.0])]
        wants = [np.asarray(jq._quant_act(_jax_bn(x, bn), jnp.asarray(s.numpy()))) for s in scales]
    assert bn.dtype == getattr(torch, dtype)
    rows = []
    for scale, want in zip(scales, wants):
        with torch.no_grad():
            got = int8_conv.bn_quant(torch.from_numpy(np.ascontiguousarray(x)), bn, scale)
        assert got.dtype == torch.int8 and tuple(got.shape) == x.shape
        np.testing.assert_array_equal(got.numpy(), want)
        rows.append(got.numpy()[0, 0, 0])
    if case == "halves" and dtype == "float32":
        np.testing.assert_array_equal(rows[-1], [2, -2, 4, 126, 127, -127])  # 2.5, -2.5, 3.5, 126.5, 127.5, -1e4
    elif case == "halves":
        np.testing.assert_array_equal(rows[0], [101, -101, 100, -100, 127, -127])  # _BF16_TIES / 0.5


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel", "halves", "per_tensor_bf16",
                                         "per_channel_bf16", "halves_bf16"])
def test_bias_prelu_quant_matches_jax(granularity):
    """bias_prelu_quant on CPU tensors (its plain version,
    bias_prelu_quant_plain: the bias, the PReLU as the forward computes
    it, then quant_act_plain) bit for bit JAX's eager _quant_act(_prelu(mm
    + bias, alpha), scale), on the packaged bundle's dec/Dense_0 product of
    seeded latents with its bias, PReLU_1 and dec/Dense_1's scale (per
    tensor, and per channel from the scale's own spread), with phase 19's
    edge values in the product; and quotients on .5 and past +-127
    (bias 0, alphas 1 and 0.5, scale 1).  ``_bf16``: a bfloat16 product,
    the bias cast to bfloat16 and added in bfloat16, the PReLU in
    bfloat16 (quantized.py:509-512); halves_bf16 puts the bias add on
    bfloat16 halfway points and past the largest bfloat16 (scale 0.5)."""
    granularity, dtype, _ = _dtype_case(granularity)
    _, tqv, _ = _packaged_layers()
    dec = tqv.model.decoder
    bias, alpha = dec.dense0.bias.detach(), dec.prelu0.alpha.detach()
    if granularity == "halves" and dtype == "bfloat16":
        f = bias.shape[0]
        bias = torch.tensor(_BF16_TIES).repeat(f // 6 + 1)[:f] - 50.0 * torch.sign(torch.tensor(_BF16_TIES)).repeat(
            f // 6 + 1)[:f]
        mm = np.tile(np.where(bias.numpy() >= 0, 50.0, -50.0).astype(np.float32), (2, 1))
        alpha, scale = torch.ones(f), torch.tensor(0.5)
    elif granularity == "halves":
        f = bias.shape[0]
        mm = np.tile(np.array([2.5, -2.5, 3.5, -3.5, 126.5, 127.5, -127.5, 1e4, -1e4, 0.5], np.float32), (2, f // 10))
        bias, alpha = torch.zeros(f), torch.where(torch.arange(f) % 2 == 0, torch.tensor(1.0), torch.tensor(0.5))
        scale = torch.tensor(1.0)
    else:
        z = torch.from_numpy(np.random.default_rng(3).normal(size=(6, tqv.model.cfg.latent_dim)).astype(np.float32))
        with torch.no_grad():
            mm = _with_edges((dec.prelu_in(z) @ dec.dense0.kernel).numpy(), seed=3)
        scale = tqv.act_scales["dec/Dense_1"]
        if granularity == "per_channel":
            scale = scale * torch.linspace(0.5, 2.0, mm.shape[1])
    jmm = jnp.asarray(mm).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jq._quant_act(jq._prelu(jmm + jnp.asarray(bias.numpy()).astype(jmm.dtype),
                                              jnp.asarray(alpha.numpy())), jnp.asarray(scale.numpy())))
    tmm = torch.from_numpy(np.ascontiguousarray(mm)) if dtype == "float32" else _torch_bf16(jmm)
    got = int8_conv.bias_prelu_quant(tmm, bias, alpha, scale)
    assert got.dtype == torch.int8 and tuple(got.shape) == mm.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if granularity == "halves" and dtype == "float32":
        np.testing.assert_array_equal(got.numpy()[0, :10], [2, -1, 4, -2, 126, 127, -127, 127, -127, 0])
    elif granularity == "halves":
        np.testing.assert_array_equal(got.numpy()[0, :6], [101, -101, 100, -100, 127, -127])


def test_quant_points_reject_what_they_cannot_take():
    """Both fused points raise on a device that is neither the CPU nor a
    card, on activations that are not float32, not of their rank or not
    contiguous channels last, and on parameters or scales of the wrong
    length."""
    from debvader_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(6)
    x = torch.zeros(2, 5, 5, 6)
    mm, vec = torch.zeros(2, 8), torch.zeros(8)
    s = torch.tensor(0.5)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        int8_conv.bn_quant(x.to(meta), BatchNorm(6).to(meta), s.to(meta))
    with pytest.raises(ValueError, match="unsupported device"):
        int8_conv.bias_prelu_quant(mm.to(meta), vec.to(meta), vec.to(meta), s.to(meta))
    with pytest.raises(ValueError, match="same device|activations' device"):
        int8_conv.bias_prelu_quant(mm, vec.to(meta), vec, s)
    bad = [
        lambda: int8_conv.bn_quant(x.double(), bn, s),
        lambda: int8_conv.bn_quant(x.to(torch.int8), bn, s),
        lambda: int8_conv.bn_quant(torch.zeros(2, 6, 5, 5).permute(0, 2, 3, 1), bn, s),  # NCHW underneath
        lambda: int8_conv.bn_quant(torch.zeros(2, 6, 5, 5), bn, s),  # channels first
        lambda: int8_conv.bn_quant(x[:, :, :, :3], BatchNorm(3), s),  # a strided view
        lambda: int8_conv.bn_quant(x, bn, torch.ones(5)),
        lambda: int8_conv.bias_prelu_quant(mm.half(), vec, vec, s),
        lambda: int8_conv.bias_prelu_quant(mm.t(), torch.zeros(2), torch.zeros(2), s),
        lambda: int8_conv.bias_prelu_quant(mm[None], vec, vec, s),
        lambda: int8_conv.bias_prelu_quant(mm, torch.zeros(7), vec, s),
        lambda: int8_conv.bias_prelu_quant(mm, vec, vec, torch.ones(2, 8)),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"case {i} did not raise")
