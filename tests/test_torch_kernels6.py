"""The bfloat16 decoder tail and the layouts of the redesigned tail kernels,
held on the CPU.

The port's wrappers run their plain versions here (CPU tensors); the JAX
side runs its Pallas kernel in interpret mode, as the JAX package's own
tests do.  A bfloat16 x makes the JAX kernel round its weights, its
intermediate and its output to bf16 and return bfloat16; the port's plain
version rounds at the same places.  The two sum their float32 products in
other orders, so an output may land on the neighbouring bf16 value: the
tolerance is one bf16 ulp of the output's largest magnitude, on at most
0.1% of the elements.  The share is what tells the repair from the float32
chain cast at the end, which stays within the ulp too.  The tensor-core B
operand the CUDA kernels take from Python is held to the formula the
kernels read it by.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debvader_tpu.kernels.decoder_tail import fused_decoder_tail as jax_tail
from debvader_tpu_torch.kernels.decoder_tail import decoder_tail_plain, fused_decoder_tail
from debvader_tpu_torch.kernels.tail_fused import pack_b_operand
from debvader_tpu_torch.models.precision import split_limbs

torch.set_num_threads(1)


def _tail_inputs(n, s, c, o, seed=0):
    rng = np.random.default_rng(seed)
    return (
        (rng.normal(size=(n, s, s, c)) * 0.5).astype(np.float32),
        (rng.normal(size=(3, 3, c, c)) * 0.15).astype(np.float32),
        (rng.normal(size=(c,)) * 0.1).astype(np.float32),
        rng.uniform(0, 0.5, size=(s, s, c)).astype(np.float32),
        (rng.normal(size=(3, 3, c, o)) * 0.15).astype(np.float32),
        (rng.normal(size=(o,)) * 0.1).astype(np.float32),
    )


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


# ------------------------------------------------------------ bfloat16 tail


BF16_SHAPES = [(4, 16, 32, 12), (8, 16, 8, 6), (2, 64, 32, 12), (3, 37, 32, 5)]


@lru_cache(maxsize=None)
def _jax_bf16_case(shape):
    """The seeded inputs of ``shape`` = (n, s, c, o) and the JAX kernel's
    bfloat16 output on them (interpret mode), as float32 numpy."""
    n, s, c, o = shape
    arrays = _tail_inputs(n, s, c, o, seed=n + s + c)
    x, k2, b2, a2, k3, b3 = arrays
    want = jax_tail(
        jnp.asarray(x).astype(jnp.bfloat16), *(jnp.asarray(a) for a in (k2, b2, a2, k3, b3)),
        nb=min(n, 4), interpret=True,
    )
    assert want.dtype == jnp.bfloat16
    return arrays, np.asarray(want.astype(jnp.float32))


def _bf16_agrees(got, want) -> bool:
    """Within one bf16 ulp of the output scale, on at most 0.1% of the elements."""
    diff = np.abs(got - want)
    return diff.max() <= _bf16_ulp(float(np.abs(want).max())) and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_decoder_tail_bf16_matches_pallas_interpret(shape):
    n, s, c, o = shape
    arrays, want = _jax_bf16_case(shape)
    x, *params = (torch.from_numpy(a) for a in arrays)
    got = fused_decoder_tail(x.to(torch.bfloat16), *params)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, s, s, o)
    assert float(np.abs(want).max()) > 0.5
    assert _bf16_agrees(got.to(torch.float32).numpy(), want)


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_check_rejects_the_float32_chain(shape):
    """The control the card's check is also held against: the float32 chain
    on the same bfloat16 x, cast to bfloat16 at the end, stays within the
    ulp but differs on far more than 0.1% of the elements."""
    arrays, want = _jax_bf16_case(shape)
    x, *params = (torch.from_numpy(a) for a in arrays)
    control = decoder_tail_plain(x.to(torch.bfloat16).to(torch.float32), *params).to(torch.bfloat16)
    control = control.to(torch.float32).numpy()
    assert not _bf16_agrees(control, want)
    assert (np.abs(control - want) > 0).mean() > 0.1


def test_decoder_tail_float32_ragged_matches_pallas_interpret():
    """float32 x at a size that is no multiple of the card kernels' tiles
    and an output count that is no multiple of 4."""
    x, k2, b2, a2, k3, b3 = _tail_inputs(3, 37, 32, 5, seed=9)
    want = np.asarray(jax_tail(*(jnp.asarray(a) for a in (x, k2, b2, a2, k3, b3)), nb=3, interpret=True))
    got = fused_decoder_tail(*(torch.from_numpy(a) for a in (x, k2, b2, a2, k3, b3)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 37, 37, 5)
    scale = float(np.abs(want).max())
    assert scale > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5 * scale)


def test_decoder_tail_bf16_rounds_the_intermediate():
    """Not the float32 chain cast at the end: the weights and h are
    rounded too, and the output differs from the float32 tail's by more
    than its own rounding on some elements."""
    x, k2, b2, a2, k3, b3 = (torch.from_numpy(a) for a in _tail_inputs(2, 16, 32, 12, seed=4))
    xb = x.to(torch.bfloat16)
    low = decoder_tail_plain(xb, k2, b2, a2, k3, b3)
    full = decoder_tail_plain(xb.to(torch.float32), k2, b2, a2, k3, b3)
    assert full.dtype == torch.float32 and low.dtype == torch.bfloat16
    assert not torch.equal(low, full.to(torch.bfloat16))
    # bf16-valued weights and x: only h's rounding and the output's remain
    k2b, k3b = k2.to(torch.bfloat16).to(torch.float32), k3.to(torch.bfloat16).to(torch.float32)
    near = decoder_tail_plain(xb.to(torch.float32), k2b, b2, a2, k3b, b3)
    err = (low.to(torch.float32) - near).abs().max()
    assert 0 < err <= 4 * _bf16_ulp(float(near.abs().max()))


def test_decoder_tail_float32_is_unchanged():
    """float32 x: float32 out, the op chain with no rounding to bf16."""
    args = [torch.from_numpy(a) for a in _tail_inputs(2, 16, 8, 6, seed=5)]
    got = fused_decoder_tail(*args)
    x, k2, b2, a2, k3, b3 = args
    h = torch.nn.functional.conv_transpose2d(x.permute(0, 3, 1, 2), k2.permute(3, 2, 0, 1), b2)[..., 1:-1, 1:-1]
    h = torch.clamp(h, min=0) + a2.permute(2, 0, 1) * torch.clamp(h, max=0)
    want = torch.relu(torch.nn.functional.conv2d(h, k3.permute(3, 2, 0, 1), b3, padding=1)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_decoder_tail_rejects_other_dtypes(dtype):
    args = [torch.from_numpy(a) for a in _tail_inputs(1, 8, 4, 2)]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_decoder_tail(args[0].to(dtype), *args[1:])


def test_bf16_cpu_call_is_no_launch():
    before = fused_decoder_tail.launches
    args = [torch.from_numpy(a) for a in _tail_inputs(1, 8, 32, 12)]
    assert fused_decoder_tail(args[0].to(torch.bfloat16), *args[1:]).dtype == torch.bfloat16
    assert fused_decoder_tail.launches == before == 0


# ------------------------------------------------------------------ layouts


@pytest.mark.parametrize(
    "cin,cout,n_pad,limbs", [(32, 32, 32, 2), (32, 12, 16, 2), (32, 12, 16, 1), (8, 6, 8, 1), (4, 5, 16, 2)]
)
def test_b_operand_packing_round_trips(cin, cout, n_pad, limbs):
    """Element (n, k) of the packed B sits where the kernel's descriptor
    reads it (8x8 core matrices, 128 bytes between the k halves, 256
    between groups of 8 rows, N * 16 values a k-step for N = limbs * n_pad
    columns); column l * n_pad + o holds limb l of output channel o, the
    limbs are models.precision's, padding is zero."""
    w = torch.from_numpy(np.random.default_rng(cin + cout).normal(size=(3, 3, cin, cout)).astype(np.float32))
    packed = pack_b_operand(w, n_pad, limbs)
    k = 9 * cin
    k_pad = -(-k // 16) * 16
    n_all = limbs * n_pad
    assert packed.dtype == torch.bfloat16 and packed.shape == (n_all * k_pad,)
    nn, kk = np.meshgrid(np.arange(n_all), np.arange(k_pad), indexing="ij")
    index = (kk // 16) * n_all * 16 + (nn // 8) * 128 + ((kk % 16) // 8) * 64 + (nn % 8) * 8 + kk % 8
    assert np.array_equal(np.sort(index.ravel()), np.arange(n_all * k_pad))
    b = packed.to(torch.float32).numpy()[index]          # b[n, k]
    flat = w.permute(3, 0, 1, 2).reshape(cout, k)
    for l, limb in enumerate(split_limbs(flat, limbs, "rne")):
        rows = b[l * n_pad : (l + 1) * n_pad]
        assert np.array_equal(rows[:cout, :k], limb.numpy())
        assert not rows[cout:].any() and not rows[:, k:].any()
    if limbs == 2:  # hi + mid recover w to about 16 bits
        np.testing.assert_allclose(b[:cout, :k] + b[n_pad : n_pad + cout, :k], flat.numpy(), rtol=2**-15, atol=0)
