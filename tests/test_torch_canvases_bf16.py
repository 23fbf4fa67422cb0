"""The bfloat16 canvases' arithmetic on the CPU: the plain render and place
(the versions csrc/render.cu's dvt_render_bf16 and dvt_place_bf16 are
held to bit for bit on the card) against numpy loops that round every add
with ml_dtypes, on special values: signed zeros, subnormals, infinities,
NaN, the largest finite values, and values 20 or more binades apart.  NaN
is compared as a class: torch's CPU rounding gives every NaN the payload
0x7FC0, ml_dtypes keeps the payload of the float32 sum.

Also the claim the kernels' packed add rests on: a bf16 add done as
bf16(float32(a) + float32(b)) (the plain versions, and the kernels before
__hadd2) is the exact sum rounded once to bf16 (add.rn.bf16x2), here
against an exact reference computed in float64 and rounded by hand.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from debvader_tpu_torch.kernels import render as rd

torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
SPECIALS = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -9e-39, 3e38, -3e38, 1e6, -1e6, 1e-7], np.float32)


def _bits(a) -> np.ndarray:
    """The int16 bits of a bfloat16 array or tensor, every NaN as 0x7FFF."""
    if isinstance(a, torch.Tensor):
        a = a.float().numpy().astype(BF16)
    a = np.asarray(a, BF16)
    bits = a.view(np.int16).copy()
    bits[np.isnan(a.astype(np.float32))] = 0x7FFF
    return bits


def _sprinkle(rng, a: np.ndarray, share: float) -> np.ndarray:
    """A copy of ``a`` with a share of its elements set to SPECIALS."""
    out = a.copy().reshape(-1)
    idx = rng.choice(out.size, int(share * out.size), replace=False)
    out[idx] = SPECIALS[np.arange(len(idx)) % len(SPECIALS)]
    return out.reshape(a.shape)


def _numpy_loop(canvas, patches, y, x, visible):
    """In source order, canvas = bf16(canvas + patch) element by element
    (ml_dtypes rounding); a patch that is not visible adds +0.0."""
    out = np.asarray(canvas, BF16).copy()
    p = patches.shape[1]
    with np.errstate(over="ignore", invalid="ignore"):
        for i in range(len(y)):
            q = np.where(visible[i], np.asarray(patches[i], BF16), np.zeros((), BF16))
            win = out[y[i] : y[i] + p, x[i] : x[i] + p]
            out[y[i] : y[i] + p, x[i] : x[i] + p] = (win.astype(np.float32) + q.astype(np.float32)).astype(BF16)
    return out


def _as_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, BF16).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("gap", [0, 20, 30])
def test_bf16_plain_place_matches_numpy_on_special_values(gap):
    """The plain place on a canvas and patches sprinkled with special
    values, the patches 2**gap times smaller than the canvas, some patches
    not visible (they add +0.0, which turns a -0.0 into +0.0)."""
    rng = np.random.default_rng(20 + gap)
    c, p, b, n = 48, 11, 6, 18
    canvas = _sprinkle(rng, rng.normal(size=(c, c, b)).astype(np.float32), 0.2).astype(BF16)
    canvas[::7, ::5] = -0.0
    patches = _sprinkle(rng, (rng.normal(size=(n, p, p, b)) * 2.0**-gap).astype(np.float32), 0.1).astype(BF16)
    y, x = rng.integers(0, c - p + 1, n), rng.integers(0, c - p + 1, n)
    visible = rng.uniform(size=n) > 0.25
    want = _numpy_loop(canvas, patches, y, x, visible)
    got = _as_bf16(canvas)
    rd.place_patches(got, _as_bf16(patches), torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(visible))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isnan(want.astype(np.float32)).any() and (_bits(want) == np.int16(-32768)).any()


@pytest.mark.parametrize("gap", [0, 20, 30])
def test_bf16_plain_render_matches_numpy_on_special_values(gap):
    """The plain order-1 render into a bf16 window sprinkled with special
    values, from stamps sprinkled too (their shifted values carry NaN, inf
    and subnormals into the adds), 2**gap times smaller than the window,
    with masked sources: each source's float32 bilinear rounded to bf16
    and added with a rounding, in source order, only where its padded
    patch covers the element."""
    rng = np.random.default_rng(40 + gap)
    f, s, b, n = 40, 9, 6, 14
    stamps = _sprinkle(rng, (rng.uniform(0, 3, (n, s, s, b)) * 2.0**-gap).astype(np.float32), 0.05)
    stamps = torch.from_numpy(stamps).to(torch.bfloat16)
    offsets = torch.from_numpy(rng.uniform(-18, 18, (n, 2)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=n) > 0.2)
    start = _sprinkle(rng, rng.normal(size=(f, f, b)).astype(np.float32), 0.2).astype(BF16)
    start[::3, ::4] = -0.0
    out = _as_bf16(start)
    rd.render_field_kernel(stamps, offsets, f, mask, out=out)
    patches, int_off = rd.shift_patches(stamps, offsets, 1, rd.subpixel_shift_const)
    pad = s + 2
    y, x, visible = rd.place_corners(int_off, mask, f, s, 1, f + 2 * pad)
    canvas = np.zeros((f + 2 * pad, f + 2 * pad, b), BF16)
    canvas[pad : pad + f, pad : pad + f] = start
    want = _numpy_loop(canvas, patches.numpy().astype(BF16), y.numpy(), x.numpy(), visible.numpy())
    np.testing.assert_array_equal(_bits(out), _bits(want[pad : pad + f, pad : pad + f]))


def _round_bf16_exact(v: np.ndarray) -> np.ndarray:
    """float64 values rounded once to bfloat16, to nearest, ties to even,
    with subnormals (spacing 2**-133) and overflow to infinity; as float32."""
    out = np.empty(v.shape, np.float32)
    finite = np.isfinite(v)
    out[~finite] = v[~finite]
    w = v[finite]
    _, e = np.frexp(w)  # |w| in [2**(e-1), 2**e)
    ulp = np.exp2(np.maximum(e - 8, -133).astype(np.float64))
    r = np.rint(w / ulp) * ulp  # rint rounds half to even
    r[np.abs(r) >= 2.0**128 * (1 - 2.0**-9)] = np.inf * np.sign(r[np.abs(r) >= 2.0**128 * (1 - 2.0**-9)])
    out[finite] = r.astype(np.float32)
    return out


@pytest.mark.parametrize("gap", [0, 8, 20, 30])
def test_bf16_two_step_add_is_the_exact_sum_rounded_once(gap):
    """bf16(float32(a) + float32(b)), as torch adds two bf16 tensors and the
    plain versions add, equals the exact sum of a and b rounded once to
    bf16, which is what the kernels' add.rn.bf16x2 computes: double
    rounding through float32 is innocuous here (24 >= 2 * 8 + 2).  On
    random pairs 2**gap apart, subnormal and huge values, and signed zeros
    (bits compared; NaN as a class)."""
    rng = np.random.default_rng(gap)
    a = (rng.normal(size=200000) * 10.0 ** rng.integers(-20, 20, 200000)).astype(np.float32).astype(BF16)
    b = (a.astype(np.float32) * rng.normal(size=200000).astype(np.float32) * np.float32(2.0**-gap)).astype(BF16)
    extra = np.array([0.0, -0.0, 1e-40, -1e-40, 9e-39, -9e-39, 3e38, 3.3e38, -3.3e38, 1.0, -1.0], np.float32)
    extra = extra.astype(BF16)
    a = np.concatenate([a, np.repeat(extra, len(extra))])
    b = np.concatenate([b, np.tile(extra, len(extra))])
    two_step = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                + torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16))
    exact = _round_bf16_exact(a.astype(np.float64) + b.astype(np.float64))
    # an exact zero sum is +0.0 under round to nearest unless both are -0.0
    zero = (a.astype(np.float64) + b.astype(np.float64)) == 0
    exact[zero] = np.where(np.signbit(a.astype(np.float32)[zero]) & np.signbit(b.astype(np.float32)[zero]),
                           np.float32(-0.0), np.float32(0.0))
    np.testing.assert_array_equal(_bits(two_step), _bits(exact.astype(BF16)))
