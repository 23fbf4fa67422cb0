"""Edge cases of the render and clipped-statistics kernels' plain versions,
held against the JAX package on the CPU.

The port's wrappers run their plain versions here (CPU tensors); the JAX
side runs its Pallas kernels in interpret mode, as the JAX package's own
tests do, and its XLA renderer.  The same cases run on the card in
chip_smoke.py, where the CUDA kernels are held against these plain
versions.  Medians are compared bit for bit; tolerances are stated where
they are used.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debvader_tpu.kernels.clipped_stats import sigma_clipped_stats_pallas
from debvader_tpu.kernels.render import render_field_pallas
from debvader_tpu.ops.shift import render_field as jax_render
from debvader_tpu_torch.kernels import clipped_stats as cs
from debvader_tpu_torch.kernels.render import render_field_kernel, render_field_plain
from debvader_tpu_torch.ops.shift import render_field, render_pad

torch.set_num_threads(1)


# ------------------------------------------------------- clipped statistics


def _sky(rng, n, p):
    """Sky boxes with a bright tail (after tests/test_pallas_clipped_stats.py)."""
    x = rng.normal(3.0, 0.05, size=(n, p)).astype(np.float32)
    hot = rng.random((n, p)) < 0.02
    x[hot] += rng.uniform(1, 30, hot.sum()).astype(np.float32)
    return x, np.ones_like(x)


def _clipped_cases():
    """name -> (boxes (n, P), valid (n, P), iters)."""
    rng = np.random.default_rng(11)
    p = 1024
    ties = rng.integers(0, 4, (2, p)).astype(np.float32)
    ties[:, :20] = 100.0
    # 140 negatives, 372 -0.0, 372 +0.0, 140 positives: the median (rank
    # 511) is the last -0.0, the next key up the first +0.0
    zeros = np.concatenate([
        -rng.uniform(1e-4, 2e-4, 140), np.full(372, -0.0), np.full(372, 0.0), rng.uniform(1e-4, 2e-4, 140),
    ]).astype(np.float32)
    rng.shuffle(zeros)
    # the unclipped mean overflows to inf in any order: the first round's
    # std is NaN and its clip empty, so the next round admits |x| <= 1e-12
    huge = np.concatenate([
        rng.uniform(1e36, 2e36, 1000), rng.uniform(-1e-12, 1e-12, 20), [-0.0, 0.0, 1e-12, -1e-12],
    ]).astype(np.float32)
    rng.shuffle(huge)
    one = np.ones((1, p), np.float32)
    cases = {
        "ties": (ties, np.ones_like(ties), 3),
        "signed_zeros": (zeros[None], one, 3),
        "empty_first_clip": (huge[None], one, 3),
        "empty_first_clip_iters2": (huge[None], one, 2),
    }
    # one box size for each of the kernel's variants: 4, 8, 16 or 32 pixels
    # a thread of its 512 in registers, or the box in shared memory
    for box, n in ((32, 2), (50, 3), (80, 1), (128, 2), (160, 1)):
        x, v = _sky(rng, n, box * box)
        v[0, ::7] = 0  # a few masked pixels
        cases[f"box{box}"] = (x, v, 3)
    return cases


_CLIPPED = _clipped_cases()


@pytest.mark.parametrize("name", sorted(_CLIPPED))
def test_clipped_stats_edge_boxes_match_pallas_interpret(name):
    """Medians bit-identical; mean and std NaN at the same places and
    elsewhere within 1e-6 of the box scale (float32 sums in another order)."""
    x, v, iters = _CLIPPED[name]
    want = [np.asarray(a) for a in sigma_clipped_stats_pallas(
        jnp.asarray(x), jnp.asarray(v), iters=iters, interpret=True, block=8
    )]
    got = [t.numpy() for t in cs.sigma_clipped_stats(torch.from_numpy(x), torch.from_numpy(v), iters=iters)]
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))
    scale = np.abs(np.where(v > 0, x, 0)).max(-1)
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        assert np.all(np.abs(g[ok] - w[ok]) <= 1e-6 * scale[ok])


def test_clipped_stats_signed_zero_median_keeps_its_sign():
    x, v, _ = _CLIPPED["signed_zeros"]
    _, med, _ = cs.sigma_clipped_stats(torch.from_numpy(x), torch.from_numpy(v))
    assert med.numpy().view(np.int32)[0] == np.float32(-0.0).view(np.int32)


def test_clipped_stats_empty_clip_admits_tiny_values_next_round():
    """A mean that overflows makes the first round's std NaN and its clip
    empty; the round after has no members (median 0, std 0) and so admits
    |x| <= 1e-12.  With iters=2 that is the last round: its median is the
    middle one of those values, its mean and std NaN (inf - inf).  With
    iters=3 the NaN std empties the last clip again: zeros."""
    x, v, _ = _CLIPPED["empty_first_clip"]
    tiny = np.sort(x[0][np.abs(x[0]) <= np.float32(1e-12)])
    mean, med, std = (t.numpy()[0] for t in cs.sigma_clipped_stats(torch.from_numpy(x), torch.from_numpy(v), iters=2))
    assert np.isnan(mean) and np.isnan(std)
    assert med.view(np.int32) == tiny[(len(tiny) - 1) // 2].view(np.int32)
    out = [t.item() for t in cs.sigma_clipped_stats(torch.from_numpy(x), torch.from_numpy(v), iters=3)]
    assert out == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("p", [1024, 2500, 4096, 6400, 16384, 25827])
def test_clipped_stats_kernel_takes_every_box_it_took_before(p):
    """The kernel keeps boxes up to 32 * 512 pixels in registers and larger
    ones in shared memory; every size up to 25,827 pixels stays accepted."""
    cs.check_box_pixels(p)


def test_clipped_stats_kernel_refuses_a_box_beyond_shared_memory():
    assert cs.MAX_BOX_PIXELS >= 25827
    cs.check_box_pixels(cs.MAX_BOX_PIXELS)
    with pytest.raises(ValueError, match="pixels"):
        cs.check_box_pixels(cs.MAX_BOX_PIXELS + 1)


# ------------------------------------------------------------------- render

_F, _S, _B = 96, 9, 6


def _stamps(n, seed):
    return np.random.default_rng(seed).random((n, _S, _S, _B)).astype(np.float32)


def _border_offsets():
    """Padded patches that start, or end one past their last row, exactly
    on 16- and 32-pixel tile borders, with fractions 0 to 0.999."""
    pos0 = (_F - _S) // 2
    frac = np.array([0.0, 0.25, 0.5, 0.999])
    starts = 16 * np.arange(1, 5) + 1 - pos0 + frac
    ends = 16 * np.arange(2, 6) - (_S + 2) + 1 - pos0 + frac
    return np.stack([np.concatenate([starts, ends]), np.concatenate([ends, starts])], -1).astype(np.float32)


def _render_cases():
    """name -> (stamps, offsets)."""
    rng = np.random.default_rng(8)
    off = rng.choice([-1.0, 1.0], (6, 2)) * (_F / 2 + _S + rng.uniform(0, 30, (6, 2)))
    return {
        "tile_border": (_stamps(8, 1), _border_offsets()),
        "all_off_field": (_stamps(6, 2), off.astype(np.float32)),
        "scattered": (_stamps(10, 3), rng.uniform(-_F / 2, _F / 2, (10, 2)).astype(np.float32)),
    }


_RENDER = _render_cases()


def _covered(offsets, f=_F, s=_S):
    """(f, f) bool: the pixels some padded patch covers."""
    cov = np.zeros((f, f), bool)
    pos0 = (f - s) // 2
    for oy, ox in offsets:
        if not (np.isfinite(oy) and np.isfinite(ox)) or max(abs(oy), abs(ox)) >= 1e9:
            continue
        y0, x0 = pos0 + int(np.floor(oy)) - 1, pos0 + int(np.floor(ox)) - 1
        cov[max(y0, 0) : max(y0 + s + 2, 0), max(x0, 0) : max(x0 + s + 2, 0)] = True
    return cov


@pytest.mark.parametrize("name", sorted(_RENDER))
def test_render_edge_cases_match_jax(name):
    """ops/shift.render_field (order 1) and the kernel's plain version
    against the XLA renderer (1e-5) and the Pallas kernel in interpret mode
    (3e-5, the bound of its own tests)."""
    stamps, offsets = _RENDER[name]
    st, off = torch.from_numpy(stamps), torch.from_numpy(offsets)
    got = render_field(st, off, _F).numpy()
    np.testing.assert_array_equal(got, render_field_plain(st, off, _F).numpy())
    want = np.asarray(jax_render(jnp.asarray(stamps), jnp.asarray(offsets), _F))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pallas = np.asarray(render_field_pallas(jnp.asarray(stamps), jnp.asarray(offsets), _F, tile=32, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=3e-5)
    assert not got[~_covered(offsets)].any()
    if name == "all_off_field":
        assert not got.any() and not pallas.any()


@pytest.mark.parametrize("name", sorted(_RENDER))
def test_render_into_a_filled_canvas_leaves_uncovered_pixels_alone(name):
    """The streaming call: render_field(canvas=, crop=False) into a canvas
    of seeded random values.  Pixels outside every padded patch keep their
    bits; the window equals canvas + render within 1e-6 of the scale, and
    the JAX package's incremental render within 1e-5."""
    stamps, offsets = _RENDER[name]
    st, off = torch.from_numpy(stamps), torch.from_numpy(offsets)
    pad = render_pad(_S, 1)
    before = torch.from_numpy(np.random.default_rng(9).normal(size=(_F + 2 * pad,) * 2 + (_B,)).astype(np.float32))
    canvas = render_field(st, off, _F, canvas=before.clone(), crop=False)
    window = canvas[pad : pad + _F, pad : pad + _F].numpy()
    base = before[pad : pad + _F, pad : pad + _F].numpy()
    cov = _covered(offsets)
    np.testing.assert_array_equal(window[~cov], base[~cov])
    np.testing.assert_allclose(window, base + render_field(st, off, _F).numpy(), rtol=0, atol=1e-6 * 5)
    jc = jax_render(jnp.asarray(stamps), jnp.asarray(offsets), _F, canvas=jnp.asarray(before.numpy()), crop=False)
    np.testing.assert_allclose(window, np.asarray(jc)[pad : pad + _F, pad : pad + _F], rtol=0, atol=1e-5)
    # the kernel's own wrapper with out= (the plain version here) agrees
    out = before.clone()
    render_field_kernel(st, off, _F, out=out[pad : pad + _F, pad : pad + _F])
    np.testing.assert_allclose(out[pad : pad + _F, pad : pad + _F].numpy(), window, rtol=0, atol=1e-6 * 5)


def test_render_drops_non_finite_and_huge_offsets():
    """A NaN or huge offset places nothing (the kernel tests |floor| < 1e9;
    the plain scatter clips the patch off the canvas and masks it)."""
    stamps = _stamps(3, 4)
    offsets = np.array([[np.nan, 0.0], [1e20, 3.0], [2.5, -4.25]], np.float32)
    got = render_field_plain(torch.from_numpy(stamps), torch.from_numpy(offsets), _F).numpy()
    want = render_field_plain(torch.from_numpy(stamps[2:]), torch.from_numpy(offsets[2:]), _F).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
