"""Edge cases of the fused detect core and the label resolution, plain
versions against the JAX package's Pallas kernels on the CPU.

The port's wrappers run their plain versions here (CPU tensors); the JAX
side runs its Pallas kernels in interpret mode, as the JAX package's own
tests do.  chip_smoke.py runs the same kinds of case on the card, where
the CUDA kernels are held bit for bit against these plain versions.

filt is held to 1e-5 of its largest magnitude (the JAX kernel's own
parity bound with the XLA conv is 2e-5 absolute); dir_code and parent of
the port's race on the JAX kernel's filt, and labels, are held bit for
bit.  The JAX kernel pads a field to its tile and the outputs are cropped
back; label_select_fixpoint takes W padded to 128 and H to its row block
with code 4 (self), as its contract asks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debvader_tpu.kernels.detect_fused import matched_filter_parents as jax_mfp
from debvader_tpu.kernels.label_select import label_select_fixpoint
from debvader_tpu_torch.kernels.detect_fused import matched_filter_parents, parent_race
from debvader_tpu_torch.kernels.label_select import label_fixpoint
from debvader_tpu_torch.ops.detection import default_filter_kernel

torch.set_num_threads(1)


def _field(f, seed, nsrc=6, noise=0.05):
    rng = np.random.default_rng(seed)
    img = noise * rng.normal(size=(f, f)) + 0.01
    yy, xx = np.mgrid[:f, :f]
    for _ in range(nsrc):
        cy, cx = rng.uniform(2, f - 2, 2)
        s = rng.uniform(1.2, 3.0)
        img += rng.uniform(0.3, 3.0) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def _ramp(f):
    """A tilted plane: every pixel's steepest neighbour is the one down and
    to the right, so each chain crosses the field to its far corner."""
    yy, xx = np.mgrid[:f, :f]
    return (1.0 + 0.01 * yy + 0.013 * xx).astype(np.float32)


def _cases():
    """name -> (images (T, F, F), backgrounds, thresholds (T,))."""
    back = lambda x: np.full_like(x, 0.01)  # noqa: E731
    stack = np.stack([_field(64, s) for s in (1, 2, 3)])
    plateau = np.ones((1, 48, 48), np.float32)
    f37 = _field(37, 5, nsrc=3)[None]
    f100 = _field(100, 4, nsrc=10)[None]
    return {
        "ragged37": (f37, back(f37), np.array([0.4], np.float32)),
        "ragged100": (f100, back(f100), np.array([0.5], np.float32)),
        "stack3": (stack, back(stack), np.array([0.3, 0.6, 1.2], np.float32)),
        "plateau": (plateau, plateau.copy(), np.array([-0.5], np.float32)),
        "ramp": (_ramp(40)[None], np.zeros((1, 40, 40), np.float32), np.array([0.0], np.float32)),
        "nothing_masked": (f100, back(f100), np.array([1e30], np.float32)),
        "everything_masked": (f100, back(f100), np.array([-1e30], np.float32)),
    }


_CASES = _cases()


def _jax_detect(images, backs, thr):
    f = images.shape[-1]
    out = jax_mfp(jnp.asarray(images), jnp.asarray(backs), default_filter_kernel(), jnp.asarray(thr),
                  tile=64, interpret=True)
    return [np.array(a)[:, :f, :f] for a in out]


def _jax_labels(cur0, dir_code, rows=64):
    """label_select_fixpoint on (H, W) padded with code 4 to (rows k, 128 j)."""
    h, w = cur0.shape
    hp, wp = -(-h // rows) * rows, -(-w // 128) * 128
    cur = np.zeros((hp, wp), np.int32)
    d = np.full((hp, wp), 4, np.int32)
    cur[:h, :w] = cur0
    d[:h, :w] = dir_code
    labels, _ = label_select_fixpoint(jnp.asarray(cur), jnp.asarray(d), rows=rows, interpret=True)
    return np.asarray(labels)[:h, :w]


@pytest.mark.parametrize("name", sorted(_CASES))
def test_detect_core_edge_cases_match_pallas_interpret(name):
    images, backs, thr = _CASES[name]
    jf, jdir, jpar = _jax_detect(images, backs, thr)
    filt, dirc, parent = matched_filter_parents(
        torch.from_numpy(images), torch.from_numpy(backs), default_filter_kernel(), torch.from_numpy(thr)
    )
    scale = max(float(np.abs(jf).max()), 1e-30)
    np.testing.assert_allclose(filt.numpy(), jf, rtol=0, atol=1e-5 * scale)
    rdir, rpar = parent_race(torch.from_numpy(np.ascontiguousarray(jf)), torch.from_numpy(thr))
    np.testing.assert_array_equal(rdir.numpy(), jdir)
    np.testing.assert_array_equal(rpar.numpy(), jpar)
    masked = int((jf > thr.reshape(-1, 1, 1)).sum())
    if name == "nothing_masked":
        assert masked == 0 and (jdir == 4).all() and (jpar == 0).all()
    elif name in ("everything_masked", "plateau", "ramp"):
        assert masked == jf.size
    else:
        assert 0 < masked < jf.size


def test_plateau_ties_go_to_the_lowest_index():
    """A constant field on its own background filters to exactly 0, above
    a negative threshold: every race is a tie, which the lowest flat index
    wins (up-left inside, left along row 0, up along column 0), so every
    chain ends at pixel 0, up to about 2F steps away."""
    images, backs, thr = _CASES["plateau"]
    jf, jdir, jpar = _jax_detect(images, backs, thr)
    f = images.shape[-1]
    assert (jf == 0).all()
    assert (jdir[0, 1:, 1:] == 0).all() and (jdir[0, 0, 1:] == 3).all() and (jdir[0, 1:, 0] == 1).all()
    assert jdir[0, 0, 0] == 4 and jpar[0, 20, 30] == 19 * f + 29


@pytest.mark.parametrize("name", sorted(_CASES))
def test_label_fixpoint_edge_cases_match_pallas_interpret(name):
    """Labels of the port's plain fixpoint against the Pallas select
    fixpoint on the same (stack row-flattened) parents and codes."""
    images, backs, thr = _CASES[name]
    jf, _, _ = _jax_detect(images, backs, thr)
    t, f, _ = jf.shape
    dirc, cur0 = parent_race(torch.from_numpy(np.ascontiguousarray(jf)), torch.from_numpy(thr))
    cur0, dirc = cur0.reshape(t * f, f), dirc.reshape(t * f, f)
    got = label_fixpoint(cur0, dirc).numpy()
    np.testing.assert_array_equal(got, _jax_labels(cur0.numpy(), dirc.numpy()))
    if name == "ramp":
        # every chain ends at the one maximum of the filtered plane
        assert np.unique(got).size == 1


def test_label_fixpoint_chain_crossing_row_blocks():
    """A hand-made serpentine chain over a ragged (100, 37) array: even rows
    point right, odd rows left, row ends down (straight or diagonally).
    Rows 0..50 end at a root at (50, 10), the rest at one in the last row;
    the JAX side splits the chains over four row blocks of 32."""
    h, w = 100, 37
    d = np.full((h, w), 4, np.int32)
    cur0 = np.arange(h * w, dtype=np.int32).reshape(h, w) * 3 + 7
    for r in range(h - 1):
        if r % 2 == 0:
            d[r, : w - 1] = 5
            d[r, w - 1] = 7
        else:
            d[r, 1:] = 3
            d[r, 0] = 8 if r % 4 == 1 else 7
    d[h - 1, :5] = 5
    d[h - 1, 6:] = 3
    d[50, 10] = 4
    got = label_fixpoint(torch.from_numpy(cur0), torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, _jax_labels(cur0, d, rows=32))
    assert got[0, 0] == cur0[50, 10] and got[50, 11] == cur0[h - 1, 5]
    assert set(np.unique(got)) == {cur0[50, 10], cur0[h - 1, 5]}


def test_label_fixpoint_codes_outside_0_to_8_are_roots():
    """A code outside 0..8 selects nothing in the Pallas iteration, so the
    pixel keeps its label and its chain ends there, as at code 4."""
    images, backs, thr = _CASES["stack3"]
    jf, _, _ = _jax_detect(images, backs, thr)
    t, f, _ = jf.shape
    dirc, cur0 = parent_race(torch.from_numpy(np.ascontiguousarray(jf)), torch.from_numpy(thr))
    cur0, dirc = cur0.reshape(t * f, f).numpy(), dirc.reshape(t * f, f).numpy()
    odd = (np.arange(t * f * f).reshape(t * f, f) % 2).astype(bool)
    bad = np.where(dirc == 4, np.where(odd, -1, 9), dirc).astype(np.int32)
    got = label_fixpoint(torch.from_numpy(cur0), torch.from_numpy(bad)).numpy()
    np.testing.assert_array_equal(got, _jax_labels(cur0, bad))
    np.testing.assert_array_equal(got, label_fixpoint(torch.from_numpy(cur0), torch.from_numpy(dirc)).numpy())
