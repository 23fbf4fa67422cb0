"""The PyTorch port's IterativeDeblendField held against the JAX package on
the CPU with the sim_demo weights and z_mode='mean': the same steps, the
same detections and deblended counts a step, the same list_idx (offset
quirk included), means within 2e-5 of their scale, and ``mse`` within 1e-5
relative; the reference's termination quirks (tests/test_pipeline.py:175,
191, 247 pin them for JAX).

Each step after the first detects at the default configuration, which on a
noisy field splits the sky into noise peaks.  Registration of a noise peak
is an ill-posed fit that amplifies the two sides' rounding, so on the noisy
field with ``optimise_positions=True`` the largest differences of the
shifts, the means and ``mse`` are printed, not held (the steps and counts
are); the noise-free field holds them.
"""

import numpy as np
import pytest
import torch

import debvader_tpu as dt
import debvader_tpu_torch as dtt
from debvader_tpu.pipeline.iterative import IterativeDeblendField as JaxIterative

torch.set_num_threads(1)


def _field(size=128, bands=6, seed=0, noise=0.0):
    """Six Gaussian galaxies with a band SED (two too close to the border
    to be cut out), over Gaussian noise of ``noise``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    field = noise * rng.normal(size=(size, size, bands))
    centers = np.array([[-30.0, -25.0], [0.0, 3.0], [20.4, -10.7], [35.0, 40.0], [-6.0, 30.0], [10.0, -40.0]])
    for cy, cx in centers:
        s = rng.uniform(1.5, 3.0)
        sed = np.exp(rng.uniform(-0.15, 0.15) * np.arange(bands))
        prof = np.exp(-((yy - size // 2 - cy) ** 2 + (xx - size // 2 - cx) ** 2) / (2 * s * s))
        field += rng.uniform(0.5, 2.0) * prof[..., None] * sed
    return field[None].astype(np.float32), centers.astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    return dt.load_deblender("sim_demo"), dtt.load_deblender("sim_demo", device="cpu")


def _run(nets, field, **kwargs):
    jnet, tnet = nets
    jdf = JaxIterative(jnet, field, z_mode="mean")
    tdf = dtt.IterativeDeblendField(tnet, field, z_mode="mean", device="cpu")
    return jdf, jdf.iterative_deblending(**kwargs), tdf, tdf.iterative_deblending(**kwargs)


def _check_steps(jdf, want, tdf, got, hold_values=True):
    """Steps, counts and the integer and position columns equal; the means
    within 2e-5 of their scale (``hold_values``); returns the relative
    differences of mse and of the means."""
    assert tdf.nb_of_detected_objects == jdf.nb_of_detected_objects
    assert tdf.nb_of_deblended_galaxies == jdf.nb_of_deblended_galaxies
    assert len(tdf.mse) == len(jdf.mse)
    assert type(got) is type(want) and got.dtype == want.dtype
    np.testing.assert_array_equal(got["list_idx"], want["list_idx"])
    for col in ("galaxy_distances_to_center_x", "galaxy_distances_to_center_y", "passed_cuts"):
        np.testing.assert_array_equal(got[col], want[col])
    gm, wm = np.stack(list(got["output_images_mean"])), np.stack(list(want["output_images_mean"]))
    means_rel = float(np.abs(gm - wm).max()) / float(np.abs(wm).max())
    if hold_values:
        assert means_rel <= 2e-5, means_rel
    return np.abs(np.asarray(tdf.mse) - np.asarray(jdf.mse)) / np.abs(np.asarray(jdf.mse)), means_rel


@pytest.mark.parametrize("optimise_positions", [False, True])
@pytest.mark.parametrize("cumulative_residual", [False, True])
def test_iterative_deblending_matches_jax(nets, cumulative_residual, optimise_positions):
    """A noise-free field: two steps (the second finds the same sources in
    the residual and no more), list_idx offset by the first step's count."""
    field, _ = _field()
    jdf, want, tdf, got = _run(
        nets, field, cumulative_residual=cumulative_residual, optimise_positions=optimise_positions
    )
    rel, _ = _check_steps(jdf, want, tdf, got)
    assert len(tdf.mse) == 2 and tdf.nb_of_deblended_galaxies == [4, 4]
    assert rel.max() <= 1e-5, rel
    shifts_got, shifts_want = np.stack(list(got["shifts"])), np.stack(list(want["shifts"]))
    np.testing.assert_allclose(shifts_got, shifts_want, rtol=0, atol=1e-4)
    assert (np.abs(shifts_got).max() > 0) == optimise_positions


@pytest.mark.parametrize("optimise_positions", [False, True])
def test_iterative_deblending_on_a_noisy_field_matches_jax(nets, optimise_positions):
    """Default-threshold detection on noise: hundreds of peaks, the same on
    both sides, and the same steps.  Without registration the means and mse
    are held.  With it, the fits of noise peaks are ill-posed: their shifts
    differ, so the next step's residual and means do, and the largest
    differences are reported."""
    field, _ = _field(noise=0.02)
    jdf, want, tdf, got = _run(nets, field, optimise_positions=optimise_positions)
    rel, means_rel = _check_steps(jdf, want, tdf, got, hold_values=not optimise_positions)
    assert tdf.nb_of_detected_objects[0] > 100
    if optimise_positions:
        shifts = np.abs(np.stack(list(got["shifts"])) - np.stack(list(want["shifts"]))).max()
        print(
            f"noisy field with registration: mse relative difference {rel.max()}, means {means_rel} of "
            f"their scale, shifts {shifts} px"
        )
    else:
        assert rel.max() <= 1e-5, rel


def test_iterative_deblending_with_given_centers_terminates_as_jax(nets):
    """The first step at given centres (tests/test_pipeline.py:175): one
    list_idx a row, offset by earlier steps, collisions allowed."""
    field, centers = _field(noise=0.01, seed=3)
    jdf, want, tdf, got = _run(nets, field, galaxy_distances_to_center=centers)
    _check_steps(jdf, want, tdf, got)
    assert len(got["list_idx"]) == len(got) and (np.asarray(got["list_idx"]) >= 0).all()


def test_iterative_empty_centers_converge_as_jax(nets):
    """No centre at all (tests/test_pipeline.py:191): nothing to deblend,
    the (empty) res_deblend is returned and nothing else runs."""
    field = (0.001 * np.random.default_rng(0).normal(size=(1, 96, 96, 6))).astype(np.float32)
    jdf, want, tdf, got = _run(nets, field, galaxy_distances_to_center=np.zeros((0, 2)))
    assert want is None and got is None
    assert tdf.mse == jdf.mse == []
    assert tdf.nb_of_detected_objects == jdf.nb_of_detected_objects == []


def test_iterative_cumulative_residual_subtracts_every_find(nets):
    """cumulative_residual=True (tests/test_pipeline.py:247): the residual
    of the accumulated array holds less flux than the field."""
    field, centers = _field(noise=0.01, seed=5)
    jdf, want, tdf, got = _run(nets, field, galaxy_distances_to_center=centers, cumulative_residual=True)
    _check_steps(jdf, want, tdf, got)
    resid = tdf.get_residual_field(res_deblend=got)
    np.testing.assert_allclose(
        resid, jdf.get_residual_field(res_deblend=want), rtol=0, atol=2e-5 * float(np.abs(field).max())
    )
    assert np.abs(resid).sum() < np.abs(field).sum()


def test_a_step_without_sources_returns_the_accumulated_array(nets):
    """deblending_step on a field with no valid source returns the last
    res_deblend, as JAX's does."""
    jnet, tnet = nets
    field, centers = _field(noise=0.01, seed=6)
    for cls, net, kw in ((JaxIterative, jnet, {}), (dtt.IterativeDeblendField, tnet, {"device": "cpu"})):
        df = cls(net, field, z_mode="mean", **kw)
        first = df.deblend_field(centers)
        assert df.deblending_step(field, galaxy_distances_to_center=np.array([[60.0, 60.0]])) is first
        assert df.deblending_step(field, galaxy_distances_to_center=np.zeros((0, 2))) is first


def test_deblend_field_keeps_an_mse_list(nets):
    field, _ = _field()
    assert dtt.DeblendField(nets[1], field, device="cpu").mse == dt.DeblendField(nets[0], field).mse == []
