"""The PyTorch port's streaming serving path (deblend_and_render,
deblend_and_predict), its measurements and its stage timer held against
the JAX package on the CPU, with the sim_demo weights and z_mode='mean'.

Float tolerances: both sides run float32 on the CPU.  Fields are held to
2e-5 of their scale (the model's bound, tests/test_torch_model.py; the
renders add 1e-5 of the stamps' scale), per-source scalars to 1e-5
relative unless stated.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import debvader_tpu as dt
import debvader_tpu_torch as dtt
from debvader_tpu.config import PipelineConfig as JaxPipelineConfig
from debvader_tpu.ops.measure import measure_batch as jax_measure_batch
from debvader_tpu_torch.ops import measure as tm
from debvader_tpu_torch.pipeline import field as tfield
from debvader_tpu_torch.utils.profiling import stage_timer

torch.set_num_threads(1)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _blob_field(size=160, bands=6, seed=0):
    """A seeded field of Gaussian galaxies with a band SED, and their
    offsets from the field centre (the last one leaves the field)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    field = 0.02 * rng.normal(size=(size, size, bands))
    centers = np.array([[-30.0, -25.0], [0.0, 3.0], [20.4, -10.7], [35.0, 40.0], [-6.0, 30.0], [70.0, 0.0]])
    for cy, cx in centers:
        s = rng.uniform(1.5, 3.0)
        sed = np.exp(rng.uniform(-0.15, 0.15) * np.arange(bands))
        prof = np.exp(-((yy - size // 2 - cy) ** 2 + (xx - size // 2 - cx) ** 2) / (2 * s * s))
        field += rng.uniform(0.5, 2.0) * prof[..., None] * sed
    return field[None].astype(np.float32), centers.astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    return dt.load_deblender("sim_demo"), dtt.load_deblender("sim_demo", device="cpu")


def _pair(nets, field, order, chunk=2):
    jnet, tnet = nets
    jdf = dt.DeblendField(jnet, field, z_mode="mean", cfg=JaxPipelineConfig(interp_order=order, source_chunk=chunk))
    tdf = dtt.DeblendField(
        tnet, field, z_mode="mean", device="cpu", cfg=dtt.PipelineConfig(interp_order=order, source_chunk=chunk)
    )
    return jdf, tdf


def _check_catalog(got, want, measured):
    assert got.dtype == want.dtype
    assert len(got) == len(want) == 5
    for col in ("list_idx", "galaxy_distances_to_center_x", "galaxy_distances_to_center_y", "passed_cuts", "epistemic_norm"):
        np.testing.assert_array_equal(got[col], want[col])
    for i in range(len(got)):
        np.testing.assert_array_equal(got.shifts[i], want.shifts[i])
    np.testing.assert_allclose(got.mse_center, want.mse_center, rtol=1e-5)
    if measured:
        # sums of ~2e4 float32 terms of either sign: 1e-4 of each column's scale
        for col in ("flux", "centroid", "ellipticity", "snr"):
            _close(np.stack(list(got[col])), np.stack(list(want[col])), 1e-4)
    else:
        assert "flux" not in got.dtype.names


# ------------------------------------------------------------------ measure


def _stamps(n=4, s=21, b=3, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:s, :s]
    out = np.zeros((n, s, s, b), np.float32)
    for i in range(n):
        cy, cx = rng.uniform(8, 12, 2)
        q = 0.6 * (yy - cy) ** 2 + 1.4 * (xx - cx) ** 2 + rng.uniform(-0.5, 0.5) * (yy - cy) * (xx - cx)
        out[i] = (rng.uniform(0.5, 2, (1, 1, b)) * np.exp(-q / 8)[..., None]).astype(np.float32)
    out += 0.01 * rng.normal(size=out.shape).astype(np.float32)
    return out, rng.uniform(0.01, 0.05, out.shape).astype(np.float32)


@pytest.mark.parametrize("with_std", [True, False])
def test_measure_batch_matches_jax(with_std):
    mean, std = _stamps()
    want = jax_measure_batch(jnp.asarray(mean), jnp.asarray(std) if with_std else None)
    got = tm.measure_batch(torch.from_numpy(mean), torch.from_numpy(std) if with_std else None)
    assert set(got) == set(want)
    assert ("snr" in got) == with_std
    for key in want:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_aperture_flux_matches_jax():
    from debvader_tpu.ops.measure import flux as jax_flux

    mean, _ = _stamps(seed=1)
    want = np.asarray(jax_flux(jnp.asarray(mean), radius=5.0))
    got = tm.flux(torch.from_numpy(mean), radius=5.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got < tm.flux(torch.from_numpy(mean)).numpy()).all()


# ----------------------------------------------------------------- serving


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("measure", [False, True])
def test_deblend_and_render_matches_jax(nets, order, measure):
    """Three chunks of two sources; residual and model within 2e-5 of the
    field's scale; the catalog's dtype, integer and bool columns equal."""
    field, centers = _blob_field()
    jdf, tdf = _pair(nets, field, order)
    jcat, jres, jmodel = jdf.deblend_and_render(centers, return_model=True, measure=measure)
    tcat, tres, tmodel = tdf.deblend_and_render(centers, return_model=True, measure=measure)
    _check_catalog(tcat, jcat, measure)
    assert tres.shape == field.shape and tmodel.shape == field.shape[1:]
    _close(tres, jres, 2e-5)
    _close(tmodel, jmodel, 2e-5)
    np.testing.assert_allclose(tres[0] + tmodel, field[0], atol=1e-6)
    assert tdf.nb_of_detected_objects == jdf.nb_of_detected_objects == [6]
    assert tdf.nb_of_deblended_galaxies == jdf.nb_of_deblended_galaxies == [5]
    # without the model the same residual comes back
    cat2, res2 = tdf.deblend_and_render(centers)
    np.testing.assert_array_equal(res2, tres)
    np.testing.assert_array_equal(cat2.list_idx, tcat.list_idx)


@pytest.mark.parametrize("order", [1, 3])
def test_deblend_and_predict_matches_jax(nets, order):
    field, centers = _blob_field(seed=1)
    jdf, tdf = _pair(nets, field, order)
    jcat, jf = jdf.deblend_and_predict(centers, measure=True)
    tcat, tf = tdf.deblend_and_predict(centers, measure=True)
    _check_catalog(tcat, jcat, True)
    assert list(tf) == list(jf)
    assert tf["predicted_epistemic_field"] is None and jf["predicted_epistemic_field"] is None
    for key in ("residual_field", "predicted_mean_field", "predicted_stddev_field"):
        _close(tf[key], jf[key], 2e-5)
    assert np.abs(tf["predicted_stddev_field"]).max() > 0


@pytest.mark.parametrize("order", [1, 3])
def test_streaming_route_equals_the_record_array_route(nets, order):
    """deblend_and_predict against deblend_field + get_residual_field +
    get_predicted_field of the same object: the same stamps rendered in
    chunks, so 1e-6 of the field's scale."""
    field, centers = _blob_field(seed=2)
    _, tdf = _pair(nets, field, order)
    cat, fields = tdf.deblend_and_predict(centers)
    res = tdf.deblend_field(centers)
    np.testing.assert_array_equal(cat.list_idx, res.list_idx)
    np.testing.assert_array_equal(cat.passed_cuts, res.passed_cuts)
    _close(fields["residual_field"], tdf.get_residual_field(), 1e-6)
    pred = tdf.get_predicted_field()
    _close(fields["predicted_mean_field"], pred["predicted_mean_field"], 1e-6)
    _close(fields["predicted_stddev_field"], pred["predicted_stddev_field"], 1e-6)


@pytest.mark.parametrize("transfer_dtype", ["bfloat16", "float16"])
def test_transfer_dtype_matches_jax(nets, transfer_dtype):
    """The cast happens on the device and widens on the host: the fields
    come back float32, equal to JAX's within one rounding step of the
    reduced format (2^-8 relative for bfloat16, 2^-11 for float16) on top
    of the float32 bound."""
    field, centers = _blob_field(seed=3)
    jdf, tdf = _pair(nets, field, 1)
    _, jres, jmodel = jdf.deblend_and_render(centers, return_model=True, transfer_dtype=transfer_dtype)
    _, tres, tmodel = tdf.deblend_and_render(centers, return_model=True, transfer_dtype=transfer_dtype)
    assert tres.dtype == np.float32 and tmodel.dtype == np.float32
    step = 2.0**-8 if transfer_dtype == "bfloat16" else 2.0**-11
    _close(tres, jres, step)
    _close(tmodel, jmodel, step)
    _, full = tdf.deblend_and_render(centers)
    assert 0 < np.abs(tres - full).max() <= step * np.abs(full).max()
    _, tf = tdf.deblend_and_predict(centers, transfer_dtype=transfer_dtype)
    _, jf = jdf.deblend_and_predict(centers, transfer_dtype=transfer_dtype)
    for key in ("residual_field", "predicted_mean_field", "predicted_stddev_field"):
        assert tf[key].dtype == np.float32
        _close(tf[key], jf[key], step)


def test_transfer_dtype_is_validated(nets):
    field, centers = _blob_field(seed=3)
    _, tdf = _pair(nets, field, 1)
    with pytest.raises(ValueError, match="transfer_dtype"):
        tdf.deblend_and_render(centers, transfer_dtype="int8")
    with pytest.raises(ValueError, match="transfer_dtype"):
        tdf.deblend_and_predict(centers, transfer_dtype="float64")


def test_serving_timings_accumulate_per_stage(nets):
    field, centers = _blob_field(seed=4)
    _, tdf = _pair(nets, field, 1)
    timings = {}
    tdf.deblend_and_render(centers, timings=timings)
    assert set(timings) == {"upload", "deblend_render", "field_download"}
    assert tdf.serving_timings is timings
    first = dict(timings)
    tdf.deblend_and_predict(centers, timings=timings)
    assert all(timings[k] > first[k] for k in first)
    tdf.deblend_and_render(centers)  # its own dict when none is passed
    assert tdf.serving_timings is not timings and "deblend_render" in tdf.serving_timings


def test_empty_field_returns(nets):
    """No source survives extraction: catalog None, the field back, zero
    predictions, as the JAX package returns them."""
    field, _ = _blob_field(seed=5)
    jdf, tdf = _pair(nets, field, 1)
    for centers in (np.zeros((0, 2), np.float32), np.array([[79.0, 0.0]], np.float32)):
        cat, res = tdf.deblend_and_render(centers)
        assert cat is None
        np.testing.assert_array_equal(res, field)
        cat, res, model = tdf.deblend_and_render(centers, return_model=True)
        jcat, jres, jmodel = jdf.deblend_and_render(centers, return_model=True)
        assert cat is None and jcat is None
        np.testing.assert_array_equal(res, jres)
        np.testing.assert_array_equal(model, jmodel)
        cat, fields = tdf.deblend_and_predict(centers)
        jcat, jfields = jdf.deblend_and_predict(centers)
        assert cat is None and jcat is None
        for key, want in jfields.items():
            if want is None:
                assert fields[key] is None
            else:
                np.testing.assert_array_equal(fields[key], want)
    assert tdf.nb_of_deblended_galaxies == [0] * 6 and tdf.nb_of_detected_objects == [0, 0, 0, 1, 1, 1]


def test_serving_with_a_nan_gap_stays_finite(nets):
    """A NaN pixel in one source's mse window: the forward sees it as 0,
    the rendered model stays finite, and that source fails the cuts, as on
    the JAX package."""
    field, centers = _blob_field(seed=6)
    field[0, 80, 83, 2] = np.nan  # inside source 1's centre window
    jdf, tdf = _pair(nets, field, 1)
    jcat, _, jmodel = jdf.deblend_and_render(centers, return_model=True)
    tcat, tres, tmodel = tdf.deblend_and_render(centers, return_model=True)
    assert np.isfinite(tmodel).all()
    np.testing.assert_array_equal(tcat.passed_cuts, jcat.passed_cuts)
    assert not tcat.passed_cuts[1] and tcat.passed_cuts[0]
    _close(tmodel, jmodel, 2e-5)
    assert np.isnan(tres[0, 80, 83, 2]) and np.isnan(tres).sum() == 1


@pytest.mark.parametrize("method", ["deblend_and_render", "deblend_and_predict", "deblend_field"])
def test_registration_is_not_ported_yet(nets, method):
    field, centers = _blob_field(seed=7)
    _, tdf = _pair(nets, field, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item: 2"):
        getattr(tdf, method)(centers, optimise_positions=True)


@pytest.mark.parametrize("kwargs", [{"upload_dtype": "bfloat16"}, {"device_dtype": "bfloat16"}])
def test_reduced_residency_is_not_ported_yet(nets, kwargs):
    field, _ = _blob_field(seed=7)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dtt.DeblendField(nets[1], field, device="cpu", **kwargs)


def test_get_deblending_meta_data_matches_jax(nets):
    field, centers = _blob_field(seed=8)
    jdf, tdf = _pair(nets, field, 1, chunk=8192)
    jdf.deblend_field(centers)
    tdf.deblend_field(centers)
    want, got = jdf.get_deblending_meta_data(), tdf.get_deblending_meta_data()
    assert list(got) == list(want)
    assert got["field_image"] is tdf.field_image
    for key in want:
        _close(got[key], want[key], 2e-5)


# ------------------------------------------------------- chunk cap, timer


def test_serving_chunk_cap_follows_the_budget():
    per, reserve = tfield._STREAM_BYTES_PER_SOURCE, tfield._STREAM_RESERVE_BYTES
    field_bytes = 4 * 1024 * 1024 * 6
    hbm = reserve + 2 * field_bytes + 1000 * per
    assert tfield._serving_chunk_cap(1024, 6, hbm) == 1000
    # one more resident canvas comes off the budget
    assert tfield._serving_chunk_cap(1024, 6, hbm, resident_fields=3) == 1000 - -(-field_bytes // per)
    # the whole card beside a 1024^2 field: far more than any source_chunk in use
    assert tfield._serving_chunk_cap(1024, 6, 80 << 30) > 8192
    # no room at all: the floor, never 0
    assert tfield._serving_chunk_cap(16384, 6, 1 << 30) == tfield._MIN_STREAM_CHUNK


def test_stream_chunk_on_the_cpu_is_the_configured_chunk(nets):
    field, _ = _blob_field(seed=9)
    _, tdf = _pair(nets, field, 1, chunk=7)
    assert tdf._stream_chunk(2) == 7
    assert dtt.PipelineConfig().serving_hbm_bytes is None
    assert dtt.PipelineConfig().render_cache_bytes == JaxPipelineConfig().render_cache_bytes == 1 << 30


def test_stage_timer_accumulates_and_survives_errors():
    times = {}
    with stage_timer(times, "a"):
        time.sleep(0.01)
    with stage_timer(times, "a", device="cpu"):
        time.sleep(0.01)
    assert times["a"] >= 0.02
    with pytest.raises(RuntimeError):
        with stage_timer(times, "b", device=torch.device("cpu")):
            raise RuntimeError("stage failed")
    assert times["b"] >= 0.0
