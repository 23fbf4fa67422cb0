"""The PyTorch port's scene pipeline held against the JAX package on the
CPU: extraction, the order-1 and order-3 renders, and DeblendField's
deblend_field / get_residual_field with the sim_demo weights.

Float tolerances: both sides run float32 on the CPU.  The renders differ
by summation order (the spline prefilter's init is a dot product; the
scatter adds overlapping patches in another order), bounded here by 1e-5
of the stamps' scale; model outputs by 2e-5 of their scale, as in
tests/test_torch_model.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import debvader_tpu_torch as dtt
from debvader_tpu.ops.extraction import extract_cutouts as jax_extract
from debvader_tpu.ops.shift import render_field as jax_render
from debvader_tpu.ops.spline import spline_prefilter as jax_prefilter
from debvader_tpu_torch.ops.extraction import extract_cutouts, extract_cutouts_np
from debvader_tpu_torch.ops.shift import render_field
from debvader_tpu_torch.ops.spline import spline_prefilter

torch.set_num_threads(1)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _blob_field(size=160, bands=6, seed=0):
    """A seeded field of Gaussian galaxies with a band SED, and their
    offsets from the field centre."""
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


def test_spline_prefilter_matches_jax():
    img = np.random.default_rng(1).normal(size=(3, 21, 17, 2)).astype(np.float32)
    got = spline_prefilter(torch.from_numpy(img)).numpy()
    want = np.stack([np.asarray(jax_prefilter(jnp.asarray(im))) for im in img])
    _close(got, want, 1e-6)


def test_extract_cutouts_matches_jax():
    field, _ = _blob_field(seed=2)
    centers = np.array([[0.0, 0.0], [-2.7, 5.9], [60.0, 0.0], [-51.0, -51.0], [51.0, 51.0]], np.float32)
    got, valid = extract_cutouts(torch.from_numpy(field), centers, 59)
    want, wvalid = jax_extract(jnp.asarray(field), 160, centers, 59)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    host, hvalid = extract_cutouts_np(field, centers, 59)
    np.testing.assert_array_equal(host, np.asarray(want))
    np.testing.assert_array_equal(hvalid, np.asarray(wvalid))


@pytest.mark.parametrize("order", [1, 3])
def test_render_field_matches_jax(order):
    """Fractional and negative offsets, overlapping stamps, a masked
    source, a stamp hanging off the field edge and one entirely off the
    padded canvas (clipped and dropped, never wrapped)."""
    rng = np.random.default_rng(3)
    stamps = rng.uniform(0, 1, (6, 21, 21, 2)).astype(np.float32)
    offsets = np.array(
        [[0.0, 0.0], [3.3, -2.6], [-7.5, 8.25], [30.2, -4.9], [500.0, 0.0], [1.5, 1.5]], np.float32
    )
    mask = np.array([True, True, True, True, True, False])
    want = np.asarray(jax_render(jnp.asarray(stamps), jnp.asarray(offsets), 64, jnp.asarray(mask), order=order))
    got = render_field(torch.from_numpy(stamps), torch.from_numpy(offsets), 64, torch.from_numpy(mask), order=order)
    _close(got.numpy(), want, 1e-5)
    assert np.abs(want).max() > 0.5


@pytest.fixture(scope="module")
def nets():
    import debvader_tpu as dt

    return dt.load_deblender("sim_demo"), dtt.load_deblender("sim_demo", device="cpu")


def test_deblend_field_and_residual_match_jax(nets):
    import debvader_tpu as dt

    jnet, tnet = nets
    field, centers = _blob_field()
    jdf = dt.DeblendField(jnet, field, z_mode="mean")
    tdf = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu")
    want = jdf.deblend_field(centers)
    got = tdf.deblend_field(centers)
    assert got.dtype == want.dtype
    assert len(got) == len(want) == 5  # the source at (70, 0) leaves the field
    for col in ("list_idx", "galaxy_distances_to_center_x", "galaxy_distances_to_center_y", "passed_cuts"):
        np.testing.assert_array_equal(got[col], want[col])
    for i in range(len(got)):
        np.testing.assert_array_equal(got.cutout_images[i], want.cutout_images[i])
        np.testing.assert_array_equal(got.shifts[i], want.shifts[i])
        np.testing.assert_array_equal(got.epistemic_uncertainty[i], want.epistemic_uncertainty[i])
    _close(np.stack(list(got.output_images_mean)), np.stack(list(want.output_images_mean)), 2e-5)
    _close(np.stack(list(got.output_images_stddev)), np.stack(list(want.output_images_stddev)), 2e-5)
    _close(tdf.get_residual_field(), jdf.get_residual_field(), 2e-5)
    tpred = tdf.get_predicted_field()
    jpred = jdf.get_predicted_field()
    for key in ("predicted_mean_field", "predicted_stddev_field"):
        _close(tpred[key], jpred[key], 2e-5)


def test_deblend_field_sample_mode_is_seeded(nets):
    _, tnet = nets
    field, centers = _blob_field(seed=4)
    a = dtt.DeblendField(tnet, field, device="cpu").deblend_field(centers)
    b = dtt.DeblendField(tnet, field, device="cpu").deblend_field(centers)
    np.testing.assert_array_equal(np.stack(list(a.output_images_mean)), np.stack(list(b.output_images_mean)))


def test_given_cutouts_skip_extraction(nets):
    _, tnet = nets
    field, centers = _blob_field(seed=8)
    df = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu")
    first = df.deblend_field(centers)
    cutouts = np.stack(list(first.cutout_images))
    again = df.deblend_field(centers[first.list_idx], cutout_images=cutouts)
    np.testing.assert_array_equal(again.list_idx, np.arange(len(cutouts)))
    np.testing.assert_array_equal(
        np.stack(list(again.output_images_mean)), np.stack(list(first.output_images_mean))
    )


def test_no_valid_source_returns_empty_and_the_field(nets):
    _, tnet = nets
    field, _ = _blob_field(seed=5)
    df = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu")
    res = df.deblend_field(np.array([[79.0, 0.0]]))
    assert isinstance(res, dict) and res["list_idx"] is None
    np.testing.assert_array_equal(df.get_residual_field(), field)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"epistemic_uncertainty_estimation": True},
        {"mesh": object()},
        {"quantized": object()},
        {"artifact": b"x"},
    ],
)
def test_unported_constructor_options_raise(nets, kwargs):
    _, tnet = nets
    field, _ = _blob_field(seed=6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dtt.DeblendField(tnet, field, device="cpu", **kwargs)


@pytest.mark.parametrize("method", ["deblend_field", "deblend_and_render"])
def test_unported_deblend_options_raise(nets, method):
    _, tnet = nets
    field, centers = _blob_field(seed=7)
    df = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(df, method)(centers, optimise_positions=True)


def test_deblend_field_measure_matches_jax(nets):
    """measure=True appends flux, centroid, ellipticity and snr columns of
    the deblended means: dtype equal, values within 1e-4 of each column's
    scale (float32 sums of ~2e4 terms over model outputs that differ by
    2e-5 of theirs)."""
    import debvader_tpu as dt

    jnet, tnet = nets
    field, centers = _blob_field(seed=9)
    want = dt.DeblendField(jnet, field, z_mode="mean").deblend_field(centers, measure=True)
    got = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu").deblend_field(centers, measure=True)
    assert got.dtype == want.dtype
    assert got.dtype.names[-4:] == ("flux", "centroid", "ellipticity", "snr")
    for col in got.dtype.names[-4:]:
        _close(np.stack(list(got[col])), np.stack(list(want[col])), 1e-4)


def test_source_chunk_recursion_matches_jax(nets):
    """More sources than source_chunk: extraction, forward and cuts run
    chunk by chunk, list_idx is shifted by each chunk's start, the counters
    collapse to one entry a call, and the merged record array equals the
    JAX package's."""
    import debvader_tpu as dt
    from debvader_tpu.config import PipelineConfig as JaxPipelineConfig

    jnet, tnet = nets
    field, centers = _blob_field(seed=10)
    centers = np.concatenate([centers[5:], centers[:5]])  # the invalid source leads
    jdf = dt.DeblendField(jnet, field, z_mode="mean", cfg=JaxPipelineConfig(source_chunk=2))
    tdf = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu", cfg=dtt.PipelineConfig(source_chunk=2))
    want = jdf.deblend_field(centers)
    got = tdf.deblend_field(centers)
    assert got.dtype == want.dtype and isinstance(got, np.recarray)
    np.testing.assert_array_equal(got.list_idx, want.list_idx)
    np.testing.assert_array_equal(got.list_idx, [1, 2, 3, 4, 5])
    np.testing.assert_array_equal(got.passed_cuts, want.passed_cuts)
    assert tdf.nb_of_detected_objects == jdf.nb_of_detected_objects == [6]
    assert tdf.nb_of_deblended_galaxies == jdf.nb_of_deblended_galaxies == [5]
    _close(np.stack(list(got.output_images_mean)), np.stack(list(want.output_images_mean)), 2e-5)
    assert tdf._render_cache is None  # chunked results live on the host only
    _close(tdf.get_residual_field(), jdf.get_residual_field(), 2e-5)
    # one whole call gives the same stamps
    whole = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu").deblend_field(centers)
    np.testing.assert_allclose(
        np.stack(list(got.output_images_mean)), np.stack(list(whole.output_images_mean)), rtol=0, atol=1e-6
    )


def test_source_chunk_recursion_with_no_survivor_returns_empty(nets):
    _, tnet = nets
    field, _ = _blob_field(seed=10)
    df = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu", cfg=dtt.PipelineConfig(source_chunk=2))
    res = df.deblend_field(np.array([[79.0, 0.0], [0.0, 79.0], [-79.0, 0.0]]))
    assert isinstance(res, dict) and res["list_idx"] is None
    assert df.nb_of_detected_objects == [3] and df.nb_of_deblended_galaxies == [0]


def test_device_field_memo_invalidates_on_mutation(nets):
    """An in-place edit of field_image, even of one pixel or sum-neutral,
    uploads again; an unchanged field, NaNs included, is served from the
    memo."""
    _, tnet = nets
    field, centers = _blob_field(seed=11)
    df = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu")
    dev1 = df._device_field(df.field_image)
    assert df._device_field(df.field_image) is dev1
    df.field_image[0, 7, 11, 1] += 0.5
    dev2 = df._device_field(df.field_image)
    assert dev2 is not dev1
    assert dev2[0, 7, 11, 1].item() == df.field_image[0, 7, 11, 1]
    a, b = df.field_image[0, 3, 3, 0], df.field_image[0, 3, 4, 0]
    df.field_image[0, 3, 3, 0], df.field_image[0, 3, 4, 0] = b, a  # a swap keeps the sum
    dev3 = df._device_field(df.field_image)
    assert dev3 is not dev2 and dev3[0, 3, 3, 0].item() == b
    df.field_image[0, 2, 2, :] = np.nan
    dev4 = df._device_field(df.field_image)
    assert df._device_field(df.field_image) is dev4
    # the serving path reads the edited field
    _, residual = df.deblend_and_render(centers)
    assert np.isnan(residual[0, 2, 2]).all()


def test_render_cache_invalidates_on_stamp_edit(nets):
    """Editing a stamp of the returned record array in place is honoured
    by the next render: the device copies are served by identity and
    content checksum, not identity alone."""
    _, tnet = nets
    field, centers = _blob_field(seed=12)
    df = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu", cfg=dtt.PipelineConfig(interp_order=1))
    res = df.deblend_field(centers)
    assert df._render_cache is not None
    assert df._stacked(res, "output_images_mean") is df._render_cache["stamps"]["output_images_mean"]
    base = df.get_residual_field(res)
    np.testing.assert_array_equal(df.get_residual_field(res), base)
    res[1]["output_images_mean"][...] = 0.0  # in place, same cell, same array
    assert df._stacked(res, "output_images_mean") is not df._render_cache["stamps"]["output_images_mean"]
    edited = df.get_residual_field(res)
    assert not np.array_equal(edited, base)
    df.drop_render_cache()
    assert df._render_cache is None
    np.testing.assert_array_equal(df.get_residual_field(res), edited)
    # another record array never gets the cached stamps
    df.deblend_field(centers)
    np.testing.assert_array_equal(df.get_residual_field(res), edited)


def test_render_cache_respects_its_byte_cap(nets):
    _, tnet = nets
    field, centers = _blob_field(seed=12)
    cfg = dtt.PipelineConfig(render_cache_bytes=1000)
    df = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu", cfg=cfg)
    res = df.deblend_field(centers)
    assert df._render_cache is None
    full = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu")
    full.deblend_field(centers)
    np.testing.assert_array_equal(df.get_residual_field(res), full.get_residual_field())
