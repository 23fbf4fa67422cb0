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


# (the upload_dtype case, kwargs0, went when upload_dtype was ported:
# tests/test_torch_residency.py holds it against JAX; the quantized case,
# kwargs2, went when quantized serving was ported:
# tests/test_torch_quantized.py holds DeblendField(quantized=) against JAX;
# the artifact case, kwargs3, went when export was ported:
# tests/test_torch_export.py holds DeblendField(artifact=) against the live
# route; the mesh case, kwargs1, went when the mesh was ported: it is the
# parity test below, tests/test_torch_parallel.py holds the rest)
@pytest.mark.parametrize("n_shards", [1, 4])
def test_mesh_option_matches_jax_and_single_device(nets, n_shards):
    """DeblendField(mesh=) at full width: the record array and its residual
    against JAX's DeblendField(mesh=) on its virtual devices (z_mode='mean')
    and against the port's single-device route, which it matches to float
    reassociation."""
    import debvader_tpu as dt
    from debvader_tpu.parallel import make_mesh as jax_make_mesh

    from debvader_tpu_torch.parallel import make_mesh

    jnet, tnet = nets
    field, centers = _blob_field(seed=6)
    jdf = dt.DeblendField(jnet, field, z_mode="mean", mesh=jax_make_mesh(n_shards))
    tdf = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu", mesh=make_mesh(n_shards, devices=["cpu"] * n_shards))
    single = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu")
    got = tdf.deblend_field(centers)
    for want, df, tol in ((jdf.deblend_field(centers), jdf, 2e-5), (single.deblend_field(centers), single, 1e-6)):
        assert len(got) == len(want) == 5
        np.testing.assert_array_equal(got.list_idx, want.list_idx)
        np.testing.assert_array_equal(got.passed_cuts, want.passed_cuts)
        _close(np.stack(list(got.output_images_mean)), np.stack(list(want.output_images_mean)), tol)
        _close(np.stack(list(got.output_images_stddev)), np.stack(list(want.output_images_stddev)), tol)
        _close(tdf.get_residual_field(), df.get_residual_field(), tol)


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


def test_deblend_field_epistemic_columns_and_cuts(nets):
    """epistemic_uncertainty_estimation=True fills the record array's
    epistemic_uncertainty column with the spread of cfg.epistemic_samples
    stochastic decodes (always drawn, also under z_mode='mean'), applies
    epistemic_criterion to its r-band norm, and get_predicted_field renders
    it.  The JAX package gives the column layout; its threefry draws cannot
    be matched, so the values are held to the port's own sampling API on
    the same generator state."""
    import debvader_tpu as dt
    from debvader_tpu.config import PipelineConfig as JaxPipelineConfig
    from debvader_tpu_torch.api import sample_stats_tensor

    jnet, tnet = nets
    field, centers = _blob_field(seed=9)
    cfg = dtt.PipelineConfig(epistemic_samples=4)

    def make(seed=3):
        return dtt.DeblendField(
            tnet, field, epistemic_uncertainty_estimation=True, z_mode="mean", cfg=cfg,
            generator=torch.Generator().manual_seed(seed), device="cpu",
        )

    tdf = make()
    got = tdf.deblend_field(centers)
    jdf = dt.DeblendField(
        jnet, field, epistemic_uncertainty_estimation=True, z_mode="mean", cfg=JaxPipelineConfig(epistemic_samples=2)
    )
    want = jdf.deblend_field(centers)
    assert got.dtype == want.dtype and len(got) == len(want) == 5
    epi = np.stack(list(got.epistemic_uncertainty))
    jepi = np.stack(list(want.epistemic_uncertainty))
    assert epi.shape == jepi.shape == (5, 59, 59, 6) and epi.dtype == jepi.dtype
    assert np.isfinite(epi).all() and (epi >= 0).all() and epi.max() > 0
    # same order of magnitude as the JAX package's own draws
    assert 0.2 < epi.mean() / jepi.mean() < 5.0

    cutouts = torch.from_numpy(np.stack(list(got.cutout_images)))
    _, std = sample_stats_tensor(tnet, cutouts, 4, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(epi, std.numpy())

    means = np.stack(list(got.output_images_mean))
    epi_norm = epi[..., 2].sum(axis=(1, 2)) / np.maximum(means[..., 2].sum(axis=(1, 2)), 1e-30)
    assert got.passed_cuts.all()
    crit = float(np.sort(epi_norm)[2])  # two sources lie above it
    cut = make().deblend_field(centers, epistemic_criterion=crit)
    np.testing.assert_array_equal(cut.passed_cuts, ~(epi_norm > crit))
    assert cut.passed_cuts.sum() == 3

    pred = tdf.get_predicted_field()
    offsets = np.stack([got.galaxy_distances_to_center_x, got.galaxy_distances_to_center_y], -1).astype(np.float32)
    rendered = render_field(torch.from_numpy(epi), torch.from_numpy(offsets), 160, order=3)
    _close(pred["predicted_epistemic_field"], rendered.numpy(), 1e-6)
    assert pred["predicted_epistemic_field"].max() > 0
    # served from the stamps kept on the device, and from the host copies alike
    tdf.drop_render_cache()
    _close(tdf.get_predicted_field()["predicted_epistemic_field"], rendered.numpy(), 1e-6)
    # without the option the column and the canvas stay zero
    plain = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu")
    assert not np.stack(list(plain.deblend_field(centers).epistemic_uncertainty)).any()
    assert not plain.get_predicted_field()["predicted_epistemic_field"].any()


def test_epistemic_draws_are_seeded_and_chunked(nets):
    """Without a generator the object seeds one with 0, so two objects
    agree; source_chunk smaller than the batch changes the replica chunks
    (and so the draws), not the shapes."""
    _, tnet = nets
    field, centers = _blob_field(seed=10)

    def run(**kw):
        cfg = dtt.PipelineConfig(epistemic_samples=3, **kw)
        df = dtt.DeblendField(tnet, field, epistemic_uncertainty_estimation=True, z_mode="mean", cfg=cfg, device="cpu")
        assert df.generator is not None
        return np.stack(list(df.deblend_field(centers).epistemic_uncertainty))

    a, b = run(), run()
    np.testing.assert_array_equal(a, b)
    c = run(source_chunk=2)
    assert c.shape == a.shape and np.isfinite(c).all() and c.max() > 0
