"""The port's row-band sharded serve (pipeline/sharded_field.py) and its
rectangular render and place held against the JAX package on the CPU.

The JAX ShardedFieldDeblender runs on JAX's 8 virtual CPU devices
(conftest.py), the port's on a mesh that repeats the CPU device D times,
with the same weights (weights.state_dict_from_flax) and the same seeded
fields: tests/test_sharded_field.py's, at its sizes (TINY, F = 192,
D = 4) and its tolerances (catalogue list_idx and passed_cuts equal,
mse_center rtol 1e-4, residual atol 2e-5).  Each case is also held
against the port's own single-device ``deblend_and_render``.  The forward
is deterministic (``z_mode='mean'``): threefry's draws are not torch's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import debvader_tpu_torch as dtt
from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
from debvader_tpu.models.vae import init_vae as jax_init_vae
from debvader_tpu.ops.shift import render_field as jax_render
from debvader_tpu.parallel.mesh import make_mesh as jax_make_mesh
from debvader_tpu.pipeline.sharded_field import ShardedFieldDeblender as JaxSharded
from debvader_tpu.pipeline.sharded_field import band_halo as jax_band_halo
from debvader_tpu.pipeline.tiles import detect_objects_tiled as jax_tiled
from debvader_tpu_torch.config import DetectionConfig, ModelConfig, PipelineConfig
from debvader_tpu_torch.kernels.render import place_corners, place_patches
from debvader_tpu_torch.ops.shift import render_field, render_pad
from debvader_tpu_torch.parallel import make_mesh
from debvader_tpu_torch.pipeline.sharded_field import ShardedFieldDeblender, band_halo
from debvader_tpu_torch.pipeline.tiles import detect_objects_tiled
from debvader_tpu_torch.weights import flatten_flax, state_dict_from_flax
from test_sharded_field import CS, TINY, B, D, F, _bright_field, _det_cfg, _field

torch.set_num_threads(1)

_TINY_KW = dict(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))


@functools.lru_cache(maxsize=None)
def _nets():
    """JAX's TINY net (init from PRNGKey(0)) and the port's copy of it."""
    jmodel = JaxVAE(TINY)
    variables = jax.jit(lambda key: jax_init_vae(jmodel, key))(jax.random.PRNGKey(0))
    net = dtt.DeblenderVAE(ModelConfig(**_TINY_KW)).eval()
    net.load_state_dict(state_dict_from_flax(flatten_flax(jax.tree_util.tree_map(np.asarray, variables)), net.cfg))
    return (jmodel, variables), net


def _mesh(d=D):
    return make_mesh(d, devices=["cpu"] * d)


def _cfgs(**kw):
    from debvader_tpu.config import PipelineConfig as JaxPipelineConfig

    kw = dict(cutout_size=CS, nb_of_bands=B, **kw)
    return JaxPipelineConfig(**kw), PipelineConfig(**kw)


def _pair(field, jkw=None, tkw=None, cfg=None, d=D, **kw):
    """(JAX sharded deblender, the port's) on the same field and options."""
    jnet, net = _nets()
    jc, tc = cfg or _cfgs()
    jsf = JaxSharded(jnet, field, jax_make_mesh(d), cutout_size=CS, nb_of_bands=B, cfg=jc, **kw, **(jkw or {}))
    tsf = ShardedFieldDeblender(net, field, _mesh(d), cutout_size=CS, nb_of_bands=B, cfg=tc, **kw, **(tkw or {}))
    return jsf, tsf


def _single(field, cfg=None, **kw):
    return dtt.DeblendField(_nets()[1], field, cutout_size=CS, nb_of_bands=B, cfg=cfg or _cfgs()[1],
                            z_mode="mean", device="cpu", **kw)


def _catalogs_agree(got, want, mse_rtol=1e-4):
    np.testing.assert_array_equal(got.list_idx, want.list_idx)
    np.testing.assert_array_equal(got.passed_cuts, want.passed_cuts)
    np.testing.assert_allclose(got.galaxy_distances_to_center_x, want.galaxy_distances_to_center_x)
    np.testing.assert_allclose(got.galaxy_distances_to_center_y, want.galaxy_distances_to_center_y)
    np.testing.assert_allclose(np.asarray(got.mse_center, np.float64), np.asarray(want.mse_center, np.float64),
                               rtol=mse_rtol)


@functools.lru_cache(maxsize=None)
def _served(seed, **kw):
    """(JAX, port, port single-device) deblend_and_render on _field(seed)."""
    field, centers = _field(seed=seed)
    jsf, tsf = _pair(field, z_mode="mean")
    return (jsf.deblend_and_render(centers, **kw), tsf.deblend_and_render(centers, **kw),
            _single(field).deblend_and_render(centers, **kw))


# ------------------------------------------------- rectangular render/place


def _rect_inputs(seed, n=9, s=11, b=3, fy=40, fx=70):
    rng = np.random.default_rng(seed)
    stamps = rng.uniform(0, 1, (n, s, s, b)).astype(np.float32)
    # offsets on a 1/64 grid: adding an integer keeps them exact
    offsets = (np.round(rng.uniform(-1, 1, (n, 2)) * np.array([fy / 2 + 8, fx / 2 + 8]) * 64) / 64).astype(np.float32)
    offsets[-1] = [500.0, 0.0]  # off the padded canvas: clipped and dropped
    mask = np.ones(n, bool)
    mask[1] = False
    return stamps, offsets, mask


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("shape", [(40, 70), (70, 40)], ids=["wide", "tall"])
def test_rectangular_render_matches_jax(order, shape):
    """render_field(..., (fy, fx), crop=False) against JAX's on a
    rectangle, at the tolerance the square case is held to against JAX
    (tests/test_torch_field.py): the padded canvas, ring included."""
    stamps, offsets, mask = _rect_inputs(1, fy=shape[0], fx=shape[1])
    want = np.asarray(jax_render(jnp.asarray(stamps), jnp.asarray(offsets), shape, jnp.asarray(mask), order=order,
                                 crop=False))
    got = render_field(torch.from_numpy(stamps), torch.from_numpy(offsets), shape, torch.from_numpy(mask),
                       order=order, crop=False)
    pad = render_pad(11, order)
    assert tuple(got.shape) == (shape[0] + 2 * pad, shape[1] + 2 * pad, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.5


@pytest.mark.parametrize("order", [1, 3])
def test_rectangular_render_is_the_square_render_rebased(order):
    """A (fy, fx) render's field is bit for bit the first fy rows of the
    square (fx, fx) render whose row offsets are moved by the integer
    difference of the two centres: the band re-base of the sharded
    serve."""
    fy, fx = 40, 70
    stamps, offsets, mask = _rect_inputs(2, fy=fy, fx=fx)
    rect = render_field(torch.from_numpy(stamps), torch.from_numpy(offsets), (fy, fx), torch.from_numpy(mask),
                        order=order)
    moved = offsets.copy()
    moved[:, 0] -= (fx - 11) // 2 - (fy - 11) // 2
    square = render_field(torch.from_numpy(stamps), torch.from_numpy(moved), fx, torch.from_numpy(mask),
                          order=order)
    assert tuple(rect.shape) == (fy, fx, 3) and rect.abs().max() > 0.5
    np.testing.assert_array_equal(rect.numpy(), square[:fy].numpy())


def test_rectangular_place_adds_each_patch_in_order():
    """The place step on a rectangular, row-strided canvas window: each
    patch added where it lands, in source order, bit for bit a numpy loop;
    a bfloat16 canvas stays square."""
    rng = np.random.default_rng(3)
    patches = rng.normal(size=(6, 13, 13, 2)).astype(np.float32)
    big = torch.from_numpy(rng.normal(size=(50, 90, 2)).astype(np.float32))
    canvas = big[5:45, 3:83]  # (40, 80, 2), rows strided
    int_off = torch.from_numpy(rng.integers(-20, 20, (6, 2)))
    mask = torch.tensor([True, True, False, True, True, True])
    y, x, visible = place_corners(int_off, mask, (40 - 26, 80 - 26), 11, 1, (40, 80))
    want = canvas.numpy().copy()
    for i in range(6):
        if visible[i]:
            want[y[i] : y[i] + 13, x[i] : x[i] + 13] += patches[i]
    place_patches(canvas, torch.from_numpy(patches), y, x, visible)
    np.testing.assert_array_equal(canvas.numpy(), want)
    with pytest.raises(ValueError, match="square"):
        render_field(torch.zeros(1, 11, 11, 2, dtype=torch.bfloat16), torch.zeros(1, 2), (40, 80))


# ------------------------------------------------------------ the serve


def test_band_geometry_and_ownership_match_jax():
    """The halo, the band height and each source's band (its truncated
    centre row: three sources straddle the band rows 48, 96 and 144)."""
    field, centers = _field()
    jsf, tsf = _pair(field)
    assert band_halo(CS, 3.0, 3) == jax_band_halo(CS, 3.0, 3) and band_halo(59, 3.0, 1) == jax_band_halo(59, 3.0, 1)
    assert (tsf.band_h, tsf.halo, tsf.h_pad, tsf.pad) == (jsf.band_h, jsf.halo, jsf.h_pad, jsf.pad)
    for a, b in zip(tsf._assign(centers), jsf._assign(centers)):
        np.testing.assert_array_equal(a, b)


def test_sharded_matches_jax_and_single_device():
    (jc, jr), (tc, tr), (sc, sr) = _served(0)
    assert tr.shape == (1, F, F, B)
    _catalogs_agree(tc, jc)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=2e-5)
    _catalogs_agree(tc, sc)
    np.testing.assert_allclose(tr, sr, rtol=0, atol=2e-5)
    assert np.abs(tr - _field()[0]).max() > 1e-3  # something was subtracted


def test_sharded_registered_matches_jax_and_single_device():
    (jc, jr), (tc, tr), (sc, sr) = _served(3, optimise_positions=True)
    for want, res in ((jc, jr), (sc, sr)):
        np.testing.assert_array_equal(tc.list_idx, want.list_idx)
        np.testing.assert_allclose(np.stack(list(tc.shifts)), np.stack(list(want.shifts)), atol=2e-3)
        np.testing.assert_allclose(tr, res, rtol=0, atol=2e-4)
    assert np.abs(np.stack(list(tc.shifts))).max() > 0


def test_sharded_return_model():
    (_, jr, jm), (tc, tr, tm), (_, sr, sm) = _served(5, return_model=True)
    np.testing.assert_allclose(tr[0] + tm, _field(seed=5)[0][0], atol=1e-5)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=2e-5)
    np.testing.assert_allclose(tm, sm, rtol=0, atol=2e-5)


def test_sharded_chunked_stream_matches_one_shot():
    """One source a band a chunk accumulates the same canvases."""
    (_, jr), (tc, tr), _ = _served(7)
    field, centers = _field(seed=7)
    _, tsf = _pair(field, z_mode="mean")
    cat, res = tsf.deblend_and_render(centers, source_chunk_per_band=1)
    np.testing.assert_array_equal(cat.list_idx, tc.list_idx)
    np.testing.assert_allclose(res, tr, rtol=0, atol=2e-5)
    np.testing.assert_allclose(res, jr, rtol=0, atol=2e-5)


def test_sharded_rejects_what_jax_rejects():
    halo = band_halo(CS, 3.0, 1)
    small = np.zeros((1, D * (halo - 1), D * (halo - 1), B), np.float32)
    with pytest.raises(ValueError, match="halo"):
        ShardedFieldDeblender(_nets()[1], small, _mesh(), cutout_size=CS, nb_of_bands=B, cfg=_cfgs()[1])
    field, _ = _field()
    with pytest.raises(ValueError, match="halo=3 is below"):
        ShardedFieldDeblender(_nets()[1], field, _mesh(), cutout_size=CS, nb_of_bands=B, cfg=_cfgs()[1], halo=3)
    with pytest.raises(ValueError, match="n_devices=5"):
        make_mesh(5)


def test_sharded_no_sources():
    field, _ = _field(seed=9, n_src=1)
    centers = np.asarray([[-(F // 2) + 1, 0.0]], np.float32)
    _, tsf = _pair(field)
    cat, residual = tsf.deblend_and_render(centers)
    assert cat is None
    np.testing.assert_array_equal(residual, field)


def test_sharded_detection_matches_tiled_and_jax():
    """Band-tiled detection: the same centres as the port's and JAX's
    tiled detection of the whole field, and as JAX's band-tiled one."""
    field, _ = _bright_field()
    cfgs = _cfgs(tile_size=64, tile_overlap=16)
    jsf, tsf = _pair(field, cfg=cfgs)
    tdet = DetectionConfig(thresh=25.0, background_box=32, detection_band=0)
    got = tsf.detect_objects(tdet)
    assert len(got) == 4
    key = lambda a: np.asarray(sorted(map(tuple, a)))  # noqa: E731
    np.testing.assert_array_equal(key(got), key(jsf.detect_objects(_det_cfg())))
    np.testing.assert_array_equal(key(got), key(detect_objects_tiled(field, tdet, tile=64, overlap=16,
                                                                      device="cpu")))
    np.testing.assert_array_equal(key(got), key(jax_tiled(field, _det_cfg(), tile=64, overlap=16)))


def test_sharded_iterative_single_step_matches_one_shot():
    field, centers = _bright_field(seed=2)
    cfgs = _cfgs(tile_size=64, tile_overlap=16)
    _, tsf = _pair(field, cfg=cfgs, z_mode="mean")
    cat1, res1 = tsf.deblend_and_render(centers)
    _, tsf2 = _pair(field, cfg=cfgs, z_mode="mean")
    cat2, res2 = tsf2.iterative_deblend_and_render(centers, max_iterations=1)
    np.testing.assert_allclose(res2, res1, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(cat1.list_idx, cat2.list_idx)
    assert (cat2.iteration == 0).all() and len(tsf2.mse) == 1 and np.isfinite(tsf2.mse[0])
    np.testing.assert_array_equal(tsf2.field_image, field)  # the running residual is a copy


def test_sharded_iterative_until_it_ends_matches_jax():
    """Detection on the sharded field, then on the sharded residual, until
    a step finds no more than the last: JAX's steps, catalogue and
    residual."""
    field, _ = _bright_field(seed=4)
    cfgs = _cfgs(tile_size=64, tile_overlap=16)
    jsf, tsf = _pair(field, cfg=cfgs, z_mode="mean")
    jc, jr = jsf.iterative_deblend_and_render(det_cfg=_det_cfg())
    t = {}
    tc, tr = tsf.iterative_deblend_and_render(det_cfg=DetectionConfig(thresh=25.0, background_box=32,
                                                                     detection_band=0), timings=t)
    np.testing.assert_array_equal(tc.iteration, jc.iteration)
    _catalogs_agree(tc, jc)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=2e-5)
    np.testing.assert_allclose(tsf.mse, jsf.mse, rtol=1e-4)
    assert set(t) == {"upload", "detect", "deblend_render", "subtract", "field_download"}


def test_sharded_measure_matches_jax_and_single_device():
    (jc, _), (tc, _), (sc, _) = _served(11, measure=True)
    for col in ("flux", "snr", "ellipticity"):
        for want in (jc, sc):
            np.testing.assert_allclose(np.stack(list(tc[col])), np.stack(list(want[col])), rtol=1e-4, atol=1e-6)


def test_sharded_predict_matches_jax_and_single_device():
    """The mean and stddev fields and the residual of deblend_and_predict;
    the epistemic field is sampled (band-local draws), so it is held
    statistically to the single-device one."""
    field, centers = _field(seed=13)
    jsf, tsf = _pair(field, z_mode="mean", epistemic_uncertainty_estimation=True)
    _, jf = jsf.deblend_and_predict(centers)
    cat, tf = tsf.deblend_and_predict(centers)
    _, sf = _single(field, epistemic_uncertainty_estimation=True).deblend_and_predict(centers)
    for key in ("predicted_mean_field", "predicted_stddev_field", "residual_field"):
        np.testing.assert_allclose(tf[key], jf[key], rtol=0, atol=2e-5)
        np.testing.assert_allclose(tf[key], sf[key], rtol=0, atol=2e-5)
    epi = tf["predicted_epistemic_field"]
    assert np.isfinite(epi).all() and epi.max() > 0
    np.testing.assert_allclose(epi.sum(), sf["predicted_epistemic_field"].sum(), rtol=0.5)
    norms = np.asarray(cat.epistemic_norm, np.float32)
    assert np.isfinite(norms).all() and (norms > 0).all()


def test_sharded_epistemic_normalise_bracket():
    """normalise=True with epistemic sampling: the band-local statistics
    apply the bracket once, and the per-source epistemic_norm agrees with
    the single-device stream's within sampling noise."""
    field, centers = _field(seed=17, n_src=6)
    cfgs = _cfgs(epistemic_samples=32)
    _, tsf = _pair(field, cfg=cfgs, z_mode="mean", normalise=True, epistemic_uncertainty_estimation=True)
    b = np.asarray(tsf.deblend_and_render(centers)[0].epistemic_norm, np.float32)
    a = np.asarray(_single(field, cfg=cfgs[1], normalise=True, epistemic_uncertainty_estimation=True)
                   .deblend_and_render(centers)[0].epistemic_norm, np.float32)
    assert np.isfinite(b).all() and (b > 0).all()
    np.testing.assert_allclose(b, a, rtol=0.6)


def test_residency_report_matches_formula():
    """JAX's formula, (band_h + 2 halo) x F x B x 4 bytes of field a band
    and the matching canvas, against the live tensors; on a mesh that
    repeats the CPU, that device holds the sum over the bands."""
    field, _ = _field()
    jsf, tsf = _pair(field)
    rep, jrep = tsf.residency_report(), jsf.residency_report()
    for key in ("field_bytes_per_device", "predicted_field_bytes", "canvas_bytes_per_device",
                "predicted_canvas_bytes"):
        assert rep[key] == jrep[key], key
    assert rep["field_bytes_per_device"] == rep["predicted_field_bytes"] == tsf.h_pad * F * B * 4
    assert rep["canvas_bytes_per_device"] == rep["predicted_canvas_bytes"]
    assert rep["per_shard"] == [rep["field_bytes_per_device"] + rep["canvas_bytes_per_device"]] * D
    assert rep["per_device"] == {"cpu": D * (rep["field_bytes_per_device"] + rep["canvas_bytes_per_device"])}


def test_sharded_timings_instrumented():
    field, centers = _field()
    _, tsf = _pair(field, z_mode="mean")
    t = {}
    assert tsf.deblend_and_render(centers, timings=t)[0] is not None
    assert set(t) == {"upload", "deblend_render", "cutouts", "forward", "render", "field_download", "catalog",
                      "residual_copy"} and min(t.values()) >= 0
    assert t["cutouts"] + t["forward"] + t["render"] <= t["deblend_render"]
    assert tsf.serving_timings is t
    # the bands' detection counts its masked pixels and, for the watershed
    # merge, the saddle edges built on each band's device (not under 'lutz')
    counters = {"count.masked_px", "count.saddle_pairs", "count.segment_edges"}
    for algo, want in (("watershed", counters), ("lutz", {"count.masked_px"})):
        found = {}
        tsf.detect_objects(dtt.DetectionConfig(deblend_algo=algo), tile=48, overlap=16, timings=found)
        assert {k for k in found if k.startswith("count.")} == want and all(found[k] > 0 for k in want)


def test_sharded_one_band_is_the_four_band_catalogue():
    """A one-band mesh serves the same catalogue, and a residual within
    float reassociation of the four-band one."""
    (_, _), (tc, tr), _ = _served(0)
    field, centers = _field()
    one = ShardedFieldDeblender(_nets()[1], field, _mesh(1), cutout_size=CS, nb_of_bands=B, cfg=_cfgs()[1],
                                z_mode="mean")
    c1, r1 = one.deblend_and_render(centers)
    for col in tc.dtype.names:
        if col != "shifts":
            np.testing.assert_array_equal(c1[col], tc[col])
    np.testing.assert_allclose(r1, tr, rtol=0, atol=2e-5)


def test_sharded_quantized_matches_jax_and_single_device():
    """int8 with field sharding: each band runs the int8 forward on its own
    copy of the bundle; the catalogue and residual of JAX's sharded int8
    serve and of the port's single-device DeblendField(quantized=); a
    normalise-mismatched bundle is refused."""
    from test_torch_quantized import _bundles, _tiny

    jmodel, variables, tmodel, _ = _tiny()
    jqv, tqv = _bundles("per_tensor")
    field, centers = _field(seed=7)
    jc, tc = _cfgs()
    jsf = JaxSharded((jmodel, variables), field, jax_make_mesh(D), cutout_size=CS, nb_of_bands=B, cfg=jc,
                     z_mode="mean", quantized=jqv)
    tsf = ShardedFieldDeblender(tmodel, field, _mesh(), cutout_size=CS, nb_of_bands=B, cfg=tc, z_mode="mean",
                                quantized=tqv)
    single = dtt.DeblendField(tmodel, field, cutout_size=CS, nb_of_bands=B, cfg=tc, z_mode="mean", device="cpu",
                              quantized=tqv)
    cat, res = tsf.deblend_and_render(centers)
    for want_cat, want_res in (jsf.deblend_and_render(centers), single.deblend_and_render(centers)):
        np.testing.assert_array_equal(cat.list_idx, want_cat.list_idx)
        np.testing.assert_allclose(cat.mse_center, want_cat.mse_center, rtol=1e-4)
        np.testing.assert_allclose(res, want_res, rtol=0, atol=2e-5)
    floating = ShardedFieldDeblender(tmodel, field, _mesh(), cutout_size=CS, nb_of_bands=B, cfg=tc, z_mode="mean")
    assert np.abs(res - floating.deblend_and_render(centers)[1]).max() > 1e-4
    with pytest.raises(ValueError, match="normalise"):
        ShardedFieldDeblender(tmodel, field, _mesh(), cutout_size=CS, nb_of_bands=B, cfg=tc, normalise=True,
                              quantized=tqv)
