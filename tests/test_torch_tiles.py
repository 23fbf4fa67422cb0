"""The port's tiled detection and the servers built on it held against the
JAX package on the CPU: ``detect_sources_batched`` (fused and chain cores,
with and without label maps, watershed and Lutz), ``tile_origins``,
``detect_objects_tiled`` (host, device-resident and bfloat16 fields, one
tile, a source on a seam), ``TiledDeblendField`` and
``IterativeDeblendField.iterative_deblend_and_render`` with the sim_demo
weights and z_mode='mean'.

The JAX side runs its fused core in interpret mode (``use_pallas_fused=True``,
as on a TPU) or its XLA chain (``use_pallas_fused=False``), beside the
port's plain versions.  Integer outputs (labels, peaks, areas, detected
offsets, list_idx, iteration) are equal; detection's floats within rtol
1e-6, except the fluxes of default-threshold noise peaks (see
``FLUX_RTOL_DEFAULT``); the deblended fields within 2e-5 of their scale and
``mse_center`` / ``self.mse`` within rtol 1e-5, the tolerances of the
float32 serving tests (tests/test_torch_serving.py).  bfloat16 residency is
held to the one-ulp / 0.1% share rule of tests/test_torch_residency.py,
with its failing control.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_residency import _control_fails, _ulp_agreement

import debvader_tpu as dt
import debvader_tpu_torch as dtt
from debvader_tpu.config import DetectionConfig as JaxDetectionConfig
from debvader_tpu.config import PipelineConfig as JaxPipelineConfig
from debvader_tpu.ops import detection as jd
from debvader_tpu.pipeline import tiles as jtiles
from debvader_tpu.pipeline.iterative import IterativeDeblendField as JaxIterative
from debvader_tpu_torch.config import DetectionConfig
from debvader_tpu_torch.ops import detection as td
from debvader_tpu_torch.pipeline import tiles as ttiles

torch.set_num_threads(1)

# The serving threshold of chip_smoke.py: one detection a galaxy.
SERVING = dict(thresh=5.0, threshold_scaling="matched")
# At the default threshold (1.5 x rms, noise peaks included) the fluxes of
# a few faint noise peaks differ from JAX's by more than 1e-6: read 2.6e-6
# (a 5-pixel peak of flux 0.45).  The port's background map and rms differ
# from JAX's in the last bits (the bilinear upsample and the clipped std sum
# in another order; tests/test_torch_detection.py holds the maps to 1e-6 of
# their scale), which moves such a peak's filtered values.  Held to the
# reading; a filtered map rounded to bfloat16 fails it.
FLUX_RTOL_DEFAULT = 3e-6


def _field(f, seed, nsrc=12, noise=0.05):
    rng = np.random.default_rng(seed)
    img = noise * rng.normal(size=(f, f)) + 0.01
    yy, xx = np.mgrid[:f, :f]
    for _ in range(nsrc):
        cy, cx = rng.uniform(4, f - 4, 2)
        s = rng.uniform(1.2, 3.0)
        img += rng.uniform(0.3, 3.0) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def _stack():
    return np.stack([_field(128, s) for s in (1, 2, 3)])


def _scene(size=192, bands=6, seed=0, noise=0.02, n=10):
    """(1, size, size, bands): n Gaussian galaxies with a band SED over
    noise, the first on the seam of 128-pixel tiles overlapping by 32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    f = noise * rng.normal(size=(size, size, bands))
    pos = rng.uniform(-60, 60, (n, 2))
    pos[0] = (96 - size // 2 + 0.3, 10.0)
    for cy, cx in pos:
        s = rng.uniform(1.5, 3.0)
        sed = np.exp(rng.uniform(-0.15, 0.15) * np.arange(bands))
        prof = np.exp(-((yy - size // 2 - cy) ** 2 + (xx - size // 2 - cx) ** 2) / (2 * s * s))
        f += rng.uniform(0.5, 2.0) * prof[..., None] * sed
    return f[None].astype(np.float32)


def _jcfg(**kw):
    return JaxDetectionConfig(use_pallas_fused=kw.pop("use_pallas_fused", True), **kw)


def _catalogs_equal(got, want, flux_rtol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w["labels"] is None:
            assert g["labels"] is None
        else:
            np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["peak_yx"], w["peak_yx"])
        np.testing.assert_array_equal(g["area"], w["area"])
        np.testing.assert_allclose(g["globalrms"], w["globalrms"], rtol=1e-6)
        for key in ("y", "x"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6)
        np.testing.assert_allclose(g["flux"], w["flux"], rtol=flux_rtol)


# ------------------------------------------------------ batched detection


# The batched core's switches: the fused core, the chain, and
# ``use_pallas_filter`` (a single-field kernel), which the batched path
# routes to the fused core unless the fused core is switched off.
CORES = {
    "fused": {"use_pallas_fused": True},
    "chain": {"use_pallas_fused": False},
    "filter": {"use_pallas_filter": True},
    "fused+filter": {"use_pallas_fused": True, "use_pallas_filter": True},
    "chain+filter": {"use_pallas_fused": False, "use_pallas_filter": True},
}


@pytest.mark.parametrize("algo", ["watershed", "lutz"])
@pytest.mark.parametrize("want_map", [True, False])
@pytest.mark.parametrize("core", list(CORES))
def test_detect_sources_batched_equals_jax(core, want_map, algo):
    """A 3-tile stack at the serving threshold: every tile's catalog (and
    label map) as JAX's, on the fused core, on the chain and under
    ``use_pallas_filter``."""
    tiles = _stack()
    kw = dict(SERVING, deblend_algo=algo, **CORES[core])
    want = jd.detect_sources_batched(tiles, _jcfg(**kw), want_map=want_map)
    got = td.detect_sources_batched(tiles, DetectionConfig(**kw), want_map=want_map, device="cpu")
    assert min(len(w["y"]) for w in want) > 5
    _catalogs_equal(got, want)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chain"])
def test_detect_sources_batched_at_the_default_threshold(fused):
    """Hundreds of noise peaks a tile: the integer columns equal, the
    centroids within 1e-6, the fluxes within FLUX_RTOL_DEFAULT; the
    control (the port's filtered values rounded to bfloat16) fails that."""
    tiles = _stack()
    want = jd.detect_sources_batched(tiles, _jcfg(use_pallas_fused=fused))
    got = td.detect_sources_batched(tiles, DetectionConfig(use_pallas_fused=fused), device="cpu")
    assert min(len(w["y"]) for w in want) > 150
    _catalogs_equal(got, want, flux_rtol=FLUX_RTOL_DEFAULT)
    worst = max(float(np.max(np.abs(g["flux"] / w["flux"] - 1))) for g, w in zip(got, want))
    print(f"default threshold, {'fused' if fused else 'chain'}: largest flux difference {worst} (relative)")
    cfg = DetectionConfig(use_pallas_fused=fused)
    labels, filt, grms = td._batched_core(torch.from_numpy(tiles), cfg)
    filt = filt.to(torch.bfloat16).float()
    idx, lab, val = td._compact_masked(labels, filt)
    keys, heights, _ = td._dense_saddle_edges(labels, filt)
    control = td._postprocess_stack(idx.numpy(), lab.numpy(), val.numpy(), 3, 128, grms.numpy(), cfg, {}, True,
                                    (keys.numpy(), heights.numpy()))
    with pytest.raises(AssertionError):
        _catalogs_equal(control, want, flux_rtol=FLUX_RTOL_DEFAULT)


@pytest.mark.parametrize("kw", [SERVING, {}, {"deblend_algo": "lutz", **SERVING}])
def test_a_tile_of_the_stack_is_detected_as_one_field(kw):
    """Batching changes nothing: each tile's catalog and label map are bit
    for bit those of detect_sources on that tile alone."""
    tiles = _stack()
    cfg = DetectionConfig(**kw)
    for got, tile in zip(td.detect_sources_batched(tiles, cfg, device="cpu"), tiles):
        want = td.detect_sources(tile, cfg, device="cpu")
        for key in ("y", "x", "area", "flux", "peak_yx", "labels"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["globalrms"] == want["globalrms"]


def test_detect_sources_batched_times_its_stages():
    """Every stage and counter once; the watershed merge's counters show
    its saddle edges engaging (touching segments on every tile: more
    boundary pixel pairs than distinct edges), and the Lutz tree, which
    takes no edges, records neither."""
    t = {}
    out = td.detect_sources_batched(_stack(), DetectionConfig(), timings=t, device="cpu")
    assert set(t) == {"core", "download", "merge", "segstats", "clean", "reconstruct", "count.masked_px",
                      "count.saddle_pairs", "count.segment_edges"}
    assert all(v >= 0 for v in t.values())
    assert t["count.masked_px"] == sum(int((o["labels"] >= 0).sum()) for o in out)
    assert t["count.masked_px"] > t["count.saddle_pairs"] > t["count.segment_edges"] > 0
    t = {}
    td.detect_sources_batched(_stack(), DetectionConfig(), timings=t, want_map=False, device="cpu")
    assert "reconstruct" not in t and out[0]["labels"].shape == (128, 128)
    t = {}
    td.detect_sources_batched(_stack(), DetectionConfig(deblend_algo="lutz"), timings=t, device="cpu")
    assert t["count.masked_px"] > 0 and not {"count.saddle_pairs", "count.segment_edges"} & set(t)


def test_batched_detection_validates_its_arguments():
    with pytest.raises(ValueError, match=r"\(T, F, F\) square stack"):
        td.detect_sources_batched(np.zeros((2, 64, 32), np.float32), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.detect_sources_batched(_stack())


@pytest.mark.parametrize("shards", [1, 4, 8])
@pytest.mark.parametrize("core", ["fused", "chain"])
def test_batched_detection_on_a_mesh_equals_jax(core, shards):
    """detect_sources_batched(mesh=): the 3-tile stack padded to the data
    axis by a cyclic repeat (5 pad tiles on 8 shards), each shard's core on
    its own (one piece of detection's route on 1 shard, four on 4), the
    labels and catalogues of every tile equal to JAX's on its mesh and to
    the port's without a mesh, with the same stages and counters."""
    from debvader_tpu.parallel import make_mesh as jax_make_mesh

    from debvader_tpu_torch.parallel import make_mesh

    tiles = _stack()
    kw = dict(SERVING, **CORES[core])
    mesh = make_mesh(shards, devices=["cpu"] * shards)
    t, alone = {}, {}
    got = td.detect_sources_batched(tiles, DetectionConfig(**kw), mesh=mesh, timings=t)
    _catalogs_equal(got, jd.detect_sources_batched(tiles, _jcfg(**kw), mesh=jax_make_mesh(shards)))
    _catalogs_equal(got, td.detect_sources_batched(tiles, DetectionConfig(**kw), device="cpu", timings=alone))
    assert {"core", "download", "merge"} <= set(t) and set(t) == set(alone)


@pytest.mark.parametrize(
    "kw",
    [{}, {"use_pallas_filter": True}, {"use_pallas_filter": True, "use_pallas_fused": False},
     {"use_pallas_filter": True, "use_pallas_select": False}, {"use_pallas_filter": True, "filter_size": 5},
     {"use_pallas_select": False}],
)
def test_batched_config_is_normalized_as_jax(monkeypatch, kw):
    """The port reads JAX's 'on a TPU' as 'on either device': its rule
    equals JAX's with the TPU backend, and the batched core it picks is
    the one JAX's batched core runs (the fused core whenever enabled)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = jd._normalize_batched_cfg(JaxDetectionConfig(**kw))
    got = td._normalize_batched_cfg(DetectionConfig(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert td._fused_enabled(got) == jd._fused_enabled(want)
    picked = []
    monkeypatch.setattr(td, "detect_core_stack", lambda xs, cfg: picked.append("fused"))
    monkeypatch.setattr(td, "_chain_core", lambda xs, cfg: picked.append("chain"))
    td._batched_core(None, got)
    assert picked == ["fused" if jd._fused_enabled(want) else "chain"]


def test_the_standalone_filter_takes_one_field():
    """The stand-alone filter kernel filters one field: the chain refuses
    a larger stack instead of filtering its first tile only."""
    with pytest.raises(ValueError, match="stack of 3"):
        td._chain_core(torch.from_numpy(_stack()), DetectionConfig(use_pallas_filter=True, use_pallas_fused=False))
    labels, _, _ = td._chain_core(torch.from_numpy(_stack()[:1]), DetectionConfig(use_pallas_filter=True))
    assert labels.shape == (1, 128, 128)


# ---------------------------------------------------------- tiled fields


@pytest.mark.parametrize(
    "f, tile, overlap",
    [(300, 160, 40), (100, 160, 40), (160, 160, 40), (4096, 1024, 64), (1536, 512, 64), (192, 128, 32),
     (257, 64, 16), (1000, 999, 0)],
)
def test_tile_origins_equal_jax(f, tile, overlap):
    assert ttiles.tile_origins(f, tile, overlap) == jtiles.tile_origins(f, tile, overlap)


def test_the_tile_stack_is_one_gather_of_the_field():
    band = torch.arange(300 * 300, dtype=torch.float32).reshape(300, 300)
    o = ttiles.tile_origins(300, 160, 40)
    want = torch.stack([band[y : y + 160, x : x + 160] for y in o for x in o])
    assert torch.equal(ttiles._tile_stack(band, o, 160), want)


def _tiled_pair(field, tile=128, overlap=32, jfield=None, **kw):
    want = jtiles.detect_objects_tiled(field if jfield is None else jfield, _jcfg(**SERVING, **kw),
                                       tile=tile, overlap=overlap)
    got = ttiles.detect_objects_tiled(field, DetectionConfig(**SERVING, **kw), tile=tile, overlap=overlap,
                                      device="cpu")
    return got, want


@pytest.mark.parametrize("form", ["host", "device", "device_band", "bfloat16"])
def test_detect_objects_tiled_equals_jax(form):
    """A 192^2 field in 2 x 2 tiles of 128 overlapping by 32: the rows of
    JAX's catalog, exactly, from a host field, a device-resident one (the
    whole field or its band) and a bfloat16 one (widened to float32 for
    detection, as JAX widens its tiles)."""
    field = _scene()
    if form == "host":
        got, want = _tiled_pair(field)
    elif form == "device":
        got, want = _tiled_pair(torch.from_numpy(field), jfield=jnp.asarray(field))
    elif form == "device_band":
        band = field[0, :, :, 2]
        got, want = _tiled_pair(torch.from_numpy(band), jfield=jnp.asarray(band))
    else:
        got, want = _tiled_pair(torch.from_numpy(field).to(torch.bfloat16), jfield=jnp.asarray(field, jnp.bfloat16))
    assert len(want) == 10
    np.testing.assert_array_equal(got, want)


def test_a_source_on_a_seam_is_counted_once():
    """The first galaxy sits in the overlap of all four tiles: one row, as
    JAX reports it, and the catalog as the untiled detection's."""
    field = _scene()
    got, want = _tiled_pair(field)
    np.testing.assert_array_equal(got, want)
    assert np.sum(np.all(np.abs(got - (0.0, 10.0)) <= 1, axis=1)) == 1
    whole = dtt.detect_objects(field, DetectionConfig(**SERVING), device="cpu")
    np.testing.assert_array_equal(np.sort(got, 0), np.sort(whole, 0))


@pytest.mark.parametrize("tile", [192, 256])
def test_a_single_tile_field_is_a_stack_of_one(tile):
    """tile >= F: one tile, no core cut, the untiled detection's rows."""
    field = _scene()
    got, want = _tiled_pair(field, tile=tile)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dtt.detect_objects(field, DetectionConfig(**SERVING), device="cpu"))


def test_tiled_lutz_equals_jax():
    field = _scene(seed=3)
    got, want = _tiled_pair(field, deblend_algo="lutz")
    assert len(want) >= 9
    np.testing.assert_array_equal(got, want)


def test_tiled_detection_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="square field"):
        ttiles.detect_objects_tiled(np.zeros((1, 128, 96, 6), np.float32), device="cpu")
    with pytest.raises(ValueError, match="square field"):
        ttiles.detect_objects_tiled(torch.zeros(96, 128), device="cpu")
    t = {}
    assert ttiles.detect_objects_tiled(np.zeros((128, 128), np.float32), tile=64, overlap=16, timings=t,
                                       device="cpu").shape == (0, 2)
    assert {"core", "download", "tile_select"} <= set(t)


# ----------------------------------------------------------- the servers


@pytest.fixture(scope="module")
def nets():
    return dt.load_deblender("sim_demo"), dtt.load_deblender("sim_demo", device="cpu")


def _pcfgs(**kw):
    kw = dict(tile_size=128, tile_overlap=32, interp_order=1, source_chunk=4, **kw)
    return JaxPipelineConfig(**kw), dtt.PipelineConfig(**kw)


def _tiled_fields(nets, field, **kw):
    jc, tc = _pcfgs()
    jdf = jtiles.TiledDeblendField(nets[0], field, z_mode="mean", cfg=jc, det_cfg=_jcfg(**SERVING), **kw)
    tdf = dtt.TiledDeblendField(nets[1], field, z_mode="mean", cfg=tc, det_cfg=DetectionConfig(**SERVING),
                                device="cpu", **kw)
    return jdf, tdf


def _stream_catalogs_equal(got, want):
    assert got.dtype == want.dtype
    for col in ("list_idx", "galaxy_distances_to_center_x", "galaxy_distances_to_center_y", "passed_cuts",
                "epistemic_norm") + (("iteration",) if "iteration" in want.dtype.names else ()):
        np.testing.assert_array_equal(got[col], want[col], err_msg=col)
    np.testing.assert_allclose(got.mse_center, want.mse_center, rtol=1e-5)


def test_tiled_detect_deblend_render_equals_jax(nets):
    field = _scene()
    jdf, tdf = _tiled_fields(nets, field)
    jcat, jres, jmodel = jdf.detect_deblend_render(return_model=True)
    tcat, tres, tmodel = tdf.detect_deblend_render(return_model=True)
    _stream_catalogs_equal(tcat, jcat)
    scale = float(np.abs(field).max())
    for got, want in ((tres, jres), (tmodel, jmodel)):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)
    assert {"core", "download", "merge", "segstats", "tile_select"} <= set(tdf.detect_timings)
    assert "reconstruct" not in tdf.detect_timings


def test_tiled_detect_and_deblend_equals_jax(nets):
    field = _scene(seed=1)
    jdf, tdf = _tiled_fields(nets, field)
    want, got = jdf.detect_and_deblend(), tdf.detect_and_deblend()
    for col in ("list_idx", "galaxy_distances_to_center_x", "galaxy_distances_to_center_y", "passed_cuts"):
        np.testing.assert_array_equal(got[col], want[col])
    gm, wm = np.stack(list(got.output_images_mean)), np.stack(list(want.output_images_mean))
    assert float(np.abs(gm - wm).max()) <= 2e-5 * float(np.abs(wm).max())
    np.testing.assert_allclose(tdf.get_residual_field(), jdf.get_residual_field(), rtol=0,
                               atol=2e-5 * float(np.abs(field).max()))


def test_detection_on_the_device_field_equals_the_host_field(nets):
    """The serving entry points detect on the memoized device field: the rows of
    the host field's detection, for float32 and bfloat16 residency."""
    field = _scene()
    for kw in ({}, {"upload_dtype": "bfloat16"}, {"device_dtype": "bfloat16"}):
        _, tdf = _tiled_fields(nets, field, **kw)
        host = tdf.detect()
        np.testing.assert_array_equal(tdf.detect(field=tdf._device_field(tdf.field_image)), host)
    empty = np.zeros_like(field)
    _, tdf = _tiled_fields(nets, empty)
    assert tdf.detect_and_deblend() is None
    cat, res, model = tdf.detect_deblend_render(return_model=True)
    assert cat is None and np.array_equal(res, empty) and not model.any()


def test_tiled_routes_on_a_mesh_equal_jax(nets):
    """The tiled routes with mesh= (JAX's tests/test_tiles.py mesh cases):
    detect_objects_tiled, TiledDeblendField.detect_deblend_render (the
    tile stack and the stamp forward split over 4 shards) and
    IterativeDeblendField.iterative_deblend_and_render, each against JAX's
    on its mesh and against the port without a mesh."""
    from debvader_tpu.parallel import make_mesh as jax_make_mesh

    from debvader_tpu_torch.parallel import make_mesh

    field = _scene()
    mesh, jmesh = make_mesh(4, devices=["cpu"] * 4), jax_make_mesh(4)
    got = ttiles.detect_objects_tiled(field, DetectionConfig(**SERVING), tile=128, overlap=32, mesh=mesh,
                                      device="cpu")
    np.testing.assert_array_equal(got, jtiles.detect_objects_tiled(field, _jcfg(**SERVING), tile=128, overlap=32,
                                                                  mesh=jmesh))
    np.testing.assert_array_equal(got, _tiled_pair(field)[0])
    scale = float(np.abs(field).max())
    _, plain = _tiled_fields(nets, field)
    jm = jtiles.TiledDeblendField(nets[0], field, z_mode="mean", cfg=_pcfgs()[0], det_cfg=_jcfg(**SERVING),
                                  mesh=jmesh)
    tm = dtt.TiledDeblendField(nets[1], field, z_mode="mean", cfg=_pcfgs()[1], det_cfg=DetectionConfig(**SERVING),
                               device="cpu", mesh=mesh)
    tcat, tres = tm.detect_deblend_render()
    for cat, res in (jm.detect_deblend_render(), plain.detect_deblend_render()):
        _stream_catalogs_equal(tcat, cat)
        np.testing.assert_allclose(tres, res, rtol=0, atol=2e-5 * scale)
    jdf, (jcat, jres), tdf, (tcat, tres) = _iterative(nets, field, jkw={"mesh": jmesh}, tkw={"mesh": mesh})
    _stream_catalogs_equal(tcat, jcat)
    assert tdf.nb_of_detected_objects == jdf.nb_of_detected_objects == [10, 10]
    np.testing.assert_allclose(tres, jres, rtol=0, atol=2e-5 * float(np.abs(jres).max()))


def _iterative(nets, field, det_kw=SERVING, run_kw=None, jkw=None, tkw=None, **kw):
    jc, tc = _pcfgs()
    run_kw = run_kw or {}
    jdf = JaxIterative(nets[0], field, z_mode="mean", cfg=jc, **kw, **(jkw or {}))
    tdf = dtt.IterativeDeblendField(nets[1], field, z_mode="mean", cfg=tc, device="cpu", **kw, **(tkw or {}))
    want = jdf.iterative_deblend_and_render(det_cfg=_jcfg(**det_kw), **run_kw)
    got = tdf.iterative_deblend_and_render(det_cfg=DetectionConfig(**det_kw), **run_kw)
    return jdf, want, tdf, got


@pytest.mark.parametrize("transfer_dtype", [None, "bfloat16"])
def test_iterative_deblend_and_render_equals_jax(nets, transfer_dtype):
    """Two steps on the tiled field (the second finds the ten galaxies'
    leftovers and no more): the catalog with its iteration column and
    offset list_idx, the per-step counts and mse, and the residual (float32
    within 2e-5 of its scale; downloaded as bfloat16, within one bf16 ulp
    of the scale on at most 0.1% of the elements, where a rounding of the
    two sides' float32 residuals flips)."""
    field = _scene()
    jdf, (jcat, jres), tdf, (tcat, tres) = _iterative(nets, field, run_kw={"transfer_dtype": transfer_dtype})
    _stream_catalogs_equal(tcat, jcat)
    assert tdf.nb_of_detected_objects == jdf.nb_of_detected_objects == [10, 10]
    assert tdf.nb_of_deblended_galaxies == jdf.nb_of_deblended_galaxies
    np.testing.assert_array_equal(np.unique(tcat.iteration), [0, 1])
    np.testing.assert_allclose(tdf.mse, jdf.mse, rtol=1e-5)
    assert tres.dtype == np.float32
    if transfer_dtype is None:
        np.testing.assert_allclose(tres, jres, rtol=0, atol=2e-5 * float(np.abs(jres).max()))
    else:
        print(f"transfer_dtype bfloat16: share off JAX's {_ulp_agreement(tres, jres)}")


def test_iterative_bfloat16_residency_equals_jax(nets):
    """device_dtype='bfloat16' at order 1: the same detections and catalog
    as JAX's at every step, the residual within one bf16 ulp of its scale
    of JAX's on at most 0.1% of the elements, and within 2e-2 of the
    float32 route's scale; the control, the port's float32 residual
    rounded to bfloat16 at the end, fails the share rule."""
    field = _scene()
    jdf, (jcat, jres), tdf, (tcat, tres) = _iterative(nets, field, device_dtype="bfloat16")
    _stream_catalogs_equal(tcat, jcat)
    assert tdf.nb_of_detected_objects == jdf.nb_of_detected_objects
    np.testing.assert_allclose(tdf.mse, jdf.mse, rtol=1e-5)
    print(f"bfloat16 iterative residual: share off JAX's {_ulp_agreement(tres, jres)}")
    _, (_, f32_res) = _iterative(nets, field)[2:]
    _control_fails(f32_res, jres)
    assert float(np.abs(tres - f32_res).max()) <= 2e-2 * float(np.abs(f32_res).max())


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def test_step_zero_leaves_the_memoized_field_unchanged(nets):
    """Step 0 subtracts into a new buffer: the memoized device field is the
    same tensor with the same bits after the run, and a one-step run's
    residual is deblend_and_render's, bit for bit (both are field -
    crop(canvas) of the same stream)."""
    field = _scene()
    _, tc = _pcfgs()
    centers = dtt.detect_objects_tiled(field, DetectionConfig(**SERVING), tile=128, overlap=32, device="cpu")
    for kw in ({}, {"device_dtype": "bfloat16"}):
        tdf = dtt.IterativeDeblendField(nets[1], field, z_mode="mean", cfg=tc, device="cpu", **kw)
        memo = tdf._device_field(tdf.field_image)
        before = _bits(memo).clone()
        tdf.iterative_deblend_and_render(det_cfg=DetectionConfig(**SERVING))
        assert tdf._device_field(tdf.field_image) is memo
        assert torch.equal(_bits(memo), before)
        cat1, res1 = tdf.iterative_deblend_and_render(det_cfg=DetectionConfig(**SERVING), max_iterations=1)
        cat2, res2 = tdf.deblend_and_render(centers)
        np.testing.assert_array_equal(res1.view(np.int32), res2.view(np.int32))
        assert len(cat1) == len(cat2) and (cat1.iteration == 0).all()


def test_iterative_at_given_centres_and_without_sources_as_jax(nets):
    """Step 0 at given centres with nothing found after it (the JAX test of
    tests/test_pipeline.py:529), and a field without sources."""
    field = _scene()
    centers = dtt.detect_objects_tiled(field, DetectionConfig(**SERVING), tile=128, overlap=32, device="cpu")
    jdf, (jcat, jres), tdf, (tcat, tres) = _iterative(
        nets, field, det_kw={"thresh": 1e6, **{k: v for k, v in SERVING.items() if k != "thresh"}},
        run_kw={"galaxy_distances_to_center": centers})
    _stream_catalogs_equal(tcat, jcat)
    assert tdf.nb_of_detected_objects == jdf.nb_of_detected_objects == [10]
    np.testing.assert_allclose(tres, jres, rtol=0, atol=2e-5 * float(np.abs(jres).max()))
    empty = np.zeros_like(field)
    jdf, (jcat, jres), tdf, (tcat, tres) = _iterative(nets, empty)
    assert jcat is None and tcat is None and np.array_equal(tres, empty) and tdf.mse == jdf.mse == []
    with pytest.raises(ValueError, match="transfer_dtype"):
        tdf.iterative_deblend_and_render(transfer_dtype="int8")
