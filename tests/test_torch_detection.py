"""The PyTorch port's detection held against the JAX package on the CPU.

The port's kernel modules run their plain versions here (CPU tensors);
the JAX side runs its Pallas kernels in interpret mode, as the JAX
package's own tests do, or its XLA formulation.  Integer outputs (labels,
parents, direction codes, merge roots, detected offsets) and medians must
be bit-identical; float maps carry a tolerance stated where they are
compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debvader_tpu.config import DetectionConfig as JaxDetectionConfig
from debvader_tpu.kernels.clipped_stats import sigma_clipped_stats_pallas
from debvader_tpu.kernels.detect_fused import matched_filter_parents as jax_mfp
from debvader_tpu.kernels.label_select import label_select_fixpoint
from debvader_tpu.ops import detection as jd
from debvader_tpu_torch.config import DetectionConfig
from debvader_tpu_torch.kernels.clipped_stats import sigma_clipped_stats
from debvader_tpu_torch.kernels.detect_fused import (
    matched_filter_parents,
    parent_race,
    separable_filter,
    separate,
)
from debvader_tpu_torch.kernels.label_select import label_fixpoint
from debvader_tpu_torch.ops import detection as td

torch.set_num_threads(1)


def _field(f, seed, nsrc=10, noise=0.05):
    rng = np.random.default_rng(seed)
    img = noise * rng.normal(size=(f, f)) + 0.01
    yy, xx = np.mgrid[:f, :f]
    for _ in range(nsrc):
        cy, cx = rng.uniform(4, f - 4, 2)
        s = rng.uniform(1.2, 3.0)
        img += rng.uniform(0.3, 3.0) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def _boxes():
    """Six boxes of 1024: two plain, one half-masked, one all-invalid, one
    constant, one with a bright outlier tail (clipping matters)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 1024)).astype(np.float32)
    x[1] += 3.0
    x[4] = 0.25
    x[5, :40] = rng.uniform(20, 50, 40)
    v = np.ones_like(x)
    v[2, ::2] = 0
    v[3] = 0
    return x, v


def test_clipped_stats_plain_matches_pallas_interpret():
    """Medians bit-identical; mean and std differ only by summation order
    (<= 1e-6 relative to the box scale for 1024 float32 terms)."""
    x, v = _boxes()
    want = jax.device_get(sigma_clipped_stats_pallas(jnp.asarray(x), jnp.asarray(v), interpret=True))
    got = [t.numpy() for t in sigma_clipped_stats(torch.from_numpy(x), torch.from_numpy(v))]
    np.testing.assert_array_equal(got[1].view(np.int32), np.asarray(want[1]).view(np.int32))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert got[0][3] == got[1][3] == got[2][3] == 0.0  # all-invalid box
    assert got[1][4] == np.float32(0.25) and got[2][4] == 0.0  # constant box


def test_clipped_stats_median_is_exact_rank_statistic():
    x, v = _boxes()
    _, med, _ = sigma_clipped_stats(torch.from_numpy(x), torch.from_numpy(v), iters=0)
    for i in range(6):
        vals = np.sort(x[i][v[i] > 0])
        want = vals[(len(vals) - 1) // 2] if len(vals) else 0.0
        assert med[i].item() == want


def test_matched_filter_parents_matches_pallas_interpret():
    """filt against the Pallas kernel (interpret) within 1e-5 of max|filt|
    (the TPU kernel's own parity bound with the XLA conv is 2e-5 absolute);
    dir_code and parent bit-identical to the port's race on JAX's filt."""
    imgs = np.stack([_field(128, 1), _field(128, 2)])
    backs = np.full_like(imgs, 0.01)
    thr = np.array([0.4, 0.5], np.float32)
    k = td.default_filter_kernel()
    jf, jdir, jpar = jax_mfp(jnp.asarray(imgs), jnp.asarray(backs), k, jnp.asarray(thr), tile=64, interpret=True)
    jf, jdir, jpar = (np.asarray(a)[:, :128, :128] for a in (jf, jdir, jpar))
    filt, dirc, parent = matched_filter_parents(
        torch.from_numpy(imgs), torch.from_numpy(backs), k, torch.from_numpy(thr)
    )
    np.testing.assert_allclose(filt.numpy(), jf, rtol=0, atol=1e-5 * np.abs(jf).max())
    rdir, rpar = parent_race(torch.from_numpy(np.array(jf)), torch.from_numpy(thr))
    np.testing.assert_array_equal(rdir.numpy(), jdir)
    np.testing.assert_array_equal(rpar.numpy(), jpar)
    assert (jdir != 4).sum() > 0


def test_separable_taps_match_jax():
    from debvader_tpu.kernels.matched_filter import _separate

    k = td.default_filter_kernel()
    for a, b in zip(separate(k), _separate(k)):
        np.testing.assert_array_equal(a, b)


def test_label_fixpoint_matches_pallas_interpret():
    imgs = np.stack([_field(128, 3, nsrc=14), _field(128, 4, nsrc=14)])
    k = td.default_filter_kernel()
    wy, wx = separate(k)
    filt = separable_filter(torch.from_numpy(imgs), wy, wx)
    dirc, cur0 = parent_race(filt, torch.tensor([0.3, 0.3]))
    want, _ = label_select_fixpoint(
        jnp.asarray(cur0.numpy().reshape(256, 128)), jnp.asarray(dirc.numpy().reshape(256, 128)),
        rows=128, interpret=True,
    )
    got = label_fixpoint(cur0.reshape(256, 128), dirc.reshape(256, 128))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (dirc != 4).sum() > 0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_estimate_background_matches_jax(use_pallas):
    """Both JAX clip formulations.  A 100^2 field with 64-px boxes pads
    the mesh at the edge, holds non-finite pixels, and has a 2x2 mesh, so
    the global values are medians of an even count (jnp.median averages the
    two middle values; torch.median would return the lower one, far
    outside the tolerance).  The maps come from jax.image.resize's bilinear
    weights, edges included.  All four outputs match within 1e-6 of their
    scale: the box means differ by float32 summation order, which moves the
    mode estimator by an ulp."""
    img = _field(100, 5)
    img[3, 7] = np.nan
    img[50:52, 60] = np.inf
    want = [np.asarray(a) for a in jd.estimate_background(jnp.asarray(img), box=64, use_pallas=use_pallas)]
    got = [t.numpy() for t in td.estimate_background(torch.from_numpy(img), box=64)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * max(np.abs(w).max(), 1e-30))


def test_even_count_median_is_the_midpoint():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert td._median(x).item() == 2.5 == float(jnp.median(jnp.asarray(x.numpy())))
    assert torch.median(x).item() == 2.0  # the trap the port avoids


@pytest.mark.parametrize("seed", [11, 12])
def test_detect_objects_equals_jax_tpu_path(seed):
    """The TPU path (fused detect core + Pallas clip), interpreted, against
    the port: the same offsets, exactly."""
    img = _field(128, seed, nsrc=12)
    cfg = JaxDetectionConfig(use_pallas_fused=True, use_pallas_clip=True)
    want = jd.detect_objects(img, cfg)
    got = td.detect_objects(img, DetectionConfig(), device="cpu")
    assert len(want) > 5
    np.testing.assert_array_equal(got, want)


def test_detect_sources_labels_and_catalog_equal_jax():
    img = _field(128, 13, nsrc=12)
    cfg = JaxDetectionConfig(use_pallas_fused=True, use_pallas_clip=True)
    want = jd.detect_sources(img, cfg)
    got = td.detect_sources(img, DetectionConfig(), device="cpu")
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["peak_yx"], want["peak_yx"])
    for key in ("y", "x", "area", "flux"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_merge_roots_equal_jax_merge_segments_py():
    img = _field(128, 14, nsrc=16)
    t = torch.from_numpy(img)[None]
    labels, filt, grms = td.detect_core_stack(t, DetectionConfig())
    flat = labels[0].numpy().ravel()
    idx = np.flatnonzero(flat >= 0)
    lab = flat[idx].astype(np.int64)
    val = filt[0].numpy().ravel()[idx]
    lo, hi, h = td._saddle_edges_coo(idx, lab, val, 128)
    jlo, jhi, jh = jd._saddle_edges_coo(idx, lab, val, 128)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(h, jh)
    labs = np.unique(lab)
    L = len(labs)
    ia, ib = np.searchsorted(labs, lo), np.searchsorted(labs, hi)
    ukey, inv = np.unique(ia * L + ib, return_inverse=True)
    eh = np.full(len(ukey), -np.inf)
    np.maximum.at(eh, inv, h)
    cid = np.searchsorted(labs, lab)
    flux = np.bincount(cid, weights=np.maximum(val, 0.0), minlength=L)
    peak = val[np.searchsorted(idx, labs)].astype(np.float64)
    order = np.argsort(peak, kind="stable")
    thr = 1.5 * float(grms[0])
    args = (ukey // L, ukey % L, eh, peak)
    for nthr, cont in ((64, 1e-5), (8, 0.05)):
        want = jd._merge_segments_py(*args, flux.copy(), order, nthr, thr, cont)
        got = td._merge_segments_py(*args, flux.copy(), order, nthr, thr, cont)
        np.testing.assert_array_equal(got, want)
    assert L > 3


# ------------------------------------------- single-field detection backends

_BACKENDS = {
    "filter_kernel": {"use_pallas_filter": True},
    "chain": {"use_pallas_fused": False},
    "filter_size_5": {"filter_size": 5},
    "filter_kernel_matched": {"use_pallas_filter": True, "threshold_scaling": "matched", "thresh": 3.0},
    "select_off": {"use_pallas_select": False},
}


@pytest.mark.parametrize("backend", sorted(_BACKENDS))
@pytest.mark.parametrize("seed", [13, 15])
def test_detect_sources_backends_equal_jax(backend, seed):
    """The chain detect core under each backend against the JAX package
    under the same config (its Pallas filter interpreted): labels, peaks
    and offsets equal; the flux-weighted columns within 1e-5 relative (the
    filters sum in different orders, 5e-6 of filt's scale)."""
    kw = _BACKENDS[backend]
    img = _field(128, seed, nsrc=12)
    want = jd.detect_sources(img, JaxDetectionConfig(**kw))
    got = td.detect_sources(img, DetectionConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["peak_yx"], want["peak_yx"])
    np.testing.assert_array_equal(got["area"], want["area"])
    for key in ("y", "x", "flux"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    np.testing.assert_array_equal(
        td.detect_objects(img, DetectionConfig(**kw), device="cpu"),
        jd.detect_objects(img, JaxDetectionConfig(**kw)),
    )
    assert len(want["y"]) > 5


@pytest.mark.parametrize("backend", ["filter_kernel", "chain"])
def test_detect_sources_backends_equal_the_fused_route(backend):
    """At 7x7 every backend of the port finds the fused core's labels."""
    img = _field(128, 16, nsrc=12)
    fused = td.detect_sources(img, DetectionConfig(), device="cpu")
    got = td.detect_sources(img, DetectionConfig(**_BACKENDS[backend]), device="cpu")
    np.testing.assert_array_equal(got["labels"], fused["labels"])
    np.testing.assert_array_equal(got["peak_yx"], fused["peak_yx"])


def test_detect_core_guards_non_finite_pixels_like_jax():
    """NaN and inf pixels add nothing to the filter on either filter of
    the chain, and the labels equal JAX's."""
    img = _field(128, 17, nsrc=12)
    img[40, 41] = np.nan
    img[90:92, 30] = np.inf
    for kw in ({"use_pallas_filter": True}, {"use_pallas_fused": False}):
        labels, filt, grms = td._detect_core(torch.from_numpy(img), DetectionConfig(**kw))
        assert torch.isfinite(filt).all()
        jlabels, _, jfilt, _, jrms = jd._detect_core(jnp.asarray(img), JaxDetectionConfig(**kw))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
        np.testing.assert_allclose(filt.numpy(), np.asarray(jfilt), rtol=0, atol=1e-5 * float(np.abs(jfilt).max()))
        np.testing.assert_allclose(float(grms), float(jrms), rtol=1e-6)


@pytest.mark.parametrize(
    "kw,fused",
    [
        ({}, True),
        ({"use_pallas_fused": True}, True),
        ({"use_pallas_fused": False}, False),
        ({"filter_size": 5}, False),
        ({"filter_size": 5, "use_pallas_fused": True}, False),
        ({"use_pallas_select": False}, False),
        ({"use_pallas_select": False, "use_pallas_fused": True}, True),
        ({"use_pallas_select": False, "use_pallas_fused": False}, False),
        ({"filter_size": 5, "use_pallas_select": False}, False),
        ({"use_pallas_clip": True}, True),
        ({"use_pallas_clip": False, "use_pallas_select": False}, False),
    ],
)
def test_fused_enabled_dispatch(kw, fused, monkeypatch):
    """The port's rule, and the JAX rule on an accelerator (auto mode runs
    the fused core iff use_pallas_select; an explicit use_pallas_fused
    wins; a filter other than 7x7 never runs it)."""
    assert td._fused_enabled(DetectionConfig(**kw)) is fused
    monkeypatch.setattr(jd.jax, "default_backend", lambda: "tpu")
    assert bool(jd._fused_enabled(JaxDetectionConfig(**kw))) is fused


def test_detection_config_carries_the_jax_backend_fields():
    ours, theirs = DetectionConfig(), JaxDetectionConfig()
    for name in ("filter_size", "use_pallas_filter", "use_pallas_fused"):
        assert getattr(ours, name) == getattr(theirs, name)
    with pytest.raises(ValueError, match="filter_size"):
        DetectionConfig(filter_size=6)


@pytest.mark.parametrize("size", [3, 5, 9])
def test_conv2d_same_matches_jax(size):
    rng = np.random.default_rng(size)
    img = rng.normal(size=(40, 40)).astype(np.float32)
    k = rng.random((size, size)).astype(np.float32)
    want = np.asarray(jd._conv2d_same(jnp.asarray(img), jnp.asarray(k)))
    got = td._conv2d_same(torch.from_numpy(img), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6 * np.abs(want).max())
