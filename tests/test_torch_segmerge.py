"""The port's native segment merge and Lutz tree (kernels/segmerge.py, built
from debvader_tpu_torch/csrc/segmerge.cpp) held against the JAX package on
the CPU, bit for bit: merge roots against the port's plain Python loop and
against the JAX package's native core on random segment graphs and on the
segments of a real detection; Lutz labels against JAX's; detection with
``deblend_algo='lutz'`` against JAX's.  A failed build raises with the
compiler's output instead of falling back to the Python loop.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from debvader_tpu.config import DetectionConfig as JaxDetectionConfig
from debvader_tpu.ops import detection as jd
from debvader_tpu.runtime import segmerge as jseg
from debvader_tpu_torch.config import DetectionConfig
from debvader_tpu_torch.kernels import segmerge
from debvader_tpu_torch.ops import detection as td

torch.set_num_threads(1)

_ROOT = Path(__file__).resolve().parent.parent


def _field(f, seed, nsrc=12, noise=0.05):
    rng = np.random.default_rng(seed)
    img = noise * rng.normal(size=(f, f)) + 0.01
    yy, xx = np.mgrid[:f, :f]
    for _ in range(nsrc):
        cy, cx = rng.uniform(4, f - 4, 2)
        s = rng.uniform(1.2, 3.0)
        img += rng.uniform(0.3, 3.0) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def _random_graph(seed):
    """A random segment graph as tests/test_detection.py draws them."""
    rng = np.random.default_rng(seed)
    L = int(rng.integers(2, 60))
    E = int(rng.integers(1, 4 * L))
    ea = rng.integers(0, L, E)
    eb = rng.integers(0, L, E)
    keep = ea != eb
    ea, eb = np.minimum(ea, eb)[keep].astype(np.int64), np.maximum(ea, eb)[keep].astype(np.int64)
    eh = rng.uniform(0.1, 5.0, len(ea))
    peak = rng.uniform(0.5, 50.0, L)
    flux = rng.uniform(1.0, 100.0, L)
    order = np.argsort(peak, kind="stable")
    cont = float(rng.choice([1e-5, 0.005, 0.1]))
    return ea, eb, eh, peak, flux, order, cont


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("nthr", [1, 64])
def test_native_merge_equals_plain_and_jax(seed, nthr):
    """Roots bit for bit: the port's native core, its plain Python loop and
    the JAX package's native core; the caller's flux is not consumed."""
    ea, eb, eh, peak, flux, order, cont = _random_graph(seed)
    flux_before = flux.copy()
    got = segmerge.merge_segments(ea, eb, eh, peak, flux, order, nthr, 0.3, cont)
    np.testing.assert_array_equal(flux, flux_before)
    plain = td._merge_segments_py(ea, eb, eh, peak, flux.copy(), order, nthr, 0.3, cont)
    want = jseg.merge_segments(ea, eb, eh, peak, flux, order, nthr, 0.3, cont)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)


def _coo(img, cfg):
    """The masked-pixel COO of one field's watershed core."""
    labels, filt, grms = td.detect_core_stack(torch.from_numpy(img)[None], cfg)
    flat = labels[0].numpy().ravel()
    idx = np.flatnonzero(flat >= 0)
    return idx, flat[idx].astype(np.int64), filt[0].numpy().ravel()[idx], float(grms[0])


@pytest.mark.parametrize("nthr, cont", [(64, 1e-5), (8, 0.05), (32, 0.005)])
def test_native_merge_on_a_detection_equals_plain(nthr, cont):
    """The segments of a default-threshold detection (hundreds of touching
    noise peaks): the merged labels of _merge_labels_coo, which runs the
    native core on the saddle edges of the dense maps, equal the plain
    loop's on the JAX package's COO edges."""
    img = _field(128, 21, nsrc=16)
    cfg = DetectionConfig(deblend_nthresh=nthr, deblend_cont=cont)
    idx, lab, val, grms = _coo(img, cfg)
    thr = cfg.thresh * grms
    labels, filt, _ = td.detect_core_stack(torch.from_numpy(img)[None], cfg)
    keys, heights, _ = td._dense_saddle_edges(labels, filt)
    _, elo, ehi = td._split_edge_keys(keys.numpy(), 128)
    got = td._merge_labels_coo(idx, lab, val, thr, cfg, (elo, ehi, heights.numpy()))
    lo, hi, h = jd._saddle_edges_coo(idx, lab, val, 128)
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
    roots = td._merge_segments_py(ukey // L, ukey % L, eh, peak, flux, order, nthr, thr, cont)
    assert L > 100 and not np.array_equal(roots, np.arange(L))
    np.testing.assert_array_equal(got, labs[roots][cid])
    np.testing.assert_array_equal(got, jd._merge_labels_coo(idx, lab, val, 128, thr, JaxDetectionConfig(
        deblend_nthresh=nthr, deblend_cont=cont)))


@pytest.mark.parametrize("nthr, cont", [(64, 1e-5), (2, 1e-5), (64, 0.5), (16, 0.005)])
def test_lutz_deblend_equals_jax(nthr, cont):
    """The Lutz tree's labels bit for bit against the JAX package's native
    core on the same COO and pixel edges."""
    img = _field(128, 22, nsrc=16)
    idx, _, val, grms = _coo(img, DetectionConfig(thresh=3.0))
    ea, eb = td._pixel_edges_coo(idx, 128)
    jea, jeb = jd._pixel_edges_coo(idx, 128)
    np.testing.assert_array_equal(ea, jea)
    np.testing.assert_array_equal(eb, jeb)
    args = (np.maximum(val.astype(np.float64), 1e-30), idx, ea, eb, 128, nthr, 3.0 * grms, cont)
    got = segmerge.lutz_deblend(*args)
    want = jseg.lutz_deblend(*args)
    assert len(np.unique(got)) > 5
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"deblend_nthresh": 2}, {"deblend_cont": 0.5}, {"clean": False}])
def test_detect_sources_lutz_equals_jax(kw):
    """deblend_algo='lutz' through detect_sources: the labels, peaks and
    area equal, the centroids and fluxes within rtol 1e-6 (the JAX side
    runs its fused core in interpret mode, as on a TPU)."""
    img = _field(128, 23)
    want = jd.detect_sources(img, JaxDetectionConfig(
        thresh=5.0, threshold_scaling="matched", deblend_algo="lutz", use_pallas_fused=True, **kw))
    got = td.detect_sources(img, DetectionConfig(thresh=5.0, threshold_scaling="matched", deblend_algo="lutz", **kw),
                            device="cpu")
    assert len(want["y"]) > 3
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["peak_yx"], want["peak_yx"])
    np.testing.assert_array_equal(got["area"], want["area"])
    for key in ("y", "x", "flux"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_the_library_is_built_from_the_ports_copy():
    """The port builds csrc/segmerge.cpp into its own _build directory; the
    source below its header is the JAX package's, byte for byte."""
    path = segmerge.build()
    assert segmerge.SOURCE == _ROOT / "debvader_tpu_torch" / "csrc" / "segmerge.cpp"
    assert path.parent == _ROOT / "debvader_tpu_torch" / "_build" and path.name.startswith("libsegmerge-")
    ours = segmerge.SOURCE.read_text().splitlines()
    theirs = (_ROOT / "debvader_tpu" / "runtime" / "segmerge.cpp").read_text().splitlines()
    body = ours.index("#include <algorithm>")
    assert ours[body:] == theirs[theirs.index("#include <algorithm>"):]


@pytest.mark.parametrize("cxx, match", [("/nonexistent/g++", "No such file"), ("false", "exit 1")])
def test_a_failed_build_raises(monkeypatch, tmp_path, cxx, match):
    """A missing or failing compiler raises, naming the command, instead of
    returning nothing; no library is left behind."""
    monkeypatch.setattr(segmerge, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(segmerge, "CXX", cxx)
    with pytest.raises(RuntimeError, match=match) as info:
        segmerge.build()
    assert "segmerge.cpp" in str(info.value)
    assert not list(tmp_path.glob("*.so"))


def test_detection_raises_when_the_library_cannot_be_built(monkeypatch, tmp_path):
    """No silent fallback: with the library unbuildable, detection raises
    where the JAX package would run its Python loop."""
    monkeypatch.setattr(segmerge, "_lib", None)
    monkeypatch.setattr(segmerge, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(segmerge, "CXX", "/nonexistent/g++")
    with pytest.raises(RuntimeError, match="segmerge.cpp"):
        td.detect_sources(_field(64, 24), DetectionConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="segmerge.cpp"):
        segmerge.lutz_deblend(np.ones(1), np.zeros(1, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64),
                              8, 64, 0.1, 1e-5)
