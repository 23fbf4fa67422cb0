"""The port's repairs of its open faults, held on the CPU: the order-3
render's place step, the chain route's parent race, the JAX detection
backend fields of DetectionConfig, and cuDNN determinism inside
device.fp32_math.

The port's wrappers run their plain versions here (CPU tensors).  The
place step is held bit for bit against a sequential numpy loop, the JAX
package's scan order (chip_smoke.py holds the CUDA kernel bit for bit
against the same plain version); the order-3 render against the JAX render
at 1e-5 of the stamps' scale, the tolerance of tests/test_torch_field.py
(the spline prefilter sums in another order).  The chain's race, labels
and peaks are held bit for bit against the JAX chain (its
ops/detection._detect_core) on JAX's own filt.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debvader_tpu.config import DetectionConfig as JaxDetectionConfig
from debvader_tpu.ops import detection as jd
from debvader_tpu.ops.shift import render_field as jax_render
from debvader_tpu_torch import device as dv
from debvader_tpu_torch.config import DetectionConfig
from debvader_tpu_torch.kernels.detect_fused import parent_race
from debvader_tpu_torch.kernels.matched_filter import matched_filter_threshold, matched_filter_threshold_plain
from debvader_tpu_torch.kernels.parent_race import parent_race_kernel
from debvader_tpu_torch.kernels.render import place_corners, place_patches, place_patches_plain
from debvader_tpu_torch.ops import detection as td
from debvader_tpu_torch.ops.detection import default_filter_kernel
from debvader_tpu_torch.ops.shift import render_field, render_pad

torch.set_num_threads(1)


# ------------------------------------------------------------------ place


def _place_case(seed, n, p, b, c):
    """Overlapping patches of values over 16 decades (so any change of
    order shows in the last bits), corners in range, a fifth of the
    sources not visible, and a canvas that starts non-zero with some -0.0
    entries (an invisible patch adds +0.0 and flips them)."""
    rng = np.random.default_rng(seed)
    patches = (rng.normal(size=(n, p, p, b)) * 10.0 ** rng.integers(-8, 8, size=(n, 1, 1, 1))).astype(np.float32)
    y = rng.integers(0, c - p + 1, n)
    x = rng.integers(0, c - p + 1, n)
    visible = rng.random(n) > 0.2
    canvas = (rng.normal(size=(c, c, b)) * 100).astype(np.float32)
    canvas[rng.random((c, c, b)) < 0.05] = -0.0
    return canvas, patches, y, x, visible


def _numpy_scan(canvas, patches, y, x, visible):
    out = canvas.copy()
    p = patches.shape[1]
    for i in range(len(y)):
        out[y[i] : y[i] + p, x[i] : x[i] + p] += patches[i] if visible[i] else np.float32(0)
    return out


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("n,p,b,c", [(40, 9, 6, 30), (25, 5, 2, 12), (60, 79, 6, 200), (1, 7, 1, 7)])
def test_place_plain_equals_a_sequential_loop(n, p, b, c):
    canvas, patches, y, x, visible = _place_case(n + p, n, p, b, c)
    want = _numpy_scan(canvas, patches, y, x, visible)
    got = torch.from_numpy(canvas.copy())
    place_patches_plain(got, torch.from_numpy(patches), torch.from_numpy(y), torch.from_numpy(x),
                        torch.from_numpy(visible))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the wrapper takes the plain version for CPU tensors
    wrapped = torch.from_numpy(canvas.copy())
    place_patches(wrapped, torch.from_numpy(patches), torch.from_numpy(y), torch.from_numpy(x),
                  torch.from_numpy(visible))
    np.testing.assert_array_equal(_bits(wrapped.numpy()), _bits(want))


def test_place_plain_keeps_source_order_on_several_threads():
    """One index_put_(accumulate=True) of all patches adds in another order
    once the CPU runs it on several threads; the plain version does not."""
    canvas, patches, y, x, visible = _place_case(3, 64, 40, 6, 300)
    want = _numpy_scan(canvas, patches, y, x, visible)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = torch.from_numpy(canvas.copy())
        place_patches_plain(got, torch.from_numpy(patches), torch.from_numpy(y), torch.from_numpy(x),
                            torch.from_numpy(visible))
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_place_corners_clip_and_drop_off_canvas_sources():
    int_off = torch.tensor([[0, 0], [-30, 12], [10**6, 0], [5, -10**6]])
    mask = torch.tensor([True, False, True, True])
    y, x, visible = place_corners(int_off, mask, 64, 21, 10, 64 + 2 * 41)
    # pos0 = (64 - 21) // 2 = 21; corner = pos0 + off - 10 + 41
    assert y.tolist()[:2] == [52, 22] and x.tolist()[:2] == [52, 64]
    assert visible.tolist() == [True, False, False, False]
    assert 0 <= int(y.min()) and int(y.max()) <= 146 - 41


@pytest.mark.parametrize(
    "bad",
    [
        {"canvas": torch.zeros(10, 11, 2)},
        {"canvas": torch.zeros(10, 10, 3)},
        {"patches": torch.zeros(2, 4, 5, 2)},
        {"patches": torch.zeros(2, 11, 11, 2)},
        {"y": torch.zeros(3, dtype=torch.int64)},
        {"canvas": torch.zeros(10, 10, 2, dtype=torch.float64)},
        {"canvas": torch.zeros(10, 10, 4)[:, :, ::2]},
    ],
)
def test_place_rejects_bad_arguments(bad):
    args = {"canvas": torch.zeros(10, 10, 2), "patches": torch.zeros(2, 4, 4, 2),
            "y": torch.zeros(2, dtype=torch.int64), "x": torch.zeros(2, dtype=torch.int64),
            "visible": torch.ones(2, dtype=torch.bool)}
    args.update(bad)
    with pytest.raises(ValueError):
        place_patches(**args)


def _stamps(seed, n=7, s=21, b=2):
    rng = np.random.default_rng(seed)
    stamps = rng.uniform(0, 1, (n, s, s, b)).astype(np.float32)
    offsets = np.array(
        [[0.0, 0.0], [3.3, -2.6], [-7.5, 8.25], [30.2, -4.9], [500.0, 0.0], [1.5, 1.5], [-40.1, 39.9]], np.float32
    )[:n]
    mask = np.ones(n, bool)
    mask[5] = False
    return stamps, offsets, mask


@pytest.mark.parametrize("seed", [5, 6])
def test_render_order3_matches_jax(seed):
    """Overlapping stamps, one hanging off the field edge, one off the
    padded canvas, one masked: the order-3 render through the place step
    against the JAX scan."""
    stamps, offsets, mask = _stamps(seed)
    want = np.asarray(jax_render(jnp.asarray(stamps), jnp.asarray(offsets), 64, jnp.asarray(mask), order=3))
    got = render_field(torch.from_numpy(stamps), torch.from_numpy(offsets), 64, torch.from_numpy(mask), order=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * float(np.abs(stamps).max()))
    assert np.abs(want).max() > 0.5


def test_render_order3_incremental_canvas_matches_jax():
    """Two calls into one padded canvas (``canvas=``, ``crop=False``), the
    way the record-array route renders in chunks, against the JAX package's
    incremental render."""
    stamps, offsets, mask = _stamps(7)
    pad = render_pad(21, 3)
    canvas = None
    jcanvas = None
    for sl in (slice(0, 4), slice(4, 7)):
        canvas = render_field(torch.from_numpy(stamps[sl]), torch.from_numpy(offsets[sl]), 64,
                              torch.from_numpy(mask[sl]), order=3, canvas=canvas, crop=False)
        jcanvas = jax_render(jnp.asarray(stamps[sl]), jnp.asarray(offsets[sl]), 64, jnp.asarray(mask[sl]),
                             order=3, canvas=jcanvas, crop=False)
    assert tuple(canvas.shape) == (64 + 2 * pad,) * 2 + (2,)
    window = canvas[pad : pad + 64, pad : pad + 64].numpy()
    jwindow = np.asarray(jcanvas)[pad : pad + 64, pad : pad + 64]
    np.testing.assert_allclose(window, jwindow, rtol=0, atol=1e-5 * float(np.abs(stamps).max()))


def test_render_order3_is_deterministic_on_several_threads():
    stamps, offsets, mask = _stamps(8)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [render_field(torch.from_numpy(stamps), torch.from_numpy(offsets), 64, torch.from_numpy(mask),
                             order=3).numpy() for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(_bits(runs[0]), _bits(runs[1]))


# --------------------------------------------------------------- the race


def _jax_chain_race(filt, threshold):
    """The JAX chain's race, as debvader_tpu/ops/detection.py _detect_core
    computes it (value, then smaller index; out-of-field neighbours -inf),
    and its direction codes; cur0 = parent where masked, 0 elsewhere."""
    f = filt.shape[0]
    mask = filt > threshold
    flat_idx = jnp.arange(f * f, dtype=jnp.int32).reshape(f, f)
    val = jnp.where(mask, filt, -jnp.inf)
    best_val, best_idx = val, flat_idx
    vp = jnp.pad(val, 1, constant_values=-jnp.inf)
    ip = jnp.pad(flat_idx, 1, constant_values=0)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nv = vp[1 + dy : 1 + dy + f, 1 + dx : 1 + dx + f]
            ni = ip[1 + dy : 1 + dy + f, 1 + dx : 1 + dx + f]
            better = (nv > best_val) | ((nv == best_val) & (ni < best_idx))
            best_val = jnp.where(better, nv, best_val)
            best_idx = jnp.where(better, ni, best_idx)
    parent = jnp.where(mask, best_idx, -1)
    iy, ix = flat_idx // f, flat_idx % f
    pdy = jnp.clip(parent // f - iy, -1, 1)
    pdx = jnp.clip(parent % f - ix, -1, 1)
    dir_code = jnp.where(mask, (pdy + 1) * 3 + (pdx + 1), 4)
    return np.asarray(dir_code), np.asarray(jnp.where(mask, parent, 0))


def _race_image(kind):
    rng = np.random.default_rng(21)
    f = 72
    yy, xx = np.mgrid[:f, :f]
    img = 0.05 * rng.normal(size=(f, f)) + 0.01
    if kind == "plateau":
        # a flat-topped source: a filter sums the same values in the same
        # order all over its top, so the race there is ties broken by index
        img[20:44, 16:40] = 5.0
    elif kind == "ties":
        # integer pixels: many equal filtered values
        img = np.floor(rng.uniform(0, 3, (f, f))) + 2.0 * (np.hypot(yy - 36, xx - 36) < 6)
    elif kind == "edges":
        for cy, cx in ((0, 0), (0, 40), (71, 71), (35, 0), (71, 10)):
            img += 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    elif kind == "nan_guarded":
        for cy, cx in ((20, 20), (50, 45)):
            img += 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
        img[20, 21] = np.nan
        img[49:52, 45] = np.inf
        img[0, 5] = -np.inf
    return img.astype(np.float32)


@pytest.mark.parametrize("kind", ["plateau", "ties", "edges", "nan_guarded"])
@pytest.mark.parametrize("kw", [{"use_pallas_filter": True}, {"use_pallas_fused": False}], ids=["mf", "conv"])
def test_chain_race_and_labels_match_jax(kind, kw):
    """The race kernel's wrapper on the JAX chain's filt against the JAX
    chain's codes and parents; the port's chain detect core against the
    JAX chain's labels and peaks, all bit for bit."""
    img = _race_image(kind)
    cfg = DetectionConfig(thresh=1.0, **kw)
    jlabels, jpeak, jfilt, _, jrms = jd._detect_core(jnp.asarray(img), JaxDetectionConfig(thresh=1.0, **kw))
    thr = np.float32(1.0) * np.float32(jrms)
    want_dir, want_cur = _jax_chain_race(jnp.asarray(jfilt), thr)
    dir_code, cur0 = parent_race_kernel(torch.from_numpy(np.array(jfilt))[None], torch.tensor([thr]))
    np.testing.assert_array_equal(dir_code[0].numpy(), want_dir)
    np.testing.assert_array_equal(cur0[0].numpy(), want_cur)
    masked = np.asarray(jfilt) > thr
    assert masked.sum() > 20
    if kind == "plateau":
        assert (want_dir[masked] != 4).sum() > 100  # the ties are raced
    labels, _, _ = td._detect_core(torch.from_numpy(img), cfg)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    peaks = (labels.numpy() == np.arange(img.size).reshape(img.shape)) & (labels.numpy() >= 0)
    np.testing.assert_array_equal(peaks, np.asarray(jpeak))


def test_parent_race_kernel_takes_the_plain_race_on_the_cpu():
    rng = np.random.default_rng(4)
    filt = torch.from_numpy(rng.normal(size=(3, 33, 33)).astype(np.float32))
    thr = torch.tensor([0.0, 0.5, -1.0])
    for got, want in zip(parent_race_kernel(filt, thr), parent_race(filt, thr)):
        assert got.dtype == torch.int32
        assert torch.equal(got, want)


@pytest.mark.parametrize(
    "filt,thr",
    [
        (torch.zeros(4, 4), torch.zeros(1)),
        (torch.zeros(1, 4, 5), torch.zeros(1)),
        (torch.zeros(2, 4, 4), torch.zeros(1)),
        (torch.zeros(1, 4, 4), torch.zeros(())),
    ],
)
def test_parent_race_kernel_rejects_bad_shapes(filt, thr):
    with pytest.raises(ValueError):
        parent_race_kernel(filt, thr)


@pytest.mark.parametrize("threshold", [0.3, np.float32(0.3), torch.tensor(0.3), torch.tensor([0.3]),
                                       torch.tensor([0.3], dtype=torch.float64)])
def test_matched_filter_takes_any_threshold_form(threshold):
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.normal(size=(40, 40)).astype(np.float32))
    back = torch.full((40, 40), 0.01)
    filt, mask = matched_filter_threshold(img, back, default_filter_kernel(), threshold)
    pfilt, pmask = matched_filter_threshold_plain(img, back, default_filter_kernel(), torch.tensor([0.3]))
    assert torch.equal(filt, pfilt) and torch.equal(mask, pmask)
    assert mask.dtype == torch.bool and mask.any() and not mask.all()


# --------------------------------------------------------------- config


def test_detection_config_defaults_and_fields_equal_jax():
    ours, theirs = DetectionConfig(), JaxDetectionConfig()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize(
    "kw",
    [
        {"use_pallas_select": False, "use_pallas_clip": True, "thresh": 3.0},
        {"use_pallas_fused": True, "use_pallas_clip": False, "threshold_scaling": "matched"},
        {"deblend_algo": "lutz", "minarea": 6, "clean": False, "clean_param": 2.0},
        {"use_pallas_filter": True, "filter_size": 5, "filter_fwhm": 2.0, "detection_band": 1},
    ],
)
def test_a_jax_detection_config_carries_over(kw):
    theirs = JaxDetectionConfig(**kw)
    ours = DetectionConfig(**dataclasses.asdict(theirs))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for name, value in kw.items():
        assert getattr(ours, name) == value


def test_deblend_algo_is_checked_as_jax_checks_it():
    for cls in (DetectionConfig, JaxDetectionConfig):
        with pytest.raises(ValueError, match="deblend_algo must be 'watershed' or 'lutz', got 'sep'"):
            cls(deblend_algo="sep")


def test_lutz_is_not_ported_yet():
    img = np.zeros((32, 32), np.float32)
    with pytest.raises(NotImplementedError, match="Queue 1, item: 3"):
        td.detect_objects(img, DetectionConfig(deblend_algo="lutz"), device="cpu")


# ------------------------------------------------------------ fp32_math


@pytest.mark.parametrize("before", [False, True])
def test_fp32_math_scopes_cudnn_determinism(before, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", before)
    tf32 = torch.backends.cudnn.allow_tf32
    with dv.fp32_math():
        assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.deterministic is before
    assert torch.backends.cudnn.allow_tf32 is tf32
    with pytest.raises(RuntimeError), dv.fp32_math():
        raise RuntimeError("inside")
    assert torch.backends.cudnn.deterministic is before


def test_fp32_math_follows_the_determinism_switch(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(dv, "_CUDNN_DETERMINISTIC", False)
    with dv.fp32_math():
        assert torch.backends.cudnn.deterministic is False
    assert torch.backends.cudnn.deterministic is True
