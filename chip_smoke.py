"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
without printing its last line):

1. versions, the card's name and power limit, the TF32 flags;
2. build every kernel in debvader_tpu_torch/csrc with nvcc (timed);
3. each kernel against its plain version on the card at its path's shapes
   (a 1024x1024 field: 16x16 boxes of 4096 pixels for the clipped
   statistics, (1, 1024, 1024) for the detect core and the labels,
   (1024, 1024) for the stand-alone matched filter on both of its
   branches, 295 stamps of 59x59x6 for the render), with CUDA-event
   timings of kernel, plain version and library yardstick;
4. the record-array path through the public entry points:
   load_deblender("sim_demo") once, then detect_objects ->
   DeblendField(z_mode="mean").deblend_field -> get_residual_field on a
   seeded 1024x1024x6 field of ~300 simulated galaxies, with every kernel's
   launch count reset before and read after; then warm runs timed per
   stage, one warm run under torch.profiler (the device's idle share), and
   detection at the default threshold;
5. the decoder-tail kernel on the real tail input of that path's batch
   (caught by a hook on the decoder's last transposed conv) against the
   decoder's own output before the crop;
6. the streaming serving path: detect_objects with the stand-alone filter
   kernel (the same offsets as the fused core), then
   DeblendField(cfg=PipelineConfig(interp_order=1, source_chunk=128))
   .deblend_and_render / .deblend_and_predict in three chunks, launch
   counts reset before and read after, held against the record-array
   route of the same object; warm stage times, one profiled warm
   deblend_and_render, and the peak device memory of one stream chunk;
7. both routes on a 256x256 crop on the card and on the CPU (plain
   versions), which must agree, with TF32 switched on outside the port;
8. one {"kernels": [...]} line, the nvidia-smi line, and the last line
   {"ok": true, "device": {...}}.

A fuller report (ptxas output, every timing, the profiled run's top device
events) goes to chiprun_out/chip_smoke_report.json.  Needs no network;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the float32 rate
# outside the tensor cores, used for each kernel's lower bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
REPS = 30
WARMUP = 3
# A 5-sigma matched-filter threshold: at the default 1.5 x unfiltered rms
# the detector also splits the pure-noise sky into peaks (11,565 sources
# on this field, timed on their own in phase 4); here it finds ~300, one
# for each galaxy.
DETECTION = dict(thresh=5.0, threshold_scaling="matched")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_field(size=1024, n_gal=300, bands=6, noise=0.02, seed=0) -> np.ndarray:
    """(1, size, size, bands) float32: elliptical two-Gaussian galaxies with
    a smooth band SED (after debvader_tpu/data/simulate.py), a Gaussian PSF
    blur (sigma 1.2 px) and Gaussian pixel noise, all from ``seed``."""
    from scipy.ndimage import convolve1d

    rng = np.random.default_rng(seed)
    field = np.zeros((size, size, bands), np.float64)
    half = 20
    yy, xx = np.mgrid[-half : half + 1, -half : half + 1]
    margin = min(40, size // 4)
    for _ in range(n_gal):
        cy, cx = rng.uniform(margin, size - margin, 2)
        flux = rng.uniform(5.0, 50.0)
        r50 = rng.uniform(1.5, 4.0)
        e1, e2 = rng.uniform(-0.3, 0.3, 2)
        sed = np.exp(rng.uniform(-0.15, 0.15) * np.arange(bands))
        sed /= sed.mean()
        iy, ix = int(cy), int(cx)
        dy, dx = yy - (cy - iy), xx - (cx - ix)
        q = (1 + e1) * dx * dx + (1 - e1) * dy * dy + 2 * e2 * dx * dy
        prof = 0.7 * np.exp(-q / (2 * (0.6 * r50) ** 2)) + 0.3 * np.exp(-q / (2 * (1.8 * r50) ** 2))
        prof /= prof.sum()
        field[iy - half : iy + half + 1, ix - half : ix + half + 1] += flux * prof[..., None] * sed
    r = np.arange(7) - 3
    g = np.exp(-(r**2) / (2 * 1.2**2))
    g /= g.sum()
    field = convolve1d(convolve1d(field, g, axis=0, mode="constant"), g, axis=1, mode="constant")
    field += noise * rng.normal(size=field.shape)
    return field[None].astype(np.float32)


def cuda_ms(torch, fn) -> float:
    """Median milliseconds of ``fn`` over REPS runs after WARMUP, each run
    between two CUDA events."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profiled_device_ms(torch, fn, kernel_name: str):
    """Mean device time of the CUDA kernel ``kernel_name`` over REPS calls
    of ``fn``, from torch.profiler's device events; None when the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if kernel_name in e.key and str(e.device_type).endswith("CUDA"):
            total += float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))
            count += int(e.count)
    return total / count / 1e3 if count and total > 0 else None


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, field_r: np.ndarray) -> list[dict]:
    """Phase 3: every kernel against its plain version at the main path's
    shapes; returns the kernel records (launches filled in later)."""
    import torch.nn.functional as F

    from debvader_tpu_torch.kernels import clipped_stats as cs
    from debvader_tpu_torch.kernels import detect_fused as df
    from debvader_tpu_torch.kernels import label_select as ls
    from debvader_tpu_torch.ops.detection import default_filter_kernel, estimate_background

    dev = torch.device("cuda")
    img = torch.as_tensor(field_r, device=dev)
    f = img.shape[0]
    box = 64
    g = f // box
    boxes = img.reshape(g, box, g, box).permute(0, 2, 1, 3).reshape(g * g, box * box).contiguous()
    # edge cases beside the field's boxes: a half-masked box, an
    # all-invalid box and a constant box
    extra = torch.randn((3, box * box), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    extra[2] = 0.25
    xb = torch.cat([boxes, extra])
    vb = torch.ones_like(xb)
    vb[g * g, ::2] = 0
    vb[g * g + 1] = 0
    records = []

    # --- clipped statistics ---------------------------------------------
    got = cs.sigma_clipped_stats(xb, vb)
    want = cs.sigma_clipped_stats_plain(xb, vb)
    torch.cuda.synchronize()
    if not torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)):
        raise AssertionError("clipped_stats: medians differ from the plain version")
    err = 0.0
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        e = float((a - b).abs().max())
        if e > 1e-5 * float(b.abs().max()):
            raise AssertionError(f"clipped_stats: mean/std off by {e}")
        err = max(err, e)
    vf = torch.ones_like(boxes)
    n, p = boxes.shape
    # The operations the function needs, not this design's 35-pass radix
    # descend: in each of the 4 rounds (3 clips, then the statistics) a
    # pixel takes a clip test, a count, a sum, a sum of squares and a step
    # of a linear-time selection, ~8 operations.
    t_bound, by = bound(n * p * 8 + n * 12, n * p * 4 * 8)
    masked = torch.where(vf > 0, boxes, torch.full_like(boxes, float("inf")))
    records.append({
        "name": "clipped_stats", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/clipped_stats.cu",
        "replaces": "debvader_tpu/kernels/clipped_stats.py:126",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: cs.sigma_clipped_stats(boxes, vf)),
        "device_ms": profiled_device_ms(torch, lambda: cs.sigma_clipped_stats(boxes, vf), "clipped_stats_kernel"),
        "plain_ms": cuda_ms(torch, lambda: cs.sigma_clipped_stats_plain(boxes, vf)),
        "library_ms": cuda_ms(torch, lambda: torch.sort(masked, dim=-1)),
        "library_call": "torch.sort of the boxes",
        "bound_ms": t_bound, "bound_by": by,
        "shape": [n, p],
    })

    # --- fused detect core ------------------------------------------------
    back, _, _, grms = estimate_background(img, box=box)
    images = img[None].contiguous()
    backs = back[None].contiguous()
    kernel = default_filter_kernel()
    scale = float(np.sqrt(np.sum(np.square(kernel)))) if DETECTION["threshold_scaling"] == "matched" else 1.0
    thr = (DETECTION["thresh"] * grms * scale).reshape(1)
    filt, dirc, parent = df.matched_filter_parents(images, backs, kernel, thr)
    filt_p, _, _ = df.matched_filter_parents_plain(images, backs, kernel, thr)
    dir_p, parent_p = df.parent_race(filt, thr)
    torch.cuda.synchronize()
    err = float((filt - filt_p).abs().max())
    if err > 1e-5 * float(filt_p.abs().max()):
        raise AssertionError(f"detect_fused: filt off by {err}")
    if not (torch.equal(dirc, dir_p) and torch.equal(parent, parent_p)):
        raise AssertionError("detect_fused: dir_code/parent differ from the plain race")
    t_bound, by = bound(f * f * 20 + 4 + 56, f * f * 54)
    kt = torch.as_tensor(kernel, device=dev)[None, None]
    fore = (images - backs)[None]
    records.append({
        "name": "detect_fused", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/detect_fused.cu",
        "replaces": "debvader_tpu/kernels/detect_fused.py:112",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: df.matched_filter_parents(images, backs, kernel, thr)),
        "device_ms": profiled_device_ms(
            torch, lambda: df.matched_filter_parents(images, backs, kernel, thr), "detect_fused_kernel"
        ),
        "plain_ms": cuda_ms(torch, lambda: df.matched_filter_parents_plain(images, backs, kernel, thr)),
        "library_ms": cuda_ms(torch, lambda: F.conv2d(fore, kt, padding=3)),
        "library_call": "F.conv2d of the 7x7 filter alone",
        "bound_ms": t_bound, "bound_by": by,
        "shape": [1, f, f],
        "filt_bit_identical": err == 0.0,
    })

    # --- label resolution -------------------------------------------------
    cur0 = parent.reshape(f, f)
    dir2 = dirc.reshape(f, f)
    labels = ls.label_fixpoint(cur0, dir2)
    labels_p = ls.label_fixpoint_plain(cur0, dir2)
    torch.cuda.synchronize()
    if not torch.equal(labels, labels_p):
        raise AssertionError("label_select: labels differ from the plain fixpoint")
    # data-dependent work: one chase step per pixel per edge on its path
    steps = _path_steps(torch, dir2)
    t_bound, by = bound(f * f * 12, f * f + 4 * steps)
    records.append({
        "name": "label_select", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/label_select.cu",
        "replaces": "debvader_tpu/kernels/label_select.py:123",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: ls.label_fixpoint(cur0, dir2)),
        "device_ms": profiled_device_ms(torch, lambda: ls.label_fixpoint(cur0, dir2), "label_resolve_kernel"),
        "plain_ms": cuda_ms(torch, lambda: ls.label_fixpoint_plain(cur0, dir2)),
        "library_ms": None,
        "bound_ms": t_bound, "bound_by": by,
        "shape": [f, f],
        "path_steps": steps,
    })
    return records


def check_filter_and_render(torch, field_r: np.ndarray) -> list[dict]:
    """Phase 3, the kernels of the streaming slice that need no model: the
    stand-alone matched filter on the r band (both branches, filt bit for
    bit) and the render at the serving path's shapes."""
    import torch.nn.functional as F

    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.kernels import matched_filter as mf
    from debvader_tpu_torch.kernels import render as rd
    from debvader_tpu_torch.ops.detection import default_filter_kernel, estimate_background

    dev = torch.device("cuda")
    img = torch.as_tensor(field_r, device=dev)
    f = img.shape[0]
    records = []

    # --- stand-alone matched filter ---------------------------------------
    back, _, _, grms = estimate_background(img, box=64)
    kernel = default_filter_kernel()
    scale = float(np.sqrt(np.sum(np.square(kernel)))) if DETECTION["threshold_scaling"] == "matched" else 1.0
    thr = (DETECTION["thresh"] * grms * scale).reshape(1)
    # a filter that does not separate takes the 49-tap branch
    full = (kernel + 0.05 * np.random.default_rng(5).random((7, 7))).astype(np.float32)
    identical = {}
    for branch, k in (("separable", kernel), ("taps49", full)):
        filt, mask = mf.matched_filter_threshold(img, back, k, thr)
        filt_p, _ = mf.matched_filter_threshold_plain(img, back, k, thr)
        torch.cuda.synchronize()
        identical[branch] = torch.equal(filt.view(torch.int32), filt_p.view(torch.int32))
        if not identical[branch]:
            raise AssertionError(f"matched_filter ({branch}): filt is not bit-identical to the plain version")
        # a filt within an ulp of the threshold would flip a mask taken
        # from another filt: the mask is held to the kernel's own
        if not torch.equal(mask, filt > thr):
            raise AssertionError(f"matched_filter ({branch}): mask differs from filt > threshold")
    t_bound, by = bound(f * f * 13 + 4 + 56, f * f * 28)
    kt = torch.as_tensor(kernel, device=dev)[None, None]

    def library():
        with fp32_math():
            return F.conv2d((img - back)[None, None], kt, padding=3) > thr

    records.append({
        "name": "matched_filter", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/matched_filter.cu",
        "replaces": "debvader_tpu/kernels/matched_filter.py:144",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: mf.matched_filter_threshold(img, back, kernel, thr)),
        "device_ms": profiled_device_ms(
            torch, lambda: mf.matched_filter_threshold(img, back, kernel, thr), "matched_filter_kernel"
        ),
        "taps49_ms": cuda_ms(torch, lambda: mf.matched_filter_threshold(img, back, full, thr)),
        "plain_ms": cuda_ms(torch, lambda: mf.matched_filter_threshold_plain(img, back, kernel, thr)),
        "library_ms": cuda_ms(torch, library),
        "library_call": "subtract, F.conv2d (float32), compare",
        "bound_ms": t_bound, "bound_by": by,
        "shape": [f, f],
        "filt_bit_identical": identical,
    })

    # --- render -------------------------------------------------------------
    n, s, b = 295, 59, 6
    gen = torch.Generator(device=dev).manual_seed(2)
    stamps = torch.rand((n, s, s, b), generator=gen, device=dev)
    # fractional offsets over the whole field, some stamps hanging over its
    # edge, one source masked out
    offsets = (torch.rand((n, 2), generator=gen, device=dev) - 0.5) * (f + 40)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[7] = False
    got = rd.render_field_kernel(stamps, offsets, f, mask)
    want = rd.render_field_plain(stamps, offsets, f, mask)
    again = rd.render_field_kernel(stamps, offsets, f, mask)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > 1e-5 * float(stamps.abs().max()):
        raise AssertionError(f"render: off by {err} from the plain version")
    if not torch.equal(got, again):
        raise AssertionError("render: two launches on the same inputs differ")
    if not float(want.abs().max()) > 1.0:
        raise AssertionError("render: the test field holds no overlapping stamps")
    # each stamp read once and the field written once; a shifted patch
    # pixel takes 6 multiplies and 5 adds, with the add into the field
    t_bound, by = bound(n * s * s * b * 4 + n * 9 + f * f * b * 4, n * (s + 2) * (s + 2) * b * 11)
    records.append({
        "name": "render", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/render.cu",
        "replaces": "debvader_tpu/kernels/render.py:149",
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: rd.render_field_kernel(stamps, offsets, f, mask)),
        "device_ms": profiled_device_ms(torch, lambda: rd.render_field_kernel(stamps, offsets, f, mask), "render_kernel"),
        "plain_ms": cuda_ms(torch, lambda: rd.render_field_plain(stamps, offsets, f, mask)),
        "library_ms": None,
        "bound_ms": t_bound, "bound_by": by,
        "shape": [n, s, s, b, f],
        "deterministic": True,
    })
    return records


def check_decoder_tail(torch, net, stamps: np.ndarray) -> dict:
    """Phase 5: the fused decoder tail on the real tail input of the main
    path's batch against the decoder's own output before the crop.  The
    launch that is counted is one call of the public function on those
    activations; comparison and timing launches come after the count is
    read."""
    import torch.nn.functional as F

    import debvader_tpu_torch as dt
    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.kernels import decoder_tail as dtl

    caught = {}
    pre = net.decoder.convts[-1].register_forward_pre_hook(lambda m, a: caught.update(x=a[0]))
    post = net.decoder.head.register_forward_hook(lambda m, a, out: caught.update(y=out))
    dt.deblend(net, stamps, z_mode="mean", device="cuda")
    pre.remove()
    post.remove()
    x = caught["x"].permute(0, 2, 3, 1).contiguous()  # (N, 64, 64, 32)
    want = F.relu(caught["y"]).permute(0, 2, 3, 1)     # (N, 64, 64, 12)
    params = dt.decoder_tail_params(net.decoder)

    dtl.fused_decoder_tail.launches = 0
    got = dt.fused_decoder_tail(x, *params)
    torch.cuda.synchronize()
    launches = dtl.fused_decoder_tail.launches
    if launches <= 0:
        raise AssertionError("decoder_tail: the kernel was not launched")
    err = float((got - want).abs().max())
    if got.shape != want.shape or err > 5e-5 * float(want.abs().max()):
        raise AssertionError(f"decoder_tail: off by {err} from the decoder's own output")
    plain = dtl.decoder_tail_plain(x, *params)
    err_plain = float((got - plain).abs().max())
    if err_plain > 5e-5 * float(plain.abs().max()):
        raise AssertionError(f"decoder_tail: off by {err_plain} from the plain version")

    n, size, _, c = x.shape
    o = want.shape[-1]
    t_bound, by = bound(
        (x.numel() + want.numel() + sum(p.numel() for p in params)) * 4,
        n * size * size * 2 * 9 * c * (c + o),
    )
    x_nchw = caught["x"]
    convt, prelu, head = net.decoder.convts[-1], net.decoder.prelus[-1], net.decoder.head

    def library():
        with torch.no_grad(), fp32_math():
            return F.relu(head(prelu(convt(x_nchw))))

    return {
        "name": "decoder_tail", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/decoder_tail.cu",
        "replaces": "debvader_tpu/kernels/decoder_tail.py:105",
        "launches": launches,
        "launched_by": "one stand-alone call on the main path's tail input (no entry point calls it, as in the JAX package)",
        "max_abs_err": max(err, err_plain),
        "ms": cuda_ms(torch, lambda: dtl.fused_decoder_tail(x, *params)),
        "device_ms": profiled_device_ms(torch, lambda: dtl.fused_decoder_tail(x, *params), "decoder_tail_kernel"),
        "plain_ms": cuda_ms(torch, lambda: dtl.decoder_tail_plain(x, *params)),
        "library_ms": cuda_ms(torch, library),
        "library_call": "the decoder's own layers (conv_transpose2d, PReLU, conv2d, ReLU on cuDNN, float32)",
        "bound_ms": t_bound, "bound_by": by,
        "shape": [n, size, size, c, o],
        "output_max_abs": float(want.abs().max()),
    }


def serving_cfg(chunk=128):
    import debvader_tpu_torch as dt

    return dt.PipelineConfig(interp_order=1, source_chunk=chunk)


def catalogs_agree(cat, res) -> None:
    """The stream's catalog against another catalog or record array of the
    same sources: the index, flag and position columns equal."""
    for col in ("list_idx", "passed_cuts", "galaxy_distances_to_center_x", "galaxy_distances_to_center_y"):
        if not np.array_equal(cat[col], res[col]):
            raise AssertionError(f"catalog column {col} differs between the two routes")


def run_serving_path(torch, net, field: np.ndarray, device: str):
    """Phase 6: detect with the stand-alone filter kernel, then the two
    streaming entry points in chunks of 128 sources."""
    import debvader_tpu_torch as dt

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    centers = dt.detect_objects(field, dt.DetectionConfig(use_pallas_filter=True, **DETECTION), device=device)
    sync()
    detect_s = time.perf_counter() - t0
    dfield = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device=device)
    render_t, predict_t = {}, {}
    catalog, residual, model = dfield.deblend_and_render(
        centers, return_model=True, measure=True, timings=render_t
    )
    _, fields = dfield.deblend_and_predict(centers, timings=predict_t)
    times = {"detect_s": detect_s, "deblend_and_render": render_t, "deblend_and_predict": predict_t}
    return dfield, centers, catalog, residual, model, fields, times


def _path_steps(torch, dir_code) -> int:
    """Total chase steps over all pixels (sum of ascent path lengths)."""
    h, w = dir_code.shape
    flat = dir_code.reshape(-1).long()
    pos = torch.arange(h * w, device=dir_code.device)
    steps = 0
    active = flat[pos] != 4
    while bool(active.any()):
        steps += int(active.sum())
        d = flat[pos]
        move = (d // 3 - 1) * w + (d % 3 - 1)
        pos = torch.where(active, pos + move, pos)
        active = flat[pos] != 4
    return steps


def run_main_path(torch, net, field: np.ndarray, device: str):
    """Phase 4: detect -> deblend -> residual through the public entry
    points, each stage timed on the host clock up to a device synchronise.
    ``net`` comes from load_deblender, which a user pays once a process."""
    import debvader_tpu_torch as dt

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    centers = dt.detect_objects(field, dt.DetectionConfig(**DETECTION), device=device)
    sync()
    t1 = time.perf_counter()
    dfield = dt.DeblendField(net, field, z_mode="mean", device=device)
    res = dfield.deblend_field(centers)
    sync()
    t2 = time.perf_counter()
    residual = dfield.get_residual_field()
    sync()
    t3 = time.perf_counter()
    times = {"detect_s": t1 - t0, "deblend_s": t2 - t1, "residual_s": t3 - t2}
    return centers, res, residual, times


def profile_run(torch, fn) -> dict:
    """One call of ``fn`` (warm, ending in a synchronise) under
    torch.profiler: host wall time, device-busy time (the device-side
    events: kernels, copies, memsets), the device's idle share and the top
    device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    # device-side events only: the host ops that launched them carry the
    # same time again
    events = sorted(
        ({"name": e.key, "device_ms": device_us(e) / 1e3, "calls": int(e.count)}
         for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and device_us(e) > 0),
        key=lambda r: -r["device_ms"],
    )
    busy_ms = sum(r["device_ms"] for r in events)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "top_device_events": events[:25]}


def stamp_mask(field_size: int, centers: np.ndarray, size: int = 59) -> np.ndarray:
    mask = np.zeros((field_size, field_size), bool)
    half = field_size // 2
    for cy, cx in np.trunc(centers).astype(int):
        y0, x0 = cy + half - size // 2, cx + half - size // 2
        if 0 <= y0 and y0 + size <= field_size and 0 <= x0 and x0 + size <= field_size:
            mask[y0 : y0 + size, x0 : x0 + size] = True
    return mask


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import debvader_tpu_torch  # noqa: F401  (fails outside the repo)
    from debvader_tpu_torch.kernels import _build
    from debvader_tpu_torch.kernels import clipped_stats as cs
    from debvader_tpu_torch.kernels import detect_fused as df
    from debvader_tpu_torch.kernels import label_select as ls
    from debvader_tpu_torch.kernels import matched_filter as mf
    from debvader_tpu_torch.kernels import render as rd

    report = {}
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {smi}")
    report["card"] = smi

    t = time.perf_counter()
    logs = _build.build_all()
    report["build_s"] = time.perf_counter() - t
    report["ptxas"] = logs
    print(f"built {sorted(logs)} in {report['build_s']:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    field = make_field()
    records = check_kernels(torch, field[0, :, :, 2])
    records += check_filter_and_render(torch, field[0, :, :, 2])
    print("kernels match their plain versions")

    import debvader_tpu_torch as dt

    t = time.perf_counter()
    net = dt.load_deblender("sim_demo", device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t

    # A caller with TF32 on for their own code: the port scopes float32 to
    # its forward and background matmuls, leaves these flags as they were,
    # and phase 7 holds its outputs to the CPU's.
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    counters = {
        "clipped_stats": cs.sigma_clipped_stats,
        "detect_fused": df.matched_filter_parents,
        "label_select": ls.label_fixpoint,
        "matched_filter": mf.matched_filter_threshold,
        "render": rd.render_field_kernel,
    }

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts(path, needed):
        counts = {k: fn.launches for k, fn in counters.items()}
        for name, least in needed.items():
            if counts[name] < least:
                raise AssertionError(
                    f"kernel {name} was launched {counts[name]} times on the {path} path, expected >= {least}"
                )
        return counts

    reset_counts()
    centers, res, residual, times = run_main_path(torch, net, field, "cuda")
    launches = read_counts("record-array", {"clipped_stats": 1, "detect_fused": 1, "label_select": 1})
    if not (torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("the main path changed the caller's TF32 flags")
    print(f"tf32 outside the port: cudnn {torch.backends.cudnn.allow_tf32} "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}")
    means = np.stack(list(res.output_images_mean))
    if not (np.isfinite(means).all() and np.isfinite(residual).all()):
        raise AssertionError("non-finite outputs on the main path")
    if means.shape != (len(res), 59, 59, 6) or residual.shape != field.shape:
        raise AssertionError("unexpected output shapes")
    mask = stamp_mask(field.shape[1], np.stack([res.galaxy_distances_to_center_x, res.galaxy_distances_to_center_y], -1))
    flux_field = float(np.abs(field[0][mask]).sum())
    flux_resid = float(np.abs(residual[0][mask]).sum())
    if not flux_resid < flux_field:
        raise AssertionError(f"residual flux {flux_resid} is not below the field's {flux_field}")
    main = {
        "field": list(field.shape), "sources": int(len(centers)), "deblended": int(len(res)),
        "abs_flux_in_stamps": {"field": flux_field, "residual": flux_resid},
        "launches": launches, "load_s": load_s, "first_run": times,
    }
    print(json.dumps({"main_path": main}))
    report["main_path"] = main

    # warm runs: stage times, then one profiled run for the device's idle
    # share; and detection at the default threshold for its host cost
    warm = [run_main_path(torch, net, field, "cuda")[3] for _ in range(2)]
    prof = profile_run(torch, lambda: run_main_path(torch, net, field, "cuda"))
    default_runs = []
    for _ in range(2):
        t = time.perf_counter()
        found = dt.detect_objects(field, device="cuda")
        default_runs.append(time.perf_counter() - t)
    default = {"sources": int(len(found)), "detect_s": default_runs}
    report.update(warm=warm, profiled_run=prof, default_detection=default)
    print(json.dumps({"warm": warm, "default_detection": default}))
    print(f"profiled warm run: wall {prof['wall_ms']} ms, device busy {prof['device_busy_ms']} ms, "
          f"idle share {prof['device_idle_share']}")
    for r in prof["top_device_events"][:12]:
        print(f"  {r['device_ms']:9.3f} ms  {r['calls']:6d}  {r['name'][:100]}")

    # phase 5: the decoder tail on this batch's real tail input
    tail = check_decoder_tail(torch, net, np.stack(list(res.cutout_images)))
    records.append(tail)
    print(json.dumps({"decoder_tail": {k: tail[k] for k in ("shape", "launches", "max_abs_err", "output_max_abs")}}))

    # phase 6: the streaming serving path, counts from 0
    reset_counts()
    dfield, s_centers, catalog, s_residual, s_model, s_fields, s_times = run_serving_path(torch, net, field, "cuda")
    serving_launches = read_counts(
        "streaming", {"clipped_stats": 1, "label_select": 1, "matched_filter": 1, "render": 3}
    )
    if not np.array_equal(s_centers, centers):
        raise AssertionError("detection with the stand-alone filter kernel differs from the fused core")
    if len(catalog) != len(res) or s_residual.shape != field.shape or s_model.shape != field.shape[1:]:
        raise AssertionError("unexpected output shapes on the streaming path")
    if not all(np.isfinite(a).all() for a in (s_residual, s_model, *(v for v in s_fields.values() if v is not None))):
        raise AssertionError("non-finite outputs on the streaming path")
    # the record-array route of the same object renders the same stamps
    r_res = dfield.deblend_field(centers)
    r_residual = dfield.get_residual_field()
    r_pred = dfield.get_predicted_field()
    catalogs_agree(catalog, r_res)
    scale = float(np.abs(field).max())
    routes = {
        "residual": float(np.abs(s_residual - r_residual).max()),
        "residual_predict": float(np.abs(s_fields["residual_field"] - r_residual).max()),
        "model": float(np.abs(s_model - r_pred["predicted_mean_field"]).max()),
        "mean": float(np.abs(s_fields["predicted_mean_field"] - r_pred["predicted_mean_field"]).max()),
        "stddev": float(np.abs(s_fields["predicted_stddev_field"] - r_pred["predicted_stddev_field"]).max()),
    }
    for name, err in routes.items():
        if err > 1e-5 * scale:
            raise AssertionError(f"streaming and record-array routes differ on the {name} field by {err}")
    flux = np.stack(list(catalog.flux))
    if flux.shape != (len(catalog), 6) or not np.isfinite(flux).all():
        raise AssertionError("measure=True gave no finite per-band flux")
    serving = {
        "sources": int(len(s_centers)), "deblended": int(len(catalog)), "chunks": -(-len(s_centers) // 128),
        "launches": serving_launches, "first_run": s_times,
        "routes_max_abs_err": routes, "field_max_abs": scale,
        "passed_cuts": int(catalog.passed_cuts.sum()),
    }
    print(json.dumps({"serving_path": serving}))

    # warm stage times of the streaming route, one profiled warm
    # deblend_and_render, and the peak device memory of one stream chunk
    s_warm = [run_serving_path(torch, net, field, "cuda")[6] for _ in range(3)]
    s_prof = profile_run(
        torch, lambda: dfield.deblend_and_render(centers, return_model=True, measure=True)
    )
    one = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(chunk=8192))
    one.deblend_and_predict(centers, measure=True)  # warm, field memoized
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    one.deblend_and_predict(centers, measure=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    canvas_bytes = 2 * (field.shape[1] + 2 * dt.render_pad(59, 1)) ** 2 * 6 * 4
    chunk_mem = {
        "sources": int(len(catalog)), "baseline_bytes": int(base), "peak_bytes": int(peak),
        "canvas_bytes": int(canvas_bytes),
        "bytes_per_source": (peak - base - canvas_bytes) / len(catalog),
        "device_total_bytes": int(torch.cuda.get_device_properties(0).total_memory),
        "stream_chunk_at_this_field": int(one._stream_chunk(3)),
    }
    serving.update(warm=s_warm, profiled_deblend_and_render=s_prof, stream_chunk_memory=chunk_mem)
    report["serving_path"] = serving
    print(json.dumps({"serving_warm": s_warm, "stream_chunk_memory": chunk_mem}))
    print(f"profiled warm deblend_and_render: wall {s_prof['wall_ms']} ms, device busy "
          f"{s_prof['device_busy_ms']} ms, idle share {s_prof['device_idle_share']}")
    for r in s_prof["top_device_events"][:12]:
        print(f"  {r['device_ms']:9.3f} ms  {r['calls']:6d}  {r['name'][:100]}")

    # phase 7: a 256^2 crop on the card (TF32 still on outside the port)
    # and on the CPU must agree; the forward run outside the port's scope,
    # with TF32 on, shows the error the check is there to catch
    crop = np.ascontiguousarray(field[:, 384:640, 384:640, :])
    net_cpu = dt.load_deblender("sim_demo", device="cpu")
    c_gpu, r_gpu, res_gpu, _ = run_main_path(torch, net, crop, "cuda")
    c_cpu, r_cpu, res_cpu, _ = run_main_path(torch, net_cpu, crop, "cpu")
    if not np.array_equal(c_gpu, c_cpu):
        raise AssertionError("detect_objects differs between card and CPU on the crop")
    m_gpu = np.stack(list(r_gpu.output_images_mean))
    m_cpu = np.stack(list(r_cpu.output_images_mean))
    mean_err = float(np.abs(m_gpu - m_cpu).max())
    resid_err = float(np.abs(res_gpu - res_cpu).max())
    with torch.no_grad():
        stamps = torch.as_tensor(np.stack(list(r_cpu.cutout_images)), device="cuda")
        m_tf32 = net(stamps, z_mode="mean")[0].mean().cpu().numpy()
    # the streaming route on the crop: the render kernel on the card
    # against its plain version on the CPU
    sg = run_serving_path(torch, net, crop, "cuda")
    sc = run_serving_path(torch, net_cpu, crop, "cpu")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    if mean_err > 1e-4 * float(np.abs(m_cpu).max()) or resid_err > 1e-4 * float(np.abs(crop).max()):
        raise AssertionError(f"card and CPU disagree on the crop: means {mean_err}, residual {resid_err}")
    if not np.array_equal(sg[1], sc[1]) or not np.array_equal(sg[1], c_cpu):
        raise AssertionError("detection with the filter kernel differs between card and CPU on the crop")
    catalogs_agree(sg[2], sc[2])
    stream_err = {
        "residual": float(np.abs(sg[3] - sc[3]).max()),
        "model": float(np.abs(sg[4] - sc[4]).max()),
        "stddev": float(np.abs(sg[5]["predicted_stddev_field"] - sc[5]["predicted_stddev_field"]).max()),
        "flux_rel": float(np.abs(np.stack(list(sg[2].flux)) / np.stack(list(sc[2].flux)) - 1).max()),
    }
    if max(stream_err["residual"], stream_err["model"], stream_err["stddev"]) > 1e-4 * float(np.abs(crop).max()):
        raise AssertionError(f"card and CPU disagree on the crop's streaming route: {stream_err}")
    small = {"sources": int(len(c_gpu)), "mean_max_abs_err": mean_err, "residual_max_abs_err": resid_err,
             "streaming_max_abs_err": stream_err,
             "tf32_forward_mean_max_abs_err": float(np.abs(m_tf32 - m_cpu).max()),
             "mean_max_abs": float(np.abs(m_cpu).max())}
    print(json.dumps({"crop_vs_cpu": small}))
    report["crop_vs_cpu"] = small

    # launches: the first three kernels on the record-array path, the
    # filter and the render on the streaming path, each counted from 0;
    # the decoder tail carries its own
    counted_on = dict.fromkeys(("clipped_stats", "detect_fused", "label_select"), launches)
    counted_on.update(dict.fromkeys(("matched_filter", "render"), serving_launches))
    for rec in records:
        if rec["name"] in counted_on:
            rec["launches"] = counted_on[rec["name"]][rec["name"]]
        rec["kernel_ms"] = rec["ms"]
    report["kernels"] = records
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "kernel_ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(nvidia_smi_line())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
