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
   timings of kernel, plain version and library yardstick; the clipped
   statistics also on edge boxes (ties, signed zeros around the median,
   an overflowing mean whose first clip is empty, boxes of 50^2, 128^2
   and 160^2 pixels), the render also at the serving path's shape (one
   128-source chunk added into a filled canvas window, timed with its own
   bound), on tile borders, off the field and with two bands; the detect
   core and the labels, bit for bit and timed with their bounds, on a
   (16, 1024, 1024) stack with 16 thresholds, ragged fields of 1023 and
   37 pixels, the 49-tap branch, a plateau of ties and the default
   threshold, with F.conv2d's time beside the detect core (the
   detect_label_cases line); on the same cases the chain route's matched
   filter and parent race, bit for bit, timed (the chain_cases line); the
   order-3 place kernel bit for bit against its plain version on the CPU
   (the place_cases line);
4. the record-array path through the public entry points:
   load_deblender("sim_demo") once, then detect_objects ->
   DeblendField(z_mode="mean").deblend_field -> get_residual_field on a
   seeded 1024x1024x6 field of ~300 simulated galaxies, with every kernel's
   launch count reset before and read after; two residuals of one record
   array, bit-identical; then warm runs timed per
   stage, one warm run under torch.profiler (the device's idle share), and
   detection at the default threshold; warm deblend_s, the streaming
   deblend_and_render and the epistemic deblend_and_predict with cuDNN's
   deterministic algorithms off and on, in 4 alternating pairs (the
   cudnn_determinism line);
5. the decoder-tail kernels on the real tail input of that path's batch
   (caught by a hook on the decoder's last transposed conv): float32
   (csrc/decoder_tail.cu) against the decoder's own output before the crop
   and against its plain version, bfloat16 (the same input cast; the
   one-limb instance of csrc/tail_fused.cu) against its plain version to
   one bf16 ulp of the output scale, with the share of elements that
   differ; both also on a constant input and a batch of 1;
6. the streaming serving path: detect_objects with the stand-alone filter
   kernel (the same offsets as the fused core), then
   DeblendField(cfg=PipelineConfig(interp_order=1, source_chunk=128))
   .deblend_and_render / .deblend_and_predict in three chunks, launch
   counts reset before and read after, held against the record-array
   route of the same object; warm stage times, one profiled warm
   deblend_and_render, and the peak device memory of one stream chunk;
   the launches and uploads of one chain-route detection core, profiled
   (the chain_route line);
7. the fidelity-precision tail pair (csrc/tail_fused.cu) on the real input
   of dec/ConvT_7 for that batch, under a model whose last two layers run
   the bf16x3 limb scheme: against its plain version, against the model's
   own head output, on a constant input (the border case) and on a ragged
   shape;
8. the fidelity serving path: load_deblender("sim_demo",
   cfg=fidelity_serving_config(limb_emulation=True), flux_calibration=True)
   on the card, its per-band gain, the raw and the calibrated flux error
   against the float32 model on 64 held-out simulated stamps, then
   deblend_and_render on the field through it beside the float32 route;
9. the epistemic path: DeblendField(epistemic_uncertainty_estimation=True)
   .deblend_and_predict with a seeded generator (three canvases a chunk
   through the render kernel, counted from 0), twice for the same seed
   (bit-identical) and once for another,
   deblend_sample_stats against the statistics of deblend_samples, warm
   time and peak device memory;
10. both routes, and the fidelity model's forward, on a 256x256 crop on the
   card and on the CPU (plain versions), which must agree, with TF32
   switched on outside the port;
11. the registration kernel (csrc/registration.cu) against its plain
   version on the record-array route's real inputs (the r band of the
   field and of every deblended source's mean) and on sources flush
   against each border, a NaN pixel, the +-bound clip, the full-field
   branch at a 64-pixel field and a known (0.37, -0.62) px offset, timed
   with its bound (the registration line);
12. the bfloat16 instances of the render and place kernels, bit for bit
   against their plain versions on filled bf16 canvases at the bfloat16
   stream's chunk shape, timed with their bounds;
13. optimise_positions=True on both routes at interp_order=1 in 128-source
   chunks (launch counts from 0), the routes' shifts and residuals held
   against each other, each timed beside the same call without it
   (the registration_routes line);
14. device_dtype='bfloat16' serving at orders 1 and 3 against the float32
   route (launch counts from 0), upload_dtype alone, the resident field's
   and canvases' dtypes and bytes, and the peak memory of a float32 and a
   bfloat16 serving call (the device_dtype line);
15. IterativeDeblendField.iterative_deblending(optimise_positions=True) on a
   259x259 crop at the default threshold (launch counts from 0), twice,
   bit-identical, step 1's detections equal to the CPU's (the iterative
   line);
16. tiled serving: TiledDeblendField(cfg=PipelineConfig(interp_order=1,
   source_chunk=128, tile_size=1024, tile_overlap=64)).detect_deblend_render()
   on a seeded 4096x4096x6 field of 4,800 galaxies (a 5x5 grid of 1024^2
   tiles), launch counts from 0 just before and read just after (fails
   unless the tile stack launches the clipped statistics, the detect core
   and the labels once each), detection's stage seconds, warm detect and
   deblend_and_render, the card's tiled catalogue equal to the CPU's on a
   1536^2 crop in 16 tiles of 512, the untiled detection's overlap with the
   tiled catalogue (printed), and the three detection kernels on the tile
   stack and the render into the 4096^2 canvas, each held against its
   plain version on the same tensors and timed beside it (the tiled line);
17. IterativeDeblendField.iterative_deblend_and_render(max_iterations=3) on
   the same field: two float32 runs bit-identical, step 0 equal to phase
   16's catalogue, a one-step run's residual equal to phase 16's bit for
   bit, device_dtype='bfloat16' within 2e-2 of the float32 route's scale
   outside the stamps of sources that only one of the two routes found
   (at most 2% of the rows; the one-step residual must fail that check),
   each run's launches counted from 0, wall time and peak memory (the
   iterative_serving line);
18. training on the sim_demo model at full width with pairs from the
   port's make_dataset: one step card against CPU (loss terms within 1e-5
   relative, gradient leaves within 1e-4 of their scale, parameters moved
   the other way counted and bounded), train_deblender warm-started from
   sim_demo for one epoch a stage at batch 32 (the decoder bit for bit
   through stage 2, stage 1's loss falling, the best-validation
   checkpoint reloaded through load_deblender), two seeded 10-step runs
   bit-identical, the native loader's batches equal to the .npy source's,
   and the median warm step time at batch 5 and 64 (the training line);
19. int8 quantized serving with the packaged sim_demo_int8 bundle: the
   fused layer of csrc/int8_conv.cu (the implicit-GEMM s8 x s8 -> s32
   convolution on wgmma, its dequantization, PReLU(s) and the next layer's
   quantizer in one launch; stride-2 transposed convs as four parity
   sub-convolutions; split K where tiles leave SMs idle) on each of the 18
   int8 layers at a 128-stamp chunk of the record-array batch's real
   activations (their int8 inputs and epilogues as the forward gives
   them), bit for bit against its plain version (also as raw int32 and as
   the float32 layer, and against the unfused chain of conv_s8, the eager
   PReLU and quant_act), timed with its bound, the plain version,
   torch._int_mm over an im2col, the float32 cuDNN layer and the unfused
   chain (the int8_layer_groups line, one line a layer after it); the two
   fused float -> int8 points (dvt_quant_point: the BatchNorm and the
   quantizer before enc/Conv_0, dec/Dense_0's bias, its PReLU and the
   quantizer before dec/Dense_1) bit for bit against their plain versions
   on the chunk's real inputs, per-channel scales, NaN, infinite,
   signed-zero and extreme values, quotients on .5 and past +-127, a batch
   of 1 and a ragged 39-stamp chunk, each timed with its bound (the
   int8_points part of that line), and the stand-alone quantizer, which
   the forward no longer launches, on the same points' float inputs; a
   batch of 1, the ragged 295-source batch, all-(+-127) operands,
   per-tensor scales and NaN, infinite and signed-zero epilogue values;
   then DeblendField(quantized=load_quantized('sim_demo_int8'),
   z_mode='mean') on the 1024^2 field, both routes in 128-source chunks
   with the launches of each route counted from 0 and held to exactly 18
   fused layers and one of each fused point a chunk (no stand-alone
   quantizer), two runs bit-identical, the routes against each other, the
   total-flux error against the float forward on 64 simulated stamps, warm
   deblend_and_render int8 and float32 in turns with one profiled call of
   each (its CUDA kernels and the device's idle share), a chunk's peak
   memory, the 256^2 crop card against CPU, and one qat_finetune step at
   batch 32 card against CPU (the quantized line);
20. the model options: load_deblender("sim_demo", dtype="bfloat16"); the
   stamp forward on the record-array route's 295 real stamps in float32
   (TF32 off), bfloat16 and the sub-pixel float32 model, timed in turns
   with CUDA events and once under torch.profiler, each beside its bound
   (2 x forward_macs x N over 67 TFLOP/s float32, 989 bf16); the bf16 flux
   error against float32 on 64 simulated stamps (under the JAX package's
   3e-2 envelope, also with decoder_f32_stages=2); decoder_subpixel=True
   within 2e-5 of the stock model and decoder_f32_stages=2 in float32 bit
   for bit; detection and deblend_and_render of the 1024^2 field through
   the bf16 model with the detection and render kernels counted from 0,
   two runs bit-identical, the residual within BF16_RESIDUAL_TOL of the
   float32 route's, warm times in turns; the 256^2 crop, the bf16 forward
   card against CPU (BF16_CROP_SHARE beyond one bf16 ulp) (the
   model_options line);
21. export and the CLI: export_deblender on the card, load_exported and
   artifact_forward against the live model at 1, 128 and 295 stamps
   through one artifact (bit for bit expected, held to ARTIFACT_TOL, the
   largest difference and the share that differs printed), timed beside
   the live forward; DeblendField(artifact=) deblend_and_render against
   the live route, its render launches counted from 0; then `python -m
   debvader_tpu_torch` in processes of their own on the field written
   under chiprun_out/cli: detect against the in-process detection, serve
   --centers against the in-process route, export then serve --artifact
   (the export_cli line);
22. multi-device on a single-controller mesh that repeats the card
   (parallel/): make_mesh asked for more cards than there are raises;
   ShardedFieldDeblender on phase 16's 4096^2 field and centres over
   4 row bands and over 1, at orders 1 and 3 (the band canvases render
   through dvt_render and place through dvt_place, counted from 0), each
   held against the single-device streaming route (catalogue rows equal,
   mse_center to 1e-4 relative, the residual within 1e-5 of the field's
   scale), the 1-band catalogue against the 4-band one, wall times,
   residency_report and the device's peak; a registered 4-band serve
   (optimise_positions=True: the windowed registration kernel with the
   bands' row bounds, never the full-field one) against the registered
   single-device route (shifts within 2e-3 px, residual within 2e-4);
   band-tiled detection against the tiled detection's rows; the
   band-canvas render and place at the serve's band shape against their
   plain versions, timed beside the square 4096^2 calls and their bounds
   (the render's bound from what this chunk covers on the band window);
   DeblendField(mesh=) and make_sharded_quantized_forward at 2 shards
   against 1, the latter also fed host stamps and a CPU tensor of them,
   bit for bit the card-fed result; one
   data-parallel training step at 2 shards against the single-device step
   from the same state and generator (the multi_device line);
23. the int8 route in bfloat16: quantize_vae(load_deblender("sim_demo",
   dtype="bfloat16")) calibrated on the record-array batch's 295 stamps;
   phase 19's kernel checks on its bfloat16 epilogues (each of the 18
   layers bit for bit its plain version on a 128-stamp chunk's real int8
   inputs, as raw sums and unfused; dec/Dense_1 under strict_cast and
   not; both bfloat16 points; NaN, +-inf, signed zeros, bfloat16 halfway
   points rounded to even and overflow to inf; a batch of 1, 295 stamps,
   the ragged 39-stamp chunk; each timed with its bound beside
   torch._int_mm over an im2col and the bfloat16 cuDNN layer);
   DeblendField(quantized=<it>, z_mode='mean') on both routes with the
   launches counted from 0 (exactly 18 bfloat16 fused layers and one of
   each bfloat16 point a chunk), two runs bit-identical, the flux error
   against the float32 forward (this post-training bundle under JAX's PTQ
   envelope of 0.35; the packaged QAT bundle served in bfloat16 under 5e-2
   beside its float32 route's),
   warm deblend_and_render in turns against the float32 int8 route and
   the bfloat16 float route with one profiled call each, the crop card
   against CPU (the int8_bf16_layer_groups and quantized_bf16 lines); then the
   reference checkpoint import: the shipped sim_demo weights as a
   TensorBundle, `import-weights` in a process of its own,
   load_deblender of its file on the card, the forward bit for bit the
   shipped weights' (the checkpoint_import line);
24. data-parallel training across two processes (parallel/ on
   torch.distributed): the script starts two worker processes of itself
   (``--cross-process-worker RANK``), each a rank of a gloo group through a
   FileStore under chiprun_out/cross_process/, with two shards of cuda:0,
   so the mesh is [(0, cuda:0)] * 2 + [(1, cuda:0)] * 2; each takes three
   train steps of the sim_demo model at full width on batch 32 of phase
   18's seeded pairs, one eval step and one weighted step on a batch of 30
   (two pad rows), and every term, parameter, BatchNorm statistic and Adam
   moment (SHA-256 of its bytes) must be bit for bit the single-process
   ["cuda:0"] * 4 mesh's run in this process, and rank 0's rank 1's; each
   worker also checks that gloo's all_gather and broadcast take CUDA
   tensors, as parallel/collectives.py needs, and that DeblendField(mesh=)
   refuses its mesh; warm step times of both meshes and of the step's gradient
   reduction alone (the cross_process line).  A
   worker that fails or outlives its wall limit fails the script;
25. the one-pass bias and PReLU (csrc/bias_prelu.cu) bit for bit, NaN as
   a class, against its plain version (the layers' ops) at the 16 conv
   layers' and the two biased dense layers' shapes at batch 4,096, float32
   and bfloat16, on inputs seeded with NaN, signed zeros, infinities,
   subnormals and exact cancellations of the bias, the transposed convs'
   crop views and their contiguous copies, each layer timed with its
   bound and the plain version; the stamp forward of the float32,
   bfloat16, sub-pixel and f32-stages models on a 4,096-stamp batch of the
   record-array route's real stamps through api.deblend_tensor (18
   launches a forward; models/layers.py conv2d_same's TF-SAME pads 7
   inside the convolution, 6 with the sub-pixel head, and 2 copied)
   torch.equal to the plain composition, the same forward recorded by
   autograd, which launches none, and set beside the same forward with
   every pad copied (the pad_route_gap, reported); the kernel route
   timed, one profiled call each; each forward's convolution inputs
   counted by layout (models/layers.py conv_input: float32 17 NCHW and 2
   copies, bfloat16 17 channels-last, the f32-stages model 5 and 12), the
   recorded forward's the same; an artifact exported on the card bit for
   bit the live model (the bias_prelu line); the float32 forward's 17
   convolutions at 4,096 stamps with their input NCHW-dense and
   channels-last (ms, cuDNN's kernels, the transposed convs' bias and
   PReLU on either crop view), and its whole forward with the layout rule
   against without and with cuDNN's deterministic algorithms on against
   off, in turns (the conv_layouts and stamp_forward_layouts lines; alone:
   ``python3 chip_smoke.py --conv-layouts [OUT.json]``).  The record-array (phase 4),
   streaming (6), tiled (16) and bfloat16-model (20) paths each require
   the kernel's 18 launches a forward chunk;
26. one {"kernels": [...]} line, the nvidia-smi line, and the last line
   {"ok": true, "device": {...}}.

Phase 4's default-threshold detection also times the native segment merge
(csrc/segmerge.cpp, built with g++ at its first call) beside the whole
call, and in turns the plain Python loop in its place (default_detection).

A fuller report (ptxas output, every timing, the profiled run's top device
events) goes to chiprun_out/chip_smoke_report.json.  Needs no network;
imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the float32 rate
# outside the tensor cores and the dense bf16 tensor-core rate, used for
# each kernel's lower bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
REPS = 30
WARMUP = 3
# runs of a plain version at the tile stack's shapes, where one takes up
# to a second
PLAIN_REPS = 3
# A 5-sigma matched-filter threshold: at the default 1.5 x unfiltered rms
# the detector also splits the pure-noise sky into peaks (11,565 sources
# on this field, timed on their own in phase 4); here it finds ~300, one
# for each galaxy.
DETECTION = dict(thresh=5.0, threshold_scaling="matched")
# Phase 17: a later iterative step detects on the residual, where a
# bfloat16 rounding can move a faint feature across the threshold; the
# sources that only one of the float32 and bfloat16 routes finds are held
# to this share of the float32 route's rows (read 162 of 9,291, 1.7%).
ONE_ROUTE_MAX_SHARE = 0.02
# Phase 20: the bf16 model's serving residual is held to this share of the
# field's scale from the float32 route's (the JAX package's bf16 envelope
# is a 3e-2 flux error), and the bf16 crop's means, card against CPU (cuDNN
# against oneDNN, each rounding its contraction once to bf16), to this
# share of elements beyond one bf16 ulp of the means' scale.
BF16_RESIDUAL_TOL = 3e-2
BF16_CROP_SHARE = 0.01
# Phase 21: an artifact runs the live model's ATen operations, bit for bit
# expected; any difference is printed and held to this share of the scale.
ARTIFACT_TOL = 1e-5
# Phase 21: the CLI detects at this threshold (its --thresh, sep_conv
# scaling)
CLI_THRESH = 5.0


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_field(size=1024, n_gal=300, bands=6, noise=0.02, seed=0, crop=None) -> np.ndarray:
    """(1, size, size, bands) float32: elliptical two-Gaussian galaxies with
    a smooth band SED (after debvader_tpu/data/simulate.py), a Gaussian PSF
    blur (sigma 1.2 px) and Gaussian pixel noise, all from ``seed``.

    ``crop=(y0, x0, n)`` returns the (1, n, n, bands) window at (y0, x0) of
    that field, bit for bit, without making the rest: every random number is
    drawn as for the whole field, but only the galaxies and noise rows the
    window (and the PSF's 3-pixel reach around it) needs are used."""
    from scipy.ndimage import convolve1d

    rng = np.random.default_rng(seed)
    reach = 3
    y0, x0, n = crop if crop is not None else (0, 0, size)
    lo_y, lo_x = max(y0 - reach, 0), max(x0 - reach, 0)
    hi_y, hi_x = min(y0 + n + reach, size), min(x0 + n + reach, size)
    field = np.zeros((hi_y - lo_y, hi_x - lo_x, bands), np.float64)
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
        if iy + half < lo_y or iy - half >= hi_y or ix + half < lo_x or ix - half >= hi_x:
            continue
        dy, dx = yy - (cy - iy), xx - (cx - ix)
        q = (1 + e1) * dx * dx + (1 - e1) * dy * dy + 2 * e2 * dx * dy
        prof = 0.7 * np.exp(-q / (2 * (0.6 * r50) ** 2)) + 0.3 * np.exp(-q / (2 * (1.8 * r50) ** 2))
        prof /= prof.sum()
        stamp = flux * prof[..., None] * sed
        ys, xs = slice(max(iy - half, lo_y), min(iy + half + 1, hi_y)), slice(max(ix - half, lo_x), min(ix + half + 1, hi_x))
        field[ys.start - lo_y : ys.stop - lo_y, xs.start - lo_x : xs.stop - lo_x] += stamp[
            ys.start - iy + half : ys.stop - iy + half, xs.start - ix + half : xs.stop - ix + half]
    r = np.arange(7) - 3
    g = np.exp(-(r**2) / (2 * 1.2**2))
    g /= g.sum()
    field = convolve1d(convolve1d(field, g, axis=0, mode="constant"), g, axis=1, mode="constant")
    field = field[y0 - lo_y : y0 - lo_y + n, x0 - lo_x : x0 - lo_x + n]
    if crop is None:
        field += noise * rng.normal(size=field.shape)
    else:
        rng.normal(size=(y0, size, bands))  # the noise rows above the window
        field += noise * np.stack([rng.normal(size=(size, bands))[x0 : x0 + n] for _ in range(n)])
    return field[None].astype(np.float32)


def cuda_ms(torch, fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after ``warmup``,
    each run between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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


def bound(bytes_moved: float, ops: float, peak_ops: float = PEAK_OPS_PER_S):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, field_r: np.ndarray) -> list[dict]:
    """Phase 3: every kernel against its plain version at the main path's
    shapes; returns the kernel records (launches filled in later)."""
    import torch.nn.functional as F

    from debvader_tpu_torch.kernels import clipped_stats as cs
    from debvader_tpu_torch.kernels import detect_fused as df
    from debvader_tpu_torch.kernels import int8_conv as ic
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
        "edge_boxes": check_clipped_edges(torch, cs, field_r),
    })

    # --- fused detect core ------------------------------------------------
    back, _, _, grms = estimate_background(img, box=box)
    images = img[None].contiguous()
    backs = back[None].contiguous()
    kernel = default_filter_kernel()
    scale = float(np.sqrt(np.sum(np.square(kernel)))) if DETECTION["threshold_scaling"] == "matched" else 1.0
    thr = (DETECTION["thresh"] * grms * scale).reshape(1)
    filt, dirc, parent = df.matched_filter_parents(images, backs, kernel, thr)
    filt_p, dir_p, parent_p = df.matched_filter_parents_plain(images, backs, kernel, thr)
    torch.cuda.synchronize()
    err = float((filt - filt_p).abs().max())
    if not torch.equal(filt.view(torch.int32), filt_p.view(torch.int32)):
        raise AssertionError(f"detect_fused: filt is not bit-identical to the plain version (off by {err})")
    if not (torch.equal(dirc, dir_p) and torch.equal(parent, parent_p)):
        raise AssertionError("detect_fused: dir_code/parent differ from the plain version")
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
        "filt_bit_identical": True,
    })

    # --- label resolution -------------------------------------------------
    cur0 = parent.reshape(f, f)
    dir2 = dirc.reshape(f, f)
    labels = ls.label_fixpoint(cur0, dir2)
    labels_p = ls.label_fixpoint_plain(cur0, dir2)
    torch.cuda.synchronize()
    if not torch.equal(labels, labels_p):
        raise AssertionError("label_select: labels differ from the plain fixpoint")
    # a code outside 0..8 selects nothing in the iteration: a root, as 4 is
    odd = torch.arange(f * f, device=dev).reshape(f, f) % 2 == 1
    bad = torch.where(dir2 == 4, torch.where(odd, -1, 9).to(torch.int32), dir2)
    if not torch.equal(ls.label_fixpoint(cur0, bad), ls.label_fixpoint_plain(cur0, bad)):
        raise AssertionError("label_select: codes outside 0..8 do not act as roots")
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


def detect_label_cases(torch, field_r: np.ndarray) -> dict:
    """Edge cases of the fused detect core and the label resolution: name ->
    (images (T, F, F), backgrounds, 7x7 filter, thresholds (T,)), on the
    card.  A (16, 1024, 1024) stack (the field rolled and re-noised, 16
    thresholds from 1.5 to 7.5 sigma); ragged fields of 1023 and 37 pixels
    (rows not 16-byte aligned, partial tiles); the 49-tap branch; a plateau
    (a constant field on its own background filters to exactly 0, above a
    negative threshold: every race a tie broken by index, every chain runs
    to pixel 0, up to 2F steps across many tiles); the field at the default
    DetectionConfig() threshold (11,565 peaks)."""
    from debvader_tpu_torch.config import DetectionConfig
    from debvader_tpu_torch.ops.detection import default_filter_kernel, estimate_background

    dev = torch.device("cuda")
    img = torch.as_tensor(field_r, device=dev)
    f = img.shape[0]
    back, _, _, grms = estimate_background(img, box=64)
    kernel = default_filter_kernel()
    matched = float(np.sqrt(np.sum(np.square(kernel))))
    five = (DETECTION["thresh"] * grms * matched).reshape(1)
    default = (DetectionConfig().thresh * grms).reshape(1)
    gen = torch.Generator(device=dev).manual_seed(9)
    stack = torch.stack([
        torch.roll(img, (97 * i, 53 * i), (0, 1)) + 0.02 * torch.randn((f, f), generator=gen, device=dev)
        for i in range(16)
    ])
    full = (kernel + 0.05 * np.random.default_rng(5).random((7, 7))).astype(np.float32)

    def one(x, b):
        return x[None].contiguous(), b[None].contiguous()

    return {
        "stack16": (stack, back.expand(16, f, f).contiguous(), kernel,
                    grms * torch.linspace(1.5, 7.5, 16, device=dev)),
        "ragged1023": (*one(img[:1023, :1023], back[:1023, :1023]), kernel, five),
        "ragged37": (*one(img[500:537, 500:537], back[500:537, 500:537]), kernel, default),
        "taps49": (*one(img, back), full, five),
        "plateau": (torch.ones((1, f, f), device=dev), torch.ones((1, f, f), device=dev), kernel,
                    torch.full((1,), -0.5, device=dev)),
        "default_threshold": (*one(img, back), kernel, default),
    }


def check_detect_label_cases(torch, df, ls, field_r: np.ndarray) -> dict:
    """Each case of detect_label_cases: filt, dir_code and parent bit for
    bit against the plain version, the labels of the kernel's outputs bit
    for bit against the plain fixpoint on them; each kernel timed (device
    and per-call) beside its bound."""
    out = {}
    for name, (images, backs, kernel, thr) in detect_label_cases(torch, field_r).items():
        t, f, _ = images.shape
        filt, dirc, parent = df.matched_filter_parents(images, backs, kernel, thr)
        filt_p, dir_p, parent_p = df.matched_filter_parents_plain(images, backs, kernel, thr)
        torch.cuda.synchronize()
        if not torch.equal(filt.view(torch.int32), filt_p.view(torch.int32)):
            raise AssertionError(f"detect_fused ({name}): filt is not bit-identical to the plain version")
        if not (torch.equal(dirc, dir_p) and torch.equal(parent, parent_p)):
            raise AssertionError(f"detect_fused ({name}): dir_code/parent differ from the plain version")
        cur0, dir2 = parent.reshape(t * f, f), dirc.reshape(t * f, f)
        labels = ls.label_fixpoint(cur0, dir2)
        labels_p = ls.label_fixpoint_plain(cur0, dir2)
        torch.cuda.synchronize()
        if not torch.equal(labels, labels_p):
            raise AssertionError(f"label_select ({name}): labels differ from the plain fixpoint")
        steps = _path_steps(torch, dir2)
        det_bound, det_by = bound(t * f * f * 20 + t * 4 + 56, t * f * f * 54)
        fore = (images - backs)[:, None]
        kt = torch.as_tensor(kernel, device="cuda")[None, None]
        lab_bound, lab_by = bound(t * f * f * 12, t * f * f + 4 * steps)
        out[name] = {
            "shape": [t, f, f], "masked_pixels": int((filt > thr.reshape(t, 1, 1)).sum()), "path_steps": steps,
            "detect_fused": {
                "device_ms": profiled_device_ms(
                    torch, lambda: df.matched_filter_parents(images, backs, kernel, thr), "detect_fused_kernel"),
                "ms": cuda_ms(torch, lambda: df.matched_filter_parents(images, backs, kernel, thr)),
                "library_ms": cuda_ms(torch, lambda: conv2d_fp32(torch, fore, kt)),
                "library_call": "F.conv2d of the 7x7 filter alone (float32)",
                "bound_ms": det_bound, "bound_by": det_by,
            },
            "label_select": {
                "device_ms": profiled_device_ms(torch, lambda: ls.label_fixpoint(cur0, dir2), "label_resolve_kernel"),
                "ms": cuda_ms(torch, lambda: ls.label_fixpoint(cur0, dir2)),
                "bound_ms": lab_bound, "bound_by": lab_by,
            },
        }
    return out


def conv2d_fp32(torch, fore, kt):
    import torch.nn.functional as F

    from debvader_tpu_torch.device import fp32_math

    with fp32_math():
        return F.conv2d(fore, kt, padding=kt.shape[-1] // 2)


def clipped_edge_boxes(rng, field_r: np.ndarray) -> dict:
    """Boxes for the clipped statistics beyond the field's 64x64 ones:
    name -> (boxes (n, P) float32, valid (n, P) float32, iters)."""
    p = 4096
    ties = rng.integers(0, 4, p).astype(np.float32)
    ties[:50] = 100.0  # outliers for the first clip to remove
    # 548 negatives, 1,500 -0.0, 1,500 +0.0, 548 positives: the median
    # (rank 2,047) is the last -0.0, the next key up the first +0.0
    zeros = np.concatenate([
        -rng.uniform(1e-4, 2e-4, 548), np.full(1500, -0.0), np.full(1500, 0.0), rng.uniform(1e-4, 2e-4, 548),
    ]).astype(np.float32)
    rng.shuffle(zeros)
    # the unclipped mean overflows to inf in any order, so the first
    # round's std is NaN and its clip empty; the next round admits
    # |x| <= 1e-12, 94 of the 96 small values (with iters=2 the last round)
    huge = np.concatenate([
        rng.uniform(1e35, 2e35, 4000), rng.uniform(-1e-12, 1e-12, 90), [-0.0, 0.0, 1e-12, -1e-12, 2e-12, -2e-12],
    ]).astype(np.float32)
    rng.shuffle(huge)

    def one(x):
        return x[None], np.ones((1, x.size), np.float32)

    def field_boxes(box):
        g = field_r.shape[0] // box
        crop = field_r[: g * box, : g * box]
        x = np.ascontiguousarray(crop.reshape(g, box, g, box).transpose(0, 2, 1, 3).reshape(g * g, box * box))
        return x, np.ones_like(x)

    return {
        "ties": (*one(ties), 3),
        "signed_zeros": (*one(zeros), 3),
        "empty_first_clip": (*one(huge), 3),
        "empty_first_clip_iters2": (*one(huge), 2),
        # each of the kernel's variants: 4, 8, 16 or 32 pixels a thread of
        # its 512 in registers (box32, box50 and the field's box64, box80,
        # box128), and above 32 x 512 pixels the box in shared memory
        "box32": (*field_boxes(32), 3),
        "box50": (*field_boxes(50), 3),
        "box80": (*field_boxes(80), 3),
        "box128": (*field_boxes(128), 3),
        "box160_shared": (*field_boxes(160), 3),
    }


def clipped_agree(torch, got, want, x, v, name: str) -> float:
    """Medians bit for bit; mean and std NaN where the plain version's are
    and elsewhere within 1e-5 of each box's scale (its largest valid
    |value|).  Returns the largest error over that scale."""
    if not torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)):
        raise AssertionError(f"clipped_stats ({name}): medians differ from the plain version")
    scale = torch.where(v > 0, x.abs(), torch.zeros_like(x)).amax(-1).clamp(min=1e-30)
    worst = 0.0
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"clipped_stats ({name}): NaN outputs differ from the plain version")
        rel = torch.where(a == b, torch.zeros_like(a), (a - b).abs()) / scale
        rel = rel[~torch.isnan(b)]
        e = float(rel.max()) if rel.numel() else 0.0
        if not e <= 1e-5:
            raise AssertionError(f"clipped_stats ({name}): mean/std off by {e} of the box scale")
        worst = max(worst, e)
    return worst


def check_clipped_edges(torch, cs, field_r: np.ndarray) -> dict:
    """The clipped statistics on the edge boxes, each batch on its own (the
    overflow box's NaN and 1e35 scale would hide the others)."""
    out = {}
    for name, (x, v, iters) in clipped_edge_boxes(np.random.default_rng(11), field_r).items():
        xt, vt = torch.as_tensor(x, device="cuda"), torch.as_tensor(v, device="cuda")
        got = cs.sigma_clipped_stats(xt, vt, iters=iters)
        want = cs.sigma_clipped_stats_plain(xt, vt, iters=iters)
        torch.cuda.synchronize()
        out[name] = {"boxes": int(x.shape[0]), "pixels": int(x.shape[1]), "iters": iters,
                     "max_err_over_scale": clipped_agree(torch, got, want, xt, vt, name),
                     "device_ms": profiled_device_ms(
                         torch, lambda: cs.sigma_clipped_stats(xt, vt, iters=iters), "clipped_stats_kernel")}
    return out


def covered_mask(offsets: np.ndarray, mask, s: int, f) -> np.ndarray:
    """(fy, fx) bool, f an int or (fy, fx): the field pixels that some
    listed source's padded patch covers (padded row 0 at (fy - s) // 2 +
    floor(offset) - 1, s + 2 rows and columns, the columns likewise);
    masked and non-finite sources cover nothing."""
    fy, fx = (f, f) if np.isscalar(f) else f
    cov = np.zeros((fy, fx), bool)
    for i, (oy, ox) in enumerate(offsets):
        if (mask is not None and not mask[i]) or not (np.isfinite(oy) and np.isfinite(ox)):
            continue
        y0, x0 = (fy - s) // 2 + int(np.floor(oy)) - 1, (fx - s) // 2 + int(np.floor(ox)) - 1
        cov[max(y0, 0) : max(y0 + s + 2, 0), max(x0, 0) : max(x0 + s + 2, 0)] = True
    return cov


def clipped_patches(offsets: np.ndarray, mask, s: int, fy: int, fx: int) -> tuple[int, int]:
    """(padded-patch pixels, stamp pixels) that the unmasked sources need
    on an fy x fx window: each padded patch clipped to the window, and the
    stamp rows and columns that reach it (at most s each)."""
    keep = np.asarray(mask, bool) & np.isfinite(offsets).all(-1)
    pos = np.floor(offsets[keep]).astype(np.int64) + [(fy - s) // 2 - 1, (fx - s) // 2 - 1]
    rows = np.clip(pos[:, 0] + s + 2, 0, fy) - np.clip(pos[:, 0], 0, fy)
    cols = np.clip(pos[:, 1] + s + 2, 0, fx) - np.clip(pos[:, 1], 0, fx)
    return int((rows * cols).sum()), int((np.minimum(rows, s) * np.minimum(cols, s)).sum())


def render_path_cases(torch, f: int, n: int = 128, s: int = 59, b: int = 6) -> dict:
    """name -> (stamps, offsets) on the card: one stream chunk of n sources
    inside the field, as the serving path hands the kernel; sources whose
    padded patch starts or ends exactly on a 32- or 16-pixel tile border;
    sources that all lie off the field (with a NaN and a huge offset)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    stamps = torch.rand((n, s, s, b), generator=gen, device="cuda")
    chunk = (torch.rand((n, 2), generator=gen, device="cuda") - 0.5) * (f - 80)
    pos0 = (f - s) // 2
    k = np.arange(1, 17)
    frac = np.array([0.0, 0.25, 0.5, 0.999] * 4)
    starts = 32 * k + 1 - pos0 + frac            # padded row 0 on 32 k
    ends = 16 * (k + 10) - s - 2 + 1 - pos0 + frac  # one past the last row on 16 (k + 10)
    border = np.stack([np.concatenate([starts, ends]), np.concatenate([ends[::-1], starts])], -1)
    rng = np.random.default_rng(6)
    sign = rng.choice([-1.0, 1.0], (32, 2))
    off = sign * (f / 2 + s + rng.uniform(0, 200, (32, 2)))
    off[5] = [np.nan, 0.0]
    off[9] = [1e20, 3.0]
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    return {
        "chunk": (stamps, chunk),
        "tile_border": (stamps[:32].contiguous(), as_dev(border)),
        "off_field": (stamps[:32].contiguous(), as_dev(off)),
    }


def check_render_paths(torch, rd, f: int) -> dict:
    """The render at the serving path's shape and its edge cases: added
    with out= into the window of a padded canvas filled with seeded random
    values; within 1e-5 of the plain version, pixels outside every padded
    patch unchanged bit for bit, two launches bit-identical; without out=,
    the same against the plain version.  Times the chunk case with its own
    bound (the stamps, the offsets, and a read and a write of the covered
    pixels only)."""
    pad = 59 + 2
    gen = torch.Generator(device="cuda").manual_seed(5)
    canvas0 = torch.randn((f + 2 * pad, f + 2 * pad, 6), generator=gen, device="cuda")

    def window(c):
        return c[pad : pad + f, pad : pad + f]

    out = {}
    for name, (stamps, offsets) in render_path_cases(torch, f).items():
        n, s, _, b = stamps.shape
        cov = covered_mask(offsets.cpu().numpy(), None, s, f)
        got, again, plain = canvas0.clone(), canvas0.clone(), canvas0.clone()
        rd.render_field_kernel(stamps, offsets, f, out=window(got))
        rd.render_field_kernel(stamps, offsets, f, out=window(again))
        rd.render_field_plain(stamps, offsets, f, out=window(plain))
        fresh = rd.render_field_kernel(stamps, offsets, f)
        fresh_plain = rd.render_field_plain(stamps, offsets, f)
        torch.cuda.synchronize()
        tol = 1e-5 * float(stamps.abs().max())
        err = float((got - plain).abs().max())
        err_fresh = float((fresh - fresh_plain).abs().max())
        if not (err <= tol and err_fresh <= tol):
            raise AssertionError(f"render ({name}): off by {err} (out=) / {err_fresh} from the plain version")
        if not torch.equal(got, again):
            raise AssertionError(f"render ({name}): two launches on the same canvas differ")
        untouched = torch.ones(canvas0.shape[:2], dtype=torch.bool, device="cuda")
        window(untouched)[torch.as_tensor(cov, device="cuda")] = False
        if not torch.equal(got[untouched], canvas0[untouched]):
            raise AssertionError(f"render ({name}): pixels outside every padded patch changed")
        if name == "off_field" and (cov.any() or fresh.any()):
            raise AssertionError("render (off_field): sources off the field placed something")
        rec = {"sources": int(n), "covered_pixels": int(cov.sum()), "max_abs_err": max(err, err_fresh)}
        if name == "chunk":
            work = canvas0.clone()
            t_bound, by = bound(n * s * s * b * 4 + n * 8 + 2 * int(cov.sum()) * b * 4,
                                n * (s + 2) * (s + 2) * b * 11)
            rec.update({
                "ms": cuda_ms(torch, lambda: rd.render_field_kernel(stamps, offsets, f, out=window(work))),
                "device_ms": profiled_device_ms(
                    torch, lambda: rd.render_field_kernel(stamps, offsets, f, out=window(work)), "render_"
                ),
                "plain_ms": cuda_ms(torch, lambda: rd.render_field_plain(stamps, offsets, f, out=window(work))),
                "bound_ms": t_bound, "bound_by": by, "shape": [n, s, s, b, f], "pitch": int(work.stride(0)),
            })
        out[name] = rec

    # another band count takes the 16x16 tile kernel with the same sums
    gen2 = torch.Generator(device="cuda").manual_seed(7)
    st2 = torch.rand((20, 15, 15, 2), generator=gen2, device="cuda")
    off2 = (torch.rand((20, 2), generator=gen2, device="cuda") - 0.5) * 260
    got2 = rd.render_field_kernel(st2, off2, 256)
    again2 = rd.render_field_kernel(st2, off2, 256)
    err2 = float((got2 - rd.render_field_plain(st2, off2, 256)).abs().max())
    torch.cuda.synchronize()
    if not (err2 <= 1e-5 and torch.equal(got2, again2)):
        raise AssertionError(f"render (2 bands): off by {err2} from the plain version, or not deterministic")
    out["two_bands"] = {"sources": 20, "max_abs_err": err2}
    return out


def place_inputs(torch, stamps, offsets, f: int, mask=None):
    """The order-3 render's shift step on the card, as ops/shift.render_field
    takes it: (patches (N, 79, 79, B), y, x, visible, canvas size) for
    stamps of 59 pixels padded by 10 on a canvas padded by 79."""
    from debvader_tpu_torch.kernels.render import place_corners, shift_patches
    from debvader_tpu_torch.ops.spline import subpixel_shift_spline_const

    interp_pad = 10
    patches, int_off = shift_patches(stamps, offsets, interp_pad, subpixel_shift_spline_const)
    p = patches.shape[1]
    y, x, visible = place_corners(int_off, mask, f, stamps.shape[1], interp_pad, f + 2 * p)
    return patches.contiguous(), y, x, visible, f + 2 * p


def place_agrees(torch, rd, canvas0, patches, y, x, visible, name: str) -> int:
    """The place kernel on the card against the plain version on the CPU
    (serial index_put_, source order) on the same patches and corners, the
    canvas bit for bit; two launches bit-identical.  Returns the number of
    canvas elements that changed."""
    got, again = canvas0.clone(), canvas0.clone()
    rd.place_patches(got, patches, y, x, visible)
    rd.place_patches(again, patches, y, x, visible)
    base = canvas0.cpu().clone()
    want = base.clone()
    rd.place_patches_plain(want, patches.cpu(), y.cpu(), x.cpu(), visible.cpu())
    torch.cuda.synchronize()
    got_cpu = got.cpu()
    if not torch.equal(got_cpu.view(torch.int32), want.view(torch.int32)):
        diff = int((got_cpu.view(torch.int32) != want.view(torch.int32)).sum())
        raise AssertionError(f"place ({name}): {diff} canvas elements differ from the CPU plain version")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"place ({name}): two launches on the same canvas differ")
    return int((got_cpu.view(torch.int32) != base.view(torch.int32)).sum())


def footprint_elements(y, x, p: int, c: int, b: int, cols: int | None = None) -> int:
    """Canvas elements that some patch's P x P footprint covers (visible or
    not: an invisible patch adds +0.0 there) on a c x c canvas, or c x
    ``cols``."""
    cov = np.zeros((c, c if cols is None else cols), bool)
    for yy, xx in zip(y.tolist(), x.tolist()):
        cov[yy : yy + p, xx : xx + p] = True
    return int(cov.sum()) * b


def check_place(torch, f: int) -> dict:
    """The order-3 place kernel (csrc/render.cu dvt_place): bit for bit
    against the CPU plain version on render_path_cases at order 3 and on
    the record-array route's shape (295 stamps over the whole field, some
    hanging over its edge, one masked), each into a canvas filled with
    seeded random values; the latter timed against its bound."""
    from debvader_tpu_torch.kernels import render as rd

    dev = torch.device("cuda")
    cases = {}
    for name, (stamps, offsets) in render_path_cases(torch, f).items():
        patches, y, x, visible, c = place_inputs(torch, stamps, offsets, f)
        canvas0 = torch.randn((c, c, 6), generator=torch.Generator(device=dev).manual_seed(12), device=dev)
        changed = place_agrees(torch, rd, canvas0, patches, y, x, visible, name)
        cases[name] = {"sources": int(len(y)), "visible": int(visible.sum()), "changed_elements": changed}
    if cases["off_field"]["visible"] != 0 or cases["chunk"]["changed_elements"] == 0:
        raise AssertionError(f"place: unexpected visibility or coverage {cases}")
    # another band count takes the 16x16 tile kernel with the same sums
    gen2 = torch.Generator(device=dev).manual_seed(7)
    st2 = torch.rand((20, 15, 15, 2), generator=gen2, device=dev)
    off2 = (torch.rand((20, 2), generator=gen2, device=dev) - 0.5) * 260
    patches, y, x, visible, c = place_inputs(torch, st2, off2, 256)
    canvas0 = torch.randn((c, c, 2), generator=gen2, device=dev)
    cases["two_bands"] = {"sources": 20, "changed_elements": place_agrees(
        torch, rd, canvas0, patches, y, x, visible, "two_bands")}

    n, s, b = 295, 59, 6
    gen = torch.Generator(device=dev).manual_seed(2)
    stamps = torch.rand((n, s, s, b), generator=gen, device=dev)
    offsets = (torch.rand((n, 2), generator=gen, device=dev) - 0.5) * (f + 40)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[7] = False
    patches, y, x, visible, c = place_inputs(torch, stamps, offsets, f, mask)
    canvas0 = torch.zeros((c, c, b), device=dev)
    cases["record_array"] = {"sources": n, "changed_elements": place_agrees(
        torch, rd, canvas0, patches, y, x, visible, "record_array")}
    p = patches.shape[1]
    covered = footprint_elements(y.cpu(), x.cpu(), p, c, b)
    # the patches read once, corners and flags once, every covered canvas
    # element read and written once; one add a patch element
    t_bound, by = bound(patches.numel() * 4 + n * 9 + covered * 8, patches.numel())
    work = canvas0.clone()
    # the library call: the earlier port's order-3 place, one atomic
    # index_put_(accumulate=True) of the masked patches at the flat canvas
    # indices of their footprints (both made before the clock starts)
    ar = torch.arange(p, device=dev)
    flat = ((y[:, None] + ar)[:, :, None] * c + (x[:, None] + ar)[:, None, :]).reshape(-1)
    masked = torch.where(visible[:, None, None, None], patches, torch.zeros((), device=dev)).reshape(-1, b)
    lib, mine = canvas0.clone(), canvas0.clone()
    lib.view(-1, b).index_put_((flat,), masked, accumulate=True)
    rd.place_patches(mine, patches, y, x, visible)
    lib_err = float((lib - mine).abs().max())
    return {
        "name": "place", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/render.cu",
        "replaces": "debvader_tpu/ops/shift.py:209 (render_field's order-3 scan, XLA; no Pallas kernel)",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: rd.place_patches(work, patches, y, x, visible)),
        "device_ms": profiled_device_ms(
            torch, lambda: rd.place_patches(work, patches, y, x, visible), "place_tile_kernel"),
        "plain_ms": cuda_ms(torch, lambda: rd.place_patches_plain(work, patches, y, x, visible)),
        "library_ms": cuda_ms(torch, lambda: work.view(-1, b).index_put_((flat,), masked, accumulate=True)),
        "library_max_abs_err": lib_err,
        "bound_ms": t_bound, "bound_by": by,
        "shape": [n, p, p, b, c], "covered_elements": covered,
        "cases": cases,
    }


def check_chain_cases(torch, field_r: np.ndarray) -> tuple[dict, dict]:
    """The chain route's two kernels on every case of detect_label_cases:
    the stand-alone matched filter (a field at a time: filt and mask bit for
    bit against the plain version) and the parent race (on the plain
    filter's filt: dir_code and parent bit for bit against parent_race),
    each timed with its bound.  Returns the race's record at the main case
    (the field at the 5-sigma threshold) and every case."""
    import torch.nn.functional as F

    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.kernels import detect_fused as df
    from debvader_tpu_torch.kernels import matched_filter as mf
    from debvader_tpu_torch.kernels import parent_race as pr
    from debvader_tpu_torch.ops.detection import default_filter_kernel, estimate_background

    dev = torch.device("cuda")
    img = torch.as_tensor(field_r, device=dev)
    back, _, _, grms = estimate_background(img, box=64)
    kernel = default_filter_kernel()
    five = (DETECTION["thresh"] * grms * float(np.sqrt(np.sum(np.square(kernel))))).reshape(1)
    cases = {"main": (img[None], back[None], kernel, five), **detect_label_cases(torch, field_r)}
    out = {}
    for name, (images, backs, k, thr) in cases.items():
        t, f, _ = images.shape
        filt = df.apply_filter(images - backs, k)
        dirc, parent = pr.parent_race_kernel(filt, thr)
        dir_p, parent_p = df.parent_race(filt, thr)
        torch.cuda.synchronize()
        if not (torch.equal(dirc, dir_p) and torch.equal(parent, parent_p)):
            raise AssertionError(f"parent_race ({name}): dir_code/parent differ from the plain version")
        race_bound, race_by = bound(t * f * f * 12 + t * 4, t * f * f * 20)
        rec = {
            "shape": [t, f, f], "masked_pixels": int((filt > thr.reshape(t, 1, 1)).sum()),
            "parent_race": {
                "device_ms": profiled_device_ms(torch, lambda: pr.parent_race_kernel(filt, thr), "parent_race_kernel"),
                "ms": cuda_ms(torch, lambda: pr.parent_race_kernel(filt, thr)),
                "plain_ms": cuda_ms(torch, lambda: df.parent_race(filt, thr)),
                "bound_ms": race_bound, "bound_by": race_by,
            },
        }
        if t == 1:
            im, bk, th = images[0], backs[0], thr
            mfilt, mmask = mf.matched_filter_threshold(im, bk, k, th)
            pfilt, pmask = mf.matched_filter_threshold_plain(im, bk, k, th)
            torch.cuda.synchronize()
            if not torch.equal(mfilt.view(torch.int32), pfilt.view(torch.int32)):
                raise AssertionError(f"matched_filter ({name}): filt is not bit-identical to the plain version")
            if not torch.equal(mmask, pmask):
                raise AssertionError(f"matched_filter ({name}): mask differs from the plain version")
            separable = df.filter_taps(k)[0]
            mf_bound, mf_by = bound(f * f * 13 + 4 + 56, f * f * (28 if separable else 98))
            kt = torch.as_tensor(k, device=dev)[None, None]

            def library():
                with fp32_math():
                    return F.conv2d((im - bk)[None, None], kt, padding=3) > th

            rec["matched_filter"] = {
                "device_ms": profiled_device_ms(
                    torch, lambda: mf.matched_filter_threshold(im, bk, k, th), "matched_filter_kernel"),
                "ms": cuda_ms(torch, lambda: mf.matched_filter_threshold(im, bk, k, th)),
                "plain_ms": cuda_ms(torch, lambda: mf.matched_filter_threshold_plain(im, bk, k, th)),
                "library_ms": cuda_ms(torch, library),
                "bound_ms": mf_bound, "bound_by": mf_by, "separable": bool(separable),
            }
        out[name] = rec
    main = out["main"]
    race = {
        "name": "parent_race", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/parent_race.cu",
        "replaces": "debvader_tpu/ops/detection.py:281 (_detect_core's parent race, XLA; no Pallas kernel)",
        "max_abs_err": 0.0, **main["parent_race"], "library_ms": None, "shape": main["shape"],
    }
    return race, out


def chain_route_launches(torch, field_r: np.ndarray) -> dict:
    """One chain-route detection core (``_detect_core`` with the
    stand-alone filter kernel, the serving path's) under torch.profiler:
    the port's kernel launches by counter, every device kernel by name and
    the host-to-device copies; beside it the plain race alone on the same
    filt, for the launches and uploads the race kernel replaces.  Fails
    unless filter, race and labels launch once each and the race adds
    nothing to the core but its kernel: no eager op, no upload."""
    from torch.profiler import ProfilerActivity, profile

    from debvader_tpu_torch.config import DetectionConfig
    from debvader_tpu_torch.kernels import clipped_stats as cs
    from debvader_tpu_torch.kernels import detect_fused as df
    from debvader_tpu_torch.kernels import int8_conv as ic
    from debvader_tpu_torch.kernels import label_select as ls
    from debvader_tpu_torch.kernels import matched_filter as mf
    from debvader_tpu_torch.kernels import parent_race as pr
    from debvader_tpu_torch.ops import detection as td

    img = torch.as_tensor(field_r, device="cuda")
    cfg = DetectionConfig(use_pallas_filter=True, **DETECTION)

    counters = (cs.sigma_clipped_stats, mf.matched_filter_threshold, pr.parent_race_kernel, ls.label_fixpoint)

    def events(fn):
        fn()
        torch.cuda.synchronize()
        for counter in counters:
            counter.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        kernels, uploads = {}, 0
        for e in prof.key_averages():
            if not str(e.device_type).endswith("CUDA"):
                continue
            if "Memcpy HtoD" in e.key:
                uploads += int(e.count)
            elif "Memcpy" not in e.key and "Memset" not in e.key:
                kernels[e.key[:80]] = int(e.count)
        return out, kernels, uploads

    (labels, filt, grms), core_kernels, core_uploads = events(lambda: td._detect_core(img, cfg))
    counts = {fn.__name__: fn.launches for fn in counters}
    thr = (cfg.thresh * grms * td._threshold_scale(cfg)).reshape(1)
    _, race_kernels, race_uploads = events(lambda: df.parent_race(filt[None], thr))
    if counts["matched_filter_threshold"] != 1 or counts["parent_race_kernel"] != 1 or counts["label_fixpoint"] != 1:
        raise AssertionError(f"chain route: port kernel launches {counts}, expected one each")
    # the same core with the race stubbed out (its outputs made before the
    # profile) launches everything the core launches but the race: the
    # difference must be the race kernel alone, with no upload of its own
    race_out = pr.parent_race_kernel(filt[None], thr)
    torch.cuda.synchronize()
    try:
        td.parent_race_kernel = lambda filt, thresholds: race_out
        _, rest_kernels, rest_uploads = events(lambda: td._detect_core(img, cfg))
    finally:
        td.parent_race_kernel = pr.parent_race_kernel
    extra = Counter(core_kernels)
    extra.subtract(rest_kernels)
    extra = {k: v for k, v in extra.items() if v}
    if list(extra.values()) != [1] or "parent_race" not in next(iter(extra)) or core_uploads != rest_uploads:
        raise AssertionError(
            f"chain route: the race adds kernels {extra} and {core_uploads - rest_uploads} host-to-device "
            "copies to the core, expected the race kernel alone and no copy"
        )
    return {
        "port_launches_per_detection": counts,
        "port_launches_after_background": sum(counts[k] for k in (
            "matched_filter_threshold", "parent_race_kernel", "label_fixpoint")),
        "device_kernels_per_detection": sum(core_kernels.values()),
        "host_to_device_copies_per_detection": core_uploads,
        "plain_race_device_kernels": sum(race_kernels.values()),
        "plain_race_host_to_device_copies": race_uploads,
        "race_kernels_and_copies_beyond_the_rest": {"kernels": extra, "copies": core_uploads - rest_uploads},
        "kernels_by_name": core_kernels,
    }


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
        "device_ms": profiled_device_ms(torch, lambda: rd.render_field_kernel(stamps, offsets, f, mask), "render_"),
        "plain_ms": cuda_ms(torch, lambda: rd.render_field_plain(stamps, offsets, f, mask)),
        "library_ms": None,
        "bound_ms": t_bound, "bound_by": by,
        "shape": [n, s, s, b, f],
        "deterministic": True,
        "path_cases": check_render_paths(torch, rd, f),
    })
    return records


def bf16_ulp(scale: float) -> float:
    """The spacing of bfloat16 values at ``scale``."""
    return float(2.0 ** (np.floor(np.log2(scale)) - 7))


# The bfloat16 decoder tail may differ from its plain version by one bf16 ulp
# of the output scale (the two sum their float32 products in other orders,
# so a value may round to its neighbour) on at most this share of the
# elements.  The ulp alone cannot reject the unrepaired arithmetic (the
# float32 chain cast at the end is within one ulp too); the share does:
# phase 5 holds that control to the same check and fails if it passes.
BF16_SHARE_LIMIT = 0.01


def tail_agreement(got, plain, tol: float | None, held_to_share: bool = True) -> tuple[float, float, str | None]:
    """(max abs error, share of elements that differ, the fault or None) of a
    tail's output against its plain version: within ``tol`` of the output
    scale, or for ``tol=None`` (bfloat16) within one bf16 ulp of the scale
    and, where ``held_to_share``, on at most ``BF16_SHARE_LIMIT`` of the
    elements."""
    diff = (got.float() - plain.float()).abs()
    scale = float(plain.float().abs().max())
    err, share = float(diff.max()), float((diff > 0).float().mean())
    limit = bf16_ulp(scale) if tol is None else tol * scale
    if not err <= limit:
        return err, share, f"off by {err} (limit {limit} at a scale of {scale})"
    if tol is None and held_to_share and not share <= BF16_SHARE_LIMIT:
        return err, share, f"{share:.4%} of the elements differ (limit {BF16_SHARE_LIMIT:.0%})"
    return err, share, None


def check_decoder_tail(torch, net, stamps: np.ndarray) -> list[dict]:
    """Phase 5: the fused decoder tail on the real tail input of the main
    path's batch, float32 against the decoder's own output before the crop
    and against the plain version (5e-5 of the output scale), bfloat16 (the
    same input cast) against the plain version (one bf16 ulp of the scale on
    at most ``BF16_SHARE_LIMIT`` of the elements); both also on a constant
    input (the ring of h; one ulp only, since its interior holds one value
    a channel), a batch of 1 and a ragged (3, 37, 37, 32) -> 5 with seeded
    weights.  A control, the float32 chain on the same bfloat16 x cast to
    bfloat16 at the end, must fail the bfloat16 check.  The launches that
    are counted are one call of the public function a dtype on those
    activations; comparison and timing launches come after the count is
    read.  Returns the float32 and the bfloat16 records."""
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
    xb = x.to(torch.bfloat16)

    def counted(xi):
        dtl.fused_decoder_tail.launches = 0
        got = dt.fused_decoder_tail(xi, *params)
        torch.cuda.synchronize()
        if dtl.fused_decoder_tail.launches <= 0:
            raise AssertionError(f"decoder_tail: the {xi.dtype} kernel was not launched")
        return got, dtl.fused_decoder_tail.launches

    got, launches = counted(x)
    got_b, launches_b = counted(xb)
    err = float((got - want).abs().max())
    if got.shape != want.shape or err > 5e-5 * float(want.abs().max()):
        raise AssertionError(f"decoder_tail: off by {err} from the decoder's own output")

    def agree(xi, got_i=None, p=params, held_to_share=True):
        """Max abs error and differing share of the kernel against the plain
        version on xi; raises beyond the tolerance."""
        got_i = dt.fused_decoder_tail(xi, *p) if got_i is None else got_i
        plain = dtl.decoder_tail_plain(xi, *p)
        if got_i.dtype != xi.dtype or got_i.shape != plain.shape:
            raise AssertionError(f"decoder_tail: {got_i.dtype} {tuple(got_i.shape)} for {xi.dtype} x")
        low = xi.dtype == torch.bfloat16
        e, share, fault = tail_agreement(got_i, plain, None if low else 5e-5, held_to_share)
        if fault is not None:
            raise AssertionError(f"decoder_tail ({xi.dtype}, {tuple(xi.shape)}) against the plain version: {fault}")
        return e, share

    err_plain, _ = agree(x, got)
    err_b, share_b = agree(xb, got_b)
    control = dtl.decoder_tail_plain(xb.float(), *params).to(torch.bfloat16)
    control_err, control_share, control_fault = tail_agreement(control, dtl.decoder_tail_plain(xb, *params), None)
    if control_fault is None:
        raise AssertionError(f"decoder_tail: the bfloat16 check passes the float32 chain cast at the end "
                             f"(off by {control_err}, {control_share:.4%} of the elements differ)")

    rng = np.random.default_rng(37)
    n_r, s_r, c_r, o_r = 3, 37, 32, 5
    ragged_x, *ragged_p = (torch.as_tensor(a.astype(np.float32), device="cuda") for a in (
        rng.normal(size=(n_r, s_r, s_r, c_r)), rng.normal(size=(3, 3, c_r, c_r)) * 0.06,
        rng.normal(size=(c_r,)) * 0.05, rng.uniform(0.0, 0.3, size=(s_r, s_r, c_r)),
        rng.normal(size=(3, 3, c_r, o_r)) * 0.06, rng.normal(size=(o_r,)) * 0.05))
    ones = torch.ones_like(x[:2])
    cases = {  # (max abs error, differing share) a case
        "float32": {"constant": agree(ones), "batch1": agree(x[:1]),
                    "ragged_3x37x37x32_to_5": agree(ragged_x, p=ragged_p)},
        "bfloat16": {"constant": agree(ones.to(torch.bfloat16), held_to_share=False), "batch1": agree(xb[:1]),
                     "ragged_3x37x37x32_to_5": agree(ragged_x.to(torch.bfloat16), p=ragged_p)},
    }

    n, size, _, c = x.shape
    o = want.shape[-1]
    param_bytes = sum(p.numel() for p in params) * 4
    ops = n * size * size * 2 * 9 * c * (c + o)
    t_bound, by = bound((x.numel() + want.numel()) * 4 + param_bytes, ops)
    t_bound_b, by_b = bound((x.numel() + want.numel()) * 2 + param_bytes, ops, PEAK_BF16_OPS_PER_S)
    x_nchw = caught["x"]
    convt, prelu, head = net.decoder.convts[-1], net.decoder.prelus[-1], net.decoder.head
    xb_nchw = x_nchw.to(torch.bfloat16)
    k2b, b2b = convt.weight.detach().to(torch.bfloat16), convt.bias.detach().to(torch.bfloat16)
    a2b = prelu.alpha.detach().to(torch.bfloat16)
    k3b, b3b = head.weight.detach().to(torch.bfloat16), head.bias.detach().to(torch.bfloat16)

    def library():
        with torch.no_grad(), fp32_math():
            return F.relu(head(prelu(convt(x_nchw))))

    def library_bf16():
        with torch.no_grad():
            h = F.conv_transpose2d(xb_nchw, k2b, b2b, padding=1)
            h = torch.clamp(h, min=0) + a2b * torch.clamp(h, max=0)
            return F.relu(F.conv2d(h, k3b, b3b, padding=1))

    common = {
        "route": "cuda", "launched_by": "one stand-alone call on the main path's tail input (no entry point "
                                        "calls it, as in the JAX package)",
        "replaces": "debvader_tpu/kernels/decoder_tail.py:105", "shape": [n, size, size, c, o],
    }
    f32 = {
        **common, "name": "decoder_tail", "source": "debvader_tpu_torch/csrc/decoder_tail.cu",
        "launches": launches, "max_abs_err": max(err, err_plain),
        "ms": cuda_ms(torch, lambda: dtl.fused_decoder_tail(x, *params)),
        "device_ms": profiled_device_ms(torch, lambda: dtl.fused_decoder_tail(x, *params), "decoder_tail_kernel"),
        "plain_ms": cuda_ms(torch, lambda: dtl.decoder_tail_plain(x, *params)),
        "library_ms": cuda_ms(torch, library),
        "library_call": "the decoder's own layers (conv_transpose2d, PReLU, conv2d, ReLU on cuDNN, float32)",
        "bound_ms": t_bound, "bound_by": by,
        "output_max_abs": float(want.abs().max()), "cases_max_abs_err": {k: v[0] for k, v in cases["float32"].items()},
    }
    bf16 = {
        **common, "name": "decoder_tail_bf16", "source": "debvader_tpu_torch/csrc/tail_fused.cu",
        "launches": launches_b, "max_abs_err": err_b, "differing_share": share_b,
        "differing_share_limit": BF16_SHARE_LIMIT,
        "control_f32_chain_cast": {"max_abs_err": control_err, "differing_share": control_share,
                                   "rejected_by": control_fault},
        "ulp_at_scale": bf16_ulp(float(got_b.float().abs().max())),
        "ms": cuda_ms(torch, lambda: dtl.fused_decoder_tail(xb, *params)),
        "device_ms": profiled_device_ms(torch, lambda: dtl.fused_decoder_tail(xb, *params), "tail_pair_kernel"),
        "plain_ms": cuda_ms(torch, lambda: dtl.decoder_tail_plain(xb, *params)),
        "library_ms": cuda_ms(torch, library_bf16),
        "library_call": "the same layers in bfloat16 on cuDNN (conv_transpose2d, PReLU, conv2d, ReLU)",
        "bound_ms": t_bound_b, "bound_by": by_b,
        "output_max_abs": float(got_b.float().abs().max()),
        "cases_max_abs_err": {k: v[0] for k, v in cases["bfloat16"].items()},
        "cases_differing_share": {k: v[1] for k, v in cases["bfloat16"].items()},
    }
    return [f32, bf16]


TAIL_LAYERS = {"dec/ConvT_7": "bf16x3", "dec/Conv_0": "bf16x3"}


def check_tail_fused(torch, stamps: np.ndarray) -> dict:
    """Phase 7: the fidelity-precision tail pair on the real input of
    dec/ConvT_7 for the main path's batch, under a model whose last two
    layers run the bf16x3 scheme.  The counted launch is one call of the
    public function on those activations; comparison and timing launches
    come after the count is read.  Tolerance 5e-6 of the output scale
    against the plain version: the same limbs and exact products, summed in
    another order (and by the tensor core, not as a chain of IEEE adds)."""
    import torch.nn.functional as F

    import debvader_tpu_torch as dt
    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.kernels import tail_fused as tf

    net = dt.load_deblender("sim_demo", device="cuda", cfg=dt.ModelConfig(layer_precision=TAIL_LAYERS))
    caught = {}
    pre = net.decoder.convts[-1].register_forward_pre_hook(lambda m, a: caught.update(x=a[0]))
    post = net.decoder.head.register_forward_hook(lambda m, a, out: caught.update(y=out))
    dt.deblend(net, stamps, z_mode="mean", device="cuda")
    pre.remove()
    post.remove()
    x = caught["x"].permute(0, 2, 3, 1).contiguous()  # (N, 64, 64, 32)
    want = F.relu(caught["y"]).permute(0, 2, 3, 1)     # (N, 64, 64, 12)
    params = dt.tail_pair_params(net.decoder)

    tf.fused_tail_pair.launches = 0
    got = dt.fused_tail_pair(x, *params)
    torch.cuda.synchronize()
    launches = tf.fused_tail_pair.launches
    if launches <= 0:
        raise AssertionError("tail_fused: the kernel was not launched")
    plain = tf.tail_pair_plain(x, *params)
    scale = float(plain.abs().max())
    err_plain = float((got - plain).abs().max())
    if got.shape != plain.shape or not err_plain <= 5e-6 * scale:
        raise AssertionError(f"tail_fused: off by {err_plain} from the plain version (scale {scale})")
    err_model = float((got - want).abs().max())
    if not err_model <= 5e-5 * scale:
        raise AssertionError(f"tail_fused: off by {err_model} from the model's own head output")

    # the border case (a constant input shows a ring of h1 that is not
    # zeroed) and a shape that is no multiple of the tile
    ones = torch.ones_like(x[:2])
    err_border = float((dt.fused_tail_pair(ones, *params) - tf.tail_pair_plain(ones, *params)).abs().max())
    gen = torch.Generator(device="cuda").manual_seed(3)
    xr = torch.randn((3, 37, 50, 32), generator=gen, device="cuda")
    ar = 0.2 * torch.randn((37, 50, 32), generator=gen, device="cuda")
    ragged = (xr, params[0], params[1], ar, params[3][..., :5].contiguous(), params[4][:5].contiguous())
    plain_r = tf.tail_pair_plain(*ragged)
    err_ragged = float((dt.fused_tail_pair(*ragged) - plain_r).abs().max())
    torch.cuda.synchronize()
    if not err_border <= 5e-6 * scale:
        raise AssertionError(f"tail_fused: constant input off by {err_border}: the ring of h1 leaks")
    if not err_ragged <= 5e-6 * float(plain_r.abs().max()):
        raise AssertionError(f"tail_fused: ragged shape off by {err_ragged}")

    n, height, width, c = x.shape
    o = want.shape[-1]
    # the function's own operations are bf16 products: 3 limb terms a
    # multiply-add, against the dense bf16 tensor-core rate
    t_bound, by = bound(
        (x.numel() + want.numel() + sum(p.numel() for p in params)) * 4,
        3 * n * height * width * 2 * 9 * c * (c + o),
        PEAK_BF16_OPS_PER_S,
    )
    x_nchw = caught["x"]
    convt, prelu, head = net.decoder.convts[-1], net.decoder.prelus[-1], net.decoder.head

    def library():
        with torch.no_grad(), fp32_math():
            return F.relu(head(prelu(convt(x_nchw))))

    return {
        "name": "tail_fused", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/tail_fused.cu",
        "replaces": "debvader_tpu/kernels/tail_fused.py:218",
        "launches": launches,
        "launched_by": "one stand-alone call on the main path's dec/ConvT_7 input (no entry point calls it, as in the JAX package)",
        "max_abs_err": err_plain,
        "err_vs_plain": err_plain, "err_vs_model_head": err_model,
        "err_border_case": err_border, "err_ragged_shape": err_ragged,
        "ragged_output_max_abs": float(plain_r.abs().max()),
        "ms": cuda_ms(torch, lambda: tf.fused_tail_pair(x, *params)),
        "device_ms": profiled_device_ms(torch, lambda: tf.fused_tail_pair(x, *params), "tail_pair_kernel"),
        "plain_ms": cuda_ms(torch, lambda: tf.tail_pair_plain(x, *params)),
        "library_ms": cuda_ms(torch, library),
        "library_call": "the model's own two layers under bf16x3 (six float32 cuDNN convs on bf16-valued "
                        "operands, PReLU, ReLU): the same function through the library, not one call",
        "bound_ms": t_bound, "bound_by": by,
        "shape": [n, height, width, c, o],
        "output_max_abs": scale,
    }


def flux_rel_err(a: np.ndarray, ref: np.ndarray) -> float:
    """Largest relative error of the per-stamp total flux."""
    tr = ref.astype(np.float64).sum(axis=(1, 2, 3))
    return float(np.max(np.abs(a.astype(np.float64).sum(axis=(1, 2, 3)) - tr) / np.abs(tr)))


def run_fidelity_path(torch, net, field, centers, catalog, s_residual) -> tuple:
    """Phase 8: the precision-scheme serving mode at full width on the
    card.  Returns (the fidelity net, its report)."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.data.simulate import simulate_batch
    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.utils.flux_cal import apply_flux_calibration

    t = time.perf_counter()
    fid = dt.load_deblender(
        "sim_demo", device="cuda", cfg=dt.fidelity_serving_config(limb_emulation=True), flux_calibration=True
    )
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    scale = fid.flux_cal_scale.cpu().numpy()
    if scale.shape != (6,) or not np.isfinite(scale).all():
        raise AssertionError(f"fidelity: bad flux calibration {scale}")

    held_out = torch.as_tensor(simulate_batch(7, 64)[0], device="cuda")
    with torch.no_grad(), fp32_math():
        ref = net(held_out, z_mode="mean")[0].loc.cpu().numpy()
        dist = fid(held_out, z_mode="mean")[0]
        raw = dist.loc.cpu().numpy()
        cal = apply_flux_calibration(dist, fid).loc.cpu().numpy()
    raw_err, cal_err = flux_rel_err(raw, ref), flux_rel_err(cal, ref)
    if not (raw_err > 1e-4 > cal_err):
        raise AssertionError(f"fidelity: raw flux error {raw_err}, calibrated {cal_err}; expected raw > 1e-4 > calibrated")

    dfid = dt.DeblendField(fid, field, z_mode="mean", cfg=serving_cfg(), device="cuda")
    f_cat, f_residual, f_model = dfid.deblend_and_render(centers, return_model=True, measure=True)
    catalogs_agree(f_cat, catalog)
    field_scale = float(np.abs(field).max())
    resid_err = float(np.abs(f_residual - s_residual).max())
    if not (np.isfinite(f_residual).all() and resid_err <= 1e-3 * field_scale):
        raise AssertionError(f"fidelity: residual differs from the float32 route's by {resid_err}")

    # warm times, the float32 route beside it within this one call
    df32 = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device="cuda")
    df32.deblend_and_render(centers, return_model=True, measure=True)
    warm = {"float32": [], "fidelity": []}
    for name, obj in (("float32", df32), ("fidelity", dfid), ("fidelity", dfid), ("float32", df32),
                      ("float32", df32), ("fidelity", dfid)):
        timings = {}
        t = time.perf_counter()
        obj.deblend_and_render(centers, return_model=True, measure=True, timings=timings)
        torch.cuda.synchronize()
        warm[name].append({"total_s": time.perf_counter() - t, **timings})
    return fid, {
        "load_s": load_s, "flux_cal_scale": [float(v) for v in scale],
        "held_out_stamps": 64, "raw_max_rel_flux_err": raw_err, "calibrated_max_rel_flux_err": cal_err,
        "residual_max_abs_err_vs_float32_route": resid_err, "field_max_abs": field_scale,
        "deblended": int(len(f_cat)), "warm_deblend_and_render": warm,
    }


def run_epistemic_path(torch, net, field, centers, cutouts: np.ndarray, samples: int = 16) -> dict:
    """Phase 9: epistemic estimation on the streaming route and the
    stochastic stamp API, at full width on the card."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.kernels import render as rd

    cfg = dt.PipelineConfig(interp_order=1, source_chunk=128, epistemic_samples=samples)

    def make(seed=1234):
        return dt.DeblendField(
            net, field, epistemic_uncertainty_estimation=True, z_mode="mean", cfg=cfg,
            generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda",
        )

    rd.render_field_kernel.launches = 0
    cat, fields = make().deblend_and_predict(centers)
    torch.cuda.synchronize()
    launches = rd.render_field_kernel.launches
    chunks = -(-len(centers) // 128)
    if launches < 3 * chunks:
        raise AssertionError(f"epistemic: render kernel launched {launches} times, expected >= {3 * chunks}")
    epi = fields["predicted_epistemic_field"]
    if epi is None or epi.shape != field.shape[1:] or not np.isfinite(epi).all():
        raise AssertionError("epistemic: no finite epistemic field of the field's shape")
    if epi.min() < 0 or not epi.max() > 0:
        raise AssertionError(f"epistemic: field range [{epi.min()}, {epi.max()}]")
    # a bilinear deposit reaches one pixel past the stamp's 59x59 window
    xy = np.stack([cat.galaxy_distances_to_center_x, cat.galaxy_distances_to_center_y], -1)
    outside = ~stamp_mask(field.shape[1], xy, size=63)
    if epi[outside].any():
        raise AssertionError("epistemic: deposits outside every stamp's window")
    if not (np.isfinite(cat.epistemic_norm).all() and (cat.epistemic_norm > 0).all()):
        raise AssertionError("epistemic: epistemic_norm is not positive and finite")
    # The same seed gives the same draws, and the forward runs on cuDNN's
    # deterministic algorithms (device.fp32_math), so every field of two
    # runs is bit-identical.  Another seed moves the field by a share of
    # its own size.
    _, again = make().deblend_and_predict(centers)
    _, other = make(seed=4321).deblend_and_predict(centers)
    same_seed = float(np.abs(again["predicted_epistemic_field"] - epi).max())
    other_seed = float(np.abs(other["predicted_epistemic_field"] - epi).max())
    differ = [k for k, v in fields.items() if v is not None and not np.array_equal(
        np.asarray(v).view(np.int32), np.asarray(again[k]).view(np.int32))]
    if differ or other_seed < 1e-2 * float(epi.max()):
        raise AssertionError(
            f"epistemic: same seed not bit-identical on {differ} (epistemic field off by {same_seed}), "
            f"another seed off by {other_seed} (field max {epi.max()})"
        )

    # warm time and peak memory of the call
    obj = make()
    obj.deblend_and_predict(centers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    warm = []
    for _ in range(2):
        timings = {}
        t = time.perf_counter()
        obj.deblend_and_predict(centers, timings=timings)
        torch.cuda.synchronize()
        warm.append({"total_s": time.perf_counter() - t, **timings})
    peak = torch.cuda.max_memory_allocated()

    # the statistics against the sample cube, the same generator state and
    # the same chunking (two replica chunks: one Welford merge)
    x32 = cutouts[:32]
    gen = lambda: torch.Generator(device="cuda").manual_seed(77)  # noqa: E731
    cube = dt.deblend_samples(net, x32, samples, generator=gen(), max_chunk=256, device="cuda")
    mean, std = dt.deblend_sample_stats(net, x32, samples, generator=gen(), max_chunk=256, device="cuda")
    scale = float(cube.abs().max())
    stats_err = {
        "mean": float((mean - cube.mean(dim=0)).abs().max()),
        "std": float((std - cube.std(dim=0, unbiased=False)).abs().max()),
    }
    if cube.shape != (samples, 32, 59, 59, 6) or max(stats_err.values()) > 1e-5 * scale:
        raise AssertionError(f"epistemic: deblend_sample_stats differs from the cube's statistics: {stats_err}")

    # the whole batch at the reference's 100 samples, 1,024 decodes a chunk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_stats = torch.cuda.memory_allocated()
    t = time.perf_counter()
    _, std_all = dt.deblend_sample_stats(net, cutouts, 100, generator=gen(), max_chunk=1024, device="cuda")
    torch.cuda.synchronize()
    stats_s = time.perf_counter() - t
    peak_stats = torch.cuda.max_memory_allocated()
    if std_all.shape != (len(cutouts), 59, 59, 6) or not bool(torch.isfinite(std_all).all()):
        raise AssertionError("epistemic: deblend_sample_stats on the whole batch is not finite")
    return {
        "epistemic_samples": samples, "sources": int(len(cat)), "chunks": chunks, "render_launches": launches,
        "same_seed_max_abs_diff": same_seed, "other_seed_max_abs_diff": other_seed,
        "epistemic_field_max": float(epi.max()), "epistemic_norm_median": float(np.median(cat.epistemic_norm)),
        "warm_deblend_and_predict": warm, "baseline_bytes": int(base), "peak_bytes": int(peak),
        "stats_vs_cube_max_abs_err": stats_err, "cube_max_abs": scale,
        "sample_stats_whole_batch": {
            "stamps": int(len(cutouts)), "n_samples": 100, "max_chunk": 1024, "seconds": stats_s,
            "baseline_bytes": int(base_stats), "peak_bytes": int(peak_stats),
        },
    }


def time_cudnn_determinism(torch, net, field, centers, pairs: int = 4) -> dict:
    """What cuDNN's deterministic algorithms (on inside device.fp32_math)
    cost: warm deblend_s of the record-array route, the warm streaming
    deblend_and_render (the serving call) and the warm epistemic
    deblend_and_predict (16 samples), each warmed once under each setting,
    then ``pairs`` off/on pairs, the order within a pair alternating (off,
    on / on, off / ...).  Per route and setting: the seconds of every run,
    their median, least and largest; and the median of the pairs' on / off
    ratios."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch import device as dv

    cfg = dt.PipelineConfig(interp_order=1, source_chunk=128, epistemic_samples=16)
    record = dt.DeblendField(net, field, z_mode="mean", device="cuda")
    stream = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device="cuda")
    epi = dt.DeblendField(net, field, epistemic_uncertainty_estimation=True, z_mode="mean", cfg=cfg,
                          generator=torch.Generator(device="cuda").manual_seed(1234), device="cuda")
    routes = {
        "deblend_s": lambda: record.deblend_field(centers),
        "streaming_deblend_and_render_s": lambda: stream.deblend_and_render(
            centers, return_model=True, measure=True),
        "epistemic_deblend_and_predict_s": lambda: epi.deblend_and_predict(centers),
    }
    runs = {name: {"off": [], "on": []} for name in routes}
    order = [("off", "on") if i % 2 == 0 else ("on", "off") for i in range(pairs)]
    try:
        for setting in ("off", "on"):
            dv._CUDNN_DETERMINISTIC = setting == "on"
            for fn in routes.values():
                fn()
        for pair in order:
            for setting in pair:
                dv._CUDNN_DETERMINISTIC = setting == "on"
                for name, fn in routes.items():
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    runs[name][setting].append(time.perf_counter() - t)
    finally:
        dv._CUDNN_DETERMINISTIC = True
    out = {}
    for name, r in runs.items():
        out[name] = {
            **{setting: {"median": float(np.median(v)), "min": min(v), "max": max(v), "runs": v}
               for setting, v in r.items()},
            "pairs": pairs,
            "median_on_over_off": float(np.median(np.array(r["on"]) / np.array(r["off"]))),
        }
    return out


# ------------------------------------- registration, residency, iteration

REG_BOUND = 3.0
REG_ITERATIONS = 20
# One pixel of one Gauss-Newton step in csrc/registration.cu: the two
# blends (6), the output (3), the two Jacobian columns (6), the residual
# (1), the window mask (4), two negations and the five products and sums
# (10 + 2); the base's blend takes 11 a padded-window pixel, once.
REG_OPS_PER_PIXEL_STEP = 32


def registration_bound(n: int, s: int, band_pixels: int, full: bool = False):
    """(ms, bound_by) of the registration of n stamps of s pixels: the
    stamps, the band, the offsets and the shifts moved once, and each
    source's window (or the whole band, ``full``) through every step."""
    win = s + 2 * (int(np.ceil(REG_BOUND)) + 3)
    pixels = band_pixels if full else win * win
    pw = win + 2 * (int(np.ceil(REG_BOUND)) + 1)
    ops = n * REG_ITERATIONS * pixels * REG_OPS_PER_PIXEL_STEP + n * (pixels if full else pw * pw) * 11
    return bound(n * s * s * 4 + band_pixels * 4 + n * 16, ops)


def registration_cases(torch, band: np.ndarray, preds: np.ndarray, dets: np.ndarray) -> dict:
    """name -> (band, stamps, offsets, windowed) on the card, beside the
    record-array route's real inputs: sources flush against each border of
    the field, a NaN pixel in the band under a source, sources driven to
    the +-bound clip (the field holds them 5 px away), the full-field
    branch at a 64-pixel field, and the recovery of a stamp placed at
    (0.37, -0.62) px from an integer detection in a zero field."""
    import debvader_tpu_torch as dt

    dev = torch.device("cuda")
    f, s = band.shape[0], preds.shape[1]
    as_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)  # noqa: E731
    half = f / 2
    edge = np.array([[-half, 3.2], [half - 1.5, -40.6], [17.3, -half], [-8.8, half - 0.5],
                     [-half + 10.0, -half + 10.0], [half - 20.0, half - 20.0]], np.float32)
    k = len(edge)
    nan_band = band.copy()
    y0, x0 = (f - s) // 2 + np.floor(dets[0]).astype(int) + s // 2
    nan_band[y0, x0] = np.nan
    nan_band[y0 + 2, x0 - 3] = np.inf
    render = lambda st, off, size: dt.render_field(as_dev(st[..., None]), as_dev(off), size)[..., 0]  # noqa: E731
    clip_off = np.array([[-f / 10, f / 20], [f / 5, -f / 4], [10.0, 10.0]], np.float32)
    clip_band = render(preds[:3], clip_off + np.array([[5.0, -5.0], [-5.0, 5.0], [5.0, 5.0]], np.float32), f)
    small = render(preds[:4], np.array([[0.3, -0.6], [1.2, 1.9], [-2.2, 0.4], [0.0, 0.0]], np.float32), 64)
    det = np.round(np.array([[0.0, 0.0], [f / 5, -f / 7]], np.float32))
    truth = np.array([0.37, -0.62], np.float32)
    recover = render(preds[:2], det + truth, f)
    return {
        "borders": (as_dev(band), as_dev(preds[:k]), as_dev(edge)),
        "nan_pixel": (as_dev(nan_band), as_dev(preds[:1]), as_dev(dets[:1])),
        "clip": (clip_band, as_dev(preds[:3]), as_dev(clip_off)),
        "full_field_64": (small, as_dev(preds[:4]), torch.zeros((4, 2), device=dev)),
        "recovery": (recover, as_dev(preds[:2]), as_dev(det)),
    }


def check_registration(torch, field: np.ndarray, res) -> dict:
    """Phase 11: csrc/registration.cu against its plain version on the
    record-array route's real inputs (the smoke field's r band, the means'
    r band of every deblended source, their offsets) and on the edge cases
    of ``registration_cases``, each within 1e-4 px; the clip case on the
    bound and the recovery within 0.01 px of the truth; timed with its
    bound."""
    from debvader_tpu_torch.kernels import registration as kr
    from debvader_tpu_torch.ops.registration import position_optimization_batch_windowed as windowed

    dev = torch.device("cuda")
    band = np.ascontiguousarray(field[0, :, :, 2])
    preds = np.ascontiguousarray(np.stack(list(res.output_images_mean))[..., 2])
    dets = np.stack([res.galaxy_distances_to_center_x, res.galaxy_distances_to_center_y], -1).astype(np.float32)
    b, p, o = (torch.as_tensor(a, device=dev) for a in (band, preds, dets))
    cases, worst = {}, 0.0
    runs = {"real": (b, p, o)}
    runs.update(registration_cases(torch, band, preds, dets))
    for name, (bb, pp, oo) in runs.items():
        got = windowed(bb, pp, oo, REG_BOUND, REG_ITERATIONS)
        full = bb.shape[0] < kr.registration_window(pp.shape[1], REG_BOUND)
        plain = (kr.register_full_plain if full else kr.register_windowed_plain)(bb, pp, oo, REG_BOUND, REG_ITERATIONS)
        one = windowed(bb, pp, oo, REG_BOUND, 1)
        one_plain = (kr.register_full_plain if full else kr.register_windowed_plain)(bb, pp, oo, REG_BOUND, 1)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        err1 = float((one - one_plain).abs().max())
        if not (err <= 1e-4 and err1 <= 1e-5 and bool(torch.isfinite(got).all())):
            raise AssertionError(f"registration ({name}): off by {err} px (20 steps) / {err1} px (1 step)")
        rec = {"sources": int(pp.shape[0]), "max_abs_err_px": err, "one_step_max_abs_err_px": err1,
               "max_abs_shift": float(got.abs().max())}
        if name == "clip" and not bool((got.abs() == REG_BOUND).all()):
            raise AssertionError(f"registration (clip): shifts {got.tolist()} did not end on the bound")
        if name == "recovery":
            miss = float((got - torch.tensor([0.37, -0.62], device=dev)).abs().max())
            rec["recovery_err_px"] = miss
            if not miss <= 0.01:
                raise AssertionError(f"registration (recovery): {got.tolist()} misses (0.37, -0.62) by {miss} px")
        cases[name] = rec
        worst = max(worst, err)
    n, s = preds.shape[:2]
    t_bound, by = registration_bound(n, s, band.size)
    return {
        "name": "registration", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/registration.cu",
        "replaces": "debvader_tpu/ops/registration.py:106 (position_optimization_batch_windowed, XLA; no Pallas kernel)",
        "max_abs_err": worst,
        "ms": cuda_ms(torch, lambda: kr.register_windowed(b, p, o, REG_BOUND, REG_ITERATIONS)),
        "device_ms": profiled_device_ms(
            torch, lambda: kr.register_windowed(b, p, o, REG_BOUND, REG_ITERATIONS), "register_windowed_kernel"),
        "plain_ms": cuda_ms(torch, lambda: kr.register_windowed_plain(b, p, o, REG_BOUND, REG_ITERATIONS)),
        "library_ms": None,
        "bound_ms": t_bound, "bound_by": by,
        "shape": [n, s, s, band.shape[0]], "iterations": REG_ITERATIONS,
        "full_field_64_ms": cuda_ms(torch, lambda: kr.register_full(*runs["full_field_64"], REG_BOUND, REG_ITERATIONS)),
        "full_field_64_bound_ms": registration_bound(4, s, 64 * 64, full=True)[0],
        "cases": cases,
    }


# Phase 12: special values for the bfloat16 canvases (as bfloat16): NaN,
# infinities, signed zeros, subnormals, the largest finite values, and
# values 20 or more binades from the rest.
BF16_SPECIALS = (float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-40, -9e-39, 3e38, -3e38, 1e6, -1e6,
                 1e-7)


def with_specials(torch, t, gen, count: int):
    """A copy of bfloat16 ``t`` with ``count`` seeded elements set to
    BF16_SPECIALS in turn."""
    out = t.clone()
    flat = out.view(-1)
    idx = torch.randint(0, flat.numel(), (count,), generator=gen, device=t.device)
    vals = torch.tensor(BF16_SPECIALS, device=t.device).to(torch.bfloat16)
    flat[idx] = vals[torch.arange(count, device=t.device) % len(BF16_SPECIALS)]
    return out


def bf16_bits(torch, t):
    """The bits of a bfloat16 tensor on the CPU, every NaN as 0x7FFF (the
    card's and the CPU's roundings give NaNs other payloads)."""
    t = t.cpu()
    bits = t.view(torch.int16).clone()
    bits[torch.isnan(t)] = 0x7FFF
    return bits


def bf16_held(torch, name: str, got, again, plain, cpu) -> None:
    """The kernel's canvas bit for bit (NaN as NaN) against a second launch,
    the plain version on the card and the plain version on the CPU."""
    g = bf16_bits(torch, got)
    for what, z in (("two launches", again), ("plain on the card", plain), ("plain on the CPU", cpu)):
        diff = int((g != bf16_bits(torch, z)).sum())
        if diff:
            raise AssertionError(f"{name}: {diff} elements differ ({what})")


def check_bf16_canvases(torch, f: int, n: int = 128, s: int = 59, b: int = 6) -> list[dict]:
    """Phase 12: the bfloat16 kernels of csrc/render.cu at the bfloat16
    stream's shapes (one 128-source chunk): dvt_render_bf16 into the window
    of a padded bf16 canvas filled with seeded random values, dvt_place_bf16
    of the order-3 patches into a filled bf16 canvas.  Each case bit for
    bit (NaN as NaN) against a second launch and against the plain version
    on the card and on the CPU: the chunk; stamps, patches and canvases
    with special values (some patches not visible); sources on tile
    borders, off the field, NaN and huge offsets (render_path_cases); two
    bands (the generic kernels); and, for the render, a chunk into the
    4096^2 window of a 4218^2 canvas (the tiled route's shape).  Device
    time is the sum of every kernel one call launches; each is timed with
    its bound and its plain version."""
    from debvader_tpu_torch.kernels import render as rd

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(14)
    stamps = torch.rand((n, s, s, b), generator=gen, device=dev).to(bf)
    offsets = (torch.rand((n, 2), generator=gen, device=dev) - 0.5) * (f - 80)

    def render_case(name, st, off, field, canvas0, pad, mask=None):
        def window(c):
            return c[pad : pad + field, pad : pad + field]

        got, again, plain = canvas0.clone(), canvas0.clone(), canvas0.clone()
        rd.render_field_kernel(st, off, field, mask, out=window(got))
        rd.render_field_kernel(st, off, field, mask, out=window(again))
        rd.render_field_plain(st, off, field, mask, out=window(plain))
        cpu = canvas0.cpu()
        rd.render_field_plain(st.cpu(), off.cpu(), field, None if mask is None else mask.cpu(), out=window(cpu))
        torch.cuda.synchronize()
        bf16_held(torch, f"render_bf16 ({name})", got, again, plain, cpu)
        changed = int((bf16_bits(torch, got) != bf16_bits(torch, canvas0)).sum())
        return {"sources": int(st.shape[0]), "changed_elements": changed}

    pad = s + 2
    canvas0 = torch.randn((f + 2 * pad, f + 2 * pad, b), generator=gen, device=dev).to(bf)
    render_cases = {"chunk": render_case("chunk", stamps, offsets, f, canvas0, pad)}
    special_mask = torch.rand(n, generator=gen, device=dev) > 0.1
    render_cases["special"] = render_case(
        "special", with_specials(torch, stamps, gen, 20000), offsets, f, with_specials(torch, canvas0, gen, 200000),
        pad, special_mask)
    for name, (st, off) in render_path_cases(torch, f).items():
        if name != "chunk":
            render_cases[name] = render_case(name, st.to(bf), off, f, canvas0, pad)
    st2 = torch.rand((20, 15, 15, 2), generator=gen, device=dev).to(bf)
    of2 = (torch.rand((20, 2), generator=gen, device=dev) - 0.5) * 260
    render_cases["two_bands"] = render_case("two_bands", st2, of2, 256, torch.randn(
        (256, 256, 2), generator=gen, device=dev).to(bf), 0)
    fs, pad4 = 4096, s + 2
    stamps4 = torch.rand((n, s, s, b), generator=gen, device=dev).to(bf)
    offsets4 = (torch.rand((n, 2), generator=gen, device=dev) - 0.5) * (fs + 40)
    canvas4 = torch.randn((fs + 2 * pad4, fs + 2 * pad4, b), generator=gen, device=dev).to(bf)
    render_cases["window_4096"] = render_case("window_4096", stamps4, offsets4, fs, canvas4, pad4)
    if render_cases["off_field"]["changed_elements"] != 0 or render_cases["chunk"]["changed_elements"] == 0:
        raise AssertionError(f"render_bf16: unexpected coverage {render_cases}")

    def render_timing(st, off, field, canvas, pad_):
        n_, s_ = st.shape[0], st.shape[1]
        cov = covered_mask(off.cpu().numpy(), None, s_, field)
        work = canvas.clone()
        window = work[pad_ : pad_ + field, pad_ : pad_ + field]
        t_bound, by = bound(n_ * s_ * s_ * b * 2 + n_ * 8 + 2 * int(cov.sum()) * b * 2,
                            n_ * (s_ + 2) * (s_ + 2) * b * 11)
        return {
            "ms": cuda_ms(torch, lambda: rd.render_field_kernel(st, off, field, out=window)),
            "device_ms": profiled_all_ms(torch, lambda: rd.render_field_kernel(st, off, field, out=window)),
            "plain_ms": cuda_ms(torch, lambda: rd.render_field_plain(st, off, field, out=window)),
            "bound_ms": t_bound, "bound_by": by, "shape": [n_, s_, s_, b, field], "covered_pixels": int(cov.sum()),
        }

    render_rec = {
        "name": "render_bf16", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/render.cu",
        "replaces": "debvader_tpu/kernels/render.py:149 (render_field_pallas) on a bfloat16 canvas "
                    "(debvader_tpu/ops/shift.py:209, the scan's bf16 adds)",
        "max_abs_err": 0.0, "library_ms": None,
        **render_timing(stamps, offsets, f, canvas0, pad),
        "window_4096": render_timing(stamps4, offsets4, fs, canvas4, pad4),
        "cases": render_cases,
    }
    del canvas4

    def place_case(name, pt, y, x, vis, canvas0):
        got, again, plain = canvas0.clone(), canvas0.clone(), canvas0.clone()
        rd.place_patches(got, pt, y, x, vis)
        rd.place_patches(again, pt, y, x, vis)
        rd.place_patches_plain(plain, pt, y, x, vis)
        cpu = canvas0.cpu()
        rd.place_patches_plain(cpu, pt.cpu(), y.cpu(), x.cpu(), vis.cpu())
        torch.cuda.synchronize()
        bf16_held(torch, f"place_bf16 ({name})", got, again, plain, cpu)
        return {"sources": int(len(y)), "visible": int(vis.sum()),
                "changed_elements": int((bf16_bits(torch, got) != bf16_bits(torch, canvas0)).sum())}

    patches, y, x, visible, c = place_inputs(torch, stamps.float(), offsets, f)
    patches = patches.to(bf).contiguous()
    canvas0 = torch.randn((c, c, b), generator=gen, device=dev).to(bf)
    place_cases = {"chunk": place_case("chunk", patches, y, x, visible, canvas0)}
    hidden = visible.clone()
    hidden[::5] = False
    place_cases["special"] = place_case("special", with_specials(torch, patches, gen, 40000), y, x, hidden,
                                        with_specials(torch, canvas0, gen, 200000))
    for name, (st, off) in render_path_cases(torch, f).items():
        if name != "chunk":
            pt, yy, xx, vv, cc = place_inputs(torch, st, off, f)
            place_cases[name] = place_case(name, pt.to(bf).contiguous(), yy, xx, vv, torch.randn(
                (cc, cc, b), generator=gen, device=dev).to(bf))
    pt2, y2, x2, v2, c2 = place_inputs(torch, st2.float(), of2, 256)
    place_cases["two_bands"] = place_case("two_bands", pt2.to(bf).contiguous(), y2, x2, v2, torch.randn(
        (c2, c2, 2), generator=gen, device=dev).to(bf))
    if place_cases["off_field"]["visible"] != 0 or place_cases["chunk"]["changed_elements"] == 0:
        raise AssertionError(f"place_bf16: unexpected visibility or coverage {place_cases}")
    p = patches.shape[1]
    covered = footprint_elements(y.cpu(), x.cpu(), p, c, b)
    t_bound, by = bound(patches.numel() * 2 + n * 9 + covered * 4, patches.numel())
    ar = torch.arange(p, device=dev)
    flat = ((y[:, None] + ar)[:, :, None] * c + (x[:, None] + ar)[:, None, :]).reshape(-1)
    masked = torch.where(visible[:, None, None, None], patches, torch.zeros((), device=dev, dtype=bf)).reshape(-1, b)
    work = canvas0.clone()
    place_rec = {
        "name": "place_bf16", "route": "cuda",
        "source": "debvader_tpu_torch/csrc/render.cu",
        "replaces": "debvader_tpu/ops/shift.py:209 (render_field's order-3 scan on a bfloat16 canvas, XLA; "
                    "no Pallas kernel)",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: rd.place_patches(work, patches, y, x, visible)),
        "device_ms": profiled_all_ms(torch, lambda: rd.place_patches(work, patches, y, x, visible)),
        "plain_ms": cuda_ms(torch, lambda: rd.place_patches_plain(work, patches, y, x, visible)),
        "library_ms": cuda_ms(torch, lambda: work.view(-1, b).index_put_((flat,), masked, accumulate=True)),
        "library_call": "index_put_(accumulate=True) of the masked bf16 patches",
        "bound_ms": t_bound, "bound_by": by,
        "shape": [n, p, p, b, c], "covered_elements": covered, "cases": place_cases,
    }
    return [render_rec, place_rec]


def median_s(fn, reps: int = 3) -> float:
    """Median host seconds of ``fn`` (ending in a synchronise) over reps."""
    import torch

    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return float(np.median(times))


def run_registration_routes(torch, net, field: np.ndarray, centers: np.ndarray) -> dict:
    """Phase 13 (its launches counted by the caller): optimise_positions=True
    on the record-array route (deblend_field, then get_residual_field) and
    on the streaming route (deblend_and_render), both at interp_order=1 in
    128-source chunks; the two routes' shifts and residuals held against
    each other; then warm times of each beside the same call without
    registration, in turns (6 pairs, the order swapped each pair)."""
    import debvader_tpu_torch as dt

    rec_df = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device="cuda")
    res = rec_df.deblend_field(centers, optimise_positions=True)
    r_residual = rec_df.get_residual_field()
    st_df = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device="cuda")
    cat, s_residual = st_df.deblend_and_render(centers, optimise_positions=True)
    torch.cuda.synchronize()
    catalogs_agree(cat, res)
    shifts_r, shifts_s = np.stack(list(res.shifts)), np.stack(list(cat.shifts))
    shift_err = float(np.abs(shifts_r - shifts_s).max())
    scale = float(np.abs(field).max())
    resid_err = float(np.abs(r_residual - s_residual).max())
    if not (shift_err <= 1e-4 and resid_err <= 1e-5 * scale and np.isfinite(s_residual).all()):
        raise AssertionError(f"registration routes disagree: shifts {shift_err} px, residuals {resid_err}")
    if not (np.abs(shifts_s) <= REG_BOUND).all() or not np.abs(shifts_s).max() > 0:
        raise AssertionError("registration gave no shift, or one beyond the bound")
    times = {"record_array_s": {False: [], True: []}, "deblend_and_render_s": {False: [], True: []}}
    for i in range(6):
        for opt in ((False, True) if i % 2 == 0 else (True, False)):
            times["record_array_s"][opt].append(median_s(
                lambda: (rec_df.deblend_field(centers, optimise_positions=opt), rec_df.get_residual_field()), 1))
            times["deblend_and_render_s"][opt].append(median_s(
                lambda: st_df.deblend_and_render(centers, optimise_positions=opt), 1))
    summary = {k: {"off": float(np.median(v[False])), "on": float(np.median(v[True])), "runs_off": v[False],
                   "runs_on": v[True]} for k, v in times.items()}
    return {"sources": int(len(centers)), "deblended": int(len(res)), "max_abs_shift_px": float(np.abs(shifts_s).max()),
            "routes_shift_max_abs_err_px": shift_err, "routes_residual_max_abs_err": resid_err,
            "field_max_abs": scale, "warm": summary}


def run_device_dtype(torch, net, field: np.ndarray, centers: np.ndarray) -> dict:
    """Phase 14 (its launches counted by the caller): device_dtype='bfloat16'
    serving at orders 1 and 3 (deblend_and_render and deblend_and_predict in
    128-source chunks) against the float32 route, within 2e-2 of its scale
    (the JAX package's own bound); upload_dtype='bfloat16' alone; the
    memoized field's and the canvases' dtypes and bytes against float32;
    and the peak device memory of one float32 and one bfloat16 serving
    call."""
    import debvader_tpu_torch as dt

    out = {}
    for order in (1, 3):
        cfg = dt.PipelineConfig(interp_order=order, source_chunk=128)
        ref = dt.DeblendField(net, field, z_mode="mean", cfg=cfg, device="cuda")
        low = dt.DeblendField(net, field, z_mode="mean", cfg=cfg, device="cuda", device_dtype="bfloat16")
        _, r_res = ref.deblend_and_render(centers)
        _, l_res = low.deblend_and_render(centers)
        _, r_f = ref.deblend_and_predict(centers)
        _, l_f = low.deblend_and_predict(centers)
        errs = {"residual": (l_res, r_res)}
        errs.update({k: (l_f[k], r_f[k]) for k in ("residual_field", "predicted_mean_field", "predicted_stddev_field")})
        rec = {}
        for name, (a, z) in errs.items():
            if a.dtype != np.float32 or not np.isfinite(a).all():
                raise AssertionError(f"device_dtype order {order}: {name} is not finite float32")
            rel = float(np.abs(a - z).max()) / float(np.abs(z).max())
            if not rel < 2e-2:
                raise AssertionError(f"device_dtype order {order}: {name} off the float32 route by {rel} of its scale")
            rec[name] = rel
        out[f"order{order}_rel_err_vs_float32"] = rec
    up = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device="cuda", upload_dtype="bfloat16")
    _, u_res = up.deblend_and_render(centers)
    ref = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device="cuda")
    _, r_res = ref.deblend_and_render(centers)
    out["upload_dtype_rel_err_vs_float32"] = float(np.abs(u_res - r_res).max()) / float(np.abs(r_res).max())
    if up._device_field(up.field_image).dtype != torch.float32:
        raise AssertionError("upload_dtype alone must widen the field back to float32 on the device")

    low = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device="cuda", device_dtype="bfloat16")
    f_low, f_ref = low._device_field(low.field_image), ref._device_field(ref.field_image)
    _, c_low, _ = low._stream_deblend(f_low, centers, render_std=True, resident_fields=3)
    _, c_ref, _ = ref._stream_deblend(f_ref, centers, render_std=True, resident_fields=3)
    resident = {}
    for name, a, z in [("field", f_low, f_ref)] + [(k, c_low[k], c_ref[k]) for k in ("mean", "std")]:
        nb_low, nb_ref = a.numel() * a.element_size(), z.numel() * z.element_size()
        if a.dtype != torch.bfloat16 or 2 * nb_low != nb_ref:
            raise AssertionError(f"device_dtype: the resident {name} is {a.dtype}, {nb_low} bytes against {nb_ref}")
        resident[name] = {"dtype": str(a.dtype), "bytes": nb_low, "float32_bytes": nb_ref}
    out["resident"] = resident
    del c_low, c_ref
    peaks = {}
    for name, obj in (("float32", ref), ("bfloat16", low)):
        obj.deblend_and_render(centers)  # warm, field memoized
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        obj.deblend_and_render(centers)
        torch.cuda.synchronize()
        peaks[name] = {"baseline_bytes": int(base), "peak_bytes": int(torch.cuda.max_memory_allocated()),
                       "serving_s": median_s(lambda obj=obj: obj.deblend_and_render(centers))}
    out["serving_peak_memory"] = peaks
    return out


def run_iterative(torch, net, field: np.ndarray, read_counts) -> dict:
    """Phase 15: IterativeDeblendField.iterative_deblending(
    optimise_positions=True) with z_mode='mean' on a 259x259x6 crop of the
    smoke field (the reference's DC2 field size), at the default detection
    threshold: the steps, the sources of each step, the mse list and the
    wall time; two runs bit-identical; step 1's detections on the card equal
    to the CPU's. The caller sets the counts to 0; read_counts() is called
    right after the two iterative runs, before the card-against-CPU
    detection that would otherwise add its own launches."""
    import debvader_tpu_torch as dt

    c0 = (field.shape[1] - 259) // 2
    crop = np.ascontiguousarray(field[:, c0 : c0 + 259, c0 : c0 + 259, :])
    runs = []
    for _ in range(2):
        t = time.perf_counter()
        idf = dt.IterativeDeblendField(net, crop, z_mode="mean", device="cuda")
        res = idf.iterative_deblending(optimise_positions=True)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t, idf, res))
    launches = read_counts()
    (t1, a, ra), (t2, b, rb) = runs
    if a.mse != b.mse or a.nb_of_detected_objects != b.nb_of_detected_objects:
        raise AssertionError("two iterative runs differ in their steps or mse")
    for col in ("output_images_mean", "shifts"):
        x, y = np.stack(list(ra[col])), np.stack(list(rb[col]))
        if not np.array_equal(x.view(np.int32), y.view(np.int32)):
            raise AssertionError(f"two iterative runs differ in {col}")
    if not np.array_equal(np.asarray(ra["list_idx"]), np.asarray(rb["list_idx"])):
        raise AssertionError("two iterative runs differ in list_idx")
    card = dt.detect_objects(crop, device="cuda")
    cpu = dt.detect_objects(crop, device="cpu")
    if not np.array_equal(card, cpu) or len(card) != a.nb_of_detected_objects[0]:
        raise AssertionError("step 1's detections differ between the card and the CPU")
    means = np.stack(list(ra["output_images_mean"]))
    if not np.isfinite(means).all() or not np.all(np.abs(np.stack(list(ra["shifts"]))) <= REG_BOUND):
        raise AssertionError("the iterative run gave non-finite means or shifts beyond the bound")
    return {"field": list(crop.shape), "steps": len(a.mse), "detected_per_step": a.nb_of_detected_objects,
            "deblended_per_step": a.nb_of_deblended_galaxies, "rows": int(len(ra)), "mse": a.mse,
            "wall_s": [t1, t2], "step1_detections_equal_cpu": True, "two_runs_bit_identical": True,
            "launches": launches}


# ------------------------------------------------ tiled and iterative serving

# Phases 16-17: a field of the size the JAX tile module was written for
# (4k x 4k coadds) at the 1024^2 field's density of 300 galaxies, tiled at
# the JAX package's defaults.
BIG_FIELD = dict(size=4096, n_gal=4800)
TILES = dict(tile_size=1024, tile_overlap=64)


def tiled_cfg():
    import debvader_tpu_torch as dt

    return dt.PipelineConfig(interp_order=1, source_chunk=128, **TILES)


def stack_kernel_times(torch, band, tile: int, overlap: int) -> dict:
    """The clipped statistics, the detect core and the labels on the tile
    stack that tiled detection gives them (the field's r band cut at the
    JAX defaults), and the render into the field's padded canvas with one
    128-source chunk: each held against its plain version on the same
    tensors (filt, medians and labels bit for bit, direction codes and
    parents equal, means and stds within 1e-5 of their scale, the render
    within 1e-5 of the stamps' scale), then timed beside its plain version
    (PLAIN_REPS runs: the plain versions take up to a second here) and its
    bound; outside every counting window."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.config import DetectionConfig
    from debvader_tpu_torch.kernels import clipped_stats as cs
    from debvader_tpu_torch.kernels import detect_fused as df
    from debvader_tpu_torch.kernels import int8_conv as ic
    from debvader_tpu_torch.kernels import label_select as ls
    from debvader_tpu_torch.kernels import render as rd
    from debvader_tpu_torch.ops import detection as td
    from debvader_tpu_torch.pipeline import tiles as tt

    origins = tt.tile_origins(band.shape[0], tile, overlap)
    xs = tt._tile_stack(torch.as_tensor(band, device="cuda"), origins, tile)
    t, f, _ = xs.shape
    cfg = DetectionConfig(**DETECTION)
    back, _, _, grms = td.estimate_background(xs, box=64)
    thr = cfg.thresh * grms * td._threshold_scale(cfg)
    kernel = td.default_filter_kernel()
    guarded = torch.where(torch.isfinite(xs), xs, back)
    g = f // 64
    boxes = xs.reshape(t, g, 64, g, 64).permute(0, 1, 3, 2, 4).reshape(t * g * g, 4096).contiguous()
    ones = torch.ones_like(boxes)
    out = {"shape": [t, f, f], "boxes": t * g * g}

    got, want = cs.sigma_clipped_stats(boxes, ones), cs.sigma_clipped_stats_plain(boxes, ones)
    if not torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)):
        raise AssertionError("clipped_stats on the tile stack: medians differ from the plain version")
    stats_err = 0.0
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        e = float((a - b).abs().max())
        if e > 1e-5 * float(b.abs().max()):
            raise AssertionError(f"clipped_stats on the tile stack: mean/std off by {e}")
        stats_err = max(stats_err, e)

    filt, dirc, parent = df.matched_filter_parents(guarded, back, kernel, thr)
    filt_p, dir_p, parent_p = df.matched_filter_parents_plain(guarded, back, kernel, thr)
    if not torch.equal(filt.view(torch.int32), filt_p.view(torch.int32)):
        raise AssertionError("detect_fused on the tile stack: filt is not bit-identical to the plain version")
    if not (torch.equal(dirc, dir_p) and torch.equal(parent, parent_p)):
        raise AssertionError("detect_fused on the tile stack: dir_code/parent differ from the plain version")
    out["masked_pixels"] = int((filt > thr.reshape(t, 1, 1)).sum())
    cur0, dir2 = parent.reshape(t * f, f), dirc.reshape(t * f, f)
    if not torch.equal(ls.label_fixpoint(cur0, dir2), ls.label_fixpoint_plain(cur0, dir2)):
        raise AssertionError("label_select on the tile stack: labels differ from the plain fixpoint")
    steps = _path_steps(torch, dir2)

    # the render: one chunk of 128 sources into the padded canvas of the
    # whole field, through a strided window as the stream renders
    n, s, b, fs = 128, 59, 6, band.shape[0]
    pad = dt.render_pad(s, 1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    stamps = torch.rand((n, s, s, b), generator=gen, device="cuda")
    offsets = (torch.rand((n, 2), generator=gen, device="cuda") - 0.5) * (fs + 40)
    mask = torch.ones(n, dtype=torch.bool, device="cuda")

    def window():
        return torch.zeros((fs + 2 * pad, fs + 2 * pad, b), device="cuda")[pad : pad + fs, pad : pad + fs]

    canvas, canvas_p = window(), window()
    rd.render_field_kernel(stamps, offsets, fs, mask, out=canvas)
    rd.render_field_plain(stamps, offsets, fs, mask, out=canvas_p)
    render_err = float((canvas - canvas_p).abs().max())
    if render_err > 1e-5 * float(stamps.abs().max()):
        raise AssertionError(f"render into the {fs}^2 canvas: off by {render_err} from the plain version")
    torch.cuda.synchronize()

    for name, fn, plain, kname, err, (bd, by) in (
        ("clipped_stats", lambda: cs.sigma_clipped_stats(boxes, ones),
         lambda: cs.sigma_clipped_stats_plain(boxes, ones), "clipped_stats_kernel", stats_err,
         bound(boxes.numel() * 8 + t * g * g * 12, boxes.numel() * 4 * 8)),
        ("detect_fused", lambda: df.matched_filter_parents(guarded, back, kernel, thr),
         lambda: df.matched_filter_parents_plain(guarded, back, kernel, thr), "detect_fused_kernel", 0.0,
         bound(t * f * f * 20 + t * 4 + 56, t * f * f * 54)),
        ("label_select", lambda: ls.label_fixpoint(cur0, dir2), lambda: ls.label_fixpoint_plain(cur0, dir2),
         "label_resolve_kernel", 0.0, bound(t * f * f * 12, t * f * f + 4 * steps)),
        # a chunk's stamps read once and its footprint read and written once
        ("render", lambda: rd.render_field_kernel(stamps, offsets, fs, mask, out=canvas),
         lambda: rd.render_field_plain(stamps, offsets, fs, mask, out=canvas_p), "render_", render_err,
         bound(n * s * s * b * 4 + n * 8 + 2 * n * (s + 2) ** 2 * b * 4, n * (s + 2) * (s + 2) * b * 11)),
    ):
        out[name] = {"max_abs_err": err, "ms": cuda_ms(torch, fn), "device_ms": profiled_device_ms(torch, fn, kname),
                     "plain_ms": cuda_ms(torch, plain, reps=PLAIN_REPS, warmup=1), "bound_ms": bd, "bound_by": by,
                     "library_ms": None}
    # the library yardsticks of the one-field rows at the stack's shapes:
    # a sort of the 6,400 boxes, and the 7x7 filter alone in float32
    masked = torch.where(ones > 0, boxes, torch.full_like(boxes, float("inf")))
    kt = torch.as_tensor(kernel, device="cuda")[None, None]
    fore = (guarded - back)[:, None].contiguous()
    out["clipped_stats"].update(library_ms=cuda_ms(torch, lambda: torch.sort(masked, dim=-1)),
                                library_call="torch.sort of the boxes")
    out["detect_fused"].update(library_ms=cuda_ms(torch, lambda: conv2d_fp32(torch, fore, kt)),
                               library_call="F.conv2d of the 7x7 filter alone, float32")
    out["render"].update(shape=[n, s, s, b, fs], canvas=[fs + 2 * pad] * 2 + [b])
    out["held_against_plain"] = True
    return out


def run_tiled(torch, net, big: np.ndarray, reset_counts, read_counts) -> tuple[dict, object, tuple]:
    """Phase 16: TiledDeblendField(...).detect_deblend_render() on the
    4096^2 field, its launches counted from 0 in a window of their own
    (fails unless the tile stack launches the detect core and the labels
    once, and the clipped statistics once for every box of the stack);
    the detection's stages, warm times of detect and deblend_and_render;
    the card's tiled catalogue against the CPU's on a 1536^2 crop in 16
    tiles of 512; how many of the tiled sources the untiled detection
    finds (printed, not held: each tile has its own background)."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.pipeline.tiles import tile_origins

    det = dt.DetectionConfig(**DETECTION)
    tdf = dt.TiledDeblendField(net, big, z_mode="mean", cfg=tiled_cfg(), det_cfg=det, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    catalog, residual = tdf.detect_deblend_render()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    n_tiles = len(tile_origins(big.shape[1], TILES["tile_size"], TILES["tile_overlap"])) ** 2
    if launches["detect_fused"] != 1 or launches["label_select"] != 1 or launches["clipped_stats"] != 1:
        raise AssertionError(f"tiled detection of {n_tiles} tiles launched {launches}: expected the detect core, "
                             "the labels and the clipped statistics once each")
    if launches["bias_prelu"] < 18 or launches["bias_prelu"] % 18:
        raise AssertionError(f"tiled serving launched the bias and PReLU {launches['bias_prelu']} times: expected "
                             "18 a forward chunk")
    first_timings = dict(tdf.detect_timings)
    centers = tdf.detect(field=tdf._device_field(tdf.field_image))
    if catalog is None or len(catalog) == 0 or len(centers) != tdf.nb_of_detected_objects[-1]:
        raise AssertionError("tiled serving deblended nothing, or its detections changed between calls")
    if residual.shape != big.shape or not np.isfinite(residual).all():
        raise AssertionError("tiled serving gave a non-finite residual or one of the wrong shape")
    mask = stamp_mask(big.shape[1], centers)
    flux_field, flux_resid = float(np.abs(big[0][mask]).sum()), float(np.abs(residual[0][mask]).sum())
    if not flux_resid < flux_field:
        raise AssertionError(f"tiled residual flux {flux_resid} is not below the field's {flux_field}")
    # warm calls, each with its own stage dict (two: a third was cut to
    # make room for phase 18)
    detect_runs, render_runs = [], []
    for _ in range(2):
        for runs, call in ((detect_runs, lambda t: tdf.detect(timings=t, field=tdf._device_field(tdf.field_image))),
                           (render_runs, lambda t: tdf.deblend_and_render(centers, timings=t))):
            stages = {}
            t0 = time.perf_counter()
            call(stages)
            torch.cuda.synchronize()
            runs.append({"wall_s": time.perf_counter() - t0, **stages})

    # the card against the CPU on a 1536^2 crop: 16 tiles of 512
    c0 = (big.shape[1] - 1536) // 2
    crop = np.ascontiguousarray(big[:, c0 : c0 + 1536, c0 : c0 + 1536, :])
    on_card = dt.detect_objects_tiled(crop, det, tile=512, overlap=64, device="cuda")
    on_cpu = dt.detect_objects_tiled(crop, det, tile=512, overlap=64, device="cpu")
    if not np.array_equal(on_card, on_cpu):
        raise AssertionError(f"tiled detection differs between card and CPU on the crop: {len(on_card)} against "
                             f"{len(on_cpu)} rows")
    untiled = dt.detect_objects(big, det, device="cuda")
    found = len(set(map(tuple, centers)) & set(map(tuple, untiled)))
    stack = stack_kernel_times(torch, big[0, :, :, 2], TILES["tile_size"], TILES["tile_overlap"])
    out = {
        "field": list(big.shape), "tiles": n_tiles, "sources": int(len(centers)), "deblended": int(len(catalog)),
        "launches": launches, "first_call_s": first_s, "first_detect_timings_s": first_timings,
        "warm_detect_s": float(np.median([r["wall_s"] for r in detect_runs])), "warm_detect_runs": detect_runs,
        "warm_deblend_and_render_s": float(np.median([r["wall_s"] for r in render_runs])),
        "warm_deblend_and_render_runs": render_runs,
        "abs_flux_in_stamps": {"field": flux_field, "residual": flux_resid},
        "crop_vs_cpu": {"field": list(crop.shape), "tiles": 16, "rows": int(len(on_cpu)), "equal": True},
        "untiled": {"sources": int(len(untiled)), "tiled_sources_also_found": found},
        "stack_kernels": stack,
    }
    return out, catalog, (residual, centers)


def default_merge_times(torch, band: np.ndarray, sources: int) -> dict:
    """detect_sources at the default threshold with its stage seconds: the
    native merge beside the whole call, then the same with the plain Python
    loop as the merge (a measurement hook: the port never runs it), in
    turns, twice; both give the same catalogue."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.ops import detection as td

    native = td.merge_segments

    def plain(ea, eb, eh, peak, flux, *rest):
        return td._merge_segments_py(ea, eb, eh, peak, np.array(flux, np.float64), *rest)

    runs = {"native": [], "python_loop": []}
    cats = {}
    for _ in range(2):
        for name, merge in (("native", native), ("python_loop", plain)):
            td.merge_segments = merge
            try:
                stages = {}
                t = time.perf_counter()
                cats[name] = dt.detect_sources(band, device="cuda", timings=stages)
                runs[name].append({"whole_s": time.perf_counter() - t, "stages_s": stages})
            finally:
                td.merge_segments = native
    if not all(np.array_equal(cats["native"][k], cats["python_loop"][k]) for k in ("y", "x", "labels")):
        raise AssertionError("the native merge and the Python loop give different catalogues")
    if len(cats["native"]["y"]) != sources:
        raise AssertionError("detect_sources and detect_objects found different numbers of sources")
    return runs


def run_iterative_serving(torch, net, big: np.ndarray, tiled_catalog, tiled_residual, reset_counts,
                          read_counts) -> dict:
    """Phase 17: IterativeDeblendField(...).iterative_deblend_and_render(
    max_iterations=3) on the 4096^2 field, float32 twice (bit-identical,
    catalogue and residual), step 0's rows against phase 16's catalogue, a
    one-step run's residual against phase 16's bit for bit (both are the
    memoized field minus the crop of the same canvas), then under
    device_dtype='bfloat16' (the sources only one route found at most
    ONE_ROUTE_MAX_SHARE of the rows, and the residual within 2e-2 of the
    float32 route's scale outside their stamps, a check that the one-step
    residual, step 1's subtract left out, must fail);
    launches counted from 0 for each run, and the peak device memory of
    each route."""
    import debvader_tpu_torch as dt

    det = dt.DetectionConfig(**DETECTION)

    def run(max_iterations=3, **kw):
        idf = dt.IterativeDeblendField(net, big, z_mode="mean", cfg=tiled_cfg(), device="cuda", **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        cat, res = idf.iterative_deblend_and_render(det_cfg=det, max_iterations=max_iterations)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = int(torch.cuda.max_memory_allocated())
        if cat is None or not np.isfinite(res).all():
            raise AssertionError("iterative serving found nothing or gave a non-finite residual")
        # a detection a step, and one more when the last step found nothing
        steps = len(idf.nb_of_detected_objects)
        for name in ("detect_fused", "label_select", "clipped_stats"):
            if counts[name] not in (steps, steps + 1) or counts[name] != counts["detect_fused"]:
                raise AssertionError(f"iterative serving: {name} launched {counts[name]} times for {steps} steps")
        return {"steps": steps, "detected_per_step": idf.nb_of_detected_objects,
                "deblended_per_step": idf.nb_of_deblended_galaxies, "mse_per_step": idf.mse, "wall_s": wall,
                "peak_bytes": peak, "launches": counts}, cat, res

    a, cat_a, res_a = run()
    b, cat_b, res_b = run()
    if not np.array_equal(res_a.view(np.int32), res_b.view(np.int32)):
        raise AssertionError("two float32 iterative runs differ in their residual")
    for col in cat_a.dtype.names:
        x, y = cat_a[col], cat_b[col]
        if x.dtype == object:
            x, y = np.stack(list(x)), np.stack(list(y))
        if not np.array_equal(np.ascontiguousarray(x).view(np.uint8), np.ascontiguousarray(y).view(np.uint8)):
            raise AssertionError(f"two float32 iterative runs differ in column {col}")
    step0 = cat_a[cat_a.iteration == 0]
    for col in tiled_catalog.dtype.names:
        x, y = step0[col], tiled_catalog[col]
        if x.dtype == object:
            x, y = np.stack(list(x)), np.stack(list(y))
        if not np.array_equal(x, y):
            raise AssertionError(f"iterative step 0 differs from tiled serving in column {col}")
    one, _, res_one = run(max_iterations=1)
    if not np.array_equal(res_one.view(np.int32), tiled_residual.view(np.int32)):
        raise AssertionError("a one-step iterative residual differs from tiled serving's")
    low, cat_l, res_l = run(device_dtype="bfloat16")
    # A later step detects on the residual, where a bfloat16 rounding can
    # move a faint feature across the threshold: a source found by one
    # route only changes the residual by its model.  The bound holds
    # outside those sources' stamps; the whole field's distance is printed.
    def rows(cat):
        return set(zip(cat.iteration.tolist(), cat.galaxy_distances_to_center_x.tolist(),
                       cat.galaxy_distances_to_center_y.tolist()))

    one_route = sorted(rows(cat_a) ^ rows(cat_l))
    if len(one_route) > ONE_ROUTE_MAX_SHARE * len(cat_a):
        raise AssertionError(f"{len(one_route)} of {len(cat_a)} sources were found by only one of the float32 "
                             f"and bfloat16 routes: more than {ONE_ROUTE_MAX_SHARE:.0%}")
    outside = ~stamp_mask(big.shape[1], np.array([r[1:] for r in one_route]).reshape(-1, 2), size=61)
    scale = float(np.abs(res_a).max())

    def off_outside(res):
        return float(np.abs(res - res_a)[0][outside].max()) / scale

    rel, rel_outside = float(np.abs(res_l - res_a).max()) / scale, off_outside(res_l)
    if not rel_outside < 2e-2:
        raise AssertionError(f"bfloat16 iterative serving off the float32 route by {rel_outside} of its scale "
                             f"outside the stamps of the {len(one_route)} sources only one route found")
    # the control: the float32 residual with step 1's subtract left out
    # (the one-step run's) must fail the same check
    control = off_outside(res_one)
    if control < 2e-2:
        raise AssertionError(f"the control (step 1's subtract left out) passes the masked check: {control}")
    return {"field": list(big.shape), "float32": [a, b], "one_step": one, "bfloat16": low,
            "bfloat16_rows": int(len(cat_l)), "bfloat16_residual_rel_err_vs_float32": rel,
            "bfloat16_residual_rel_err_outside_one_route_sources": rel_outside,
            "sources_found_by_one_route_only": [list(r) for r in one_route][:20],
            "sources_found_by_one_route_only_count": len(one_route),
            "control_without_step1_rel_err_outside": control,
            "two_float32_runs_bit_identical": True, "step0_equals_tiled_catalog": True,
            "one_step_residual_equals_tiled": True}


# Phase 18: the card's one training step against the CPU's.  A
# parameter whose gradient element sits near 0 with another sign on the
# card moves the other way (Adam's first step is lr sign(g)): at most this
# share of the 8,318,452 values may.
TRAIN_FLIP_MAX_SHARE = 1e-3
TRAIN_BATCH = 32


def run_training(torch) -> dict:
    """Phase 18: training on the sim_demo model at full width with pairs
    from the port's make_dataset (650 training and 128 validation pairs a
    stage): one step from the shipped weights with one batch of 32 and one
    eps on the card and on the CPU (the loss terms within 1e-5 relative,
    every gradient leaf within 1e-4 of its largest magnitude, the
    parameters that moved the other way counted and bounded);
    train_deblender warm-started from sim_demo, one epoch a stage at batch
    32 (20 full batches and one of 10), the decoder bit for bit through
    stage 2, stage 1's loss lower at its end than at its first step, the
    best-validation checkpoint reloaded through load_deblender; two seeded
    runs of 10 steps bit-identical; the native loader built from the
    port's copy, its batches the .npy source's rows; the median warm step
    time by CUDA events over 25 steps at batch 5 and 64, each alone and
    back to back, samples/s and peak device memory, and 5 profiled steps'
    device idle share."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.data.simulate import make_dataset
    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.runtime import loader
    from debvader_tpu_torch.training import checkpoint as ckpt
    from debvader_tpu_torch.training import train as tt
    from debvader_tpu_torch.weights import flax_from_state_dict, weights_file

    out = {}
    t = time.perf_counter()
    data = make_dataset(0, n_train=650, n_val=128)
    out["make_dataset_s"] = time.perf_counter() - t
    (xv, yv), _ = data["vae"]
    (xd, yd), _ = data["deblender"]
    shipped = dt.load_deblender("sim_demo", device="cpu")
    variables = flax_from_state_dict(shipped.state_dict(), shipped.cfg)
    cfg = dt.TrainConfig(batch_size=TRAIN_BATCH)

    # -- one step, card against CPU: the same weights, batch and eps
    eps = np.random.default_rng(1).standard_normal((TRAIN_BATCH, 32)).astype(np.float32)
    x, y = xd[:TRAIN_BATCH], yd[:TRAIN_BATCH]

    def grads(device, dtype=torch.float32, keep=None):
        """The step's terms, its gradients and the band head's output before
        its ReLU on ``device`` in ``dtype``; with ``keep`` (a per-pixel 0/1
        weight) the gradients are those of the loss over the kept pixels."""
        state = tt.create_train_state(dt.DeblenderVAE(), cfg, variables=variables, device=device)
        module = state.module.to(dtype)
        params = state.trainable()
        xs, ys, e = (torch.as_tensor(a, device=device, dtype=dtype) for a in (x, y, eps))
        head = {}
        hook = module.decoder.head.register_forward_hook(lambda m, i, o: head.update(pre=o.detach().cpu()))
        with fp32_math():
            loss, terms = tt.make_loss_fn(cfg)(module, xs, ys, e, 0)
            if keep is not None:
                k = torch.as_tensor(keep, device=device, dtype=dtype)
                posterior = module.encode(xs, train=True)
                nll = -(module.decode(posterior.sample(eps=e)).log_prob(ys) * k).sum() / k.sum()
                loss = nll + cfg.kl_weight * posterior.kl_to_standard_normal().mean()
            g = torch.autograd.grad(loss, list(params.values()))
        hook.remove()
        return ({k: float(v) for k, v in terms.items()}, {k: v.double().cpu() for k, v in zip(params, g)},
                head["pre"])

    def stepped(device):
        """The parameters after make_train_step's one step with eps."""
        state = tt.create_train_state(dt.DeblenderVAE(), cfg, variables=variables, device=device)
        noise = tt._latent_noise
        tt._latent_noise = lambda generator, shape, like: torch.as_tensor(eps, device=like.device)
        try:
            state, _ = tt.make_train_step(cfg)(state, torch.as_tensor(x, device=device),
                                               torch.as_tensor(y, device=device))
        finally:
            tt._latent_noise = noise
        return {k: v.detach().cpu() for k, v in state.module.state_dict().items()}

    def leaf_errors(ga, gb):
        return {k: float((ga[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30) for k, g in gb.items()}

    t_card, g_card, h_card = grads("cuda")
    t_cpu, g_cpu, h_cpu = grads("cpu")
    term_err = {k: abs(t_card[k] / t_cpu[k] - 1) for k in t_cpu}
    if max(term_err.values()) > 1e-5:
        raise AssertionError(f"training step: loss terms differ between card and CPU: {term_err}")
    card_vs_cpu = leaf_errors(g_card, g_cpu)
    # Two things move a float32 gradient leaf far more than its last bits.
    # (1) The pixel Normal's scale is 1e-4 + ReLU(head): a pixel whose head
    # output is on the ReLU's kink on one device and off it on the other
    # moves the gradient by its whole share, which at the 1e-4 floor is
    # large; those pixels (loc or scale channel, cropped 64 -> 59 as the
    # decoder crops) are counted and left out of the loss below.  (2) At
    # the floor the per-pixel gradients are large and cancel, so a float32
    # leaf can be percents of its scale off the exact sum on any device:
    # each device's float32 gradient is held against a float64 one (on the
    # card, where the double convolutions take a second, not the CPU's
    # several), the card no further from it than twice the CPU's float32
    # or 1e-4 of the leaf's scale.
    b, lo = 6, 2
    flip = ((h_card > 0) != (h_cpu > 0))[:, :, lo : lo + 59, lo : lo + 59]
    flip = (flip[:, :b] | flip[:, b:]).permute(0, 2, 3, 1)
    keep = (~flip).float().numpy()
    _, gk_card, _ = grads("cuda", keep=keep)
    _, gk_cpu, _ = grads("cpu", keep=keep)
    _, gk_ref, _ = grads("cuda", torch.float64, keep=keep)
    card_err, cpu_err = leaf_errors(gk_card, gk_ref), leaf_errors(gk_cpu, gk_ref)
    for k, e in card_err.items():
        if e > max(1e-4, 2 * cpu_err[k]):
            raise AssertionError(f"training step: the card's gradient of {k} is {e} of its scale off the float64 "
                                 f"gradient, the CPU's {cpu_err[k]}")
    p_card, p_cpu = stepped("cuda"), stepped("cpu")
    lr = cfg.learning_rate
    moved = total = 0
    for k, v in p_cpu.items():
        d = (p_card[k] - v).abs()
        total += d.numel()
        moved += int((d > lr).sum())
        if float(d.max()) > 2.5 * lr:
            raise AssertionError(f"training step: {k} moved by {float(d.max())}, more than a sign flip")
    if moved > TRAIN_FLIP_MAX_SHARE * total:
        raise AssertionError(f"training step: {moved} of {total} parameters moved the other way on the card")
    worst = max(card_vs_cpu, key=card_vs_cpu.get)
    out["step_card_vs_cpu"] = {
        "terms_card": t_card, "terms_rel_err": term_err, "kink_pixels": int(flip.sum()),
        "grad_worst_leaf_card_vs_cpu": [worst, card_vs_cpu[worst]],
        "grad_median_leaf_card_vs_cpu": float(np.median(list(card_vs_cpu.values()))),
        "grad_leaves_over_1e-4_card_vs_cpu": sum(e > 1e-4 for e in card_vs_cpu.values()),
        "grad_worst_leaf_vs_float64": {"card": max(card_err.values()), "cpu": max(cpu_err.values())},
        "sign_flips": moved, "parameters": total}
    print(f"training step, card against CPU: worst gradient leaf {worst} at {card_vs_cpu[worst]:.3e} of its "
          f"scale; against float64 the card's worst {max(card_err.values()):.3e}, the CPU's "
          f"{max(cpu_err.values()):.3e}; {moved} of {total} parameters moved the other way")

    # -- two stages, warm-started from sim_demo, with the best-validation
    # checkpoints; every step's loss recorded by wrapping the step factory
    # the run's weights directory, holding the warm start's weights; it
    # and the loader's .npy files (some 300 MB) are removed at the end
    scratch = Path("chiprun_out") / "training_scratch"
    shutil.rmtree(scratch, ignore_errors=True)
    weights_dir = scratch / "weights"
    weights_dir.mkdir(parents=True)
    shutil.copy(dt.weights.default_weights_dir() / "sim_demo.npz", weights_dir)
    step_losses = []
    factory = tt.make_train_step

    def recording(*args, **kwargs):
        step = factory(*args, **kwargs)

        def wrapped(state, *a):
            state, terms = step(state, *a)
            step_losses.append(terms["loss"])
            return state, terms

        return wrapped

    tt.make_train_step = recording
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        h1, h2, state2, model = dt.train_deblender(
            "smoke", "sim_demo", 1, *data["vae"], *data["deblender"], batch_size=TRAIN_BATCH, train_cfg=cfg,
            with_callbacks=True, weights_dir=weights_dir, verbose=0, device="cuda")
    finally:
        tt.make_train_step = factory
    torch.cuda.synchronize()
    two_stage_s = time.perf_counter() - t
    losses = [float(v) for v in step_losses]
    steps_a_stage = -(-650 // TRAIN_BATCH)
    if len(losses) != 2 * steps_a_stage or state2.step != steps_a_stage:
        raise AssertionError(f"train_deblender took {len(losses)} steps, expected {2 * steps_a_stage}")
    stage1 = losses[:steps_a_stage]
    if not np.mean(stage1[-5:]) < stage1[0]:
        raise AssertionError(f"stage 1's loss did not fall: first step {stage1[0]}, last five {stage1[-5:]}")
    stage1_vars = ckpt.load_weights_from(weights_dir / "smoke" / "vae" / "val_loss" / "ckpt.npz")
    end = state2.variables()
    frozen = [k for k in end if k.startswith("params/decoder/")]
    if not frozen or not all(np.array_equal(end[k], stage1_vars[k]) for k in frozen):
        raise AssertionError("stage 2 changed the frozen decoder")
    if all(np.array_equal(end[k], stage1_vars[k]) for k in end if k.startswith("params/encoder/")):
        raise AssertionError("stage 2 did not train the encoder")
    reloaded = dt.load_deblender("smoke", device="cuda", weights_dir=weights_dir)
    best = ckpt.load_weights_from(weights_file("smoke", weights_dir))
    if not all(np.array_equal(v, best[k]) for k, v in flax_from_state_dict(reloaded.state_dict()).items()):
        raise AssertionError("load_deblender did not reload the newest best-validation checkpoint")
    with torch.no_grad():
        mean = reloaded(torch.as_tensor(xd[:8], device="cuda"), z_mode="mean")[0].mean()
    if not bool(torch.isfinite(mean).all()):
        raise AssertionError("the reloaded deblender gives non-finite means")
    out["two_stages"] = {"seconds": two_stage_s, "steps_a_stage": steps_a_stage, "stage1_first_loss": stage1[0],
                         "stage1_last5_losses": stage1[-5:], "history_vae": h1, "history_deblender": h2,
                         "decoder_bit_identical_through_stage2": True,
                         "reloaded_checkpoint": str(weights_file("smoke", weights_dir))}

    # -- determinism: two seeded runs of 10 steps on the card
    xs = torch.as_tensor(xv[: 10 * TRAIN_BATCH], device="cuda")
    ys = torch.as_tensor(yv[: 10 * TRAIN_BATCH], device="cuda")
    step = tt.make_train_step(cfg)

    def ten_steps():
        state = tt.create_train_state(dt.DeblenderVAE(), cfg, variables=variables, device="cuda")
        for i in range(10):
            state, _ = step(state, xs[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH], ys[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
        return state.module.state_dict()

    a, b = ten_steps(), ten_steps()
    if not all(torch.equal(v.view(torch.int32), b[k].view(torch.int32)) for k, v in a.items()):
        raise AssertionError("two seeded runs of 10 training steps differ on the card")
    out["ten_steps_bit_identical"] = True

    # -- the native loader, built from the port's copy
    src = scratch / "loader"
    src.mkdir(parents=True)
    np.save(src / "x.npy", xv)
    np.save(src / "y.npy", yv)
    lib = loader.build()
    with loader.make_loader(src / "x.npy", src / "y.npy", TRAIN_BATCH, shuffle=False) as ld:
        for k in range(len(ld)):
            bx, by = ld.next_batch()
            rows = slice(k * TRAIN_BATCH, (k + 1) * TRAIN_BATCH)
            if not (np.array_equal(bx, xv[rows]) and np.array_equal(by, yv[rows])):
                raise AssertionError(f"the native loader's batch {k} is not the source's rows")
    out["native_loader"] = {"library": lib.name, "batches_equal_source": len(xv) // TRAIN_BATCH}
    shutil.rmtree(scratch)

    # -- warm step times by CUDA events: each step alone (an event pair
    # around it, then a sync: the host's enqueue is inside) and 25 steps
    # back to back (the training loop's rate)
    timing = {}
    for bs in (5, 64):
        state = tt.create_train_state(dt.DeblenderVAE(), dt.TrainConfig(batch_size=bs), variables=variables,
                                      device="cuda")
        step = tt.make_train_step(dt.TrainConfig(batch_size=bs))
        bx, by = torch.as_tensor(xd[:bs], device="cuda"), torch.as_tensor(yd[:bs], device="cuda")
        for _ in range(3):
            state, _ = step(state, bx, by)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(25):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step(state, bx, by)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(25):
            state, _ = step(state, bx, by)
        stop.record()
        stop.synchronize()
        back_to_back = start.elapsed_time(stop) / 25
        ms = float(np.median(times))
        timing[f"batch_{bs}"] = {"median_step_ms": ms, "step_ms_min_max": [min(times), max(times)],
                                 "back_to_back_step_ms": back_to_back, "samples_per_s": bs / back_to_back * 1e3,
                                 "peak_device_bytes": int(torch.cuda.max_memory_allocated())}

        def five_steps():
            nonlocal state
            for _ in range(5):
                state, _ = step(state, bx, by)

        prof = profile_run(torch, five_steps)
        timing[f"batch_{bs}"]["profiled_5_steps"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                                         "device_idle_share")}
        timing[f"batch_{bs}"]["profiled_5_steps"]["top_device_events"] = prof["top_device_events"][:8]
    out["step_times"] = timing
    out["card"] = nvidia_smi_line()
    return out


# ------------------------------------------------ int8 quantized serving

# Phase 19: the packaged int8 bundle (sim_demo_int8, 18 int8 layers with
# per-channel activation scales) on the smoke's field.  Dense int8 rate of
# the tensor cores (NVIDIA data sheet, SXM).
PEAK_INT8_OPS_PER_S = 1979e12
QUANT_CHUNK = 128
# JAX's envelope of the packaged bundle's total-flux error against the
# float sim_demo forward (tests/test_quantized.py:381)
QUANT_FLUX_MEAN_MAX = 5e-2
# One qat_finetune step, card against CPU.  The fake-quant forward rounds
# activations to the int8 grid, so a float32 difference at a rounding
# boundary moves an activation by a whole step, and the card's gradient
# differs from the CPU's by more than summation order.  So the card's
# distillation loss and gradients are also taken on the CPU's grid points
# and clip masks (pinned): then only the float32 summation order differs,
# and the loss and every gradient leaf (relative to its largest magnitude)
# are held to the first two limits, three times the readings on an H100
# (loss 6.3e-6, worst leaf 9.0e-5).  The card on its own grid is held to
# the next two, set from the readings there (loss 3.3e-4, worst leaf
# 8.7e-3, 72 of 21 M activations on another grid point).  The parameters
# that Adam's first step moves differently (by more than lr) are held to
# the last share.
QAT_PINNED_LOSS_RTOL = 2e-5
QAT_PINNED_LEAF_TOL = 3e-4
QAT_LOSS_RTOL = 1e-3
QAT_LEAF_TOL = 3e-2
QAT_MOVED_MAX_SHARE = 1e-2
QAT_LR = 2e-5


def int8_calls(torch, qv, stamps) -> tuple[list, list, list]:
    """One int8 forward of ``stamps`` (N, 59, 59, 6) on the bundle's
    device, its kernel calls caught in forward order: ([(layer name, int8
    input, Int8Layer, (alpha, flat_alpha, next_scale))] of conv_fused,
    [(layer name, float32 input, scale)] of the stand-alone quant_act,
    [(point name, wrapper name, its arguments)] of the fused points
    bn_quant and bias_prelu_quant)."""
    from debvader_tpu_torch.kernels import int8_conv as ic
    from debvader_tpu_torch.models import quantized as tq

    names = {id(layer): name for name, layer in qv.int8_layers().items()}
    by_scale = {id(s): name for name, s in qv.act_scales.items()}
    convs, quants, points = [], [], []
    saved = {k: getattr(ic, k) for k in ("conv_fused", "quant_act", "bn_quant", "bias_prelu_quant")}

    def catch_conv(q, layer, *args):
        convs.append((names[id(layer)], q.detach().clone(), layer, (tuple(args) + (None,) * 3)[:3]))
        return saved["conv_fused"](q, layer, *args)

    def catch_quant(h, scale):
        quants.append((by_scale[id(scale)], h.detach().clone(), scale))
        return saved["quant_act"](h, scale)

    def catcher(wrapper):
        def catch(x, *args):
            points.append((by_scale[id(args[-1])], wrapper, (x.detach().clone(),) + args))
            return saved[wrapper](x, *args)
        return catch

    ic.conv_fused, ic.quant_act = catch_conv, catch_quant
    ic.bn_quant, ic.bias_prelu_quant = catcher("bn_quant"), catcher("bias_prelu_quant")
    try:
        tq.quantized_forward(qv, stamps, z_mode="mean")
    finally:
        for k, fn in saved.items():
            setattr(ic, k, fn)
    return convs, quants, points


def int8_needed_macs(ic, q, layer) -> int:
    """The multiply-adds the layer needs on q: every tap that reads an
    input pixel (the padding taps of a conv and the non-integral taps of a
    transposed conv read none)."""
    n, h, w, ho, wo = ic._geometry(q, layer)
    k, s = layer.ksize, layer.stride
    if layer.kind == "dense":
        return n * layer.cin * layer.cout
    top = ic.tf_same_pads(h if layer.kind == "conv" else ho, k, s)[0]
    left = ic.tf_same_pads(w if layer.kind == "conv" else wo, k, s)[0]

    def taps(size_out, size_in, pad):
        o = np.arange(size_out)[:, None]
        kk = np.arange(k)[None, :]
        if layer.kind == "conv":
            i = o * s - pad + kk
            return int(((i >= 0) & (i < size_in)).sum())
        t = o + pad - kk
        return int(((t >= 0) & (t % s == 0) & (t // s < size_in)).sum())

    return n * taps(ho, h, top) * taps(wo, w, left) * layer.cin * layer.cout


def int8_im2col(torch, ic, q, layer):
    """(A, B) for torch._int_mm: A the (M, K8) int8 im2col of q in the
    layer's (ky, kx, ci) order, zeros where no input pixel is read, B the
    (K8, Cout) kernel, K zero-padded to a multiple of 8."""
    import torch.nn.functional as F

    n, h, w, ho, wo = ic._geometry(q, layer)
    k, s = layer.ksize, layer.stride
    if layer.kind == "dense":
        a = q
    else:
        dev = q.device
        top = ic.tf_same_pads(h if layer.kind == "conv" else ho, k, s)[0]
        left = ic.tf_same_pads(w if layer.kind == "conv" else wo, k, s)[0]

        def index(size_out, size_in, pad):
            o = torch.arange(size_out, device=dev)[:, None]
            kk = torch.arange(k, device=dev)[None, :]
            if layer.kind == "conv":
                i = o * s - pad + kk
                ok = (i >= 0) & (i < size_in)
            else:
                t = o + pad - kk
                ok = (t >= 0) & (t % s == 0) & (t // s < size_in)
                i = t // s
            return i.clamp(0, size_in - 1), ok

        iy, oky = index(ho, h, top)
        ix, okx = index(wo, w, left)
        g = q[:, iy[:, None, :, None], ix[None, :, None, :], :]
        ok = (oky[:, None, :, None] & okx[None, :, None, :])[None, ..., None]
        a = torch.where(ok, g, torch.zeros((), dtype=q.dtype, device=dev)).reshape(n * ho * wo, k * k * layer.cin)
    kdim = a.shape[1]
    k8 = -(-kdim // 8) * 8
    a = F.pad(a, (0, k8 - kdim)).contiguous()
    b = F.pad(layer.rows, (0, k8 - kdim)).t()
    return a, b


def bits_equal(torch, got, want) -> bool:
    """Bit for bit, a NaN equal to any NaN (the card's arithmetic writes
    one payload, PyTorch's bfloat16 cast another, but the comparison should
    not depend on it)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype not in (torch.float32, torch.bfloat16):
        return torch.equal(got, want)
    ints = torch.int32 if got.dtype == torch.float32 else torch.int16
    nan = torch.isnan(got)
    return torch.equal(nan, torch.isnan(want)) and torch.equal(got.view(ints)[~nan], want.view(ints)[~nan])


def unfused_chain(torch, ic, q, layer, alpha, flat_alpha, next_scale):
    """The same unit of work as one conv_fused launch, unfused as the
    parent ran it: conv_s8's float32 output (cast to the layer's dtype),
    the eager PReLU, the flatten, the eager flat PReLU (the cast to the
    dtype handed on) and the stand-alone quantizer."""
    from debvader_tpu_torch.models.layers import prelu

    y = ic.conv_s8(q, layer).to(layer.dtype)
    if alpha is not None:
        y = prelu(y, alpha)
    if next_scale is None:
        return y.to(layer.out_dtype)
    y = (y.permute(0, 2, 3, 1) if y.ndim == 4 else y).reshape(y.shape[0], -1)
    if flat_alpha is not None:
        y = prelu(y, flat_alpha)
    return ic.quant_act(y.to(layer.out_dtype).reshape(-1, 1 if next_scale.ndim == 0 else next_scale.shape[0]),
                        next_scale)


def check_int8_stamps(torch, ic, qv, stamps, what: str) -> int:
    """Every kernel call of one int8 forward of ``stamps``: conv_fused's,
    the fused points' and any stand-alone quantizer's output bit for bit
    their plain versions'."""
    convs, quants, points = int8_calls(torch, qv, stamps)
    for name, q, layer, args in convs:
        if not bits_equal(torch, ic.conv_fused(q, layer, *args), ic.conv_fused_plain(q, layer, *args)):
            raise AssertionError(f"int8 layer {name} ({what}): the kernel differs from its plain version")
    for name, h, s in quants:
        if not torch.equal(ic.quant_act(h, s), ic.quant_act_plain(h, s)):
            raise AssertionError(f"quantizer before {name} ({what}): the kernel differs from its plain version")
    for name, wrapper, args in points:
        if not torch.equal(getattr(ic, wrapper)(*args), getattr(ic, f"{wrapper}_plain")(*args)):
            raise AssertionError(f"{wrapper} before {name} ({what}): the kernel differs from its plain version")
    return len(convs) + len(points)


def int8_specials(torch, ic, q, layer, args) -> dict:
    """The epilogue on non-finite and signed-zero values: dqw[0] NaN,
    bias[1] +inf, bias[2] -inf, dqw[3] 0 with bias[3] -0.0 (so y is a zero
    of either sign) and the PReLU's alpha negated on channel 3; a layer
    that rounds to bfloat16 also gets y on bfloat16 halfway points (dqw 0,
    bias[4] 1 + 2^-8 and bias[5] 1 + 3 * 2^-8, which round to the even 1
    and 1 + 2^-6) and past the largest bfloat16 (bias[6], bias[7] +-3.4e38,
    which round to +-inf); the kernel bit for bit its plain version with
    the quantizer (a NaN gives 0) and with the float output (NaN and the
    zeros' signs kept)."""
    dqw, bias = layer.dqw.clone(), layer.bias.clone()
    dqw[0], bias[1], bias[2], dqw[3], bias[3] = float("nan"), float("inf"), float("-inf"), 0.0, -0.0
    if layer.rounding:
        dqw[4:8] = 0.0
        bias[4:8] = torch.tensor([1 + 2**-8, 1 + 3 * 2**-8, 3.4e38, -3.4e38], device=bias.device)
    sp = dataclasses.replace(layer, dqw=dqw, bias=bias)
    alpha, flat_alpha, next_scale = args
    if alpha is not None:
        alpha = alpha.detach().clone()
        alpha[3] = -alpha[3]
    out = {}
    for mode, a in (("int8", (alpha, flat_alpha, next_scale)), ("float32", (alpha, None, None))):
        if mode == "int8" and next_scale is None:
            continue
        got, want = ic.conv_fused(q, sp, *a), ic.conv_fused_plain(q, sp, *a)
        if not bits_equal(torch, got, want):
            raise AssertionError(f"int8 layer, special values ({mode}): the kernel differs from its plain version")
        if mode == "float32":
            out["nan"] = int(torch.isnan(got).sum())
            out["negative_zeros"] = int(((got == 0) & torch.signbit(got)).sum())
            out["positive_zeros"] = int(((got == 0) & ~torch.signbit(got)).sum())
            if layer.rounding and got.dtype == torch.bfloat16:
                ch = got[:, 4:6] if got.ndim == 2 else got[:, 4:6].movedim(1, -1).reshape(-1, 2)
                out["ties_to_even"] = bool((ch[:, 0] == 1.0).all() and (ch[:, 1] == 1 + 2**-6).all())
                out["overflow_to_inf"] = int(torch.isinf(got[:, 6]).sum())
                if not out["ties_to_even"]:
                    raise AssertionError("int8 layer, bfloat16 halfway points: not rounded to even")
    return out


def profiled_all_ms(torch, fn):
    """Mean device time of every CUDA kernel ``fn`` launches, over REPS
    calls, from torch.profiler; None when the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    total = sum(float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))
                for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    return total / REPS / 1e3 if total > 0 else None


def check_int8_layers(torch, qv, cutouts: np.ndarray) -> tuple[list, dict]:
    """Phase 19, the kernels: csrc/int8_conv.cu's fused layer on each of
    the 18 int8 layers at a 128-stamp chunk of the field's real
    activations (their int8 inputs and epilogues as the forward calls
    them), bit for bit against its plain version, also as the raw int32
    sums and the float32 layer; timed (CUDA events, the profiler's device
    time) beside its bound, its plain version, torch._int_mm over an
    im2col (the library yardstick, checked against the raw sums), the
    float32 cuDNN layer and the unfused chain of the same work (conv_s8,
    the eager PReLU, quant_act); the stand-alone quantizer at its two
    points.  Then the edge cases: a batch of 1, the ragged 295-source
    batch, K = 54 (enc/Conv_0), all-(+-127) operands (the largest |acc|),
    per-tensor scales and non-finite and signed-zero epilogue values.

    A bfloat16 bundle (phase 23) runs the same checks on its bfloat16
    epilogues, beside the bfloat16 cuDNN layer, with dec/Dense_1 also
    under strict_cast=False (its bfloat16 epilogue) and bfloat16 halfway
    points among the special values; its records are one a layer group,
    and the stand-alone quantizer is not timed again."""
    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.kernels import int8_conv as ic
    from debvader_tpu_torch.models import quantized as tq

    dev = torch.device("cuda")
    bf16 = qv.cfg.dtype == "bfloat16"
    cudnn_key = "cudnn_bf16_ms" if bf16 else "cudnn_f32_ms"
    convs, _, points = int8_calls(torch, qv, cutouts[:QUANT_CHUNK])
    rows = []
    for name, q, layer, args in convs:
        alpha, flat_alpha, next_scale = args
        y = ic.conv_fused(q, layer, *args)
        raw = ic.conv_s8(q, layer, raw=True)
        flt = ic.conv_s8(q, layer)
        torch.cuda.synchronize()
        if not (bits_equal(torch, y, ic.conv_fused_plain(q, layer, *args))
                and torch.equal(raw, ic.conv_s8_plain(q, layer, raw=True))
                and bits_equal(torch, flt, ic.conv_s8_plain(q, layer))):
            raise AssertionError(f"int8 layer {name}: the kernel differs from its plain version")
        chain = unfused_chain(torch, ic, q, layer, *args)
        if not bits_equal(torch, chain.reshape(y.shape), y):
            raise AssertionError(f"int8 layer {name}: the unfused chain differs from the fused kernel")
        macs = int8_needed_macs(ic, q, layer)
        extra = sum(4 * t.numel() for t in args if t is not None)
        bytes_layer = q.numel() + layer.qk.numel() + y.numel() * y.element_size() + 8 * layer.cout + extra
        t_bound, by = bound(bytes_layer, 2 * macs, PEAK_INT8_OPS_PER_S)
        a, b = int8_im2col(torch, ic, q, layer)
        lib = {"library_ms": None}
        try:
            mm = torch._int_mm(a, b)
            lib = {"library_ms": cuda_ms(torch, lambda: torch._int_mm(a, b)),
                   "library_max_abs_err": float((mm - (raw if layer.kind == "dense" else raw.permute(0, 2, 3, 1)
                                                       ).reshape(mm.shape)).abs().max())}
        except RuntimeError as exc:  # the yardstick only: the port never calls it
            lib["library_error"] = str(exc).splitlines()[0][:200]
        module = tq._module(qv.model, name)
        plan = ic._plan(q, layer, ic._sm_count(q.device.index or 0))
        # the float layer's input in the dtype it computes in
        h = (q.float() if layer.kind == "dense" else q.permute(0, 3, 1, 2).float().contiguous()).to(module.dtype)
        with fp32_math():
            cudnn_ms = cuda_ms(torch, lambda: module(h))
        rows.append({
            "layer": name, "kind": layer.kind, "stride": layer.stride, "input": list(q.shape),
            "out": [str(y.dtype).replace("torch.", "")] + list(y.shape), "classes": plan.dims[11],
            "splits": plan.splits,
            "M": flt.numel() // layer.cout, "N": layer.cout, "K": layer.ksize ** 2 * layer.cin, "needed_macs": macs,
            "ms": cuda_ms(torch, lambda: ic.conv_fused(q, layer, *args)),
            "device_ms": profiled_device_ms(torch, lambda: ic.conv_fused(q, layer, *args), "conv_fused"),
            "plain_ms": cuda_ms(torch, lambda: ic.conv_fused_plain(q, layer, *args), reps=PLAIN_REPS, warmup=1),
            "bound_ms": t_bound, "bound_by": by, "bound_bytes": bytes_layer, "bound_ops": 2 * macs,
            **lib, cudnn_key: cudnn_ms,
            "chain_ms": cuda_ms(torch, lambda: unfused_chain(torch, ic, q, layer, *args)),
            "chain_device_ms": profiled_all_ms(torch, lambda: unfused_chain(torch, ic, q, layer, *args)),
        })
    point_rows, point_cases = int8_points(torch, ic, points)
    # the stand-alone quantizer, which the sim_demo forward no longer
    # launches, on the same two points' float inputs as the forward
    # computed them before the fused points
    quant_rows = []
    for name, wrapper, args in points if not bf16 else ():
        x = args[0]
        if wrapper == "bn_quant":
            bn, s = args[1:]
            h = bn(x.permute(0, 3, 1, 2))
        else:
            bias, alpha, s = args[1:]
            h = ic.prelu(x + bias, alpha)
        if not torch.equal(ic.quant_act(h, s), ic.quant_act_plain(h, s)):
            raise AssertionError(f"quantizer before {name}: the kernel differs from its plain version")
        t_quant, by_quant = bound(5 * h.numel() + 4 * s.numel(), h.numel())
        quant_rows.append({
            "before": name, "input": list(h.shape), "ms": cuda_ms(torch, lambda: ic.quant_act(h, s)),
            "device_ms": profiled_device_ms(torch, lambda: ic.quant_act(h, s), "quant_act"),
            "plain_ms": cuda_ms(torch, lambda: ic.quant_act_plain(h, s), reps=PLAIN_REPS, warmup=1),
            "bound_ms": t_quant, "bound_by": by_quant,
        })
    cases = {
        "batch_1": check_int8_stamps(torch, ic, qv, cutouts[:1], "batch of 1"),
        "ragged_295": check_int8_stamps(torch, ic, qv, cutouts, f"batch of {len(cutouts)}"),
        "k54": convs[0][2].ksize ** 2 * convs[0][2].cin == 54,
    }
    extremes, per_tensor, specials = {}, {}, {}
    for name, q, layer, args in convs:
        # all-(+-127) operands: the largest |acc|, K * 127^2
        q127 = torch.full_like(q[:2], -127)
        big = ic.make_layer(layer.kind, torch.full_like(layer.qk, 127), torch.ones(layer.cout, device=dev),
                            torch.ones((), device=dev), torch.zeros(layer.cout, device=dev), layer.stride)
        raw = ic.conv_s8(q127, big, raw=True)
        if not torch.equal(raw, ic.conv_s8_plain(q127, big, raw=True)):
            raise AssertionError(f"int8 layer {name}: all-(+-127) operands differ from the plain version")
        extremes[name] = int(raw.abs().max())
        # per-tensor: one scale for the layer's input and one for the next's
        qk, ws = qv.qweights[name]
        flat = ic.make_layer(layer.kind, qk, ws, qv.act_scales[name].max(), layer.bias, layer.stride, layer.dtype,
                             layer.out_dtype)
        pt_args = args[:2] + (None if args[2] is None else args[2].max(),)
        if not bits_equal(torch, ic.conv_fused(q, flat, *pt_args), ic.conv_fused_plain(q, flat, *pt_args)):
            raise AssertionError(f"int8 layer {name}: per-tensor scales differ from the plain version")
        per_tensor[name] = True
        specials[name] = int8_specials(torch, ic, q, layer, args)
    cases.update(all_127_max_abs_acc=extremes, per_tensor_scales=per_tensor, special_values=specials)
    if bf16:
        # dec/Dense_1 under strict_cast=False: its bfloat16 epilogue (the
        # bundle's config holds strict_cast=True: float32, rounded once)
        name, q, layer, args = next(c for c in convs if c[0] == "dec/Dense_1")
        loose = dataclasses.replace(layer, dtype=torch.bfloat16)
        if not bits_equal(torch, ic.conv_fused(q, loose, *args), ic.conv_fused_plain(q, loose, *args)):
            raise AssertionError("int8 layer dec/Dense_1 (strict_cast=False): the kernel differs from its plain version")
        strict = ic.conv_fused(q, layer, *args)
        cases["dense1_strict_cast_false"] = {
            "codes_differing_from_strict": int((ic.conv_fused(q, loose, *args) != strict).sum()),
            "elements": strict.numel(), "specials": int8_specials(torch, ic, q, loose, args)}
    groups = {}
    for r in rows:
        g = "enc_conv" if r["layer"].startswith("enc/Conv") else "dense" if r["kind"] == "dense" else "dec_convT"
        groups.setdefault(g, []).append(r)

    def total(key, rs=rows):
        vals = [r[key] for r in rs]
        return None if any(v is None for v in vals) else float(sum(vals))

    summary = {g: {k: total(k, rs) for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                                              cudnn_key, "chain_ms", "chain_device_ms")}
               | {"layers": len(rs), "bound_bytes": sum(r["bound_bytes"] for r in rs),
                  "bound_ops": sum(r["bound_ops"] for r in rs)} for g, rs in groups.items()}
    summary["all"] = {k: total(k) for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms", cudnn_key,
                                            "chain_ms", "chain_device_ms")}
    summary["all"].update(bound_bytes_ms=sum(r["bound_bytes"] for r in rows) / PEAK_BYTES_PER_S * 1e3,
                          bound_ops_ms=sum(r["bound_ops"] for r in rows) / PEAK_INT8_OPS_PER_S * 1e3)
    if bf16:
        records = [{
            "name": f"int8_conv_bf16_{BF16_GROUPS[g]}", "route": "cuda",
            "source": "debvader_tpu_torch/csrc/int8_conv_bf16.cu (csrc/int8_conv.cu compiled with DVT_INT8_BF16)",
            "replaces": BF16_GROUP_REPLACES[g], "max_abs_err": 0.0, "ms": total("ms", rs),
            "device_ms": total("device_ms", rs), "plain_ms": total("plain_ms", rs), "bound_ms": total("bound_ms", rs),
            "bound_by": "bytes" if sum(r["bound_bytes"] for r in rs) / PEAK_BYTES_PER_S >= sum(
                r["bound_ops"] for r in rs) / PEAK_INT8_OPS_PER_S else "operations",
            "library_ms": total("library_ms", rs), "cudnn_bf16_ms": total(cudnn_key, rs), "chain_ms": total("chain_ms", rs),
            "shape": [QUANT_CHUNK, 59, 59, 6], "layers": len(rs)} for g, rs in groups.items()] + point_rows
        return records, {"layers": rows, "points": point_cases, "groups": summary, "cases": cases}
    records = [
        {"name": "int8_conv", "route": "cuda", "source": "debvader_tpu_torch/csrc/int8_conv.cu",
         "replaces": "debvader_tpu/models/quantized.py:340 (int8 conv, convT :399, dense :447, with _prelu :115 "
                     "and the next _quant_act :172; XLA, no Pallas kernel)",
         "max_abs_err": 0.0, "ms": total("ms"), "device_ms": total("device_ms"), "plain_ms": total("plain_ms"),
         "bound_ms": total("bound_ms"), "bound_by": "bytes" if summary["all"]["bound_bytes_ms"] >=
         summary["all"]["bound_ops_ms"] else "operations", "library_ms": total("library_ms"),
         "chain_ms": total("chain_ms"), "shape": [QUANT_CHUNK, 59, 59, 6], "layers": len(rows)},
        {"name": "int8_quant_act", "route": "cuda", "source": "debvader_tpu_torch/csrc/int8_conv.cu",
         "replaces": "debvader_tpu/models/quantized.py:172 (_quant_act after a float layer, XLA; no Pallas kernel)",
         "max_abs_err": 0.0, "ms": total("ms", quant_rows), "device_ms": total("device_ms", quant_rows),
         "plain_ms": total("plain_ms", quant_rows), "bound_ms": total("bound_ms", quant_rows), "bound_by": "bytes",
         "library_ms": None, "shape": [QUANT_CHUNK, 59, 59, 6], "points": len(quant_rows)},
    ] + point_rows
    return records, {"layers": rows, "quantizer": quant_rows, "points": point_cases, "groups": summary,
                     "cases": cases}


# the bfloat16 records by layer group, and what each replaces
BF16_GROUPS = {"enc_conv": "conv", "dense": "dense", "dec_convT": "convT"}
BF16_GROUP_REPLACES = {
    "enc_conv": "debvader_tpu/models/quantized.py:340-350 (int8 conv, its bfloat16 output :349) with _prelu :115 "
                "in bfloat16 and the next _quant_act :172 (XLA; no Pallas kernel)",
    "dense": "debvader_tpu/models/quantized.py:447-454 (int8 dense; dec/Dense_1's float32 epilogue and the cast at "
             "the reshape under strict_cast :513-518) with _prelu :115 and _quant_act :172 (XLA; no Pallas kernel)",
    "dec_convT": "debvader_tpu/models/quantized.py:399-409 (int8 transposed conv, its bfloat16 output :409) with "
                 "_prelu :115 in bfloat16 and the next _quant_act :172 (XLA; no Pallas kernel)",
}

# what each fused point replaces in the JAX package
POINT_REPLACES = {
    "bn_quant": "debvader_tpu/models/quantized.py:120 (_batchnorm_inference) and :172 (_quant_act) before "
                "enc/Conv_0 (XLA; no Pallas kernel)",
    "bias_prelu_quant": "debvader_tpu/models/quantized.py:115 (_prelu after dec/Dense_0's bias) and :172 "
                        "(_quant_act) before dec/Dense_1 (XLA; no Pallas kernel)",
}


def point_specials(torch, x: "torch.Tensor") -> "torch.Tensor":
    """x with NaN (both signs), the infinities, signed zeros, the largest
    floats and a subnormal in its first elements."""
    specials = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 3.4e38,
                             -3.4e38, 1e-40, -1e-45], device=x.device)
    y = x.clone()
    y.view(-1)[: len(specials)] = specials
    return y


def int8_points(torch, ic, points) -> tuple[list, dict]:
    """Phase 19, the fused float -> int8 points (dvt_quant_point) on the
    chunk's real inputs as the forward called them: bit for bit their plain
    versions there, with per-channel scales, with NaN, infinite, signed-zero
    and extreme values, on quotients exactly on .5 (round half to even) and
    past +-127, on a batch of 1 and the ragged 39-stamp chunk; each timed
    beside its bound (4 bytes in and 1 out an element) and its plain
    version.  Returns the kernels' records and the cases."""
    from debvader_tpu_torch.models.layers import BatchNorm

    records, cases = [], {}
    for name, wrapper, args in points:
        kernel, plain = getattr(ic, wrapper), getattr(ic, f"{wrapper}_plain")
        x, params, scale = args[0], args[1:-1], args[-1]
        c = x.shape[-1]
        bf16 = (args[1].dtype if wrapper == "bn_quant" else x.dtype) == torch.bfloat16
        per_channel = torch.linspace(0.5, 2.0, c, device=x.device) * scale.max()
        if wrapper == "bn_quant":
            halves = BatchNorm(c, dtype=args[1].dtype).to(x.device)
            with torch.no_grad():
                halves.scale.zero_()
                halves.bias.copy_(torch.tensor([5.0, -2.5, 1.75, 126.5, 127.5, -1e4], device=x.device)[:c])
            halves_args = (x, halves)
            halves_scales = (torch.ones((), device=x.device), torch.tensor([2.0, 1.0, 0.5, 1.0, 1.0, 1.0],
                                                                            device=x.device)[:c])
        else:
            pattern = torch.tensor([2.5, -2.5, 3.5, -3.5, 126.5, 127.5, -127.5, 1e4, -1e4, 0.5], device=x.device)
            hx = pattern.repeat(x.numel() // len(pattern) + 1)[: x.numel()].view(x.shape).to(x.dtype).contiguous()
            alternate = torch.where(torch.arange(c, device=x.device) % 2 == 0, 1.0, 0.5)
            halves_args = (hx, torch.zeros(c, device=x.device), alternate)
            halves_scales = (torch.ones((), device=x.device),)
        if bf16:
            # bfloat16 halfway points by channel (scale 0.5): 50.375 rounds to
            # the even 50.5 (quotient 101; the other way, 100.5 -> 100) and
            # 50.125 to 50.0; +-3.4e38 lies past the largest bfloat16 (+-inf)
            half = torch.full((), 0.5, device=x.device)
            if wrapper == "bn_quant":
                tie_bn = BatchNorm(c, dtype=torch.bfloat16).to(x.device)
                with torch.no_grad():
                    tie_bn.scale.zero_()
                    tie_bn.bias.copy_(torch.tensor([50.375, -50.375, 50.125, -50.125, 3.4e38, -3.4e38],
                                                   device=x.device).repeat(c)[:c])
                runs_ties = {"bf16_ties": (x, tie_bn, half)}
            else:
                # the tie in the bias add: 50 + 0.375, the PReLU the identity
                tie_bias = torch.tensor([0.375, -0.375, 0.125, -0.125, 3.4e38, -3.4e38], device=x.device).repeat(c)[:c]
                mm = torch.where(tie_bias >= 0, 50.0, -50.0).expand(x.shape).to(x.dtype).contiguous()
                runs_ties = {"bf16_ties": (mm, tie_bias, torch.ones(c, device=x.device), half)}
        runs = {
            "real": (x, *params, scale), "per_channel": (x, *params, per_channel),
            "specials": (point_specials(torch, x), *params, scale),
            "batch_1": (x[:1].contiguous(), *params, scale), "ragged_39": (x[:39].contiguous(), *params, scale),
        }
        for i, s in enumerate(halves_scales):
            runs[f"halves_{i}"] = (*halves_args, s)
        if bf16:
            runs.update(runs_ties)
        checked = {}
        for case, a in runs.items():
            got, want = kernel(*a), plain(*a)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{wrapper} ({case}): {int((got != want).sum())} elements differ from its plain "
                                     "version")
            checked[case] = {"elements": got.numel(), "saturated": int((got.abs() == 127).sum())}
            if case == "bf16_ties":
                checked[case]["first"] = got.reshape(-1)[:6].tolist()
                if checked[case]["first"] != [101, -101, 100, -100, 127, -127]:
                    raise AssertionError(f"{wrapper} (bf16_ties): {checked[case]['first']}, not rounded to even")
        cases[wrapper] = checked
        t_bound, by = bound((x.element_size() + 1) * x.numel() + 4 * (len(params) + 2) * c, 5 * x.numel())
        records.append({
            "name": f"int8_{wrapper}" + ("_bf16" if bf16 else ""), "route": "cuda",
            "source": "debvader_tpu_torch/csrc/int8_conv.cu",
            "replaces": POINT_REPLACES[wrapper] + (" under a bfloat16 compute dtype" if bf16 else ""),
            "max_abs_err": 0.0,
            "ms": cuda_ms(torch, lambda: kernel(*args)),
            "device_ms": profiled_device_ms(torch, lambda: kernel(*args), "quant_point"),
            "plain_ms": cuda_ms(torch, lambda: plain(*args), reps=PLAIN_REPS, warmup=1),
            "bound_ms": t_bound, "bound_by": by, "library_ms": None, "shape": list(x.shape), "before": name,
        })
    return records, cases


def exact_counts(counts: dict, want: dict, path: str) -> dict:
    """``counts`` unless one of ``want``'s kernels launched another number
    of times on ``path``."""
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"kernel {name} was launched {counts[name]} times on the {path} path, expected {n}")
    return counts


def run_quantized(torch, net, field: np.ndarray, centers: np.ndarray, reset_counts, read_counts) -> dict:
    """Phase 19, the serving path: load_quantized('sim_demo_int8') on the
    card, then DeblendField(quantized=qv, z_mode='mean') in 128-source
    chunks: deblend_field -> get_residual_field and deblend_and_render on
    the field, the launches counted from 0 just before and read just after;
    a second deblend_and_render bit-identical; the two routes against each
    other; the total-flux error against the float sim_demo forward on 64
    held-out simulated stamps; warm deblend_and_render, int8 and float32 in
    alternating turns; the peak memory of one 128-stamp forward, int8 and
    float32; the 256^2 crop on the card against the CPU."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.data.simulate import simulate_batch
    from debvader_tpu_torch.models import quantized as tq

    out = {}
    t = time.perf_counter()
    qv = tq.load_quantized("sim_demo_int8", device="cuda")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t
    # each int8 forward of a chunk: 18 fused layers and the two fused
    # float -> int8 points, on either route; the stand-alone quantizer and
    # conv_s8 (no epilogue) never
    chunks = -(-len(centers) // QUANT_CHUNK)
    want = {"int8_conv": 18 * chunks, "int8_bn_quant": chunks, "int8_bias_prelu_quant": chunks,
            "int8_quant_act": 0, "int8_conv_s8": 0}
    reset_counts()
    qdf = dt.DeblendField(net, field, z_mode="mean", quantized=qv, cfg=serving_cfg(QUANT_CHUNK), device="cuda")
    res = qdf.deblend_field(centers)
    r_residual = qdf.get_residual_field()
    torch.cuda.synchronize()
    out["record_array_launches"] = exact_counts(read_counts("int8 record-array", {}), want, "int8 record-array")
    reset_counts()
    catalog, residual, model = qdf.deblend_and_render(centers, return_model=True)
    torch.cuda.synchronize()
    out["launches"] = exact_counts(read_counts("int8 serving", {"render": 1}), want, "int8 deblend_and_render")
    out["chunks"] = chunks
    means = np.stack(list(res.output_images_mean))
    if not (np.isfinite(means).all() and np.isfinite(residual).all() and np.isfinite(r_residual).all()):
        raise AssertionError("non-finite outputs on the int8 serving path")
    _, again, _ = qdf.deblend_and_render(centers, return_model=True)
    if not np.array_equal(again.view(np.int32), residual.view(np.int32)):
        raise AssertionError("two int8 deblend_and_render runs differ")
    catalogs_agree(catalog, res)
    scale = float(np.abs(field).max())
    routes = float(np.abs(residual - r_residual).max())
    if routes > 1e-5 * scale:
        raise AssertionError(f"int8 streaming and record-array residuals differ by {routes}")
    mask = stamp_mask(field.shape[1], centers[res.list_idx])
    out.update(sources=int(len(centers)), deblended=int(len(res)), routes_max_abs_err=routes,
               abs_flux_in_stamps={"field": float(np.abs(field[0][mask]).sum()),
                                   "residual": float(np.abs(residual[0][mask]).sum())})

    # the total-flux error against the float forward (JAX's envelope)
    x = simulate_batch(2024, 64)[0]
    loc_q, _ = tq.make_quantized_forward(qv, z_mode="mean")(torch.as_tensor(x, device="cuda"))
    loc_f = dt.deblend(net, x, z_mode="mean", device="cuda")[0]
    fq = loc_q.double().sum(dim=(1, 2, 3)).cpu().numpy()
    ff = loc_f.astype(np.float64).sum(axis=(1, 2, 3))
    rel = np.abs(fq - ff) / np.maximum(np.abs(ff), 1e-9)
    out["flux_rel_err_vs_float"] = {"mean": float(rel.mean()), "max": float(rel.max()), "stamps": 64}
    if not rel.mean() < QUANT_FLUX_MEAN_MAX:
        raise AssertionError(f"int8 total-flux error {rel.mean()} against the float forward")

    # warm deblend_and_render, float32 and int8 in turns
    fdf = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(QUANT_CHUNK), device="cuda")
    fdf.deblend_and_render(centers)
    walls = {"float32": [], "int8": []}
    for _ in range(4):
        for key, d in (("float32", fdf), ("int8", qdf)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            d.deblend_and_render(centers)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t)
    out["warm_deblend_and_render_s"] = walls
    out["int8_over_float32"] = float(np.median(walls["int8"]) / np.median(walls["float32"]))
    # one profiled warm call of each: device busy time and idle share
    for key, d in (("float32", fdf), ("int8", qdf)):
        prof = profile_run(torch, lambda: d.deblend_and_render(centers))
        out[f"profiled_{key}"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_kernels",
                                                       "device_idle_share")} | {
            "top_device_events": prof["top_device_events"][:8]}

    # the peak memory of one 128-stamp forward, int8 and float32
    chunk = torch.as_tensor(x[:1].repeat(QUANT_CHUNK, axis=0), device="cuda")
    peaks = {}
    for key, fn in (("int8", lambda: tq.make_quantized_forward(qv, z_mode="mean")(chunk)),
                    ("float32", lambda: dt.api.deblend_tensor(net, chunk, z_mode="mean"))):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peaks[key] = int(torch.cuda.max_memory_allocated() - base)
    out["chunk_peak_bytes"] = peaks

    # the 256^2 crop on the card against the CPU
    crop = np.ascontiguousarray(field[:, 384:640, 384:640, :])
    c_centers = dt.detect_objects(crop, dt.DetectionConfig(**DETECTION), device="cpu")
    qv_cpu = tq.load_quantized("sim_demo_int8", device="cpu")
    net_cpu = dt.load_deblender("sim_demo", device="cpu")
    got = {}
    for dev, q, n in (("cuda", qv, net), ("cpu", qv_cpu, net_cpu)):
        d = dt.DeblendField(n, crop, z_mode="mean", quantized=q, cfg=serving_cfg(QUANT_CHUNK), device=dev)
        cat, resid, mdl = d.deblend_and_render(c_centers, return_model=True)
        got[dev] = (cat, resid, np.asarray(mdl))
    catalogs_agree(got["cuda"][0], got["cpu"][0])
    crop_err = {"residual": float(np.abs(got["cuda"][1] - got["cpu"][1]).max()),
                "model": float(np.abs(got["cuda"][2] - got["cpu"][2]).max()),
                "model_share_differing": float((got["cuda"][2] != got["cpu"][2]).mean()),
                "model_max_abs": float(np.abs(got["cpu"][2]).max()), "sources": int(len(c_centers))}
    out["crop_vs_cpu"] = crop_err
    if crop_err["model"] > 1e-3 * crop_err["model_max_abs"]:
        raise AssertionError(f"int8 serving on the crop: card and CPU differ: {crop_err}")
    return out


def run_qat(torch) -> dict:
    """Phase 19, QAT: one qat_finetune step at batch 32 from the packaged
    bundle with the sim_demo model as its teacher, card against CPU (the
    same simulated batch).  The distillation loss and its gradients on the
    CPU, on the card, and on the card with the CPU's grid points and clip
    masks (pinned): every one finite; pinned, the loss and each gradient
    leaf within QAT_PINNED_LOSS_RTOL / QAT_PINNED_LEAF_TOL, with two
    controls that must fail that check (the gradients halved, the largest
    leaf zeroed); on the card's own grid within QAT_LOSS_RTOL /
    QAT_LEAF_TOL, the activations that round to another grid point
    counted.  The stepped parameters finite on both devices, those moved
    by more than lr differently held to QAT_MOVED_MAX_SHARE; the step's
    time."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.data.simulate import simulate_batch
    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.models import quantized as tq
    from debvader_tpu_torch.weights import flax_from_state_dict

    x, y, _ = simulate_batch(7, TRAIN_BATCH)
    bundles = {dev: (tq.load_quantized("sim_demo_int8", device=dev), dt.load_deblender("sim_demo", device=dev))
               for dev in ("cpu", "cuda")}

    def loss_and_grads(dev, grid, pinned=False):
        """The distillation loss and its gradients by leaf on ``dev``; the
        fake-quant grid points and clip masks are appended to ``grid``, or
        with ``pinned`` taken from it in order."""
        qv, teacher = bundles[dev]
        orig = tq._act_grid
        if pinned:
            it = iter(grid)
            tq._act_grid = lambda hf, s: tuple(t.to(hf.device) for t in next(it))
        else:
            tq._act_grid = lambda hf, s: grid.append(orig(hf, s)) or grid[-1]
        try:
            xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
            with fp32_math():
                value, _ = tq._qat_loss(qv.model, teacher, xt, yt, list(qv.qweights), qv.act_scales, "distill", 0.01)
                g = torch.autograd.grad(value, list(qv.model.parameters()))
        finally:
            tq._act_grid = orig
        names = [k for k, _ in qv.model.named_parameters()]
        loss, grads = float(value.detach()), {k: v.double().cpu() for k, v in zip(names, g)}
        if not (np.isfinite(loss) and all(bool(torch.isfinite(v).all()) for v in grads.values())):
            raise AssertionError(f"qat step: a non-finite loss or gradient on {dev}{' (pinned)' if pinned else ''}")
        return loss, grads

    def leaf_errors(ga, gb):
        return {k: float((ga[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30) for k, g in gb.items()}

    grid_cpu, grid_card = [], []
    loss_cpu, g_cpu = loss_and_grads("cpu", grid_cpu)
    grid_cpu = [(q.detach().cpu(), m.cpu()) for q, m in grid_cpu]
    loss_card, g_card = loss_and_grads("cuda", grid_card)
    flips = [int((a[0].cpu() != b[0]).sum()) for a, b in zip(grid_card, grid_cpu)]
    elements = int(sum(q.numel() for q, _ in grid_cpu))
    del grid_card
    loss_pin, g_pin = loss_and_grads("cuda", grid_cpu, pinned=True)

    def pinned_holds(loss, grads):
        return (abs(loss / loss_cpu - 1) <= QAT_PINNED_LOSS_RTOL
                and max(leaf_errors(grads, g_cpu).values()) <= QAT_PINNED_LEAF_TOL)

    pin_err, card_err = leaf_errors(g_pin, g_cpu), leaf_errors(g_card, g_cpu)
    pin_loss_err, card_loss_err = abs(loss_pin / loss_cpu - 1), abs(loss_card / loss_cpu - 1)
    if not pinned_holds(loss_pin, g_pin):
        worst = max(pin_err, key=pin_err.get)
        raise AssertionError(f"qat step on the CPU's grid: loss {pin_loss_err} relative, gradient of {worst} "
                             f"{pin_err[worst]} of its scale off the CPU's")
    largest = max(g_pin, key=lambda k: float(g_pin[k].abs().max()))
    controls = {"halved": {k: 0.5 * v for k, v in g_pin.items()},
                "largest_leaf_zeroed": {**g_pin, largest: torch.zeros_like(g_pin[largest])}}
    for name, grads in controls.items():
        if pinned_holds(loss_pin, grads):
            raise AssertionError(f"qat step: the control with the gradients {name} passes the pinned check")
    if card_loss_err > QAT_LOSS_RTOL or max(card_err.values()) > QAT_LEAF_TOL:
        worst = max(card_err, key=card_err.get)
        raise AssertionError(f"qat step on the card's grid: loss {card_loss_err} relative, gradient of {worst} "
                             f"{card_err[worst]} of its scale off the CPU's ({sum(flips)} grid flips)")

    out, stepped = {}, {}
    for dev in ("cuda", "cpu"):
        qv, teacher = bundles[dev]
        if dev == "cuda":
            torch.cuda.synchronize()
            t = time.perf_counter()
        new = tq.qat_finetune(qv, steps=1, batch=TRAIN_BATCH, learning_rate=QAT_LR,
                              make_batch=lambda rng: (x, y), teacher_variables=teacher)
        if dev == "cuda":
            torch.cuda.synchronize()
            out["step_s_card"] = time.perf_counter() - t
        stepped[dev] = flax_from_state_dict(new.model.state_dict(), new.cfg)
        if not all(np.isfinite(v).all() for v in stepped[dev].values()):
            raise AssertionError(f"qat step: a non-finite parameter after the step on {dev}")
        if new.teacher_fingerprint != "a9c76466ebb29188":
            raise AssertionError(f"qat_finetune: teacher fingerprint {new.teacher_fingerprint}")
    moved = total = 0
    for k, v in stepped["cpu"].items():
        d = np.abs(stepped["cuda"][k] - v)
        total += d.size
        moved += int((d > QAT_LR).sum())
    worst, worst_pin = max(card_err, key=card_err.get), max(pin_err, key=pin_err.get)
    out.update(loss_card=loss_card, loss_rel_err=card_loss_err, loss_rel_err_pinned=pin_loss_err,
               fake_quant_grid_flips=flips, fake_quant_elements=elements,
               grad_worst_leaf=[worst, card_err[worst]], grad_median_leaf=float(np.median(list(card_err.values()))),
               grad_worst_leaf_pinned=[worst_pin, pin_err[worst_pin]],
               grad_median_leaf_pinned=float(np.median(list(pin_err.values()))),
               controls_fail=sorted(controls), moved_more_than_lr=moved, parameters=total)
    if moved > QAT_MOVED_MAX_SHARE * total:
        raise AssertionError(f"qat step: {moved} of {total} parameters moved differently on the card")
    return out


# ---------------------------------------- the int8 route in bfloat16, import

# Phase 23: the bfloat16 int8 route's 256^2 crop, card against CPU.  Its
# int8 layers are exact on both; the float bfloat16 layers between them
# (dec/Dense_0's product, the band head) may round to the neighbouring
# bfloat16 on one device (cuBLAS and cuDNN against oneDNN), and a
# quantizer after dec/Dense_0 then moves a code by one step, which the
# decoder carries on.  The crop's model field is held to this share of its
# scale, the JAX package's bfloat16 flux envelope (3e-2).
QUANT_BF16_CROP_TOL = 3e-2
# JAX's envelope of post-training quantization alone (quantize_vae of the
# converged sim_demo weights, no QAT) against the float forward: mean and
# largest total-flux error (tests/test_quantized.py:136-137; read 0.219 and
# 0.375 there).  The 5e-2 envelope (QUANT_FLUX_MEAN_MAX) is the
# QAT-fine-tuned bundle's, here the packaged sim_demo_int8 served in
# bfloat16.
QUANT_PTQ_FLUX_MEAN_MAX = 0.35
QUANT_PTQ_FLUX_MAX = 0.6


def run_quantized_bf16(torch, net, qv32, field: np.ndarray, centers: np.ndarray, cutouts: np.ndarray,
                       f32_flux_err: float, reset_counts, read_counts) -> tuple[list, dict]:
    """Phase 23, the int8 route in bfloat16: quantize_vae(load_deblender(
    'sim_demo', dtype='bfloat16')) on the card, calibrated on the
    record-array batch's real stamps; check_int8_layers on its bfloat16
    epilogues; DeblendField(quantized=<it>, z_mode='mean') in 128-source
    chunks on both routes, the launches of each counted from 0 and held to
    exactly 18 fused layers (8 conv, 2 dense, 8 transposed conv, every one
    a bfloat16 epilogue) and one of each bfloat16 point a chunk, two runs
    bit-identical, the routes against each other; the total-flux error
    against the float32 forward, of this bundle under JAX's envelope of
    post-training quantization and of the packaged QAT bundle served in
    bfloat16 under JAX's int8 envelope of 5e-2, beside its float32
    route's; warm deblend_and_render in turns against the
    float32 int8 route and the bfloat16 float route, one profiled call of
    each; the 256^2 crop card against CPU."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.data.simulate import simulate_batch
    from debvader_tpu_torch.models import quantized as tq

    out = {}
    t = time.perf_counter()
    net_bf = dt.load_deblender("sim_demo", dtype="bfloat16", device="cuda")
    qv = tq.quantize_vae(net_bf, cutouts)
    torch.cuda.synchronize()
    out["quantize_s"] = time.perf_counter() - t
    out["calibration_stamps"] = int(len(cutouts))
    out["epilogue_dtypes"] = dict(Counter(f"{str(layer.dtype)[6:]}->{str(layer.out_dtype)[6:]}"
                                          for layer in qv.int8_layers().values()))
    records, layers = check_int8_layers(torch, qv, cutouts)
    out["layers"] = layers

    chunks = -(-len(centers) // QUANT_CHUNK)
    want = {"int8_conv": 18 * chunks, "int8_conv_bf16_conv": 8 * chunks, "int8_conv_bf16_dense": 2 * chunks,
            "int8_conv_bf16_convT": 8 * chunks, "int8_bn_quant": chunks, "int8_bn_quant_bf16": chunks,
            "int8_bias_prelu_quant": chunks, "int8_bias_prelu_quant_bf16": chunks, "int8_quant_act": 0,
            "int8_conv_s8": 0}
    reset_counts()
    qdf = dt.DeblendField(net_bf, field, z_mode="mean", quantized=qv, cfg=serving_cfg(QUANT_CHUNK), device="cuda")
    res = qdf.deblend_field(centers)
    r_residual = qdf.get_residual_field()
    torch.cuda.synchronize()
    out["record_array_launches"] = exact_counts(read_counts("bf16 int8 record-array", {}), want,
                                                "bf16 int8 record-array")
    reset_counts()
    catalog, residual, model = qdf.deblend_and_render(centers, return_model=True)
    torch.cuda.synchronize()
    out["launches"] = exact_counts(read_counts("bf16 int8 serving", {"render": 1}), want,
                                   "bf16 int8 deblend_and_render")
    out["chunks"] = chunks
    means = np.stack(list(res.output_images_mean))
    if not (np.isfinite(means).all() and np.isfinite(residual).all() and np.isfinite(r_residual).all()):
        raise AssertionError("non-finite outputs on the bf16 int8 serving path")
    _, again, _ = qdf.deblend_and_render(centers, return_model=True)
    if not np.array_equal(again.view(np.int32), residual.view(np.int32)):
        raise AssertionError("two bf16 int8 deblend_and_render runs differ")
    catalogs_agree(catalog, res)
    scale = float(np.abs(field).max())
    routes = float(np.abs(residual - r_residual).max())
    if routes > 1e-5 * scale:
        raise AssertionError(f"bf16 int8 streaming and record-array residuals differ by {routes}")
    out.update(sources=int(len(centers)), deblended=int(len(res)), routes_max_abs_err=routes)

    # the total-flux error against the float32 forward on phase 19's 64
    # simulated stamps: this post-training bundle under JAX's PTQ envelope;
    # the packaged QAT-fine-tuned bundle served in bfloat16 (its weights and
    # scales, a bfloat16 model) under JAX's 5e-2, beside its float32 route
    x = simulate_batch(2024, 64)[0]
    xt = torch.as_tensor(x, device="cuda")
    ff = dt.deblend(net, x, z_mode="mean", device="cuda")[0].astype(np.float64).sum(axis=(1, 2, 3))
    qat = dt.DeblenderVAE(dataclasses.replace(qv32.cfg, dtype="bfloat16")).to("cuda")
    qat.load_state_dict(qv32.model.state_dict())
    qv_qat = dataclasses.replace(qv32, model=qat.eval(), _layers={})
    for key, bundle, limits in (("ptq", qv, (QUANT_PTQ_FLUX_MEAN_MAX, QUANT_PTQ_FLUX_MAX)),
                                ("qat_sim_demo_int8", qv_qat, (QUANT_FLUX_MEAN_MAX, None))):
        loc_q, _ = tq.make_quantized_forward(bundle, z_mode="mean")(xt)
        fq = loc_q.double().sum(dim=(1, 2, 3)).cpu().numpy()
        rel = np.abs(fq - ff) / np.maximum(np.abs(ff), 1e-9)
        out[f"flux_rel_err_vs_float32_{key}"] = {"mean": float(rel.mean()), "max": float(rel.max()), "stamps": 64}
        if not (rel.mean() < limits[0] and (limits[1] is None or rel.max() < limits[1])):
            raise AssertionError(f"bf16 int8 ({key}) total-flux error {rel.mean()} (largest {rel.max()}) against "
                                 f"the float32 forward")
    out["flux_rel_err_vs_float32_qat_sim_demo_int8"]["float32_route_mean"] = f32_flux_err

    # warm deblend_and_render in turns: the float32 int8 route, the bf16
    # float route, the bf16 int8 route; one profiled call of each
    routes_by = {
        "int8_float32": dt.DeblendField(net, field, z_mode="mean", quantized=qv32, cfg=serving_cfg(QUANT_CHUNK),
                                        device="cuda"),
        "bf16_float": dt.DeblendField(net_bf, field, z_mode="mean", cfg=serving_cfg(QUANT_CHUNK), device="cuda"),
        "int8_bf16": qdf,
    }
    for d in routes_by.values():
        d.deblend_and_render(centers)
    walls = {k: [] for k in routes_by}
    for _ in range(3):
        for key, d in routes_by.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            d.deblend_and_render(centers)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t)
    out["warm_deblend_and_render_s"] = walls
    out["int8_bf16_over_int8_float32"] = float(np.median(walls["int8_bf16"]) / np.median(walls["int8_float32"]))
    out["int8_bf16_over_bf16_float"] = float(np.median(walls["int8_bf16"]) / np.median(walls["bf16_float"]))
    for key, d in routes_by.items():
        prof = profile_run(torch, lambda: d.deblend_and_render(centers))
        out[f"profiled_{key}"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_kernels",
                                                       "device_idle_share")} | {
            "top_device_events": prof["top_device_events"][:8]}

    # the 256^2 crop on the card against the CPU
    crop = np.ascontiguousarray(field[:, 384:640, 384:640, :])
    c_centers = dt.detect_objects(crop, dt.DetectionConfig(**DETECTION), device="cpu")
    got = {}
    for dev, q, n in (("cuda", qv, net_bf),
                      ("cpu", qv.to("cpu"), dt.load_deblender("sim_demo", dtype="bfloat16", device="cpu"))):
        d = dt.DeblendField(n, crop, z_mode="mean", quantized=q, cfg=serving_cfg(QUANT_CHUNK), device=dev)
        cat, resid, mdl = d.deblend_and_render(c_centers, return_model=True)
        got[dev] = (cat, resid, np.asarray(mdl))
    catalogs_agree(got["cuda"][0], got["cpu"][0])
    m_abs = float(np.abs(got["cpu"][2]).max())
    crop_err = {"residual": float(np.abs(got["cuda"][1] - got["cpu"][1]).max()),
                "model": float(np.abs(got["cuda"][2] - got["cpu"][2]).max()),
                "model_share_differing": float((got["cuda"][2] != got["cpu"][2]).mean()),
                "model_share_beyond_one_bf16_ulp": float((np.abs(got["cuda"][2] - got["cpu"][2])
                                                          > bf16_ulp(m_abs)).mean()),
                "model_max_abs": m_abs, "sources": int(len(c_centers))}
    out["crop_vs_cpu"] = crop_err
    if crop_err["model"] > QUANT_BF16_CROP_TOL * m_abs:
        raise AssertionError(f"bf16 int8 serving on the crop: card and CPU differ: {crop_err}")
    return records, out


IMPORT_DIR = Path("chiprun_out") / "import"


def start_checkpoint_import() -> tuple:
    """Phase 23, the reference checkpoint import, its first half: the
    shipped sim_demo weights written as a 2-shard TensorBundle under
    chiprun_out/import, and `python -m debvader_tpu_torch import-weights`
    started on it in a process of its own (it runs beside the bf16 int8
    checks)."""
    from debvader_tpu_torch.utils.tf_checkpoint import read_index, write_bundle
    from debvader_tpu_torch.utils.weight_import import export_to_tensors
    from debvader_tpu_torch.weights import load_flax_npz, weights_file

    out_dir = IMPORT_DIR.resolve()
    shutil.rmtree(out_dir, ignore_errors=True)
    t = time.perf_counter()
    index = write_bundle(out_dir / "sim_demo.ckpt", export_to_tensors(load_flax_npz(weights_file("sim_demo"))),
                         shards=2)
    out = {"write_bundle_s": time.perf_counter() - t, "tensors": len(read_index(index))}
    return out, start_cli(["import-weights", "--ckpt", str(out_dir / "sim_demo.ckpt"), "--out",
                           str(out_dir / "imported")])


def run_checkpoint_import(torch, net, cutouts: np.ndarray, started: tuple) -> dict:
    """Phase 23, the import's second half: the CLI process waited for,
    load_deblender of the file it wrote on the card; that model's forward
    of the record-array batch bit for bit the shipped weights' forward.
    The checkpoint and the weights file are deleted after the check."""
    import debvader_tpu_torch as dt

    out_dir = IMPORT_DIR.resolve()
    out, cli = started
    out["cli"] = finish_cli(cli)
    imported = dt.load_deblender("imported", weights_dir=out_dir, device="cuda")
    got_m, got_d = dt.deblend(imported, cutouts, z_mode="mean", device="cuda")
    want_m, want_d = dt.deblend(net, cutouts, z_mode="mean", device="cuda")
    shutil.rmtree(out_dir)
    for a, b, what in ((got_m, want_m, "means"), (got_d.stddev().cpu().numpy(), want_d.stddev().cpu().numpy(),
                                                  "stddevs")):
        if not np.array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32)):
            raise AssertionError(f"the imported checkpoint's forward differs from the shipped weights' ({what})")
    out.update(stamps=int(len(cutouts)), bit_for_bit=True)
    return out


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
    events: kernels, copies, memsets), the CUDA kernels launched, the
    device's idle share and the top device events."""
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
    kernels = sum(r["calls"] for r in events if not r["name"].startswith(("Memcpy", "Memset")))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_kernels": kernels,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "top_device_events": events[:25]}


def stamp_forward_times(torch, nets: dict, x, reps: int = 20) -> dict:
    """Phase 20: the batched stamp forward of each model in ``nets`` on
    the same (N, S, S, B) stamps, timed in turns with CUDA events (median
    of ``reps``), then one profiled call each (its device-busy time),
    each beside its bound: 2 x forward_macs x N operations over the peak
    rate of its compute dtype (float32 with TF32 off, or bf16 tensor
    cores)."""
    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.utils.flops import forward_macs

    def fwd(net):
        def run():
            with torch.no_grad(), fp32_math():
                net(x, z_mode="mean")
        return run

    times = {name: [] for name in nets}
    for _ in range(2):
        for name, net in list(nets.items()) + list(nets.items())[::-1]:
            times[name].append(cuda_ms(torch, fwd(net), reps=reps // 4, warmup=2))
    out = {}
    for name, net in nets.items():
        ops = 2.0 * forward_macs(net.cfg) * x.shape[0]
        peak = PEAK_BF16_OPS_PER_S if net.cfg.dtype == "bfloat16" else PEAK_OPS_PER_S
        bound_ms = ops / peak * 1e3
        prof = profile_run(torch, fwd(net))
        ms = float(np.median(times[name]))
        out[name] = {"stamps": int(x.shape[0]), "ms": ms, "ms_runs": times[name],
                     "device_busy_ms": prof["device_busy_ms"], "device_idle_share": prof["device_idle_share"],
                     "device_kernels": prof["device_kernels"], "bound_ms": bound_ms, "bound_by": "operations",
                     "ms_over_bound": ms / bound_ms, "device_ms_over_bound": prof["device_busy_ms"] / bound_ms,
                     "top_device_events": prof["top_device_events"][:6]}
    return out


def run_model_options(torch, net, field: np.ndarray, centers: np.ndarray, cutouts: np.ndarray, reset_counts,
                      read_counts) -> dict:
    """Phase 20: the model options on the card.  load_deblender("sim_demo",
    dtype="bfloat16"); the stamp forward in float32 and in bfloat16 on the
    record-array route's real stamps, timed with their bounds; the bf16
    flux error against the float32 forward on 64 simulated stamps (held
    under the JAX package's 3e-2 envelope); deblend_and_render of the
    1024^2 field through the bf16 model with the detection and render
    kernels counted from 0, twice bit-identical, beside the float32
    route; the 256^2 crop card against the CPU's bf16 forward; and
    decoder_subpixel=True, decoder_f32_stages=2 against the stock model."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.data.simulate import simulate_batch
    from debvader_tpu_torch.device import fp32_math

    t = time.perf_counter()
    bf = dt.load_deblender("sim_demo", device="cuda", dtype="bfloat16")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    if bf.cfg.dtype != "bfloat16" or bf.decoder.convts[0].weight.dtype != torch.float32:
        raise AssertionError("model options: load_deblender(dtype='bfloat16') built the wrong model")
    x = torch.as_tensor(cutouts, device="cuda")
    sub = dt.load_deblender("sim_demo", device="cuda", cfg=dt.ModelConfig(decoder_subpixel=True))
    stages = dt.load_deblender("sim_demo", device="cuda", decoder_f32_stages=2)
    bf_stages = dt.load_deblender("sim_demo", device="cuda", dtype="bfloat16", decoder_f32_stages=2)
    forward = stamp_forward_times(torch, {"float32": net, "bfloat16": bf, "float32_subpixel": sub}, x)

    def loc(model, inp):
        with torch.no_grad(), fp32_math():
            return model(inp, z_mode="mean")[0].loc.cpu().numpy()

    held_out = torch.as_tensor(simulate_batch(7, 64)[0], device="cuda")
    ref = loc(net, held_out)
    flux = {"bfloat16": flux_rel_err(loc(bf, held_out), ref),
            "bfloat16_f32_stages_2": flux_rel_err(loc(bf_stages, held_out), ref)}
    if not max(flux.values()) < 3e-2:
        raise AssertionError(f"model options: bf16 flux error {flux} beyond the 3e-2 envelope")

    # the float32 options against the stock model on the real stamps
    m32 = loc(net, x)
    scale = float(np.abs(m32).max())
    sub_err = float(np.abs(loc(sub, x) - m32).max())
    stages_equal = bool(np.array_equal(loc(stages, x).view(np.int32), m32.view(np.int32)))
    if sub_err > 2e-5 * scale or not stages_equal:
        raise AssertionError(f"model options: sub-pixel {sub_err} of {scale}, f32 stages equal {stages_equal}")
    m16 = loc(bf, x)
    bf_err = float(np.abs(m16 - m32).max())

    # the bf16 model on the serving route, detection and render counted
    reset_counts()
    found = dt.detect_objects(field, dt.DetectionConfig(**DETECTION), device="cuda")
    dfb = dt.DeblendField(bf, field, z_mode="mean", cfg=serving_cfg(), device="cuda")
    cat_b, resid_b, model_b = dfb.deblend_and_render(found, return_model=True)
    # the bias and PReLU of each forward chunk: in bfloat16, and in float32
    # after the layers that compute in it (dec/Dense_1 under strict_cast)
    wide = sum(layer.dtype == torch.float32 for _, layer, _, _ in bias_prelu_layers(bf))
    chunks = -(-len(found) // serving_cfg().source_chunk)
    launches = read_counts("bfloat16 model", {"clipped_stats": 1, "detect_fused": 1, "label_select": 1,
                                             "render": 1, "bias_prelu_bf16": (18 - wide) * chunks,
                                             "bias_prelu": wide * chunks})
    again = dt.DeblendField(bf, field, z_mode="mean", cfg=serving_cfg(), device="cuda").deblend_and_render(found)[1]
    if not np.array_equal(again.view(np.int32), resid_b.view(np.int32)):
        raise AssertionError("model options: two bf16 serving runs differ")
    cat_f, resid_f = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device="cuda").deblend_and_render(
        found)
    catalogs_agree(cat_b, cat_f)
    field_scale = float(np.abs(field).max())
    resid_err = float(np.abs(resid_b - resid_f).max())
    if not (np.isfinite(resid_b).all() and resid_err <= BF16_RESIDUAL_TOL * field_scale):
        raise AssertionError(f"model options: bf16 residual {resid_err} off the float32 route's ({field_scale})")
    warm = {"float32": [], "bfloat16": []}
    dff = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device="cuda")
    for name, obj in (("float32", dff), ("bfloat16", dfb), ("bfloat16", dfb), ("float32", dff)):
        timings = {}
        t = time.perf_counter()
        obj.deblend_and_render(found, timings=timings)
        torch.cuda.synchronize()
        warm[name].append({"total_s": time.perf_counter() - t, **timings})

    # the crop: the bf16 forward on the card against the port's CPU one
    crop = np.ascontiguousarray(field[:, 384:640, 384:640, :])
    bf_cpu = dt.load_deblender("sim_demo", device="cpu", dtype="bfloat16")
    c_gpu, r_gpu, res_gpu, _ = run_main_path(torch, bf, crop, "cuda")
    c_cpu, r_cpu, res_cpu, _ = run_main_path(torch, bf_cpu, crop, "cpu")
    if not np.array_equal(c_gpu, c_cpu):
        raise AssertionError("model options: detection differs between card and CPU on the crop")
    g, c = np.stack(list(r_gpu.output_images_mean)), np.stack(list(r_cpu.output_images_mean))
    crop_scale = float(np.abs(c).max())
    diff = np.abs(g - c)
    crop_share = float(np.mean(diff > bf16_ulp(crop_scale)))
    crop_err = float(diff.max())
    if crop_share > BF16_CROP_SHARE or crop_err > 5e-2 * crop_scale:
        raise AssertionError(f"model options: bf16 crop, card against CPU: {crop_err} of {crop_scale}, "
                             f"{crop_share} beyond one bf16 ulp of the scale")
    return {
        "load_s": load_s, "stamp_forward": forward, "flux_rel_err_vs_float32": flux,
        "bf16_mean_max_abs_err_vs_float32": bf_err, "mean_max_abs": scale,
        "subpixel_max_abs_err": sub_err, "f32_stages_2_float32_bit_equal": stages_equal,
        "serving": {"sources": int(len(found)), "deblended": int(len(cat_b)), "launches": launches,
                    "residual_max_abs_err_vs_float32": resid_err, "field_max_abs": field_scale,
                    "warm_deblend_and_render": warm},
        "crop_vs_cpu": {"sources": int(len(c_gpu)), "mean_max_abs_err": crop_err, "mean_max_abs": crop_scale,
                        "share_beyond_one_bf16_ulp": crop_share, "differing_share": float(np.mean(diff > 0)),
                        "residual_max_abs_err": float(np.abs(res_gpu - res_cpu).max())},
    }


def artifact_equal(got, want) -> dict:
    """Largest difference and the share of elements that differ between an
    artifact's output and the live model's."""
    d = (got - want).abs()
    return {"max_abs_err": float(d.max()), "differing_share": float((d > 0).float().mean()),
            "scale": float(want.abs().max())}


def start_cli(args: list):
    """``python -m debvader_tpu_torch ARGS`` from the repo root started in
    a process of its own, its output into temporary files (so that it
    never waits on a full pipe); finish_cli waits for it, stop_cli stops
    it on a failure elsewhere."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", "debvader_tpu_torch", *args], cwd=Path(__file__).resolve().parent,
                            stdout=out, stderr=err, text=True)
    return proc, args, time.perf_counter(), out, err


def stop_cli(started) -> None:
    """Kill a start_cli process that is still running."""
    if started[0].poll() is None:
        started[0].kill()
        started[0].wait()


def finish_cli(started, timeout: int = 300) -> dict:
    """Wait for a CLI process of start_cli; raises unless it exits 0
    (and stops it if it outlasts ``timeout``)."""
    proc, args, t, out, err = started
    try:
        proc.wait(timeout=timeout)
    finally:
        stop_cli(started)
    with out, err:
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    if proc.returncode != 0:
        raise AssertionError(f"CLI {args[0]} exited {proc.returncode}: {stderr[-3000:]}")
    return {"s": time.perf_counter() - t, "stdout": stdout.strip().splitlines()[-1:]}


def run_cli(args: list, timeout: int = 300) -> dict:
    """``python -m debvader_tpu_torch ARGS`` in a process of its own, to
    its end; raises unless it exits 0."""
    return finish_cli(start_cli(args), timeout)


def run_export_cli(torch, net, field: np.ndarray, centers: np.ndarray, cutouts: np.ndarray, reset_counts,
                   read_counts) -> dict:
    """Phase 21: export_deblender on the card, load_exported and
    artifact_forward against the live model at batches of 1, 128 and the
    ragged 295 through one artifact; DeblendField(artifact=) against the
    live route; then the CLI in processes of its own: detect and serve
    --centers against the in-process route, export then serve --artifact."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.api import deblend_tensor
    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.utils import export as ex

    t = time.perf_counter()
    blob = ex.export_deblender(net)
    export_s = time.perf_counter() - t
    call = ex.load_exported(blob)
    fwd = ex.artifact_forward(blob, device="cuda")
    x_all = torch.as_tensor(cutouts, device="cuda")
    batches = {}
    for n in (1, 128, x_all.shape[0]):
        x = x_all[:n]
        got = fwd(x, torch.Generator(device="cuda").manual_seed(n))
        want = deblend_tensor(net, x, generator=torch.Generator(device="cuda").manual_seed(n))
        eps = torch.randn((n, net.cfg.latent_dim), generator=torch.Generator(device="cuda").manual_seed(n),
                          device="cuda")
        with torch.no_grad(), fp32_math():
            raw = call(x, eps)
        rec = {"loc": artifact_equal(got[0], want.loc), "scale": artifact_equal(got[1], want.scale),
               "load_exported_loc": artifact_equal(raw[0], want.loc)}
        for k, r in rec.items():
            if r["max_abs_err"] > ARTIFACT_TOL * r["scale"]:
                raise AssertionError(f"export: batch {n}, {k}: {r}")
        batches[str(n)] = rec
    ms = {"artifact": cuda_ms(torch, lambda: fwd(x_all, torch.Generator(device="cuda").manual_seed(0)), reps=10),
          "live": cuda_ms(torch, lambda: deblend_tensor(net, x_all, generator=torch.Generator(device="cuda")
                                                        .manual_seed(0)), reps=10)}

    # the serving route through a mean-mode artifact, counted from 0
    mean_blob = ex.export_deblender(net, z_mode="mean")
    live = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), device="cuda")
    cat_l, resid_l = live.deblend_and_render(centers)
    reset_counts()
    art = dt.DeblendField(net, field, z_mode="mean", cfg=serving_cfg(), artifact=mean_blob, device="cuda")
    cat_a, resid_a = art.deblend_and_render(centers)
    launches = read_counts("artifact", {"render": 1})
    catalogs_agree(cat_a, cat_l)
    route_err = float(np.abs(resid_a - resid_l).max())
    if route_err > ARTIFACT_TOL * float(np.abs(field).max()):
        raise AssertionError(f"export: DeblendField(artifact=) residual {route_err} off the live route's")

    # the CLI, each command a process of its own, on files under chiprun_out;
    # export (which needs no other command's output) runs beside detect
    # and serve
    out = Path("chiprun_out") / "cli"
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "field.npy", field)
    exporting = start_cli(["export", "--out", str(out / "fwd.pt2")])
    try:
        cli = export_cli_runs(torch, net, field, out, exporting)
    finally:
        stop_cli(exporting)
    return {
        "export_s": export_s, "artifact_bytes": len(blob), "batches": batches, "forward_295_ms": ms,
        "route": {"launches": launches, "residual_max_abs_err": route_err, "deblended": int(len(cat_a))},
        "cli": cli,
    }


def export_cli_runs(torch, net, field: np.ndarray, out: Path, exporting) -> dict:
    """Phase 21's CLI: detect, serve, the export started before, then
    serve --artifact, each against the in-process route."""
    import debvader_tpu_torch as dt

    cli = {"detect": run_cli(["detect", "--field", str(out / "field.npy"), "--out", str(out / "centers.npy"),
                              "--thresh", str(CLI_THRESH)])}
    det = dt.detect_objects_tiled(field, dt.DetectionConfig(thresh=CLI_THRESH), device="cuda")
    cli_centers = np.load(out / "centers.npy")
    if not np.array_equal(cli_centers, det):
        raise AssertionError("CLI detect differs from the in-process detection")
    cli["serve"] = run_cli(["serve", "--field", str(out / "field.npy"), "--centers", str(out / "centers.npy"),
                            "--out-prefix", str(out / "serve")])
    _, want = dt.DeblendField(net, field, device="cuda").deblend_and_render(det)
    serve_resid = np.load(out / "serve_residual.npy")
    serve_equal = bool(np.array_equal(serve_resid.view(np.int32), want.view(np.int32)))
    serve_err = float(np.abs(serve_resid - want).max())
    cli["export"] = finish_cli(exporting)
    cli["serve_artifact"] = run_cli(["serve", "--field", str(out / "field.npy"), "--centers",
                                     str(out / "centers.npy"), "--artifact", str(out / "fwd.pt2"),
                                     "--out-prefix", str(out / "serve_artifact")])
    art_resid = np.load(out / "serve_artifact_residual.npy")
    art_err = float(np.abs(art_resid - serve_resid).max())
    scale = float(np.abs(field).max())
    if serve_err > ARTIFACT_TOL * scale or art_err > ARTIFACT_TOL * scale:
        raise AssertionError(f"CLI serve {serve_err}, serve --artifact {art_err} off the in-process route")
    # chiprun_out comes back only under 64 MiB: keep the centres and the
    # catalogues, drop the field-sized arrays and the artifact
    for name in ("field.npy", "serve_residual.npy", "serve_artifact_residual.npy", "fwd.pt2"):
        (out / name).unlink()
    return {"runs": cli, "detections": int(len(det)), "serve_bit_equal": serve_equal,
            "serve_max_abs_err": serve_err,
            "serve_artifact_max_abs_err_vs_serve": art_err,
            "serve_artifact_bit_equal": bool(np.array_equal(art_resid.view(np.int32), serve_resid.view(np.int32)))}


def band_kernels(torch, band_rows: int, f: int, counts: dict) -> list[dict]:
    """The float32 render and place kernels on a rectangular band canvas
    of the sharded serve's real shape (band_rows x f, one 128-source chunk
    of seeded stamps over the band and past its edges, one masked): the
    render into the strided window of a filled canvas against its plain
    version (1e-5 of the stamps' scale), the place bit for bit against the
    CPU's plain version and a second launch; each timed beside its plain
    version, its bound and the same call on the square f x f field (the
    square time shows what the rectangle costs), with the launches the
    sharded serve made (``counts``)."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.kernels import render as rd

    dev = torch.device("cuda")
    n, s, b = 128, 59, 6
    gen = torch.Generator(device=dev).manual_seed(22)
    stamps = torch.rand((n, s, s, b), generator=gen, device=dev)
    half = torch.tensor([band_rows / 2 + 20.0, f / 2 + 20.0], device=dev)
    offsets = (torch.rand((n, 2), generator=gen, device=dev) * 2 - 1) * half
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[5] = False
    records = []

    # order 1: the strided window of a filled band canvas
    pad = dt.render_pad(s, 1)
    base = torch.randn((band_rows + 2 * pad, f + 2 * pad, b), generator=gen, device=dev)

    def window(c, rows=band_rows):
        return c[pad : pad + rows, pad : pad + f]

    got, want = base.clone(), base.clone()
    rd.render_field_kernel(stamps, offsets, (band_rows, f), mask, out=window(got))
    rd.render_field_plain(stamps, offsets, (band_rows, f), mask, out=window(want))
    again = base.clone()
    rd.render_field_kernel(stamps, offsets, (band_rows, f), mask, out=window(again))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > 1e-5 * float(stamps.abs().max()):
        raise AssertionError(f"render on the {band_rows}x{f} band canvas: off by {err} from the plain version")
    if not torch.equal(got, again):
        raise AssertionError("render on the band canvas: two launches differ")
    if not float((got - base).abs().max()) > 0.5:
        raise AssertionError("render on the band canvas: nothing was rendered")
    work, work_p = base.clone(), base.clone()
    square = torch.zeros((f + 2 * pad, f + 2 * pad, b), device=dev)
    # what this chunk needs on the band window: the unmasked sources'
    # stamp pixels that reach it read once, the union of their clipped
    # padded patches read and written once, 11 operations a patch element
    off_np, keep = offsets.cpu().numpy(), mask.cpu().numpy()
    covered = int(covered_mask(off_np, keep, s, (band_rows, f)).sum()) * b
    patch_px, stamp_px = clipped_patches(off_np, keep, s, band_rows, f)
    t_bound, by = bound(stamp_px * b * 4 + n * 9 + 2 * covered * 4, patch_px * b * 11)
    records.append({
        "name": "render_band", "route": "cuda", "source": "debvader_tpu_torch/csrc/render.cu",
        "replaces": "debvader_tpu/kernels/render.py:149 (render_field_pallas) on the rectangular row-band canvas of "
                    "debvader_tpu/pipeline/sharded_field.py:454",
        "launches": counts["render"], "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: rd.render_field_kernel(stamps, offsets, (band_rows, f), mask, out=window(work))),
        "device_ms": profiled_device_ms(
            torch, lambda: rd.render_field_kernel(stamps, offsets, (band_rows, f), mask, out=window(work)), "render_"),
        "plain_ms": cuda_ms(torch, lambda: rd.render_field_plain(stamps, offsets, (band_rows, f), mask,
                                                                 out=window(work_p)), reps=PLAIN_REPS, warmup=1),
        "square_ms": cuda_ms(torch, lambda: rd.render_field_kernel(stamps, offsets, f, mask,
                                                                    out=window(square, f))),
        "library_ms": None, "bound_ms": t_bound, "bound_by": by,
        "shape": [n, s, s, b, band_rows, f], "canvas": list(base.shape), "covered_elements": covered,
        "patch_pixels": patch_px, "stamp_pixels": stamp_px,
    })

    # order 3: the spline's patches placed into a filled band canvas
    from debvader_tpu_torch.kernels.render import place_corners, shift_patches
    from debvader_tpu_torch.ops.spline import subpixel_shift_spline_const

    patches, int_off = shift_patches(stamps, offsets, 10, subpixel_shift_spline_const)
    patches = patches.contiguous()
    p = patches.shape[1]
    ch, cw = band_rows + 2 * p, f + 2 * p
    y, x, visible = place_corners(int_off, mask, (band_rows, f), s, 10, (ch, cw))
    canvas0 = torch.randn((ch, cw, b), generator=gen, device=dev)
    got, again = canvas0.clone(), canvas0.clone()
    rd.place_patches(got, patches, y, x, visible)
    rd.place_patches(again, patches, y, x, visible)
    want = canvas0.cpu()
    rd.place_patches_plain(want, patches.cpu(), y.cpu(), x.cpu(), visible.cpu())
    torch.cuda.synchronize()
    if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
        raise AssertionError("place on the band canvas: the canvas differs from the CPU plain version")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("place on the band canvas: two launches differ")
    covered = footprint_elements(y.cpu(), x.cpu(), p, ch, b, cols=cw)
    t_bound, by = bound(patches.numel() * 4 + n * 9 + covered * 8, patches.numel())
    work = canvas0.clone()
    sq_patches_y, sq_x, sq_vis = place_corners(int_off, mask, f, s, 10, f + 2 * p)
    sq_canvas = torch.zeros((f + 2 * p, f + 2 * p, b), device=dev)
    ar = torch.arange(p, device=dev)
    flat = ((y[:, None] + ar)[:, :, None] * cw + (x[:, None] + ar)[:, None, :]).reshape(-1)
    masked = torch.where(visible[:, None, None, None], patches, torch.zeros((), device=dev)).reshape(-1, b)
    records.append({
        "name": "place_band", "route": "cuda", "source": "debvader_tpu_torch/csrc/render.cu",
        "replaces": "debvader_tpu/ops/shift.py:209 (render_field's order-3 scan, XLA; no Pallas kernel) on the "
                    "rectangular row-band canvas of debvader_tpu/pipeline/sharded_field.py:454",
        "launches": counts["place"], "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: rd.place_patches(work, patches, y, x, visible)),
        "device_ms": profiled_device_ms(torch, lambda: rd.place_patches(work, patches, y, x, visible),
                                        "place_tile_kernel"),
        "plain_ms": cuda_ms(torch, lambda: rd.place_patches_plain(work, patches, y, x, visible), reps=PLAIN_REPS,
                            warmup=1),
        "square_ms": cuda_ms(torch, lambda: rd.place_patches(sq_canvas, patches, sq_patches_y, sq_x, sq_vis)),
        "library_ms": cuda_ms(torch, lambda: work.view(-1, b).index_put_((flat,), masked, accumulate=True)),
        "library_call": "index_put_(accumulate=True) of the masked patches",
        "bound_ms": t_bound, "bound_by": by,
        "shape": [n, p, p, b, ch, cw], "covered_elements": covered,
    })
    return records


def catalogue_rows_equal(got, want, what: str) -> float:
    """Hold two streaming catalogues' rows equal (list_idx, centres,
    passed_cuts) and their mse_center to 1e-4 relative (the CPU tests'
    tolerance against the JAX package); returns the largest relative mse
    difference."""
    for col in ("list_idx", "galaxy_distances_to_center_x", "galaxy_distances_to_center_y", "passed_cuts"):
        if not np.array_equal(np.asarray(got[col]), np.asarray(want[col])):
            raise AssertionError(f"{what}: catalogue column {col} differs")
    a, b = np.asarray(got.mse_center, np.float64), np.asarray(want.mse_center, np.float64)
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    if rel > 1e-4:
        raise AssertionError(f"{what}: mse_center differs by {rel} relative")
    return rel


def bitwise_catalogue(got, want) -> dict:
    """Which columns of two catalogues are bit for bit equal."""
    out = {}
    for col in want.dtype.names:
        a, b = np.asarray(got[col]), np.asarray(want[col])
        if a.dtype == object:
            a, b = np.stack(list(a)), np.stack(list(b))
        out[col] = bool(a.shape == b.shape and a.tobytes() == b.tobytes())
    return out


def run_multi_device(torch, net, big: np.ndarray, centers: np.ndarray, field: np.ndarray, main_centers: np.ndarray,
                     main_cutouts: np.ndarray, qv, reset_counts, read_counts) -> tuple[dict, list]:
    """Phase 22 (module docstring): the single-controller mesh on the one
    card.  Returns (report, the band-canvas kernel records)."""
    import dataclasses as dc

    import debvader_tpu_torch as dt
    from debvader_tpu_torch.models import quantized as tq
    from debvader_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from debvader_tpu_torch.training import train as tt
    from debvader_tpu_torch.weights import flax_from_state_dict

    out = {"card": nvidia_smi_line()}
    cards = torch.cuda.device_count()
    try:
        make_mesh(cards + 1)
    except ValueError as e:
        out["make_mesh_past_the_cards"] = str(e)
    else:
        raise AssertionError(f"make_mesh({cards + 1}) on {cards} card(s) did not raise")
    mesh4, mesh1 = make_mesh(4, devices=["cuda:0"] * 4), make_mesh(1, devices=["cuda:0"])
    if any(d.type != "cuda" for d in mesh4.flat + mesh1.flat):
        raise AssertionError("a mesh of the card holds another device")
    scale = float(np.abs(big).max())

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    serve = {}
    for order in (1, 3):
        cfg = dc.replace(tiled_cfg(), interp_order=order)
        single = dt.DeblendField(net, big, z_mode="mean", cfg=cfg, device="cuda")
        single.deblend_and_render(centers)  # warm, the field memoized
        (cat_s, res_s), single_s = timed(lambda: single.deblend_and_render(centers))
        runs = {}
        for name, mesh in (("4", mesh4), ("1", mesh1)):
            sf = dt.ShardedFieldDeblender(net, big, mesh, z_mode="mean", cfg=cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            t = {}
            (cat, res), first_s = timed(lambda: sf.deblend_and_render(centers, timings=t))
            counts = read_counts(f"sharded serve ({name} band(s), order {order})",
                                 {"render": 1} if order == 1 else {"place": 1})
            peak = torch.cuda.max_memory_allocated() - base
            (cat2, res2), warm_s = timed(lambda: sf.deblend_and_render(centers))
            if not np.array_equal(res2.view(np.int32), res.view(np.int32)):
                raise AssertionError(f"two sharded serves ({name} bands, order {order}) differ")
            err = float(np.abs(res - res_s).max())
            if err > 1e-5 * scale:
                raise AssertionError(f"sharded serve ({name} bands, order {order}): residual off the single-device "
                                     f"route by {err}, field scale {scale}")
            rel = catalogue_rows_equal(cat, cat_s, f"sharded serve ({name} bands, order {order})")
            runs[name] = {"cat": cat, "res": res, "report": {
                "first_s": first_s, "warm_s": warm_s, "timings_s": t, "launches": counts,
                "residual_max_abs_err": err, "mse_center_max_rel_err": rel, "device_peak_bytes": int(peak),
                "residency": sf.residency_report(), "band_h": sf.band_h, "halo": sf.halo, "h_pad": sf.h_pad}}
        rows_4_vs_1 = catalogue_rows_equal(runs["1"]["cat"], runs["4"]["cat"], f"1 band against 4 (order {order})")
        serve[f"order{order}"] = {
            "sources": int(len(centers)), "deblended": int(len(cat_s)), "field_scale": scale,
            "single_device_warm_s": single_s, "bands4": runs["4"]["report"], "bands1": runs["1"]["report"],
            "one_vs_four_mse_max_rel_err": rows_4_vs_1,
            "one_vs_four_bitwise": bitwise_catalogue(runs["1"]["cat"], runs["4"]["cat"]),
        }
    out["sharded_serve"] = serve

    # registered: the windowed kernel on the bands, windows inside the field's rows
    from debvader_tpu_torch.kernels import registration as kr

    single = dt.DeblendField(net, big, z_mode="mean", cfg=tiled_cfg(), device="cuda")
    (cat_s, res_s), single_s = timed(lambda: single.deblend_and_render(centers, optimise_positions=True))
    sf = dt.ShardedFieldDeblender(net, big, mesh4, z_mode="mean", cfg=tiled_cfg())
    reset_counts()
    kr.register_full.launches = 0
    (cat, res), first_s = timed(lambda: sf.deblend_and_render(centers, optimise_positions=True))
    reg_counts = read_counts("registered sharded serve (4 bands)", {"registration": 1, "render": 1})
    if kr.register_full.launches:
        raise AssertionError(f"the registered sharded serve launched the full-field registration "
                             f"{kr.register_full.launches} times")
    shift_err = float(np.abs(np.stack(list(cat.shifts)) - np.stack(list(cat_s.shifts))).max())
    err = float(np.abs(res - res_s).max())
    if not (shift_err <= 2e-3 and err <= 2e-4):
        raise AssertionError(f"registered sharded serve: shifts off the single-device route by {shift_err} px, "
                             f"the residual by {err}")
    out["registered_serve"] = {
        "sources": int(len(centers)), "bands": 4, "shift_max_abs_err_px": shift_err, "residual_max_abs_err": err,
        "mse_center_max_rel_err": catalogue_rows_equal(cat, cat_s, "registered sharded serve"),
        "largest_shift_px": float(np.abs(np.stack(list(cat_s.shifts))).max()), "launches": reg_counts,
        "full_field_launches": 0, "first_s": first_s, "single_device_s": single_s}
    band_rows = serve["order1"]["bands4"]["h_pad"]
    counts = {"render": serve["order1"]["bands4"]["launches"]["render"],
              "place": serve["order3"]["bands4"]["launches"]["place"]}

    # band-tiled detection against the tiled detection's rows
    det = dt.DetectionConfig(**DETECTION)
    sf = dt.ShardedFieldDeblender(net, big, mesh4, z_mode="mean", cfg=tiled_cfg())
    reset_counts()
    t = {}
    found, first_s = timed(lambda: sf.detect_objects(det, timings=t))
    det_counts = read_counts("band-tiled detection", {"clipped_stats": 1, "detect_fused": 1, "label_select": 1})
    _, warm_s = timed(lambda: sf.detect_objects(det))
    tiled, tiled_s = timed(lambda: dt.detect_objects_tiled(big, det, tile=TILES["tile_size"],
                                                           overlap=TILES["tile_overlap"], device="cuda"))
    shared = len(set(map(tuple, found)) & set(map(tuple, tiled)))
    if shared < 0.98 * len(tiled):
        raise AssertionError(f"band-tiled detection found {shared} of the tiled detection's {len(tiled)} rows")
    out["band_detection"] = {"rows": int(len(found)), "tiled_rows": int(len(tiled)), "shared_rows": shared,
                             "first_s": first_s, "warm_s": warm_s, "tiled_warm_s": tiled_s, "timings_s": t,
                             "launches": det_counts}

    records = band_kernels(torch, band_rows, big.shape[1], counts)

    # the batch fan-out: DeblendField(mesh=) and the int8 forward at 2 shards against 1
    mesh2 = make_mesh(2, devices=["cuda:0"] * 2)
    fan = {}
    cfg = serving_cfg()
    fields = {}
    for name, mesh in (("1", mesh1), ("2", mesh2)):
        df = dt.DeblendField(net, field, cfg=cfg, mesh=mesh, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(5))
        (cat, res), secs = timed(lambda: df.deblend_and_render(main_centers))
        fields[name] = (cat, res)
        fan[f"deblend_field_mesh{name}_s"] = secs
    err = float(np.abs(fields["2"][1] - fields["1"][1]).max())
    fscale = float(np.abs(field).max())
    if err > 1e-5 * fscale:
        raise AssertionError(f"DeblendField(mesh=) at 2 shards off 1 shard by {err}")
    fan["deblend_field_residual_max_abs_err"] = err
    fan["deblend_field_mse_max_rel_err"] = catalogue_rows_equal(fields["2"][0], fields["1"][0], "DeblendField(mesh=)")
    stamps = torch.as_tensor(main_cutouts, device="cuda")
    reset_counts()
    q2 = tq.make_sharded_quantized_forward(qv, mesh2, z_mode="mean")(stamps)
    q_counts = read_counts("sharded int8 forward", {"int8_conv": 1})
    q1 = tq.make_sharded_quantized_forward(qv, mesh1, z_mode="mean")(stamps)
    torch.cuda.synchronize()
    q_err = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(q2, q1))
    if q_err > 1e-5:
        raise AssertionError(f"make_sharded_quantized_forward at 2 shards off 1 shard by {q_err} of the scale")
    # host stamps go to the mesh's card; a CPU tensor's outputs come back through a blocking copy
    fwd2 = tq.make_sharded_quantized_forward(qv, mesh2, z_mode="mean")
    for name, fed in (("numpy", main_cutouts), ("cpu_tensor", torch.as_tensor(main_cutouts))):
        got = fwd2(fed)
        if not all(torch.equal(a.to("cuda"), b) for a, b in zip(got, q2)):
            raise AssertionError(f"the sharded int8 forward fed {name} stamps differs from the card-fed one")
        fan[f"int8_{name}_device"] = str(got[0].device)
    fan.update(int8_max_rel_err=q_err, int8_launches=q_counts["int8_conv"], stamps=int(len(main_cutouts)))
    out["batch_fanout"] = fan

    # one data-parallel training step at 2 shards against the single-device step
    shipped = dt.load_deblender("sim_demo", device="cpu")
    variables = flax_from_state_dict(shipped.state_dict(), shipped.cfg)
    tcfg = dt.TrainConfig(batch_size=TRAIN_BATCH)
    x = torch.as_tensor(main_cutouts[:TRAIN_BATCH], device="cuda")
    steps = {}
    for name, step in (("single", tt.make_train_step(tcfg)), ("mesh2", make_sharded_train_step(mesh2, tcfg))):
        state = tt.create_train_state(dt.DeblenderVAE(), tcfg, variables=variables, device="cuda")
        state, terms = step(state, x, x)
        torch.cuda.synchronize()
        first = ({k: v.detach().clone() for k, v in state.module.state_dict().items()},
                 {k: float(v) for k, v in terms.items()})
        # warm steps from there (not compared)
        secs = [timed(lambda: step(state, x, x))[1] for _ in range(3)]
        steps[name] = first + (float(np.median(secs)),)
    term_err = {k: abs(steps["mesh2"][1][k] / steps["single"][1][k] - 1) for k in steps["single"][1]}
    if max(term_err.values()) > 1e-5:
        raise AssertionError(f"a data-parallel step's terms differ from the single-device step's: {term_err}")
    a = {k: v.double() for k, v in steps["mesh2"][0].items()}
    b = {k: v.double() for k, v in steps["single"][0].items()}
    n_all = sum(v.numel() for v in b.values())
    n_off = sum(int(((a[k] - v).abs() > 1e-6).sum()) for k, v in b.items())
    if n_off > 1e-3 * n_all:
        raise AssertionError(f"a data-parallel step moved {n_off} of {n_all} parameters off the single-device step's")
    out["training_step"] = {"batch": TRAIN_BATCH, "terms_max_rel_err": term_err, "params_off_1e-6": n_off,
                            "params": n_all, "single_warm_s": steps["single"][2], "mesh2_warm_s": steps["mesh2"][2]}
    return out, records


CROSS_DIR = Path("chiprun_out") / "cross_process"
# phase 24: each worker's wall limit and its process group's timeout
CROSS_WORKER_TIMEOUT_S = 240
CROSS_GROUP_TIMEOUT_S = 120
CROSS_MESH = [(0, "cuda:0")] * 2 + [(1, "cuda:0")] * 2
CROSS_WARM_STEPS = 5


def cross_process_run(torch, mesh, x, y, w, variables) -> dict:
    """Phase 24's training on ``mesh`` (one process's or each rank's of
    two): three steps on (x, y), an eval step, a weighted step on the first
    30 rows; the terms, the SHA-256 of every tensor of the state, and warm
    step times."""
    import hashlib

    import debvader_tpu_torch as dt
    from debvader_tpu_torch.parallel import collectives, create_sharded_train_state, make_sharded_eval_step
    from debvader_tpu_torch.parallel import make_sharded_train_step

    cfg = dt.TrainConfig(batch_size=TRAIN_BATCH)
    state = create_sharded_train_state(dt.DeblenderVAE(), mesh, cfg, variables=variables)
    step = make_sharded_train_step(mesh, cfg)
    x, y, w = (torch.as_tensor(a, device="cuda") for a in (x, y, w))
    terms = {}
    for k in range(3):
        state, t = step(state, x, y)
        terms[f"step{k}"] = {name: float(v) for name, v in t.items()}
    ev = make_sharded_eval_step(mesh, cfg)(state, x, y, torch.Generator(device="cuda").manual_seed(4))
    terms["eval"] = {name: float(v) for name, v in ev.items()}
    state, t = make_sharded_train_step(mesh, cfg, weighted=True)(state, x[:30], y[:30], w)
    terms["weighted_30"] = {name: float(v) for name, v in t.items()}
    tensors = {f"module/{k}": v for k, v in state.module.state_dict().items()}
    tensors.update({f"mu/{k}": v for k, v in state.mu.items()})
    tensors.update({f"nu/{k}": v for k, v in state.nu.items()})
    digests = {k: hashlib.sha256(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
               for k, v in sorted(tensors.items())}
    def seconds(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    secs = seconds(lambda: step(state, x, y), CROSS_WARM_STEPS)
    # the step's reduction alone: every shard's gradient-sized list of
    # tensors (the Adam moments stand in for it) summed in shard order
    moments = list(state.mu.values())
    psum_secs = seconds(lambda: collectives.psum({i: moments for i in mesh.local_shards}, mesh, mesh.device), 3)
    return {"terms": terms, "digests": digests, "warm_step_ms": [1e3 * v for v in secs],
            "median_warm_step_ms": 1e3 * float(np.median(secs)),
            "gradient_psum_ms": [1e3 * v for v in psum_secs]}


def gloo_cuda_probe(torch) -> dict:
    """Which gloo collectives take CUDA tensors as they are: each tried
    on a small tensor of the card (every rank tries the same ones)."""
    import torch.distributed as dist

    out = {}
    for op in ("all_gather", "broadcast"):
        t = torch.full((4,), float(dist.get_rank() + 1), device="cuda")
        try:
            if op == "all_gather":
                got = [torch.empty_like(t) for _ in range(dist.get_world_size())]
                dist.all_gather(got, t)
                ok = [float(g[0]) for g in got] == [float(r + 1) for r in range(dist.get_world_size())]
            else:
                dist.broadcast(t, src=1)
                ok = float(t[0]) == 2.0
            out[op] = {"takes_cuda": True, "right": bool(ok)}
        except RuntimeError as e:
            out[op] = {"takes_cuda": False, "right": False, "error": str(e)[:300]}
    return out


def cross_process_worker(rank: int) -> int:
    """One rank of phase 24, started by the script itself."""
    import torch

    import debvader_tpu_torch as dt
    from debvader_tpu_torch.parallel import initialize_distributed, make_mesh
    from debvader_tpu_torch.weights import flax_from_state_dict

    initialize_distributed(f"file://{(CROSS_DIR / 'store').resolve()}", 2, rank, backend="gloo",
                           timeout=CROSS_GROUP_TIMEOUT_S)
    probe = gloo_cuda_probe(torch)
    mesh = make_mesh(devices=CROSS_MESH)
    with np.load(CROSS_DIR / "batch.npz") as z:
        x, y, w = z["x"], z["y"], z["w"]
    shipped = dt.load_deblender("sim_demo", device="cpu")
    run = cross_process_run(torch, mesh, x, y, w, flax_from_state_dict(shipped.state_dict(), shipped.cfg))
    try:
        dt.DeblendField(shipped, np.zeros((1, 128, 128, 6), np.float32), mesh=mesh, device="cuda")
    except ValueError as e:
        run["serving_refused"] = str(e)
    run.update(rank=rank, gloo_cuda=probe, mesh=repr(mesh), local_shards=mesh.local_shards)
    (CROSS_DIR / f"rank{rank}.json").write_text(json.dumps(run))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def run_cross_process(torch) -> dict:
    """Phase 24 (module docstring)."""
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.data.simulate import make_dataset
    from debvader_tpu_torch.parallel import make_mesh
    from debvader_tpu_torch.weights import flax_from_state_dict

    shutil.rmtree(CROSS_DIR, ignore_errors=True)
    CROSS_DIR.mkdir(parents=True)
    (xd, yd), _ = make_dataset(0, n_train=650, n_val=128)["deblender"]
    x, y = xd[:TRAIN_BATCH], yd[:TRAIN_BATCH]
    w = np.random.default_rng(7).uniform(0.0, 2.0, size=30).astype(np.float32)
    w[3] = 0.0
    np.savez(CROSS_DIR / "batch.npz", x=x, y=y, w=w)
    shipped = dt.load_deblender("sim_demo", device="cpu")
    single = cross_process_run(torch, make_mesh(devices=["cuda:0"] * 4), x, y, w,
                               flax_from_state_dict(shipped.state_dict(), shipped.cfg))
    t0 = time.perf_counter()
    procs = []
    for rank in (0, 1):
        log = open(CROSS_DIR / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--cross-process-worker",
                                        str(rank)], stdout=log, stderr=subprocess.STDOUT), log))
    rcs = []
    try:
        for proc, _ in procs:
            rcs.append(proc.wait(timeout=max(CROSS_WORKER_TIMEOUT_S - (time.perf_counter() - t0), 1)))
    except subprocess.TimeoutExpired:
        rcs.append(None)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            log.close()
    workers_s = time.perf_counter() - t0
    for rank, rc in enumerate(rcs + [None] * (2 - len(rcs))):
        if rc != 0:
            tail = (CROSS_DIR / f"rank{rank}.log").read_text()[-3000:]
            raise AssertionError(f"phase 24: worker {rank} exited {rc} (None: killed at its wall limit):\n{tail}")
    ranks = [json.loads((CROSS_DIR / f"rank{r}.json").read_text()) for r in (0, 1)]
    for r in ranks:
        if r["terms"] != single["terms"]:
            raise AssertionError(f"phase 24: rank {r['rank']}'s terms differ from the single-process mesh's: "
                                 f"{r['terms']} against {single['terms']}")
        off = [k for k in single["digests"] if r["digests"].get(k) != single["digests"][k]]
        if off or set(r["digests"]) != set(single["digests"]):
            raise AssertionError(f"phase 24: rank {r['rank']}'s state differs from the single-process mesh's in "
                                 f"{len(off)} tensors: {off[:8]}")
        for op, probe in r["gloo_cuda"].items():
            if not (probe["takes_cuda"] and probe["right"]):
                raise AssertionError(f"phase 24: gloo's {op} does not take CUDA tensors as collectives.py needs: {probe}")
        if "reads its results on the host" not in r.get("serving_refused", ""):
            raise AssertionError("phase 24: DeblendField(mesh=) did not refuse the mesh across processes")
    out = {
        "card": nvidia_smi_line(), "mesh": ranks[0]["mesh"], "batch": TRAIN_BATCH, "weighted_batch": 30,
        "tensors_bit_for_bit": len(single["digests"]), "terms": single["terms"],
        "single_process_4_shards_warm_step_ms": single["median_warm_step_ms"],
        "two_processes_warm_step_ms": [r["median_warm_step_ms"] for r in ranks],
        "warm_steps": {"single": single["warm_step_ms"], "rank0": ranks[0]["warm_step_ms"],
                       "rank1": ranks[1]["warm_step_ms"]},
        "gradient_psum_ms": {"single": single["gradient_psum_ms"], "rank0": ranks[0]["gradient_psum_ms"],
                             "rank1": ranks[1]["gradient_psum_ms"]},
        "gloo_cuda": ranks[0]["gloo_cuda"], "local_shards": [r["local_shards"] for r in ranks],
        "serving_refused": ranks[0]["serving_refused"][:160], "workers_s": workers_s,
    }
    for name in ("batch.npz", "rank0.json", "rank1.json", "store"):
        (CROSS_DIR / name).unlink(missing_ok=True)
    return out


def bias_prelu_inputs(torch, shape, dtype, gen, batch: int):
    """(y, bias, alpha) on the card at one layer's shape: y normal with
    NaN, signed zeros, infinities and subnormals seeded in, and the first
    element of each channel of stamp 0 the negated bias (t exactly 0)."""
    c = shape[0]
    y = torch.randn((batch, *shape), generator=gen, device="cuda") * 0.7
    bias = torch.randn(c, generator=gen, device="cuda") * 0.3
    alpha = torch.randn(shape, generator=gen, device="cuda") * 0.4
    specials = torch.tensor([float("nan"), 0.0, -0.0, float("inf"), -float("inf"), 1e-40, -1e-40, 3e-39, -7e-41],
                            device="cuda")
    flat = y.view(-1)
    idx = torch.randint(0, flat.numel(), (4096,), generator=gen, device="cuda")
    flat[idx] = specials[torch.arange(4096, device="cuda") % len(specials)]
    y = y.to(dtype)
    y[0].view(c, -1)[:, 0] = -bias.to(dtype)
    return y, bias, alpha


def bias_prelu_layers(net) -> list:
    """(name, layer, PReLU, crop) of the 18 layers the forward sends
    through the kernel; crop is the (lo, extra) of a transposed conv's
    output view (stride 2: the last row and column cut, stride 1: a
    one-pixel ring), None for a contiguous output."""
    enc, dec = net.encoder, net.decoder
    out = [(f"enc/Conv_{i}", c, a, None) for i, (c, a) in enumerate(zip(enc.convs, enc.prelus))]
    out += [("dec/Dense_0", dec.dense0, dec.prelu0, None), ("dec/Dense_1", dec.dense1, dec.prelu1, None)]
    out += [(f"dec/ConvT_{j}", c, a, (0, 1) if c.stride == 2 else (1, 2))
            for j, (c, a) in enumerate(zip(dec.convts, dec.prelus))]
    return out


def check_bias_prelu_layers(torch, bp, net, batch: int = 4096) -> dict:
    """Phase 25: the kernel against its plain version at each layer's
    shape, in both layouts (NCHW, and channels-last as the forward's
    convolutions write it) and, for the transposed convs, as the crop view
    of either, bit for bit (NaN as a class) and in the plain result's
    layout; each layer timed on the forward's own layout (layers.conv_input:
    NCHW-dense in float32, channels-last in bfloat16; cropped for a
    transposed conv) with its bound (bytes: y read and the result written
    once, alpha and the bias read once) and its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows, totals = [], {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, layer, act, crop in bias_prelu_layers(net):
        shape = tuple(act.alpha.shape)
        # the layer's compute dtype: a bfloat16 model's dec/Dense_1 computes
        # in float32 under strict_cast
        ydt = layer.dtype
        y, bias, alpha = bias_prelu_inputs(torch, shape, ydt, gen, batch)
        cases = {"contiguous": y}
        if y.ndim == 4:
            cases["channels_last"] = y.contiguous(memory_format=torch.channels_last)
        if crop is not None:
            lo, extra = crop
            for fmt, tag in ((torch.contiguous_format, "crop_view_nchw"), (torch.channels_last, "crop_view")):
                full = torch.randn((batch, shape[0], shape[1] + extra, shape[2] + extra), generator=gen,
                                   device="cuda").to(ydt).contiguous(memory_format=fmt)
                full[:, :, lo: lo + shape[1], lo: lo + shape[2]] = y
                cases[tag] = full[:, :, lo: lo + shape[1], lo: lo + shape[2]]
        before = bp.bias_prelu.launches + bp.bias_prelu.launches_bf16
        for case, inp in cases.items():
            want = bp.bias_prelu_plain(inp, bias, alpha)
            dense = bp.output_like(inp) is inp
            got = bp.bias_prelu(inp.clone(memory_format=torch.preserve_format) if dense else inp, bias, alpha)
            torch.cuda.synchronize()
            if got.stride() != want.stride() or not bits_equal(torch, got, want):
                nan = torch.isnan(want)
                diff = int(((got != want) & ~nan).sum()) + int((torch.isnan(got) != nan).sum())
                raise AssertionError(f"bias_prelu {name} {ydt} {case}: {diff} elements differ from the plain "
                                     f"version (strides {got.stride()} and {want.stride()})")
            del want, got
        launched = bp.bias_prelu.launches + bp.bias_prelu.launches_bf16 - before
        if launched != len(cases):
            raise AssertionError(f"bias_prelu {name}: {launched} launches for {len(cases)}")
        nchw = ydt != torch.bfloat16
        key = next(k for k in (("crop_view_nchw", "contiguous") if nchw else ("crop_view", "channels_last", "contiguous"))
                   if k in cases)
        x = cases[key]
        nbytes = 2 * y.numel() * y.element_size() + 4 * alpha.numel() + 4 * bias.numel()
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ms = cuda_ms(torch, lambda: bp.bias_prelu(x, bias, alpha))
        device_ms = profiled_device_ms(torch, lambda: bp.bias_prelu(x, bias, alpha), "bias_prelu")
        plain_ms = cuda_ms(torch, lambda: bp.bias_prelu_plain(x, bias, alpha), reps=5, warmup=1)
        rows.append({"layer": name, "shape": [batch, *shape], "dtype": str(ydt).split(".")[-1],
                     "input": key if y.ndim == 4 else "dense",
                     "cases": list(cases), "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bytes": nbytes,
                     "roofline_share": bound_ms / device_ms if device_ms else None})
        totals["ms"] += ms
        totals["device_ms"] += device_ms or float("nan")
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += bound_ms
        del y, cases, x
    torch.cuda.empty_cache()
    return {"layers": rows, "batch": batch, **totals}


def run_bias_prelu(torch, cutouts: np.ndarray) -> tuple[list, dict]:
    """Phase 25: the kernel at every layer's shape (check_bias_prelu_layers),
    then the stamp forward of four models on a 4,096-stamp batch built from
    the real stamps (each tiled with fresh noise) through
    ``api.deblend_tensor`` under no_grad, the benchmark's entry, its
    launches counted (18 a forward), torch.equal to the plain composition:
    the same forward recorded by autograd (the input requiring a gradient,
    as in training), which launches none, calibrated as deblend_tensor
    calibrates; the kernel route timed and profiled once; an artifact
    exported on the card bit for bit the live model on the batch's first
    295 stamps.  Each forward also counts conv2d_same's TF-SAME pads by
    route and is set beside the same forward with every pad copied, and
    counts its convolutions' inputs by layout (layers.conv_input), the
    recorded forward's the same; then the float32 forward's 17
    convolutions in both layouts (conv_layout_rows) and its whole forward
    with the layout rule against without, and with cuDNN's deterministic
    algorithms on against off (forward_layouts_and_determinism)."""
    import torch.nn.functional as F

    import debvader_tpu_torch as dt
    from debvader_tpu_torch.api import _guard, deblend_tensor
    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.kernels import bias_prelu as bp
    from debvader_tpu_torch.models import layers as model_layers
    from debvader_tpu_torch.models.distributions import PixelNormal
    from debvader_tpu_torch.utils import export as ex
    from debvader_tpu_torch.utils.flux_cal import apply_flux_calibration

    nets = {
        "float32": dt.load_deblender("sim_demo", device="cuda"),
        "bfloat16": dt.load_deblender("sim_demo", device="cuda", dtype="bfloat16"),
        "float32_subpixel": dt.load_deblender("sim_demo", device="cuda", cfg=dt.ModelConfig(decoder_subpixel=True)),
        "bfloat16_f32_stages_2": dt.load_deblender("sim_demo", device="cuda", dtype="bfloat16",
                                                   decoder_f32_stages=2),
    }
    layers = {"float32": check_bias_prelu_layers(torch, bp, nets["float32"]),
              "bfloat16": check_bias_prelu_layers(torch, bp, nets["bfloat16"])}

    rng = np.random.default_rng(25)
    pick = rng.integers(0, len(cutouts), 4096)
    x = torch.as_tensor(cutouts[pick] + rng.normal(0, 0.02, (4096, *cutouts.shape[1:])).astype(np.float32),
                        device="cuda")

    def launched():
        return bp.bias_prelu.launches + bp.bias_prelu.launches_bf16

    def padded():
        return model_layers.conv2d_same.in_conv, model_layers.conv2d_same.pad_copies

    def laid_out():
        c = model_layers.conv_input
        return c.nchw, c.channels_last, c.copies

    def layout_count(run):
        """run()'s result and its convolutions' inputs by layout."""
        before = laid_out()
        got = run()
        return got, dict(zip(("nchw", "channels_last", "copies"), (a - b for a, b in zip(laid_out(), before))))

    # NCHW-dense float32, channels-last bfloat16; the copies the rule adds
    # (a cast to float32 lays out in the same copy)
    want_layouts = {"float32": (17, 0, 2), "bfloat16": (0, 17, 0), "float32_subpixel": (17, 0, 2),
                    "bfloat16_f32_stages_2": (5, 12, 0)}

    def explicit_pad(xx, w, stride, b=None):
        """conv2d_same as it was: every SAME pad materialised with F.pad."""
        k = w.shape[-1]
        lo_h, hi_h = model_layers.tf_same_pads(xx.shape[-2], k, stride)
        lo_w, hi_w = model_layers.tf_same_pads(xx.shape[-1], k, stride)
        return F.conv2d(F.pad(xx, (lo_w, hi_w, lo_h, hi_h)), w, b, stride=stride)

    def explicit_pad_served(net):
        """The served forward with conv2d_same patched back to explicit_pad."""
        kept = model_layers.conv2d_same
        model_layers.conv2d_same = explicit_pad
        try:
            return served(net)()
        finally:
            model_layers.conv2d_same = kept

    def served(net, stamps=x):
        def run():
            with torch.no_grad():
                return deblend_tensor(net, stamps, z_mode="mean")
        return run

    def recorded(net, stamps=x):
        """The layers' ops: the forward that autograd records (the stamps
        guarded as deblend_tensor guards them), detached."""
        before = launched()
        with torch.enable_grad(), fp32_math():
            dist, _ = net(_guard(stamps, False).detach().requires_grad_(), z_mode="mean")
            dist = PixelNormal(dist.loc.detach(), dist.scale.detach())
        if launched() != before:
            raise AssertionError("bias_prelu: a forward that autograd records launched the kernel")
        return apply_flux_calibration(dist, net)

    forward_rows = {}
    for name, net in nets.items():
        before, pads_before = launched(), padded()
        got, layouts = layout_count(served(net))
        torch.cuda.synchronize()
        launches = launched() - before
        if tuple(layouts.values()) != want_layouts[name]:
            raise AssertionError(f"conv_input, {name}: {layouts} a forward, {want_layouts[name]} expected")
        if launches != 18:
            raise AssertionError(f"bias_prelu route, {name}: {launches} launches a forward, 18 expected")
        # the SAME pads: seven symmetric ones inside the convolution (six
        # where the sub-pixel head packs its own), enc/Conv_3's and
        # enc/Conv_7's (0, 1) copied
        pads = dict(zip(("in_conv", "pad_copies"), (a - b for a, b in zip(padded(), pads_before))))
        want_pads = {"in_conv": 6 if net.cfg.decoder_subpixel else 7, "pad_copies": 2}
        if pads != want_pads:
            raise AssertionError(f"conv2d_same, {name}: {pads} a forward, {want_pads} expected")
        # the same forward with every pad materialised, as before the
        # padding went inside the convolution: reported, not held (cuDNN
        # may choose another algorithm for the unpadded shapes)
        old = explicit_pad_served(net)
        pad_route_gap = {"loc": artifact_equal(got.loc, old.loc), "scale": artifact_equal(got.scale, old.scale),
                         "bit_equal": bool(torch.equal(got.loc, old.loc) and torch.equal(got.scale, old.scale))}
        del old
        torch.cuda.empty_cache()
        want, recorded_layouts = layout_count(lambda: recorded(net))
        torch.cuda.empty_cache()
        if recorded_layouts != layouts:
            raise AssertionError(f"conv_input, {name}: the recorded forward's layouts {recorded_layouts}, "
                                 f"the served one's {layouts}")
        equal = {"loc": bool(torch.equal(got.loc, want.loc)), "scale": bool(torch.equal(got.scale, want.scale))}
        if not all(equal.values()):
            d = float((got.loc - want.loc).abs().max())
            raise AssertionError(f"bias_prelu route, {name}: the forward differs from the plain composition "
                                 f"({equal}, loc by {d})")
        del got, want
        ms = [cuda_ms(torch, served(net), reps=5, warmup=1) for _ in range(2)]
        prof = profile_run(torch, served(net))
        forward_rows[name] = {
            "stamps": int(x.shape[0]), "launches": launches, "equal": equal, "same_pads": pads, "layouts": layouts,
            "pad_route_gap": pad_route_gap,
            "ms": float(np.median(ms)), "ms_runs": ms, "device_kernels": prof["device_kernels"],
            "device_busy_ms": prof["device_busy_ms"], "top_device_events": prof["top_device_events"][:8],
        }

    # an artifact exported on the card traces the ops and runs them: held
    # to the live model as phase 21 holds it, and read against the plain
    # composition too
    net = nets["float32"]
    blob = ex.export_deblender(net, z_mode="mean")
    call = ex.load_exported(blob)
    x295 = x[:295].clone()
    eps = torch.zeros((295, net.cfg.latent_dim), device="cuda")
    with torch.no_grad(), fp32_math():
        art = call(x295, eps)
    live, plain = served(net, x295)(), recorded(net, x295)
    artifact = {"loc": artifact_equal(art[0], live.loc), "scale": artifact_equal(art[1], live.scale),
                "bit_equal": bool(torch.equal(art[0], live.loc) and torch.equal(art[1], live.scale)),
                "live_bit_equal_plain": bool(torch.equal(live.loc, plain.loc) and torch.equal(live.scale, plain.scale)),
                "plain_bit_equal_artifact": bool(torch.equal(art[0], plain.loc) and torch.equal(art[1], plain.scale))}
    if not artifact["live_bit_equal_plain"] or any(
            artifact[k]["max_abs_err"] > ARTIFACT_TOL * artifact[k]["scale"] for k in ("loc", "scale")):
        raise AssertionError(f"bias_prelu: the artifact against the live model: {artifact}")

    records = []
    for dtype, rec in layers.items():
        records.append({
            "name": "bias_prelu" + ("_bf16" if dtype == "bfloat16" else ""), "route": "stamp forward",
            "source": "csrc/bias_prelu.cu", "replaces": "none: XLA fuses the bias and PReLU into the convolutions",
            "launches": None, "max_abs_err": 0.0, "ms": rec["ms"], "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": "bytes", "library_ms": None,
        })
    conv_layouts = conv_layout_rows(torch, bp, nets["float32"])
    forward_layouts = forward_layouts_and_determinism(torch, nets["float32"], x)
    return records, {"layers": layers, "forward": forward_rows, "artifact": artifact, "conv_layouts": conv_layouts,
                     "forward_layouts": forward_layouts}


def conv_layout_rows(torch, bp, net, batch: int = 4096) -> dict:
    """Phase 25 and ``--conv-layouts``: each of the float32 forward's 17
    convolutions (enc/Conv_0-7, dec/ConvT_0-7, the band head) at ``batch``
    stamps inside fp32_math, its input NCHW-dense and channels-last: the
    convolution without its bias, as the one-pass route runs it (median ms
    between CUDA events; the kernels cuDNN ran and their device ms from
    one profiled call; the two outputs bit for bit or not), and for the
    transposed convs the one-pass bias and PReLU on the output's crop
    view in either layout."""
    from debvader_tpu_torch.device import fp32_math
    from debvader_tpu_torch.models import layers as model_layers

    enc, dec = net.encoder, net.decoder
    convs = [(f"enc/Conv_{i}", c, a) for i, (c, a) in enumerate(zip(enc.convs, enc.prelus))]
    convs += [(f"dec/ConvT_{j}", c, a) for j, (c, a) in enumerate(zip(dec.convts, dec.prelus))]
    convs.append(("dec/Conv_0", dec.head, None))
    shapes = {}

    def caught(name):
        def hook(module, args):
            shapes[name] = tuple(args[0].shape[1:])
        return hook

    hooks = [layer.register_forward_pre_hook(caught(name)) for name, layer, _ in convs]
    with torch.no_grad(), fp32_math():
        net(torch.zeros((1, net.cfg.stamp_size, net.cfg.stamp_size, net.cfg.nb_of_bands), device="cuda"),
            z_mode="mean")
    for h in hooks:
        h.remove()
    gen = torch.Generator(device="cuda").manual_seed(28)
    layouts = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}
    rows, totals = [], {f"{k}_{t}": 0.0 for k in layouts for t in ("ms", "bias_prelu_ms")}
    for name, layer, act in convs:
        transposed = isinstance(layer, model_layers.ConvTranspose2dTF)
        conv = model_layers.conv_transpose2d_tf if transposed else model_layers.conv2d_same
        w, stride = layer.weight.detach(), layer.stride
        x = torch.randn((batch, *shapes[name]), generator=gen, device="cuda")
        row, outs = {"layer": name, "in_shape": [batch, *shapes[name]]}, {}
        for tag, fmt in layouts.items():
            xx = x.contiguous(memory_format=fmt)
            with torch.no_grad(), fp32_math():
                ms = cuda_ms(torch, lambda: conv(xx, w, stride), reps=10, warmup=2)
                prof = profile_run(torch, lambda: conv(xx, w, stride))
                outs[tag] = y = conv(xx, w, stride)
            row[tag] = {"ms": ms, "kernels": [(e["name"], e["device_ms"]) for e in prof["top_device_events"][:6]],
                        "out_strides": list(y.stride())}
            totals[f"{tag}_ms"] += ms
            if transposed:
                bias, alpha = layer.bias.detach(), act.alpha.detach()
                row[tag]["bias_prelu_ms"] = bp_ms = cuda_ms(torch, lambda: bp.bias_prelu(y, bias, alpha))
                totals[f"{tag}_bias_prelu_ms"] += bp_ms
            del xx, y
        row["bit_equal"] = bool(torch.equal(outs["nchw"], outs["channels_last"]))
        rows.append(row)
        del x, outs
        torch.cuda.empty_cache()
    return {"batch": batch, "layers": rows, **totals}


def forward_layouts_and_determinism(torch, net, x, pairs: int = 3) -> dict:
    """Phase 25 and ``--conv-layouts``: the float32 forward through
    api.deblend_tensor on the batch x, timed in ``pairs`` turns (median ms
    of 5 calls between CUDA events, the order alternating from pair to
    pair): with layers.conv_input's layout rule against a cast-only
    conv_input, which hands every convolution its input as it comes
    (channels-last, the forward's layout before the rule); and with
    cuDNN's deterministic algorithms on against off
    (device._CUDNN_DETERMINISTIC, which only this script sets).  For each:
    every setting's median ms, the median of the pairs' ratios, the
    kernels of one profiled call, and whether the two outputs are bit for
    bit equal."""
    from debvader_tpu_torch import device as dv
    from debvader_tpu_torch.api import deblend_tensor
    from debvader_tpu_torch.models import layers as model_layers

    rule = model_layers.conv_input

    def cast_only(xx, dtype, param):
        return xx.to(param.dtype if dtype == torch.float32 else dtype)

    def layout(tag):
        model_layers.conv_input = rule if tag == "nchw" else cast_only

    def determinism(tag):
        dv._CUDNN_DETERMINISTIC = tag == "on"

    def run():
        with torch.no_grad():
            return deblend_tensor(net, x, z_mode="mean")

    out = {}
    try:
        for what, tags, setter in (("layout", ("nchw", "channels_last"), layout),
                                   ("cudnn_deterministic", ("on", "off"), determinism)):
            ms, dists, kernels = {t: [] for t in tags}, {}, {}
            for t in tags:
                setter(t)
                dists[t] = run()
                prof = profile_run(torch, run)
                kernels[t] = {"device_kernels": prof["device_kernels"], "device_busy_ms": prof["device_busy_ms"],
                              "top": [(e["name"], e["device_ms"]) for e in prof["top_device_events"][:10]]}
            for i in range(pairs):
                for t in (tags if i % 2 == 0 else tags[::-1]):
                    setter(t)
                    ms[t].append(cuda_ms(torch, run, reps=5, warmup=1))
            a, b = tags
            out[what] = {
                **{t: {"median_ms": float(np.median(v)), "ms": v, **kernels[t]} for t, v in ms.items()},
                f"median_{b}_over_{a}": float(np.median(np.array(ms[b]) / np.array(ms[a]))),
                "bit_equal": bool(torch.equal(dists[a].loc, dists[b].loc)
                                  and torch.equal(dists[a].scale, dists[b].scale)),
                "pairs": pairs,
            }
            layout("nchw")
            determinism("on")
            del dists
            torch.cuda.empty_cache()
    finally:
        layout("nchw")
        determinism("on")
    return out


def print_conv_layouts(table: dict, forward: dict, smi: str) -> None:
    """The conv_layouts and stamp_forward_layouts lines and a row a layer."""
    print(json.dumps({"conv_layouts": {k: v for k, v in table.items() if k != "layers"},
                      "stamp_forward_layouts": forward}))
    for r in table["layers"]:
        a, b = r["nchw"], r["channels_last"]
        print(f"  {r['layer']:11s} {str(r['in_shape']):22s} nchw {a['ms']:.3f} ms, channels-last {b['ms']:.3f} ms"
              + (f"; bias_prelu {a['bias_prelu_ms']:.3f} / {b['bias_prelu_ms']:.3f} ms" if "bias_prelu_ms" in a
                 else "") + f"; bit for bit {r['bit_equal']}")
        for tag in ("nchw", "channels_last"):
            print(f"    {tag:13s} " + "; ".join(f"{n[:90]} {ms:.3f}" for n, ms in r[tag]["kernels"]))
    print(f"float32 forward at {table['batch']} stamps on {smi}: conv_input's NCHW "
          f"{forward['layout']['nchw']['median_ms']:.2f} ms, channels-last "
          f"{forward['layout']['channels_last']['median_ms']:.2f} ms; cuDNN deterministic on "
          f"{forward['cudnn_deterministic']['on']['median_ms']:.2f} ms, off "
          f"{forward['cudnn_deterministic']['off']['median_ms']:.2f} ms")


def conv_layouts_main(out: str | None = None) -> int:
    """``python3 chip_smoke.py --conv-layouts [OUT]``: phase 25's layout
    table and forward timings alone, on seeded blended stamps (4,096 of
    them), printed, and written as JSON to the path OUT when given."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.data.simulate import simulate_batch
    from debvader_tpu_torch.kernels import bias_prelu as bp

    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")
    net = dt.load_deblender("sim_demo", device="cuda")
    x = torch.as_tensor(simulate_batch(np.random.default_rng(28), 4096)[0], device="cuda")
    table = conv_layout_rows(torch, bp, net)
    forward = forward_layouts_and_determinism(torch, net, x)
    print_conv_layouts(table, forward, smi)
    if out:
        Path(out).write_text(json.dumps({"card": smi, "table": table, "forward": forward}, indent=1))
    return 0


def stamp_mask(field_size: int, centers: np.ndarray, size: int = 59) -> np.ndarray:
    """True inside the size x size window of each source, clipped to the field."""
    mask = np.zeros((field_size, field_size), bool)
    half = field_size // 2
    for cy, cx in np.trunc(centers).astype(int):
        y0, x0 = cy + half - size // 2, cx + half - size // 2
        mask[max(y0, 0) : max(y0 + size, 0), max(x0, 0) : max(x0 + size, 0)] = True
    return mask


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import debvader_tpu_torch  # noqa: F401  (fails outside the repo)
    from debvader_tpu_torch.kernels import _build
    from debvader_tpu_torch.kernels import bias_prelu as bp
    from debvader_tpu_torch.kernels import clipped_stats as cs
    from debvader_tpu_torch.kernels import detect_fused as df
    from debvader_tpu_torch.kernels import int8_conv as ic
    from debvader_tpu_torch.kernels import label_select as ls
    from debvader_tpu_torch.kernels import matched_filter as mf
    from debvader_tpu_torch.kernels import parent_race as pr
    from debvader_tpu_torch.kernels import registration as kr
    from debvader_tpu_torch.kernels import render as rd

    report = {}
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {smi}")
    report["card"] = smi
    # each phase's wall seconds, the build's included
    phase_s, clock = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phase_s[name], clock[0] = now - clock[0], now


    t = time.perf_counter()
    logs = _build.build_all()
    report["build_s"] = time.perf_counter() - t
    report["ptxas"] = logs
    print(f"built {sorted(logs)} in {report['build_s']:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    mark("build")

    field = make_field()
    records = check_kernels(torch, field[0, :, :, 2])
    records += check_filter_and_render(torch, field[0, :, :, 2])
    print("kernels match their plain versions")
    by_name = {r["name"]: r for r in records}
    print(json.dumps({"clipped_stats_edge_boxes": by_name["clipped_stats"]["edge_boxes"],
                      "render_path_cases": by_name["render"]["path_cases"]}))
    cases = check_detect_label_cases(torch, df, ls, field[0, :, :, 2])
    report["detect_label_cases"] = cases
    print(json.dumps({"detect_label_cases": cases}))
    race, chain = check_chain_cases(torch, field[0, :, :, 2])
    records.append(race)
    report["chain_cases"] = chain
    print(json.dumps({"chain_cases": chain}))
    place = check_place(torch, field.shape[1])
    records.append(place)
    print(json.dumps({"place_cases": place["cases"], "place_library_max_abs_err": place["library_max_abs_err"]}))
    mark("kernels_vs_plain")

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
    # each kernel's launch count: (its wrapper, the attribute it adds to)
    counters = {
        "clipped_stats": (cs.sigma_clipped_stats, "launches"),
        "detect_fused": (df.matched_filter_parents, "launches"),
        "label_select": (ls.label_fixpoint, "launches"),
        "matched_filter": (mf.matched_filter_threshold, "launches"),
        "parent_race": (pr.parent_race_kernel, "launches"),
        "render": (rd.render_field_kernel, "launches"),
        "place": (rd.place_patches, "launches"),
        "registration": (kr.register_windowed, "launches"),
        "render_bf16": (rd.render_field_kernel, "launches_bf16"),
        "place_bf16": (rd.place_patches, "launches_bf16"),
        "int8_conv": (ic.conv_fused, "launches"),
        "int8_quant_act": (ic.quant_act, "launches"),
        "int8_bn_quant": (ic.bn_quant, "launches"),
        "int8_bias_prelu_quant": (ic.bias_prelu_quant, "launches"),
        "int8_conv_s8": (ic.conv_s8, "launches"),
        "int8_conv_bf16_conv": (ic.conv_fused, "launches_bf16_conv"),
        "int8_conv_bf16_dense": (ic.conv_fused, "launches_bf16_dense"),
        "int8_conv_bf16_convT": (ic.conv_fused, "launches_bf16_convT"),
        "int8_bn_quant_bf16": (ic.bn_quant, "launches_bf16"),
        "int8_bias_prelu_quant_bf16": (ic.bias_prelu_quant, "launches_bf16"),
        "bias_prelu": (bp.bias_prelu, "launches"),
        "bias_prelu_bf16": (bp.bias_prelu, "launches_bf16"),
    }

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts(path, needed):
        counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        for name, least in needed.items():
            if counts[name] < least:
                raise AssertionError(
                    f"kernel {name} was launched {counts[name]} times on the {path} path, expected >= {least}"
                )
        return counts

    reset_counts()
    centers, res, residual, times = run_main_path(torch, net, field, "cuda")
    # the stamp forward: the one-pass bias and PReLU after each of its 18
    # layers, once a forward chunk
    forwards = -(-len(centers) // dt.PipelineConfig().source_chunk)
    launches = read_counts("record-array", {"clipped_stats": 1, "detect_fused": 1, "label_select": 1, "place": 1,
                                            "bias_prelu": 18 * forwards})
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

    # the order-3 render adds in source order: two residuals of one record
    # array are bit-identical
    again = dt.DeblendField(net, field, z_mode="mean", device="cuda")
    again.deblend_field(centers)
    first, second = again.get_residual_field(), again.get_residual_field()
    if not np.array_equal(first.view(np.int32), second.view(np.int32)):
        raise AssertionError("two residuals of one record array differ")
    if not np.array_equal(first.view(np.int32), residual.view(np.int32)):
        raise AssertionError("the residual of a second DeblendField differs from the first's")

    # warm runs: stage times, then one profiled run for the device's idle
    # share; and detection at the default threshold for its host cost
    warm = [run_main_path(torch, net, field, "cuda")[3] for _ in range(2)]
    prof = profile_run(torch, lambda: run_main_path(torch, net, field, "cuda"))
    default_runs = []
    for _ in range(2):
        t = time.perf_counter()
        found = dt.detect_objects(field, device="cuda")
        default_runs.append(time.perf_counter() - t)
    default = {"sources": int(len(found)), "detect_s": default_runs,
               "merge": default_merge_times(torch, field[0, :, :, 2], len(found))}
    report.update(warm=warm, profiled_run=prof, default_detection=default)
    print(json.dumps({"warm": warm, "default_detection": default}))
    print(f"profiled warm run: wall {prof['wall_ms']} ms, device busy {prof['device_busy_ms']} ms, "
          f"idle share {prof['device_idle_share']}")
    for r in prof["top_device_events"][:12]:
        print(f"  {r['device_ms']:9.3f} ms  {r['calls']:6d}  {r['name'][:100]}")

    mark("main_path_warm_default_detection")
    # phase 5: the decoder tail on this batch's real tail input, float32
    # and bfloat16
    tails = check_decoder_tail(torch, net, np.stack(list(res.cutout_images)))
    records += tails
    for tail in tails:
        print(json.dumps({tail["name"]: {k: tail[k] for k in (
            "shape", "launches", "max_abs_err", "output_max_abs", "cases_max_abs_err", "ms", "device_ms", "plain_ms",
            "library_ms", "bound_ms") + (("differing_share", "cases_differing_share", "ulp_at_scale",
                                          "control_f32_chain_cast")
                                         if "ulp_at_scale" in tail else ())}}))

    mark("decoder_tail")
    # phase 6: the streaming serving path, counts from 0
    reset_counts()
    dfield, s_centers, catalog, s_residual, s_model, s_fields, s_times = run_serving_path(torch, net, field, "cuda")
    serving_launches = read_counts(
        "streaming", {"clipped_stats": 1, "label_select": 1, "matched_filter": 1, "parent_race": 1, "render": 3,
                      "bias_prelu": 18 * -(-len(s_centers) // 128)}
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
    chain_launches = chain_route_launches(torch, field[0, :, :, 2])
    serving["chain_route"] = chain_launches
    print(json.dumps({"chain_route": chain_launches}))

    mark("serving_path")
    # phase 7: the fidelity-precision tail pair on this batch's real
    # dec/ConvT_7 input
    main_cutouts = np.stack(list(res.cutout_images))
    tail3 = check_tail_fused(torch, main_cutouts)
    records.append(tail3)
    print(json.dumps({"tail_fused": {k: tail3[k] for k in (
        "shape", "launches", "err_vs_plain", "err_vs_model_head", "err_border_case", "err_ragged_shape",
        "output_max_abs", "ragged_output_max_abs", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}}))

    mark("tail_fused")
    # phase 8: the fidelity serving path; phase 9: the epistemic path
    fid, fidelity = run_fidelity_path(torch, net, field, centers, catalog, s_residual)
    report["fidelity_path"] = fidelity
    print(json.dumps({"fidelity_path": fidelity}))
    epistemic = run_epistemic_path(torch, net, field, centers, main_cutouts)
    report["epistemic_path"] = epistemic
    print(json.dumps({"epistemic_path": epistemic}))
    mark("fidelity_epistemic")
    determinism = time_cudnn_determinism(torch, net, field, centers)
    report["cudnn_determinism"] = determinism
    print(json.dumps({"cudnn_determinism": determinism}))

    mark("cudnn_determinism")
    # phase 10: a 256^2 crop on the card (TF32 still on outside the port)
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
    # the fidelity model's forward on the crop's stamps, card against CPU
    # with the card's calibration: the limb products are exact on both, so
    # the two differ as the float32 route does
    from debvader_tpu_torch.utils.flux_cal import attach_flux_calibration

    fid_cpu = dt.load_deblender("sim_demo", device="cpu", cfg=fid.cfg)
    attach_flux_calibration(fid_cpu, scale=fid.flux_cal_scale.cpu())
    crop_stamps = np.stack(list(r_cpu.cutout_images))
    f_gpu, _ = dt.deblend(fid, crop_stamps, z_mode="mean", device="cuda")
    f_cpu, _ = dt.deblend(fid_cpu, crop_stamps, z_mode="mean", device="cpu")
    fid_err = float(np.abs(f_gpu - f_cpu).max())
    # the streaming route on the crop: the render kernel on the card
    # against its plain version on the CPU
    sg = run_serving_path(torch, net, crop, "cuda")
    sc = run_serving_path(torch, net_cpu, crop, "cpu")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    if mean_err > 1e-4 * float(np.abs(m_cpu).max()) or resid_err > 1e-4 * float(np.abs(crop).max()):
        raise AssertionError(f"card and CPU disagree on the crop: means {mean_err}, residual {resid_err}")
    if fid_err > 1e-4 * float(np.abs(f_cpu).max()):
        raise AssertionError(f"card and CPU disagree on the fidelity model's forward: {fid_err}")
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
             "streaming_max_abs_err": stream_err, "fidelity_forward_max_abs_err": fid_err,
             "tf32_forward_mean_max_abs_err": float(np.abs(m_tf32 - m_cpu).max()),
             "mean_max_abs": float(np.abs(m_cpu).max())}
    print(json.dumps({"crop_vs_cpu": small}))
    report["crop_vs_cpu"] = small

    mark("crop_vs_cpu")
    # phase 11: the registration kernel on the record-array route's real
    # inputs and its edge cases; phase 12: the bfloat16 canvas instances
    reg = check_registration(torch, field, res)
    records.append(reg)
    print(json.dumps({"registration": {k: reg[k] for k in (
        "shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "full_field_64_ms",
        "full_field_64_bound_ms", "cases")}}))
    bf16_recs = check_bf16_canvases(torch, field.shape[1])
    records += bf16_recs
    for rec in bf16_recs:
        print(json.dumps({rec["name"]: {k: rec.get(k) for k in (
            "shape", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "window_4096", "cases")}}))

    mark("registration_bf16_kernels")
    # phase 13: registration on both routes, counts from 0
    reset_counts()
    reg_routes = run_registration_routes(torch, net, field, centers)
    reg_launches = read_counts("registration", {"registration": 2, "render": 1})
    reg_routes["launches"] = reg_launches
    report["registration_routes"] = reg_routes
    print(json.dumps({"registration_routes": reg_routes}))

    mark("registration_routes")
    # phase 14: bfloat16 residency of the field and the serving canvases,
    # counts from 0
    reset_counts()
    low = run_device_dtype(torch, net, field, centers)
    low_launches = read_counts("bfloat16 residency", {"render_bf16": 1, "place_bf16": 1})
    low["launches"] = low_launches
    report["device_dtype"] = low
    print(json.dumps({"device_dtype": low}))

    mark("device_dtype")
    # phase 15: the iterative deblender, counts from 0
    reset_counts()
    iterative = run_iterative(torch, net, field, lambda: read_counts(
        "iterative", {"clipped_stats": 1, "detect_fused": 1, "label_select": 1, "registration": 1, "place": 1}
    ))
    report["iterative"] = iterative
    print(json.dumps({"iterative": iterative}))

    mark("iterative")
    # phase 16: tiled serving of a 4096^2 field, its counts read in a
    # window of their own; phase 17: iterative serving on the same field
    def count_now():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    big = make_field(**BIG_FIELD)
    mark("make_field_4096")
    tiled, tiled_catalog, (tiled_residual, tiled_centers) = run_tiled(torch, net, big, reset_counts, count_now)
    report["tiled"] = tiled
    print(json.dumps({"tiled": tiled}))
    print("tiled detection stages (first call, warm call):")
    warm = tiled["warm_detect_runs"][-1]
    # the first call's dict holds the whole detect_deblend_render call; the
    # warm calls only detection's stages, and counts are no seconds
    for stage, first in tiled["first_detect_timings_s"].items():
        if stage in warm and not stage.startswith("count."):
            print(f"  {stage:12s} {first:9.4f} s {warm[stage]:9.4f} s")
    mark("tiled")
    iterative_serving = run_iterative_serving(torch, net, big, tiled_catalog, tiled_residual, reset_counts, count_now)
    report["iterative_serving"] = iterative_serving
    print(json.dumps({"iterative_serving": iterative_serving}))
    del tiled_residual
    mark("iterative_serving")
    # phase 18: training at full width
    training = run_training(torch)
    report["training"] = training
    print(json.dumps({"training": training}))
    for bs, rec in training["step_times"].items():
        prof = rec["profiled_5_steps"]
        print(f"training step, {bs}: {rec['median_step_ms']:.3f} ms median alone, {rec['back_to_back_step_ms']:.3f} "
              f"ms back to back, {rec['samples_per_s']:.1f} samples/s, "
              f"peak {rec['peak_device_bytes']} bytes, 5 profiled steps {prof['wall_ms']:.1f} ms wall, "
              f"{prof['device_busy_ms']:.1f} ms device busy (idle share {prof['device_idle_share']:.3f}) on "
              f"{training['card']}")
        for r in prof["top_device_events"]:
            print(f"  {r['device_ms']:9.3f} ms  {r['calls']:6d}  {r['name'][:100]}")
    mark("training")
    # phase 19: int8 quantized serving: the kernels on the layers' real
    # activations, the serving path with its launches counted from 0, QAT
    from debvader_tpu_torch.models import quantized as tq

    qv = tq.load_quantized("sim_demo_int8", device="cuda")
    int8_recs, int8_layers = check_int8_layers(torch, qv, main_cutouts)
    records += int8_recs
    report["int8_layers"] = int8_layers
    print(json.dumps({"int8_layer_groups": int8_layers["groups"], "int8_cases": int8_layers["cases"],
                      "int8_points": int8_layers["points"]}))
    for r in int8_layers["layers"]:
        print(f"  {r['layer']:26s} M {r['M']:7d} N {r['N']:5d} K {r['K']:5d} classes {r['classes']} splits "
              f"{r['splits']}: {r['ms']:.4f} ms (device {r['device_ms']}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.3f} ms, _int_mm {r['library_ms']}, cuDNN f32 "
              f"{r['cudnn_f32_ms']:.4f} ms, unfused chain {r['chain_ms']:.4f} ms (device {r['chain_device_ms']})")
    for r in int8_layers["quantizer"]:
        print(f"  quantizer before {r['before']:26s}: {r['ms']:.4f} ms (device {r['device_ms']}), bound "
              f"{r['bound_ms']:.4f} ms")
    for r in int8_recs:
        if r["name"] in ("int8_bn_quant", "int8_bias_prelu_quant"):
            print(f"  {r['name']} before {r['before']}: {r['ms']:.4f} ms (device {r['device_ms']}), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms")
    quantized = run_quantized(torch, net, field, centers, reset_counts, read_counts)
    int8_launches = quantized["launches"]
    quantized["qat"] = run_qat(torch)
    report["quantized"] = quantized
    print(json.dumps({"quantized": quantized}))
    mark("quantized")
    # phase 20: the model options: the bf16 and sub-pixel forwards, the bf16
    # model on the serving route with its kernels counted from 0
    options = run_model_options(torch, net, field, centers, main_cutouts, reset_counts, read_counts)
    report["model_options"] = options
    print(json.dumps({"model_options": options}))
    for name, r in options["stamp_forward"].items():
        print(f"stamp forward {name}, {r['stamps']} stamps: {r['ms']:.3f} ms (device busy {r['device_busy_ms']:.3f} "
              f"ms), bound {r['bound_ms']:.3f} ms, {r['ms_over_bound']:.2f}x the bound, on {smi}")
    mark("model_options")
    # phase 21: export and the CLI
    exported = run_export_cli(torch, net, field, centers, main_cutouts, reset_counts, read_counts)
    report["export_cli"] = exported
    print(json.dumps({"export_cli": exported}))
    mark("export_cli")
    # phase 22: multi-device on a mesh that repeats the card
    multi, band_recs = run_multi_device(torch, net, big, tiled_centers, field, centers, main_cutouts, qv,
                                        reset_counts, read_counts)
    del big
    records += band_recs
    report["multi_device"] = multi
    print(json.dumps({"multi_device": multi}))
    for order in ("order1", "order3"):
        r = multi["sharded_serve"][order]
        print(f"sharded serve {order}, {r['sources']} sources on {multi['card']}: 4 bands {r['bands4']['warm_s']:.3f} s "
              f"warm ({r['bands4']['first_s']:.3f} s first), 1 band {r['bands1']['warm_s']:.3f} s, single device "
              f"{r['single_device_warm_s']:.3f} s; peak {r['bands4']['device_peak_bytes']} bytes (4 bands) and "
              f"{r['bands1']['device_peak_bytes']} (1 band); per band resident "
              f"{r['bands4']['residency']['per_shard'][0]} bytes")
    r = multi["registered_serve"]
    print(f"registered sharded serve, {r['sources']} sources on {multi['card']}: 4 bands {r['first_s']:.3f} s, single "
          f"device {r['single_device_s']:.3f} s; shifts within {r['shift_max_abs_err_px']} px, residual within "
          f"{r['residual_max_abs_err']}; {r['launches']['registration']} registration launches, 0 full-field")
    for rec in band_recs:
        print(json.dumps({rec["name"]: {k: rec.get(k) for k in (
            "shape", "launches", "max_abs_err", "ms", "device_ms", "plain_ms", "square_ms", "library_ms", "bound_ms",
            "bound_by")}}))
    mark("multi_device")
    # phase 23: the int8 route in bfloat16 (its kernels on the layers' real
    # activations, the serving path with its launches counted from 0) and
    # the reference checkpoint import
    importing = start_checkpoint_import()
    try:
        bf16_int8_recs, quantized_bf16 = run_quantized_bf16(
            torch, net, qv, field, centers, main_cutouts, quantized["flux_rel_err_vs_float"]["mean"], reset_counts,
            read_counts)
    except BaseException:
        stop_cli(importing[1])  # and the failure goes on up
        raise
    records += bf16_int8_recs
    bf16_int8_launches = quantized_bf16["launches"]
    bf16_layers = quantized_bf16.pop("layers")
    report["int8_bf16_layers"] = bf16_layers
    print(json.dumps({"int8_bf16_layer_groups": bf16_layers["groups"], "int8_bf16_cases": bf16_layers["cases"],
                      "int8_bf16_points": bf16_layers["points"]}))
    for r in bf16_layers["layers"]:
        print(f"  bf16 {r['layer']:26s} {r['out'][0]:8s}: {r['ms']:.4f} ms (device {r['device_ms']}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.3f} ms, _int_mm {r['library_ms']}, "
              f"cuDNN bf16 {r['cudnn_bf16_ms']:.4f} ms, unfused chain {r['chain_ms']:.4f} ms")
    for r in bf16_int8_recs:
        print(json.dumps({r["name"]: {k: r.get(k) for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                                            "library_ms", "cudnn_bf16_ms", "layers", "before")}}))
    report["quantized_bf16"] = quantized_bf16
    print(json.dumps({"quantized_bf16": quantized_bf16}))
    imported = run_checkpoint_import(torch, net, main_cutouts, importing)
    report["checkpoint_import"] = imported
    print(json.dumps({"checkpoint_import": imported}))
    mark("int8_bf16_import")
    # phase 24: data-parallel training across two processes of the card
    cross = run_cross_process(torch)
    report["cross_process"] = cross
    print(json.dumps({"cross_process": cross}))
    print(f"cross-process training step, batch {TRAIN_BATCH} on 4 shards of cuda:0: two processes "
          f"{cross['two_processes_warm_step_ms'][0]:.2f} / {cross['two_processes_warm_step_ms'][1]:.2f} ms warm "
          f"(rank 0 / 1), one process {cross['single_process_4_shards_warm_step_ms']:.2f} ms; "
          f"{cross['tensors_bit_for_bit']} tensors bit for bit; on {cross['card']}")
    mark("cross_process")
    # phase 25: the one-pass bias and PReLU of the stamp forward
    bp_recs, bias_prelu = run_bias_prelu(torch, main_cutouts)
    records += bp_recs
    report["bias_prelu"] = bias_prelu
    print(json.dumps({"bias_prelu": {"forward": bias_prelu["forward"], "artifact": bias_prelu["artifact"]}}))
    for dtype, rec in bias_prelu["layers"].items():
        print(f"bias_prelu {dtype}, batch {rec['batch']}: {rec['ms']:.3f} ms a forward's 18 launches (device "
              f"{rec['device_ms']:.3f} ms), bound {rec['bound_ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, on {smi}")
        for r in rec["layers"]:
            print(f"  {r['layer']:12s} {str(r['shape']):24s} {r['input']:10s} {r['ms']:.4f} ms (device "
                  f"{r['device_ms']}), bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms")
    for name, r in bias_prelu["forward"].items():
        print(f"stamp forward {name}, {r['stamps']} stamps through deblend_tensor: {r['ms']:.2f} ms "
              f"({r['device_kernels']} kernels), equal to the recorded forward {r['equal']}; conv inputs "
              f"{r['layouts']}; SAME pads "
              f"{r['same_pads']}; against every pad materialised: bit for bit {r['pad_route_gap']['bit_equal']}, "
              f"loc off by {r['pad_route_gap']['loc']['max_abs_err']:.3g} of "
              f"{r['pad_route_gap']['loc']['scale']:.3g}")
    print_conv_layouts(bias_prelu["conv_layouts"], bias_prelu["forward_layouts"], smi)
    mark("bias_prelu")
    report["phase_s"] = phase_s
    print(json.dumps({"phase_s": phase_s}))

    # launches: the first three kernels on the record-array path, the
    # filter and the render on the streaming path, each counted from 0;
    # the two tails carry their own
    counted_on = dict.fromkeys(("clipped_stats", "detect_fused", "label_select", "place"), launches)
    counted_on.update(dict.fromkeys(("matched_filter", "parent_race", "render"), serving_launches))
    counted_on["registration"] = reg_launches
    counted_on["bias_prelu"] = launches
    counted_on["bias_prelu_bf16"] = options["serving"]["launches"]
    counted_on.update(dict.fromkeys(("render_bf16", "place_bf16"), low_launches))
    counted_on.update(dict.fromkeys(("int8_conv", "int8_quant_act", "int8_bn_quant", "int8_bias_prelu_quant"),
                                    int8_launches))
    counted_on.update(dict.fromkeys(("int8_conv_bf16_conv", "int8_conv_bf16_dense", "int8_conv_bf16_convT",
                                     "int8_bn_quant_bf16", "int8_bias_prelu_quant_bf16"), bf16_int8_launches))
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
    if sys.argv[1:2] == ["--cross-process-worker"]:
        sys.exit(cross_process_worker(int(sys.argv[2])))
    if sys.argv[1:2] == ["--conv-layouts"]:
        sys.exit(conv_layouts_main(sys.argv[2] if len(sys.argv) > 2 else None))
    sys.exit(main())
