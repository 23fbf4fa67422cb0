"""Source detection: SExtractor-equivalent, on the device, in PyTorch.

Port of debvader_tpu.ops.detection, for one field (``detect_sources``) and
for a stack of same-size tiles (``detect_sources_batched``):

1. Background and RMS meshes per 64x64 box: sigma-clipped statistics
   (kernels/clipped_stats.py, one launch for every box of the stack), the
   SExtractor mode estimator (2.5*median - 1.5*mean, the median in crowded
   boxes), empty boxes filled with the median of the others, a 3x3 median
   filter, and the bilinear upsample of ``jax.image.resize``.
2. The device core over the stack, one of two (``_fused_enabled``):
   - the fused core (kernels/detect_fused.py, the default): background
     subtract, 7x7 matched filter, threshold at thresh * globalrms and the
     steepest-ascent parent race in one kernel;
   - the chain ``_chain_core``: the filter as a step of its own, the
     stand-alone kernel (kernels/matched_filter.py, under
     ``use_pallas_filter``, one field) or ``F.conv2d`` (any odd
     ``filter_size``), then the parent race (kernels/parent_race.py).
   Either way label resolution follows over the row-flattened stack
   (kernels/label_select.py).
3. On the device, for the watershed merge, the saddle edges between
   touching segments from the dense label map (``_dense_saddle_edges``).
4. On the host, over the masked pixels only (one device compaction of the
   whole stack, then one download with the edges): the quantized
   multi-threshold merge of watershed segments (deblend_nthresh,
   deblend_cont) or the Lutz tree (``deblend_algo='lutz'``), both in the
   native library (kernels/segmerge.py), then minarea, flux-weighted
   centroids and CLEAN.

``detect_objects`` returns the reference's (N, 2) offsets from the field
centre, round(-int(F/2) + y).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

import dataclasses

from debvader_tpu_torch.config import DetectionConfig
from debvader_tpu_torch.device import fp32_math, resolve_device
from debvader_tpu_torch.kernels.clipped_stats import sigma_clipped_stats
from debvader_tpu_torch.kernels.detect_fused import matched_filter_parents
from debvader_tpu_torch.kernels.label_select import label_fixpoint
from debvader_tpu_torch.kernels.matched_filter import matched_filter_threshold
from debvader_tpu_torch.kernels.parent_race import parent_race_kernel
from debvader_tpu_torch.kernels.segmerge import lutz_deblend, merge_segments
from debvader_tpu_torch.utils.profiling import stage_timer

__all__ = [
    "default_filter_kernel",
    "estimate_background",
    "detect_core_stack",
    "detect_sources",
    "detect_sources_batched",
    "detect_objects",
]

# SExtractor's gauss_3.0_7x7.conv, the matrix the reference hardcodes.
_GAUSS_3_7x7 = np.array(
    [
        [0.004963, 0.021388, 0.051328, 0.068707, 0.051328, 0.021388, 0.004963],
        [0.021388, 0.092163, 0.221178, 0.296069, 0.221178, 0.092163, 0.021388],
        [0.051328, 0.221178, 0.530797, 0.710525, 0.530797, 0.221178, 0.051328],
        [0.068707, 0.296069, 0.710525, 0.951108, 0.710525, 0.296069, 0.068707],
        [0.051328, 0.221178, 0.530797, 0.710525, 0.530797, 0.221178, 0.051328],
        [0.021388, 0.092163, 0.221178, 0.296069, 0.221178, 0.092163, 0.021388],
        [0.004963, 0.021388, 0.051328, 0.068707, 0.051328, 0.021388, 0.004963],
    ],
    dtype=np.float32,
)


def default_filter_kernel(size: int = 7, fwhm: float = 3.0) -> np.ndarray:
    if size == 7 and fwhm == 3.0:
        return _GAUSS_3_7x7
    from scipy.special import erf

    sigma = fwhm / 2.3548200450309493
    r = np.arange(size) - size // 2
    one_d = erf((r + 0.5) / (sigma * np.sqrt(2))) - erf((r - 0.5) / (sigma * np.sqrt(2)))
    g = one_d[:, None] * one_d[None, :]
    return (g / g.max() * 0.951108).astype(np.float32)


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median ((count-1)//2) of the masked values of each row of
    (T, N); 0 for a row with none."""
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=-1).values
    cnt = mask.sum(-1)
    k = torch.clamp((cnt - 1) // 2, min=0)
    med = s.gather(-1, k[:, None])[:, 0]
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median along the last axis: the mean of the two middle values
    for an even count."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _median3x3(mesh: torch.Tensor) -> torch.Tensor:
    """3x3 median filter with edge padding of each mesh of (T, G, G)."""
    g0, g1 = mesh.shape[-2:]
    p = F.pad(mesh[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    stack = torch.stack([p[:, i : i + g0, j : j + g1] for i in range(3) for j in range(3)])
    return torch.sort(stack, dim=0).values[4]


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) bilinear weights as jax.image.resize computes them
    (half-pixel centres, triangle kernel renormalised at the edges)."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv = np.float32(1.0) / scale
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0).astype(np.float32)
    return torch.as_tensor(w, device=device)


def estimate_background(image: torch.Tensor, box: int = 64):
    """(back_map, rms_map, globalback, globalrms) of a 2D field tensor, or
    of each field of a (T, F, F) stack (then each result has the leading
    axis T): the clipped statistics of every box of the stack in one call.

    Non-finite pixels are excluded from the box statistics."""
    single = image.ndim == 2
    xs = image[None] if single else image
    t, f = xs.shape[0], xs.shape[-1]
    finite = torch.isfinite(xs)
    xs = torch.where(finite, xs, torch.zeros((), dtype=xs.dtype, device=xs.device))
    g = -(-f // box)
    pad = g * box - f

    def to_boxes(x):
        x = F.pad(x[:, None], (0, pad, 0, pad), mode="replicate")[:, 0] if pad else x
        return x.reshape(t, g, box, g, box).permute(0, 1, 3, 2, 4).reshape(t, g, g, box * box)

    boxes = to_boxes(xs)
    valid = to_boxes(finite.to(torch.float32))
    mean, med, std = sigma_clipped_stats(boxes, valid)
    has_data = valid.sum(-1) > 0
    mode = 2.5 * med - 1.5 * mean
    crowded = torch.abs(mean - med) > 0.3 * (std + 1e-12)
    back_mesh = torch.where(crowded, med, mode)
    rms_mesh = std

    def fill_gaps(mesh):
        fill = _masked_median(mesh.reshape(t, -1), has_data.reshape(t, -1))
        return torch.where(has_data, mesh, fill[:, None, None])

    back_mesh = _median3x3(fill_gaps(back_mesh))
    rms_mesh = _median3x3(fill_gaps(rms_mesh))

    w = _resize_weights(g, g * box, xs.device)
    with fp32_math():
        back = (w.T @ back_mesh @ w)[:, :f, :f]
        rms = (w.T @ rms_mesh @ w)[:, :f, :f]
    out = back, rms, _median(back_mesh.reshape(t, -1)), _median(rms_mesh.reshape(t, -1))
    return tuple(o[0] for o in out) if single else out


def _threshold_scale(cfg: DetectionConfig) -> float:
    if cfg.threshold_scaling == "matched":
        k = default_filter_kernel(cfg.filter_size, cfg.filter_fwhm)
        return float(np.sqrt(np.sum(np.square(k))))
    return 1.0


def _conv2d_same(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME zero-padded correlation of a 2D image, or of each field of
    (T, F, F), with an odd square kernel, in full float32."""
    pad = kernel.shape[0] // 2
    xs = image[None] if image.ndim == 2 else image
    with fp32_math():
        out = F.conv2d(xs[:, None], kernel[None, None], padding=pad)[:, 0]
    return out[0] if image.ndim == 2 else out


def _fused_enabled(cfg: DetectionConfig) -> bool:
    """Whether the fused detect core runs: never for a filter that is not
    7x7; in auto mode (None) on either device iff ``use_pallas_select``, the
    JAX package's rule; an explicit ``use_pallas_fused`` wins."""
    if cfg.filter_size != 7:
        return False
    if cfg.use_pallas_fused is None:
        return bool(cfg.use_pallas_select)
    return bool(cfg.use_pallas_fused)


def _normalize_batched_cfg(cfg: DetectionConfig) -> DetectionConfig:
    """The JAX package's rule for the batched path: the stand-alone filter
    kernel takes one field, so ``use_pallas_filter`` runs the fused core
    over the stack where the auto mode allows it, and otherwise the chain
    with ``F.conv2d``."""
    if cfg.use_pallas_filter and not _fused_enabled(cfg):
        if cfg.use_pallas_fused is None and cfg.filter_size == 7 and cfg.use_pallas_select:
            return dataclasses.replace(cfg, use_pallas_filter=False, use_pallas_fused=True)
        return dataclasses.replace(cfg, use_pallas_filter=False)
    return cfg


def _labels(cur0: torch.Tensor, dir_code: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each masked pixel's ascent root (per-field flat index), -1
    elsewhere, from the race's (T, F, F) maps: one label resolution over
    the row-flattened stack (parents never leave their field)."""
    t, f, _ = cur0.shape
    roots = label_fixpoint(cur0.reshape(t * f, f), dir_code.reshape(t * f, f)).reshape(t, f, f)
    return torch.where(mask, roots, torch.full_like(roots, -1))


def _chain_core(xs: torch.Tensor, cfg: DetectionConfig):
    """Detection over a (T, F, F) stack with the filter as a step of its
    own: (labels, filt, globalrms), labels (T, F, F) int32 holding each
    masked pixel's ascent root (per-field flat index) and -1 elsewhere.
    ``use_pallas_filter`` (a 7x7 filter) takes a stack of one field: the
    batched path normalises it away (``_normalize_batched_cfg``), and a
    larger stack raises."""
    if cfg.use_pallas_filter and cfg.filter_size == 7 and xs.shape[0] != 1:
        raise ValueError(
            f"use_pallas_filter runs the stand-alone filter kernel on one field, got a stack of "
            f"{xs.shape[0]}; the batched path routes it to the fused core (_normalize_batched_cfg)"
        )
    f = xs.shape[-1]
    back, _, _, grms = estimate_background(xs, box=min(cfg.background_box, f))
    kernel_np = default_filter_kernel(cfg.filter_size, cfg.filter_fwhm)
    thr = cfg.thresh * grms * _threshold_scale(cfg)
    finite = torch.isfinite(xs)
    if cfg.use_pallas_filter and cfg.filter_size == 7:
        # non-finite pixels are set to the background, so they add
        # nothing to the filter
        filt, mask = matched_filter_threshold(torch.where(finite[0], xs[0], back[0]), back[0], kernel_np, thr)
        filt, mask = filt[None], mask[None]
    else:
        fore = torch.where(finite, xs - back, torch.zeros((), dtype=xs.dtype, device=xs.device))
        filt = _conv2d_same(fore, torch.as_tensor(kernel_np, device=xs.device))
        mask = filt > thr[:, None, None]
    dir_code, cur0 = parent_race_kernel(filt, thr)
    return _labels(cur0, dir_code, mask), filt, grms


def _detect_core(image: torch.Tensor, cfg: DetectionConfig):
    """The chain on one 2D band: (labels, filt, globalrms)."""
    labels, filt, grms = _chain_core(image[None], cfg)
    return labels[0], filt[0], grms[0]


def detect_core_stack(xs: torch.Tensor, cfg: DetectionConfig):
    """Fused detect core over a (T, F, F) stack: (labels, filt, globalrms).

    labels (T, F, F) int32 hold each masked pixel's ascent root (per-field
    flat index) and -1 elsewhere."""
    t, f, _ = xs.shape
    back, _, _, grms = estimate_background(xs, box=min(cfg.background_box, f))
    thr = cfg.thresh * grms * _threshold_scale(cfg)
    guarded = torch.where(torch.isfinite(xs), xs, back)
    kernel = default_filter_kernel(cfg.filter_size, cfg.filter_fwhm)
    filt, dir_code, cur0 = matched_filter_parents(guarded, back, kernel, thr)
    return _labels(cur0, dir_code, filt > thr[:, None, None]), filt, grms


def _core(xs: torch.Tensor, cfg: DetectionConfig):
    """The single-field rule (``detect_sources``): the fused core unless
    ``use_pallas_filter`` asks for the stand-alone filter kernel."""
    if _fused_enabled(cfg) and not cfg.use_pallas_filter:
        return detect_core_stack(xs, cfg)
    return _chain_core(xs, cfg)


def _batched_core(xs: torch.Tensor, cfg: DetectionConfig):
    """The batched rule (``detect_sources_batched``, on a normalised cfg):
    the fused core whenever it is enabled, whatever ``use_pallas_filter``
    says, as the JAX package's batched core."""
    if _fused_enabled(cfg):
        return detect_core_stack(xs, cfg)
    return _chain_core(xs, cfg)


def _compact_masked(labels: torch.Tensor, filt: torch.Tensor):
    """One compaction over the whole (T, F, F) stack: each masked pixel's
    global flat index (int64, ascending), label and filtered value.  The
    dynamic shape needs no static capacity and no overflow pass, and int64
    indices do not overflow at 2^31 pixels, so the JAX package's per-tile
    route for such stacks (an int32 limit) is not kept."""
    flat = labels.reshape(-1)
    idx = torch.nonzero(flat >= 0).reshape(-1)
    return idx, flat[idx], filt.reshape(-1)[idx]


# E, S, SE, SW: each undirected 8-neighbour adjacency once
_EDGE_DIRECTIONS = ((0, 1), (1, 0), (1, 1), (1, -1))


def _split_edge_keys(keys, f: int):
    """(t, lo, hi) of ``_dense_saddle_edges``'s keys (a tensor or an int64
    numpy array)."""
    plane = f * f
    return keys // (plane * plane), keys // plane % plane, keys % plane


def _dense_saddle_edges(labels: torch.Tensor, filt: torch.Tensor):
    """The watershed merge's saddle edges over the (T, F, F) stack, on its
    device, from the dense maps before the compaction: (keys int64 (E,),
    heights float32 (E,), pairs int64 0-d tensor).

    A boundary pair is two 8-neighbour pixels of one field, both masked
    (``labels`` >= 0, a segment's per-field flat root index), with
    different labels; shifted views of the maps give the pairs of each
    direction, so none leaves its field.  An edge is a distinct touching
    pair lo < hi, keyed ``(t * F^2 + lo) * F^2 + hi`` (ascending keys are
    in (t, lo, hi) order, the order of the merge's own ``unique``; the
    detection route guards their int64 range for the whole stack), its
    height the highest over the pair's boundary pairs of the smaller
    filtered value; ``pairs`` counts the boundary pairs.  Max is exact and
    independent of order: the edges equal, bit for bit, those the JAX
    package builds on the host from the COO (its ``_saddle_edges_coo``,
    deduplicated in its ``_merge_labels_coo``)."""
    t, f, _ = labels.shape
    plane = f * f
    field = torch.arange(t, dtype=torch.int64, device=labels.device).view(t, 1, 1)
    keys, heights = [], []
    for dy, dx in _EDGE_DIRECTIONS:
        x0, x1 = max(0, -dx), f - max(0, dx)
        a, b = labels[:, : f - dy, x0:x1], labels[:, dy:, x0 + dx : x1 + dx]
        pair = (a >= 0) & (b >= 0) & (a != b)
        a, b = a[pair].long(), b[pair].long()
        keys.append((field.expand(pair.shape)[pair] * plane + torch.minimum(a, b)) * plane + torch.maximum(a, b))
        heights.append(torch.minimum(filt[:, : f - dy, x0:x1][pair], filt[:, dy:, x0 + dx : x1 + dx][pair]))
    keys, heights = torch.cat(keys), torch.cat(heights)
    ukey, inv = torch.unique(keys, sorted=True, return_inverse=True)
    best = torch.full(ukey.shape, float("-inf"), dtype=heights.dtype, device=heights.device)
    return ukey, best.scatter_reduce_(0, inv, heights, "amax"), torch.tensor(len(keys), device=labels.device)


# ----------------------------------------------------------- host postprocess


def _merge_segments_py(ea, eb, eh, peak, flux, order, nthr, thr, cont):
    """The sequential merge loop: weakest peaks first, each segment merges
    into its brightest-saddle neighbour unless a quantization level
    separates its peak from the saddle and its flux is significant.
    Returns the root of every segment.  The plain version of the native
    core (kernels/segmerge.merge_segments), which detection runs; the
    tests hold the two bit for bit."""
    L = len(peak)

    def level(v, island_peak):
        if island_peak <= thr or v <= thr:
            return 0
        x = np.log(v / thr) / np.log(island_peak / thr)
        return int(np.clip(np.floor(x * nthr), 0, nthr))

    parent = np.arange(L)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    incident: list[list[int]] = [[] for _ in range(L)]
    for e in range(len(eh)):
        incident[ea[e]].append(e)
        incident[eb[e]].append(e)

    changed = True
    while changed:
        changed = False
        for r in order:
            r = int(r)
            if parent[r] != r:
                continue
            best_other, best_h = -1, -np.inf
            for e in incident[r]:
                ra, rb = find(int(ea[e])), find(int(eb[e]))
                if ra == rb:
                    continue
                other = rb if ra == r else ra
                if eh[e] > best_h:
                    best_other, best_h = other, eh[e]
            if best_other < 0:
                continue
            if peak[best_other] < peak[r]:
                continue  # only merge into a brighter neighbour
            island_peak = max(peak[r], peak[best_other])
            island_flux = flux[r] + flux[best_other]
            separated = level(peak[r], island_peak) > level(best_h, island_peak)
            significant = flux[r] > cont * island_flux
            if not (separated and significant):
                parent[r] = best_other
                flux[best_other] += flux[r]
                incident[best_other].extend(incident[r])
                incident[r] = []
                changed = True

    return np.fromiter((find(i) for i in range(L)), np.int64, L)


def _merge_labels_coo(idx, lab, val, threshold, cfg: DetectionConfig, edges):
    """SExtractor's quantized deblending criterion on the watershed
    segments of the masked-pixel COO: merges back the splits sep's
    64-level multi-threshold tree would not have made.  ``edges``: the
    field's distinct saddle edges (lo, hi, height) in ascending (lo, hi)
    order, as detection builds them on the device
    (``_dense_saddle_edges``).  Returns the relabelled per-pixel labels."""
    if len(idx) == 0:
        return lab
    lo, hi, h = edges
    if len(lo) == 0:
        return lab
    labs = np.unique(lab)
    L = len(labs)
    ea = np.searchsorted(labs, lo)
    eb = np.searchsorted(labs, hi)
    eh = np.asarray(h, np.float64)
    cid = np.searchsorted(labs, lab)
    flux = np.bincount(cid, weights=np.maximum(val, 0.0), minlength=L)
    peak = val[np.searchsorted(idx, labs)].astype(np.float64)
    nthr = max(cfg.deblend_nthresh, 1)
    thr = max(float(threshold), 1e-30)
    order = np.argsort(peak, kind="stable")
    roots = merge_segments(ea, eb, eh, peak, flux, order, nthr, thr, cfg.deblend_cont)
    if np.array_equal(roots, np.arange(L)):
        return lab
    return labs[roots][cid]


def _pixel_edges_coo(idx, f):
    """8-neighbour pixel edge pairs (array indices) among the masked COO
    pixels (ascending flat ``idx``): the E, S, SE and SW directions cover
    every undirected adjacency."""
    idx = np.asarray(idx, np.int64)
    col = idx % f
    a_parts, b_parts = [], []
    for d, ok in ((1, col < f - 1), (f, None), (f + 1, col < f - 1), (f - 1, col > 0)):
        src = np.flatnonzero(ok) if ok is not None else np.arange(len(idx))
        cand = idx[src] + d
        pos = np.searchsorted(idx, cand)
        m = np.flatnonzero(pos < len(idx))
        m = m[idx[pos[m]] == cand[m]]
        if len(m):
            a_parts.append(src[m])
            b_parts.append(pos[m])
    if not a_parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(a_parts), np.concatenate(b_parts)


def _lutz_labels_coo(idx, val, f, threshold, cfg: DetectionConfig):
    """``deblend_algo='lutz'``: each pixel's object label (the flat index
    of its object's peak) from the native multi-threshold tree over the
    masked pixels' 8-neighbour graph, with ``deblend_nthresh``
    exponential sub-thresholds and the ``deblend_cont`` significance; the
    watershed labels are not used."""
    if len(idx) == 0:
        return np.zeros(0, np.int64)
    ea, eb = _pixel_edges_coo(idx, f)
    return lutz_deblend(
        np.maximum(np.asarray(val, np.float64), 1e-30),
        idx,
        ea,
        eb,
        f,
        max(cfg.deblend_nthresh, 1),
        max(float(threshold), 1e-30),
        cfg.deblend_cont,
    )


def _clean_pass(ys, xs, peaks, cfg: DetectionConfig) -> np.ndarray:
    """SExtractor CLEAN: a detection is spurious if the summed Gaussian
    wings of brighter detections at its position exceed its own peak times
    clean_param.  Wings beyond rcut change no decision to double
    precision."""
    sigma = cfg.filter_fwhm / 2.3548200450309493
    s2 = 2.0 * (np.sqrt(2.0) * sigma) ** 2
    n = len(ys)
    pmax, pmin = float(peaks.max()), float(max(peaks.min(), 1e-300))
    rcut = np.sqrt(s2 * (np.log(pmax / pmin) + np.log(max(n, 2)) + 28.0))
    order = np.argsort(xs, kind="stable")
    ys_s, xs_s, pk_s = ys[order], xs[order], peaks[order]
    contrib_s = np.zeros(n)
    chunk = 512
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        j0 = int(np.searchsorted(xs_s, xs_s[s] - rcut, "left"))
        j1 = int(np.searchsorted(xs_s, xs_s[e - 1] + rcut, "right"))
        d2 = (ys_s[s:e, None] - ys_s[None, j0:j1]) ** 2 + (xs_s[s:e, None] - xs_s[None, j0:j1]) ** 2
        wings = pk_s[None, j0:j1] * np.exp(-d2 / s2)
        brighter = pk_s[None, j0:j1] > pk_s[s:e, None]
        contrib_s[s:e] = np.where(brighter, wings, 0.0).sum(axis=1)
    contrib = np.empty(n)
    contrib[order] = contrib_s
    return peaks > cfg.clean_param * contrib


def _postprocess_coo(idx, lab, val, f, globalrms, cfg: DetectionConfig, timings=None, want_map=True, edges=None):
    """Merge (or the Lutz tree), minarea, centroids and CLEAN over the
    masked-pixel COO (ascending per-field flat ``idx``, per-pixel watershed
    labels, filtered values).

    ``timings``: a dict that accumulates the wall seconds of the stages
    'merge', 'segstats', 'clean' and 'reconstruct' (the dense label map).
    ``want_map=False`` skips that map and returns ``labels: None``.
    ``edges``: the merge's saddle edges (``_merge_labels_coo``); None
    under ``deblend_algo='lutz'``, which takes none."""
    t = timings if timings is not None else {}
    idx = np.asarray(idx, np.int64)
    lab = np.asarray(lab, np.int64)
    val = np.asarray(val, np.float32)
    thr_val = cfg.thresh * float(globalrms) * _threshold_scale(cfg)
    with stage_timer(t, "merge"):
        if cfg.deblend_algo == "lutz":
            lab = _lutz_labels_coo(idx, val, f, thr_val, cfg)
        else:
            lab = _merge_labels_coo(idx, lab, val, thr_val, cfg, edges)

    with stage_timer(t, "segstats"):
        w_sel = np.maximum(val, 0.0)
        ulab = np.unique(lab)
        nl = len(ulab)
        cid = np.searchsorted(ulab, lab)
        area = np.bincount(cid, minlength=nl).astype(np.float64)
        flux = np.bincount(cid, weights=w_sel, minlength=nl)
        ysum = np.bincount(cid, weights=w_sel * (idx // f), minlength=nl)
        xsum = np.bincount(cid, weights=w_sel * (idx % f), minlength=nl)

        peak_flat = idx[lab == idx]  # fixpoints of the ascent are the peaks
        pcid = np.searchsorted(ulab, peak_flat)
        kmask = area[pcid] >= cfg.minarea
        keep = peak_flat[kmask]
        kcid = pcid[kmask]
        fl = np.maximum(flux[kcid], 1e-30)
        ys = ysum[kcid] / fl
        xs = xsum[kcid] / fl
        peak_val = val[np.searchsorted(idx, keep)]

    if cfg.clean and len(keep) > 1:
        with stage_timer(t, "clean"):
            keep_mask = _clean_pass(ys, xs, peak_val, cfg)
            keep, kcid = keep[keep_mask], kcid[keep_mask]
            ys, xs = ys[keep_mask], xs[keep_mask]

    dense = None
    if want_map:
        with stage_timer(t, "reconstruct"):
            dense = np.full(f * f, -1, np.int32)
            dense[idx] = lab
            dense = dense.reshape(f, f)
    return {
        "y": ys,
        "x": xs,
        "area": area[kcid],
        "flux": flux[kcid],
        "peak_yx": np.stack([keep // f, keep % f], -1) if len(keep) else np.zeros((0, 2), int),
        "labels": dense,
        "globalrms": float(globalrms),
    }


def _on_device(x, dev: torch.device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``dev``: host arrays are uploaded, a
    tensor must already lie on ``dev`` (no silent copy between devices)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != dev.type or (dev.index is not None and x.device.index != dev.index):
            raise ValueError(f"the field lies on {x.device}, detection was asked to run on {dev}")
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _count(t: dict, name: str, n: int) -> None:
    t[f"count.{name}"] = t.get(f"count.{name}", 0) + int(n)


def _stack_edges(labels: torch.Tensor, filt: torch.Tensor, cfg: DetectionConfig):
    """The watershed merge's saddle edges over the stack, on its device
    (``_dense_saddle_edges``: keys, heights, boundary pairs); None under
    ``deblend_algo='lutz'``, which takes no edges."""
    return None if cfg.deblend_algo == "lutz" else _dense_saddle_edges(labels, filt)


def _postprocess_stack(idx, lab, val, n, f, grms, cfg: DetectionConfig, timings, want_map, edges=None) -> list[dict]:
    """The host postprocess tile by tile of a stack's COO (global flat
    ``idx``, split per tile by ``searchsorted``) and of its saddle edges
    (``edges``: ascending keys and heights, split per tile the same way;
    their count under ``count.segment_edges``)."""
    per_tile = f * f
    bounds = np.searchsorted(idx, np.arange(n + 1) * per_tile)
    tile_edges = [None] * n
    if edges is not None:
        keys, heights = edges
        cuts = np.searchsorted(keys, np.arange(n + 1) * per_tile * per_tile)
        _count(timings, "segment_edges", cuts[-1])
        for i, (s, e) in enumerate(zip(cuts[:-1], cuts[1:])):
            _, lo, hi = _split_edge_keys(keys[s:e], f)
            tile_edges[i] = (lo, hi, heights[s:e])
    return [
        _postprocess_coo(
            idx[s:e] - i * per_tile, lab[s:e], val[s:e], f, float(grms[i]), cfg, timings=timings, want_map=want_map,
            edges=tile_edges[i],
        )
        for i, (s, e) in enumerate(zip(bounds[:-1], bounds[1:]))
    ]


def _joined(parts: list, step: int = 0) -> np.ndarray:
    """The pieces' host arrays end to end, piece k's values offset by k *
    ``step``; one piece's array as it is."""
    if len(parts) == 1:
        return parts[0]
    return np.concatenate([p + k * step for k, p in enumerate(parts)])


def _detect_pieces(pieces: list, core, cfg: DetectionConfig, timings, want_map, n: int | None = None) -> list[dict]:
    """Detection's one device route: ``core`` over a tile stack split into
    equal (T_i, F, F) pieces, each on its device (one piece on one
    device).  The core of every piece is queued first (every stage is per
    tile: no collective), then each piece's masked pixels are compacted
    (the compaction syncs) and its saddle edges built, all downloaded, the
    indices and edge keys offset to the whole stack's order, and the host
    postprocess runs tile by tile on the first ``n`` tiles (all of them by
    default).  The 'core' stage ends with the pieces' devices
    synchronised; 'download' and the counters follow
    (``detect_sources_batched``)."""
    t = timings if timings is not None else {}
    per_piece, f = pieces[0].shape[0], pieces[0].shape[-1]
    n = per_piece * len(pieces) if n is None else n
    devices = list(dict.fromkeys(p.device for p in pieces))
    with stage_timer(t, "core", devices):
        cores = [core(p.to(torch.float32), cfg) for p in pieces]
        coos = [_compact_masked(labels, filt) for labels, filt, _ in cores]
        edges = [_stack_edges(labels, filt, cfg) for labels, filt, _ in cores]
    with stage_timer(t, "download", devices):
        coos = [[a.cpu().numpy() for a in coo] for coo in coos]
        grms = _joined([g.cpu().numpy() for _, _, g in cores])
        edges = [None if e is None else [a.cpu().numpy() for a in e] for e in edges]
    span = per_piece * f * f
    idx = _joined([c[0] for c in coos], span)
    lab, val = _joined([c[1] for c in coos]), _joined([c[2] for c in coos])
    _count(t, "masked_px", len(idx))
    stack_edges = None
    if edges[0] is not None:
        # each piece's keys number its own tiles: offset them as idx is
        if span * f * f * len(pieces) >= 2**63:
            raise ValueError(f"{per_piece * len(pieces)} tiles of {f}^2 overflow the int64 edge keys")
        stack_edges = (_joined([e[0] for e in edges], span * f * f), _joined([e[1] for e in edges]))
        _count(t, "saddle_pairs", sum(int(e[2]) for e in edges))
    return _postprocess_stack(idx, lab, val, n, f, grms, cfg, t, want_map, stack_edges)


def detect_sources(image_2d, cfg: DetectionConfig | None = None, device="cuda", timings=None, want_map=True):
    """Full detection on a square 2D band: dict with 'y', 'x' (float
    barycentres), 'area', 'flux', 'peak_yx', 'labels' (None with
    ``want_map=False``), 'globalrms'.  ``timings`` accumulates the stage
    seconds of ``detect_sources_batched``."""
    cfg = cfg or DetectionConfig()
    image = _on_device(image_2d, resolve_device(device))
    if image.ndim != 2 or image.shape[0] != image.shape[1]:
        raise ValueError(
            f"detection requires a square 2D field (got {tuple(image.shape)}); "
            f"the centre-offset convention is single-axis"
        )
    return _detect_pieces([image[None]], _core, cfg, timings, want_map)[0]


def detect_sources_batched(tiles, cfg: DetectionConfig | None = None, mesh=None, timings=None, want_map=True,
                           device="cuda") -> list[dict]:
    """Detection over a stack of same-size square tiles (T, F, F): one
    device pass of the core over the whole stack, one compaction of its
    masked pixels and one download, then the host postprocess tile by
    tile.  Returns one ``detect_sources`` dict a tile.

    ``tiles``: a host array, uploaded to ``device``, or a tensor already on
    it (bfloat16 is widened to float32 there).  ``timings``: a dict that
    accumulates the seconds of 'core' (the device core, the compaction and
    the saddle edges, up to their count syncs), 'download' (the three COO
    arrays and the edges) and the host postprocess's 'merge', 'segstats',
    'clean' and 'reconstruct' (``_postprocess_coo``), and counts at the
    same boundaries, never times: ``count.masked_px`` the masked pixels
    downloaded, which the merge takes; for the watershed merge (not
    ``'lutz'``) ``count.saddle_pairs`` the boundary pixel pairs the device
    found and ``count.segment_edges`` the distinct edges the merge
    received.  ``want_map=False`` skips each tile's dense label map
    (``labels: None``).

    ``mesh`` (parallel/mesh.py): the stack is padded to a multiple of the
    mesh's 'data' axis (a cyclic repeat of its tiles) and split over it;
    each shard's device runs the core on its slab (every stage is per
    tile: no collective), all shards queued before any compaction syncs;
    then each shard's masked pixels are compacted, its saddle edges built,
    both downloaded, and the host postprocess runs on the real tiles as
    without a mesh.  A tensor stack may lie on any device; the shards'
    devices are the mesh's."""
    cfg = _normalize_batched_cfg(cfg or DetectionConfig())
    if mesh is not None:
        from debvader_tpu_torch.parallel.mesh import DATA_AXIS, batch_sharding, require_single_process

        require_single_process(mesh, "detect_sources_batched(mesh=)")
        x = tiles if isinstance(tiles, torch.Tensor) else torch.as_tensor(np.asarray(tiles, np.float32))
        x = x.to(torch.float32)
    else:
        x = _on_device(tiles, resolve_device(device))
    if x.ndim != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(
            f"detection tiles must be a (T, F, F) square stack (got {tuple(x.shape)}); "
            f"see detect_sources for the square-field contract"
        )
    n = x.shape[0]
    pieces = [x]
    if mesh is not None:
        # the pad can exceed the stack: 3 tiles on 8 shards
        pad = (-n) % mesh.shape[DATA_AXIS]
        if pad:
            x = torch.cat([x, x[torch.arange(pad, device=x.device) % n]])
        pieces = batch_sharding(x, mesh)
    return _detect_pieces(pieces, _batched_core, cfg, timings, want_map, n)


def detect_shards(pieces: list, cfg: DetectionConfig, timings=None, want_map=True, n: int | None = None) -> list[dict]:
    """Detection over a tile stack already split into equal (T/D, F, F)
    pieces, each on its shard's device (``_detect_pieces``), on the first
    ``n`` tiles (all of them by default).  ``cfg`` is normalised here as
    ``detect_sources_batched`` normalises it."""
    return _detect_pieces(pieces, _batched_core, _normalize_batched_cfg(cfg), timings, want_map, n)


def detect_objects(field_image, cfg: DetectionConfig | None = None, device="cuda") -> np.ndarray:
    """Reference-signature detection: field (1, F, F, B), (F, F, B) or
    (F, F); runs on the r band (channel 2 when present).  Returns (N, 2)
    offsets from the field centre, round(-int(F/2) + y)."""
    cfg = cfg or DetectionConfig()
    img = np.asarray(field_image, np.float32)
    if img.ndim == 4:
        img = img[0]
    if img.ndim == 3:
        band = cfg.detection_band if img.shape[-1] > cfg.detection_band else 0
        img = img[..., band]
    objects = detect_sources(img, cfg, device=device)
    if len(objects["y"]) == 0:
        return np.zeros((0, 2))
    half = int(img.shape[0] / 2)
    return np.stack(
        [np.round(-half + objects["y"]), np.round(-half + objects["x"])], axis=-1
    )
