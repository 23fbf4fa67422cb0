"""Source detection: SExtractor-equivalent, on the device, in PyTorch.

Port of debvader_tpu.ops.detection along the path a TPU runs by default
(the fused detect core):

1. Background and RMS meshes per 64x64 box: sigma-clipped statistics
   (kernels/clipped_stats.py), the SExtractor mode estimator
   (2.5*median - 1.5*mean, the median in crowded boxes), empty boxes
   filled with the median of the others, a 3x3 median filter, and the
   bilinear upsample of ``jax.image.resize``.
2. The fused core (kernels/detect_fused.py): background subtract,
   separable 7x7 matched filter, threshold at thresh * globalrms, and the
   steepest-ascent parent race; then label resolution
   (kernels/label_select.py).
3. On the host, over the masked pixels only: the quantized
   multi-threshold merge of watershed segments (deblend_nthresh,
   deblend_cont), minarea, flux-weighted centroids and CLEAN.

``detect_objects`` returns the reference's (N, 2) offsets from the field
centre, round(-int(F/2) + y).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from debvader_tpu_torch.config import DetectionConfig
from debvader_tpu_torch.device import fp32_math, resolve_device
from debvader_tpu_torch.kernels.clipped_stats import sigma_clipped_stats
from debvader_tpu_torch.kernels.detect_fused import matched_filter_parents
from debvader_tpu_torch.kernels.label_select import label_fixpoint

__all__ = [
    "default_filter_kernel",
    "estimate_background",
    "detect_core_stack",
    "detect_sources",
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
    """Lower median ((count-1)//2) of the masked values; 0 when none."""
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    cnt = int(mask.sum())
    return s[max((cnt - 1) // 2, 0)] if cnt else torch.zeros((), dtype=x.dtype, device=x.device)


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the mean of the two middle values for an even count."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _median3x3(mesh: torch.Tensor) -> torch.Tensor:
    """3x3 median filter with edge padding."""
    g0, g1 = mesh.shape
    p = F.pad(mesh[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    stack = torch.stack([p[i : i + g0, j : j + g1] for i in range(3) for j in range(3)])
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
    """(back_map, rms_map, globalback, globalrms) of a 2D field tensor.

    Non-finite pixels are excluded from the box statistics."""
    f = image.shape[0]
    finite = torch.isfinite(image)
    image = torch.where(finite, image, torch.zeros((), dtype=image.dtype, device=image.device))
    g = -(-f // box)
    pad = g * box - f

    def to_boxes(x):
        x = F.pad(x[None, None], (0, pad, 0, pad), mode="replicate")[0, 0] if pad else x
        return x.reshape(g, box, g, box).permute(0, 2, 1, 3).reshape(g, g, box * box)

    boxes = to_boxes(image)
    valid = to_boxes(finite.to(torch.float32))
    mean, med, std = sigma_clipped_stats(boxes, valid)
    has_data = valid.sum(-1) > 0
    mode = 2.5 * med - 1.5 * mean
    crowded = torch.abs(mean - med) > 0.3 * (std + 1e-12)
    back_mesh = torch.where(crowded, med, mode)
    rms_mesh = std

    def fill_gaps(mesh):
        return torch.where(has_data, mesh, _masked_median(mesh.reshape(-1), has_data.reshape(-1)))

    back_mesh = _median3x3(fill_gaps(back_mesh))
    rms_mesh = _median3x3(fill_gaps(rms_mesh))

    w = _resize_weights(g, g * box, image.device)
    with fp32_math():
        back = (w.T @ back_mesh @ w)[:f, :f]
        rms = (w.T @ rms_mesh @ w)[:f, :f]
    return back, rms, _median(back_mesh), _median(rms_mesh)


def _threshold_scale(cfg: DetectionConfig) -> float:
    if cfg.threshold_scaling == "matched":
        k = default_filter_kernel(7, cfg.filter_fwhm)
        return float(np.sqrt(np.sum(np.square(k))))
    return 1.0


def detect_core_stack(xs: torch.Tensor, cfg: DetectionConfig):
    """Fused detect core over a (T, F, F) stack: (labels, filt, globalrms).

    labels (T, F, F) int32 hold each masked pixel's ascent root (per-field
    flat index) and -1 elsewhere."""
    t, f, _ = xs.shape
    stats = [estimate_background(xs[i], box=min(cfg.background_box, f)) for i in range(t)]
    back = torch.stack([s[0] for s in stats])
    grms = torch.stack([s[3] for s in stats])
    thr = cfg.thresh * grms * _threshold_scale(cfg)
    guarded = torch.where(torch.isfinite(xs), xs, back)
    kernel = default_filter_kernel(7, cfg.filter_fwhm)
    filt, dir_code, cur0 = matched_filter_parents(guarded, back, kernel, thr)
    roots = label_fixpoint(cur0.reshape(t * f, f), dir_code.reshape(t * f, f)).reshape(t, f, f)
    labels = torch.where(filt > thr[:, None, None], roots, torch.full_like(roots, -1))
    return labels, filt, grms


# ----------------------------------------------------------- host postprocess


def _saddle_edges_coo(idx, lab, val, f):
    """Saddle triples (lo, hi, h) between touching segments of the masked
    pixels (ascending flat ``idx``): for the E, S, SE and SW directions a
    pair exists where idx + d is masked too with another label; the saddle
    height is the smaller filtered value.  (None, None, None) when no
    segments touch."""
    col = idx % f
    lo_parts, hi_parts, h_parts = [], [], []
    for d, ok in ((1, col < f - 1), (f, None), (f + 1, col < f - 1), (f - 1, col > 0)):
        src = np.flatnonzero(ok) if ok is not None else np.arange(len(idx))
        cand = idx[src] + d
        pos = np.searchsorted(idx, cand)
        m = np.flatnonzero(pos < len(idx))
        m = m[idx[pos[m]] == cand[m]]
        i_src, i_dst = src[m], pos[m]
        t = lab[i_src] != lab[i_dst]
        if not t.any():
            continue
        la = lab[i_src[t]].astype(np.int64)
        lb = lab[i_dst[t]].astype(np.int64)
        lo_parts.append(np.minimum(la, lb))
        hi_parts.append(np.maximum(la, lb))
        h_parts.append(np.minimum(val[i_src[t]], val[i_dst[t]]).astype(np.float64))
    if not lo_parts:
        return None, None, None
    return np.concatenate(lo_parts), np.concatenate(hi_parts), np.concatenate(h_parts)


def _merge_segments_py(ea, eb, eh, peak, flux, order, nthr, thr, cont):
    """The sequential merge loop: weakest peaks first, each segment merges
    into its brightest-saddle neighbour unless a quantization level
    separates its peak from the saddle and its flux is significant.
    Returns the root of every segment."""
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


def _merge_labels_coo(idx, lab, val, f, threshold, cfg: DetectionConfig):
    """SExtractor's quantized deblending criterion on the watershed
    segments of the masked-pixel COO: merges back the splits sep's
    64-level multi-threshold tree would not have made.  Returns the
    relabelled per-pixel labels."""
    if len(idx) == 0:
        return lab
    lo, hi, h = _saddle_edges_coo(idx, lab, val, f)
    if lo is None:
        return lab
    labs = np.unique(lab)
    L = len(labs)
    ia = np.searchsorted(labs, lo)
    ib = np.searchsorted(labs, hi)
    ukey, inv = np.unique(ia * L + ib, return_inverse=True)
    eh = np.full(len(ukey), -np.inf)
    np.maximum.at(eh, inv, h)
    ea = ukey // L
    eb = ukey % L
    cid = np.searchsorted(labs, lab)
    flux = np.bincount(cid, weights=np.maximum(val, 0.0), minlength=L)
    peak = val[np.searchsorted(idx, labs)].astype(np.float64)
    nthr = max(cfg.deblend_nthresh, 1)
    thr = max(float(threshold), 1e-30)
    order = np.argsort(peak, kind="stable")
    roots = _merge_segments_py(ea, eb, eh, peak, flux.copy(), order, nthr, thr, cfg.deblend_cont)
    if np.array_equal(roots, np.arange(L)):
        return lab
    return labs[roots][cid]


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


def _postprocess_coo(idx, lab, val, f, globalrms, cfg: DetectionConfig):
    """Merge, minarea, centroids and CLEAN over the masked-pixel COO
    (ascending flat ``idx``, per-pixel watershed labels, filtered
    values)."""
    idx = np.asarray(idx, np.int64)
    lab = np.asarray(lab, np.int64)
    val = np.asarray(val, np.float32)
    thr_val = cfg.thresh * float(globalrms) * _threshold_scale(cfg)
    lab = _merge_labels_coo(idx, lab, val, f, thr_val, cfg)

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
        keep_mask = _clean_pass(ys, xs, peak_val, cfg)
        keep, kcid = keep[keep_mask], kcid[keep_mask]
        ys, xs = ys[keep_mask], xs[keep_mask]

    dense = np.full(f * f, -1, np.int32)
    dense[idx] = lab
    return {
        "y": ys,
        "x": xs,
        "area": area[kcid],
        "flux": flux[kcid],
        "peak_yx": np.stack([keep // f, keep % f], -1) if len(keep) else np.zeros((0, 2), int),
        "labels": dense.reshape(f, f),
        "globalrms": float(globalrms),
    }


def _postprocess_core(labels_np, filt_np, globalrms, cfg: DetectionConfig):
    f = labels_np.shape[0]
    flat = labels_np.ravel()
    sel = np.flatnonzero(flat >= 0)
    return _postprocess_coo(sel, flat[sel], filt_np.ravel()[sel], f, globalrms, cfg)


def detect_sources(image_2d, cfg: DetectionConfig | None = None, device="cuda"):
    """Full detection on a square 2D band: dict with 'y', 'x' (float
    barycentres), 'area', 'flux', 'peak_yx', 'labels', 'globalrms'."""
    cfg = cfg or DetectionConfig()
    dev = resolve_device(device)
    image = torch.as_tensor(np.asarray(image_2d, np.float32), device=dev)
    if image.ndim != 2 or image.shape[0] != image.shape[1]:
        raise ValueError(
            f"detection requires a square 2D field (got {tuple(image.shape)}); "
            f"the centre-offset convention is single-axis"
        )
    labels, filt, grms = detect_core_stack(image[None], cfg)
    return _postprocess_core(
        labels[0].cpu().numpy(), filt[0].cpu().numpy(), float(grms[0]), cfg
    )


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
