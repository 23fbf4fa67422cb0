"""The plain reference of the survey-field route: tiled detection, then
cutouts, the stamp forward, the render and the residual, in plain PyTorch
and NumPy.

Detection is a frozen copy of the plain versions that the program's CPU
route runs (``ops/detection.py``, ``pipeline/tiles.py`` and the plain
versions of its kernels), written here without them: per tile of the
(1024, overlap 64) stack, the SExtractor-like background (3 rounds of
sigma clipping to median +- 3 std on 64-px boxes, the mode 2.5 median -
1.5 mean unless crowded, a 3x3 median filter of the mesh, the bilinear
upsample of ``jax.image.resize``), the global rms as the median of the rms
mesh, the 7x7 matched filter of image - background (SExtractor's
gauss_3.0_7x7, zero outside the tile), the threshold thresh * rms *
||kernel|| ('matched'), each masked pixel's steepest-ascent root over its
3x3 neighbourhood ((value, -index) tie-break), SExtractor's quantized
multi-threshold merge of touching segments, minarea, flux-weighted
centroids of the filtered values and CLEAN; each tile keeps the sources
inside its core (cut at the overlaps' midpoints) and the field reports
round(-int(F/2) + y) offsets.

The route after detection follows the reference deblender's conventions:
a cutout's window starts at trunc(c) + F//2 - S//2, a source is deblended
iff its window lies inside the field, and a stamp renders with its corner
at (F - S)//2 + offset.  The offsets are whole pixels, where the order-3
spline reproduces the stamp's own samples, so the reference places the
stamps as they are.  The mse cut's window is the central 2 x mse_window
pixels.

``precision`` rounds the operands of every contraction (the matched
filter, the background's resize products, the forward) as
``reference.vae`` does; 'float32' leaves them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import vae as ref

__all__ = ["GAUSS_3_7x7", "tile_origins", "detect", "serve", "truth_match"]

GAUSS_3_7x7 = np.array(
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


def tile_origins(f: int, tile: int, overlap: int) -> list[int]:
    if tile >= f:
        return [0]
    starts = list(range(0, f - tile, tile - overlap))
    return starts + [f - tile]


# ------------------------------------------------------------ background


def _clipped_stats(x: torch.Tensor, iters: int = 3):
    """(mean, lower median, std) of each row of finite (B, P) values after
    ``iters`` rounds of clipping to median +- (3 std + 1e-12); sums are
    taken on the values centred on the row's unclipped mean."""
    c = x.mean(dim=1)
    y = x - c[:, None]
    member = torch.ones_like(x, dtype=torch.bool)

    def stats(member):
        n = member.sum(1)
        nf = torch.clamp(n, min=1).to(torch.float32)
        mean_y = torch.where(member, y, 0.0).sum(1) / nf
        var = torch.clamp(torch.where(member, y * y, 0.0).sum(1) / nf - mean_y * mean_y, min=0.0)
        ordered = torch.sort(torch.where(member, x, torch.inf), dim=1).values
        med = ordered.gather(1, (torch.clamp(n - 1, min=0) // 2)[:, None])[:, 0]
        return mean_y, med, torch.sqrt(var)

    for _ in range(iters):
        _, med, std = stats(member)
        thr = 3.0 * std + 1e-12
        member = (x >= (med - thr)[:, None]) & (x <= (med + thr)[:, None])
    mean_y, med, std = stats(member)
    return mean_y + c, med, std


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize's bilinear upsample:
    half-pixel centres, the triangle kernel renormalised at the edges."""
    scale = np.float32(n_out) / np.float32(n_in)
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) / scale - np.float32(0.5)
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.as_tensor(np.where(inside[None, :], w, 0).astype(np.float32), device=device)


def _median3x3(mesh: torch.Tensor) -> torch.Tensor:
    g = mesh.shape[-1]
    p = F.pad(mesh[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    stack = torch.stack([p[:, i: i + g, j: j + g] for i in range(3) for j in range(3)])
    return torch.sort(stack, dim=0).values[4]


def _background(tiles: torch.Tensor, box: int, precision: str):
    """(background maps (T, F, F), global rms (T,)) of a finite tile stack
    whose side is a multiple of ``box``."""
    t, f = tiles.shape[0], tiles.shape[-1]
    g = f // box
    boxes = tiles.reshape(t, g, box, g, box).permute(0, 1, 3, 2, 4).reshape(t * g * g, box * box)
    mean, med, std = (s.reshape(t, g, g) for s in _clipped_stats(boxes))
    crowded = torch.abs(mean - med) > 0.3 * (std + 1e-12)
    back_mesh = _median3x3(torch.where(crowded, med, 2.5 * med - 1.5 * mean))
    rms_mesh = _median3x3(std)
    w = ref.round_operand(_resize_weights(g, f, tiles.device), precision)
    with ref.float32_math():
        back = w.T @ ref.round_operand(back_mesh, precision) @ w
    ordered = torch.sort(rms_mesh.reshape(t, -1), dim=1).values
    n = ordered.shape[1]
    return back, (ordered[:, (n - 1) // 2] + ordered[:, n // 2]) * 0.5


# ------------------------------------------------------------ the core


def _separable(kernel: np.ndarray):
    u, s, vt = np.linalg.svd(kernel.astype(np.float32))
    if s[1] > 1e-4 * s[0]:
        return None
    wy, wx = u[:, 0] * np.sqrt(s[0]), vt[0] * np.sqrt(s[0])
    if wy.sum() < 0:
        wy, wx = -wy, -wx
    return wy.astype(np.float32), wx.astype(np.float32)


def _matched_filter(fore: torch.Tensor, kernel: np.ndarray, precision: str) -> torch.Tensor:
    """SAME 7x7 filter of (T, F, F), zero outside, tap by tap from 0:
    separable filters down the rows then along the columns, others over
    the 49 taps in row-major order."""
    t, f, _ = fore.shape
    p = F.pad(ref.round_operand(fore, precision), (3, 3, 3, 3))
    sep = _separable(kernel)
    if sep is not None:
        wy, wx = (ref.round_operand(torch.tensor(w), precision).tolist() for w in sep)
        tmp = torch.zeros((t, f, f + 6), dtype=fore.dtype, device=fore.device)
        for dy in range(7):
            tmp = tmp + wy[dy] * p[:, dy: dy + f, :]
        out = torch.zeros((t, f, f), dtype=fore.dtype, device=fore.device)
        for dx in range(7):
            out = out + wx[dx] * tmp[:, :, dx: dx + f]
        return out
    k = ref.round_operand(torch.tensor(kernel), precision).tolist()
    out = torch.zeros((t, f, f), dtype=fore.dtype, device=fore.device)
    for dy in range(7):
        for dx in range(7):
            out = out + k[dy][dx] * p[:, dy: dy + f, dx: dx + f]
    return out


def _roots(filt: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Each masked pixel's steepest-ascent root (per-tile flat index), -1
    elsewhere."""
    t, f, _ = filt.shape
    mask = filt > thr[:, None, None]
    val = torch.where(mask, filt, -torch.inf)
    idx = torch.arange(f * f, dtype=torch.int64, device=filt.device).reshape(1, f, f).expand(t, f, f)
    vp = F.pad(val, (1, 1, 1, 1), value=-float("inf"))
    ip = F.pad(idx, (1, 1, 1, 1), value=-1)
    best_v, best_i = val, idx
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == dx == 0:
                continue
            nv = vp[:, 1 + dy: 1 + dy + f, 1 + dx: 1 + dx + f]
            ni = ip[:, 1 + dy: 1 + dy + f, 1 + dx: 1 + dx + f]
            better = (nv > best_v) | ((nv == best_v) & (ni < best_i))
            best_v, best_i = torch.where(better, nv, best_v), torch.where(better, ni, best_i)
    parent = torch.where(mask, best_i, idx).reshape(t, f * f)
    while True:
        nxt = parent.gather(1, parent)
        if torch.equal(nxt, parent):
            break
        parent = nxt
    return torch.where(mask.reshape(t, f * f), parent, -1)


# ------------------------------------------------------------ the host part


def _saddles(idx, lab, val, f):
    col = idx % f
    lo, hi, h = [], [], []
    for d, ok in ((1, col < f - 1), (f, None), (f + 1, col < f - 1), (f - 1, col > 0)):
        src = np.flatnonzero(ok) if ok is not None else np.arange(len(idx))
        cand = idx[src] + d
        pos = np.searchsorted(idx, cand)
        m = np.flatnonzero(pos < len(idx))
        m = m[idx[pos[m]] == cand[m]]
        i_src, i_dst = src[m], pos[m]
        t = lab[i_src] != lab[i_dst]
        lo.append(np.minimum(lab[i_src[t]], lab[i_dst[t]]))
        hi.append(np.maximum(lab[i_src[t]], lab[i_dst[t]]))
        h.append(np.minimum(val[i_src[t]], val[i_dst[t]]).astype(np.float64))
    return np.concatenate(lo), np.concatenate(hi), np.concatenate(h)


def _merge(idx, lab, val, f, thr, nthr, cont):
    """SExtractor's quantized criterion on the touching segments: weakest
    peaks first, a segment joins its brightest-saddle neighbour (when that
    one is brighter) unless a level of the nthr exponential thresholds
    between thr and the pair's peak separates its peak from the saddle and
    its flux is above cont of the pair's; repeated until nothing joins."""
    lo, hi, h = _saddles(idx, lab, val, f)
    if len(h) == 0:
        return lab
    labs = np.unique(lab)
    n = len(labs)
    ia, ib = np.searchsorted(labs, lo), np.searchsorted(labs, hi)
    ukey, inv = np.unique(ia * n + ib, return_inverse=True)
    eh = np.full(len(ukey), -np.inf)
    np.maximum.at(eh, inv, h)
    ea, eb = ukey // n, ukey % n
    cid = np.searchsorted(labs, lab)
    flux = np.bincount(cid, weights=np.maximum(val, 0.0), minlength=n)
    peak = val[np.searchsorted(idx, labs)].astype(np.float64)
    thr = max(float(thr), 1e-30)

    def level(v, top):
        if top <= thr or v <= thr:
            return 0
        return int(np.clip(np.floor(np.log(v / thr) / np.log(top / thr) * nthr), 0, nthr))

    parent = np.arange(n)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    incident = [[] for _ in range(n)]
    for e in range(len(eh)):
        incident[ea[e]].append(e)
        incident[eb[e]].append(e)
    changed = True
    while changed:
        changed = False
        for r in np.argsort(peak, kind="stable"):
            r = int(r)
            if parent[r] != r:
                continue
            other, best = -1, -np.inf
            for e in incident[r]:
                ra, rb = find(int(ea[e])), find(int(eb[e]))
                if ra != rb and eh[e] > best:
                    other, best = (rb if ra == r else ra), eh[e]
            if other < 0 or peak[other] < peak[r]:
                continue
            top = max(peak[r], peak[other])
            separated = level(peak[r], top) > level(best, top)
            significant = flux[r] > cont * (flux[r] + flux[other])
            if not (separated and significant):
                parent[r] = other
                flux[other] += flux[r]
                incident[other].extend(incident[r])
                incident[r] = []
                changed = True
    roots = np.array([find(i) for i in range(n)])
    return labs[roots][cid]


def _clean(ys, xs, peaks, fwhm, param):
    """SExtractor CLEAN: a detection whose own peak is below ``param`` x
    the summed Gaussian wings of the brighter ones at its position goes."""
    s2 = 2.0 * (np.sqrt(2.0) * fwhm / 2.3548200450309493) ** 2
    d2 = (ys[:, None] - ys[None, :]) ** 2 + (xs[:, None] - xs[None, :]) ** 2
    wings = np.where(peaks[None, :] > peaks[:, None], peaks[None, :] * np.exp(-d2 / s2), 0.0).sum(axis=1)
    return peaks > param * wings


def _catalog(idx, lab, val, f, thr, det):
    """(y, x) centroids of one tile's sources."""
    if len(idx) == 0:
        return np.zeros(0), np.zeros(0)
    lab = _merge(idx, lab, val, f, thr, max(det["deblend_nthresh"], 1), det["deblend_cont"])
    w = np.maximum(val, 0.0)
    ulab = np.unique(lab)
    cid = np.searchsorted(ulab, lab)
    area = np.bincount(cid, minlength=len(ulab))
    flux = np.bincount(cid, weights=w, minlength=len(ulab))
    ysum = np.bincount(cid, weights=w * (idx // f), minlength=len(ulab))
    xsum = np.bincount(cid, weights=w * (idx % f), minlength=len(ulab))
    peaks = idx[lab == idx]
    pcid = np.searchsorted(ulab, peaks)
    keep = area[pcid] >= det["minarea"]
    peaks, pcid = peaks[keep], pcid[keep]
    fl = np.maximum(flux[pcid], 1e-30)
    ys, xs = ysum[pcid] / fl, xsum[pcid] / fl
    if det["clean"] and len(peaks) > 1:
        ok = _clean(ys, xs, val[np.searchsorted(idx, peaks)].astype(np.float64), det["filter_fwhm"],
                    det["clean_param"])
        ys, xs = ys[ok], xs[ok]
    return ys, xs


@torch.no_grad()
def detect(field: torch.Tensor, det: dict, tile: int, overlap: int, precision: str = "float32") -> np.ndarray:
    """(N, 2) whole-pixel offsets from the centre of a (1, F, F, B) field's
    sources.  ``det``: the detection settings (thresh, minarea,
    deblend_nthresh, deblend_cont, background_box, filter_fwhm,
    detection_band, clean, clean_param; 'matched' threshold scaling and the
    7x7 gauss_3.0 filter)."""
    band = field[0, :, :, det["detection_band"]].to(torch.float32)
    f = band.shape[0]
    origins = tile_origins(f, tile, overlap)
    size = min(tile, f)
    starts = torch.as_tensor(origins, device=band.device)[:, None] + torch.arange(size, device=band.device)
    n = len(origins)
    rows, cols = starts.repeat_interleave(n, dim=0), starts.repeat(n, 1)
    tiles = band[rows[:, :, None], cols[:, None, :]]
    back, grms = _background(tiles, min(det["background_box"], size), precision)
    scale = float(np.sqrt(np.sum(np.square(GAUSS_3_7x7))))
    thr = det["thresh"] * grms * scale
    filt = _matched_filter(tiles - back, GAUSS_3_7x7, precision)
    roots = _roots(filt, thr)
    cuts = [0.0] + [(b + a + size) / 2.0 for a, b in zip(origins[:-1], origins[1:])] + [float(f)]
    out = []
    for k in range(n * n):
        sel = torch.nonzero(roots[k] >= 0).reshape(-1)
        idx = sel.cpu().numpy()
        ys, xs = _catalog(idx, roots[k][sel].cpu().numpy(), filt[k].reshape(-1)[sel].cpu().numpy(), size,
                          det["thresh"] * float(grms[k]) * scale, det)
        ty, tx = divmod(k, n)
        gy, gx = ys + origins[ty], xs + origins[tx]
        keep = (gy >= cuts[ty]) & (gy < cuts[ty + 1]) & (gx >= cuts[tx]) & (gx < cuts[tx + 1])
        out.append(np.stack([np.round(-int(f / 2) + gy[keep]), np.round(-int(f / 2) + gx[keep])], -1))
    return np.concatenate(out) if out else np.zeros((0, 2))


@torch.no_grad()
def serve(params: dict, field: torch.Tensor, centres: np.ndarray, stamp: int, mse_window: int,
          precision: str = "float32", block: int = 1024):
    """(residual (F, F, B), mse_center of the deblended sources, their
    indices into ``centres``) of a (1, F, F, B) field deblended at the
    given whole-pixel offsets."""
    img = field[0]
    f = img.shape[0]
    c = torch.as_tensor(np.trunc(np.asarray(centres, np.float64)).astype(np.int64), device=img.device).reshape(-1, 2)
    starts = c + (f // 2 - stamp // 2)
    valid = torch.all((starts >= 0) & (starts + stamp <= f), dim=1)
    kept = torch.nonzero(valid).reshape(-1)
    corners = (c + (f - stamp) // 2)[kept].tolist()
    ar = torch.arange(stamp, device=img.device)
    model = torch.zeros_like(img)
    mse = []
    w0, w1 = stamp // 2 - mse_window, stamp // 2 + mse_window
    for b in range(0, len(kept), block):
        s = starts[kept[b: b + block]]
        cut = img[(s[:, 0, None] + ar)[:, :, None], (s[:, 1, None] + ar)[:, None, :]]
        means, _ = ref.forward(params, cut, precision)
        mse.append(torch.mean(torch.square(cut[:, w0:w1, w0:w1] - means[:, w0:w1, w0:w1]), dim=(1, 2, 3)))
        for m, (y, x) in zip(means, corners[b: b + block]):
            y0, x0 = max(y, 0), max(x, 0)
            y1, x1 = min(y + stamp, f), min(x + stamp, f)
            if y1 > y0 and x1 > x0:
                model[y0:y1, x0:x1] += m[y0 - y: y1 - y, x0 - x: x1 - x]
    mse = torch.cat(mse) if mse else torch.zeros(0, device=img.device)
    return img - model, mse, kept


def truth_match(found: np.ndarray, truth: np.ndarray, f: int, radius: float = 3.0, block: int = 2048):
    """(missed, spurious) of a detection against the galaxies injected into
    an F x F field: the share of the truth catalogue's (y, x) centres with
    no detection within ``radius`` pixels, and the share of the detected
    whole-pixel offsets from the centre (as ``detect`` gives them) with no
    injected galaxy within ``radius``.  Galaxies that blend into one
    detection count as missed where its centroid lies farther away."""
    a = torch.as_tensor(np.asarray(found, np.float64).reshape(-1, 2) + f // 2)
    b = torch.as_tensor(np.asarray(truth, np.float64).reshape(-1, 2))
    if len(a) == 0 or len(b) == 0:
        return float(len(b) > 0), float(len(a) > 0)
    near_a = torch.zeros(len(a), dtype=torch.bool)
    near_b = torch.zeros(len(b), dtype=torch.bool)
    for i in range(0, len(a), block):
        close = torch.cdist(a[i: i + block], b) <= radius
        near_a[i: i + block] = close.any(dim=1)
        near_b |= close.any(dim=0)
    return 1.0 - float(near_b.double().mean()), 1.0 - float(near_a.double().mean())
