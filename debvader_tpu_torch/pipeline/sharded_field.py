"""Row-band sharded survey serving: the field lives sharded over a mesh.

Port of debvader_tpu/pipeline/sharded_field.py (``ShardedFieldDeblender``,
``band_halo``).  One process drives every band (parallel/mesh.py): the
field is split into D row bands, one a mesh device, so that the resident
field and canvas of each device scale with 1/D:

- each band holds its ``band_h = ceil(F / D)`` rows plus a ``halo`` of
  neighbour rows on both sides that covers every cross-band read of a
  source whose centre row it owns (the cutout, the registration window,
  the render's reach); rows outside the field are zero;
- each source is served by the band that owns its truncated centre row:
  extract -> forward -> (epistemic statistics) -> (windowed registration)
  -> render, all on the band's device with its own copy of the weights and
  no exchange in the chunk loop; every band's chunk is queued before
  anything is read back;
- each band renders into its own padded (band_h + 2 halo + 2 pad) x
  (F + 2 pad) canvas, through the rectangular render and place kernels
  (kernels/render.py) on a card.  Offsets are re-based to the band by an
  exact integer, so the interpolation fractions are those of the
  single-device route;
- at the end of the stream each band's first and last ``halo + pad``
  canvas rows, its writes into its neighbours' rows, are copied to the
  neighbour (a ``.to(device)``, the JAX package's ``ppermute``) and added
  at fixed rows, below then above;
- the residual is computed band by band and the host concatenates the
  bands.

Per-device residency: (F / D + 2 halo) x F x B floats of field and the
matching canvas (``residency_report``); on a mesh that repeats a device,
that device holds the sum over its bands.

Random draws are band-local: band k draws from a generator of its own on
its device, seeded from (``seed``, k), the counterpart of the JAX
package's ``fold_in(rng, k)`` (threefry's stream is not torch's, so
parity with it holds under ``z_mode='mean'``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from debvader_tpu_torch.api import deblend_tensor, sample_stats_tensor
from debvader_tpu_torch.config import DetectionConfig, PipelineConfig
from debvader_tpu_torch.kernels.registration import registration_window
from debvader_tpu_torch.models.distributions import PixelNormal
from debvader_tpu_torch.models.quantized import make_quantized_forward
from debvader_tpu_torch.ops.shift import render_pad
from debvader_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate_module, require_single_process
from debvader_tpu_torch.pipeline.field import (
    _append_chunk,
    _check_field_image,
    _chunk_step,
    _records,
    _ServingTail,
    _stream_columns,
)
from debvader_tpu_torch.utils.profiling import stage_timer

__all__ = ["ShardedFieldDeblender", "band_halo"]


def band_halo(cutout_size: int, bound: float, interp_order: int) -> int:
    """Rows of neighbour-band overlap each band must hold: the cutout
    (cutout // 2 + 1 for the trunc/floor gap), the registration window
    (cutout // 2 + ceil(bound) + 3 + 1) and the render's reach (cutout // 2
    + ceil(bound) + interp_pad + 2) of a source whose centre row the band
    owns."""
    half = cutout_size // 2
    interp_pad = 1 if interp_order == 1 else 10
    reg = registration_window(cutout_size, bound) - cutout_size  # 2 * (ceil + 3)
    return half + max(reg // 2, math.ceil(bound) + interp_pad) + 2


def _fold_strips(canvases: list, strip: int, bh: int) -> None:
    """Add each band's writes into its neighbours' rows, in place: band k's
    first ``strip`` canvas rows land at band k-1's rows [bh, bh + strip),
    its last ``strip`` rows at band k+1's rows [strip, 2 strip).  Every
    strip is copied before any add (the two regions can overlap a band's
    own strips), then each band adds what comes from below, then what
    comes from above.  Nothing to do with one band."""
    d = len(canvases)
    if d <= 1:
        return
    from_below = [canvases[k + 1][:strip].to(canvases[k].device, non_blocking=True, copy=True) for k in range(d - 1)]
    from_above = [canvases[k - 1][bh + strip :].to(canvases[k].device, non_blocking=True, copy=True)
                  for k in range(1, d)]
    for k in range(d - 1):
        canvases[k][bh : bh + strip] += from_below[k]
    for k in range(1, d):
        canvases[k][strip : 2 * strip] += from_above[k - 1]


def _band_devices(mesh) -> list:
    """The band axis: every device of a Mesh, row by row, or an explicit
    device sequence (checked as ``make_mesh`` checks it)."""
    if not isinstance(mesh, Mesh):
        mesh = make_mesh(devices=list(mesh))
    require_single_process(mesh, "ShardedFieldDeblender")
    return mesh.flat


def _band_seed(seed: int, k: int) -> int:
    """Band k's generator seed: (seed, k) mixed, so that no two bands or
    seeds share a stream."""
    return int(np.random.SeedSequence([int(seed), int(k)]).generate_state(1, np.uint64)[0] >> 1)


class ShardedFieldDeblender(_ServingTail):
    """Survey serving with the field row-band sharded over a device mesh.

    ``net``: a DeblenderVAE (on any device: each band device gets a copy).
    ``mesh``: a parallel.Mesh (all its devices, row by row, form the band
    axis) or a device sequence; it may repeat a device.  The field must be
    tall enough that each band holds a whole halo (F >= D * halo): this is
    the survey-scale path, and small fields belong on one device.

    Products: ``deblend_and_render`` (catalogue, residual, model),
    ``deblend_and_predict`` (mean, stddev and epistemic fields),
    ``detect_objects`` (band-tiled detection) and
    ``iterative_deblend_and_render``, with band-local epistemic sampling
    (``epistemic_uncertainty_estimation=True``) and ``measure=True``.

    ``quantized``: a models.quantized.QuantizedVAE; each band runs its
    int8 forward on a copy of the bundle on the band's device (its
    ``normalise`` must equal the pipeline's).  Epistemic sampling stays on
    ``net``.  ``seed``: the band generators' seed (``z_mode='sample'`` and
    the epistemic draws)."""

    def __init__(
        self,
        net,
        field_image,
        mesh,
        cutout_size: int = 59,
        nb_of_bands: int = 6,
        epistemic_uncertainty_estimation: bool = False,
        normalise: bool = False,
        cfg: PipelineConfig | None = None,
        seed: int = 0,
        z_mode: str = "sample",
        halo: int | None = None,
        quantized=None,
    ):
        self.field_image = np.array(field_image, dtype=np.float32)
        _check_field_image(self.field_image)
        self.field_size = int(self.field_image.shape[1])
        self.cutout_size = cutout_size
        self.nb_of_bands = nb_of_bands
        self.epistemic_uncertainty_estimation = bool(epistemic_uncertainty_estimation)
        self.normalise = normalise
        self.cfg = cfg or PipelineConfig(cutout_size=cutout_size, nb_of_bands=nb_of_bands)
        if z_mode not in ("sample", "mean"):
            raise ValueError(f"z_mode must be 'sample' or 'mean', got {z_mode!r}")
        self.z_mode = z_mode

        self.devices = _band_devices(mesh)
        self.n_bands_mesh = len(self.devices)
        f, d = self.field_size, self.n_bands_mesh
        self.band_h = -(-f // d)  # ceil: the bottom band is zero-padded
        base_halo = band_halo(cutout_size, self.cfg.position_bounds, self.cfg.interp_order)
        if halo is None:
            # detection's cross-band tiles read tile_overlap neighbour rows:
            # include them when the bands can afford it
            halo = max(base_halo, self.cfg.tile_overlap)
            if halo > self.band_h:
                halo = base_halo
        elif halo < base_halo:
            raise ValueError(
                f"halo={halo} is below the {base_halo} rows serving needs (cutout {cutout_size}, bound "
                f"{self.cfg.position_bounds}, order {self.cfg.interp_order})"
            )
        self.halo = halo
        if self.band_h < self.halo:
            raise ValueError(
                f"field of {f} rows over {d} devices gives {self.band_h}-row bands, smaller than the "
                f"{self.halo}-row halo a {cutout_size}px cutout needs — cross-band writes would skip a "
                f"band.  Use fewer devices or the single-device driver."
            )
        self.pad = render_pad(cutout_size, self.cfg.interp_order)
        self.h_pad = self.band_h + 2 * self.halo

        if quantized is not None and bool(quantized.normalise) != bool(normalise):
            raise ValueError(
                f"quantized bundle was calibrated with normalise={quantized.normalise} but the pipeline was "
                f"built with normalise={normalise}; the activation scales only match their calibration "
                f"transform"
            )
        self.net = net
        self.quantized = quantized
        self._nets = replicate_module(net, None, devices=self.devices)
        self._quant_fwds = None
        if quantized is not None:
            self._quant_fwds = [make_quantized_forward(q, z_mode=z_mode)
                                for q in replicate_module(quantized, None, devices=self.devices)]
        self._generators = [torch.Generator(device=dev).manual_seed(_band_seed(seed, k))
                            for k, dev in enumerate(self.devices)]
        self._shards = None  # built on the first serve
        self.nb_of_detected_objects: list[int] = []
        self.nb_of_deblended_galaxies: list[int] = []
        self.serving_timings: dict = {}

    # ------------------------------------------------------------ geometry

    @property
    def _distinct(self) -> list:
        return list(dict.fromkeys(self.devices))

    def _field_shards(self) -> list:
        """D pre-haloed row bands (band_h + 2 halo, F, B) float32, band k
        on device k; rows outside [0, F) are zero."""
        if self._shards is not None:
            return self._shards
        f, bh, halo = self.field_size, self.band_h, self.halo
        field = self.field_image[0]
        shards = []
        for k, dev in enumerate(self.devices):
            host = np.zeros((self.h_pad, f, self.nb_of_bands), np.float32)
            lo = k * bh - halo
            src_lo, src_hi = max(lo, 0), min(lo + self.h_pad, f)
            if src_lo < src_hi:
                host[src_lo - lo : src_hi - lo] = field[src_lo:src_hi]
            shards.append(torch.from_numpy(host).to(dev))
        self._shards = shards
        return shards

    def _fresh_canvases(self) -> list:
        shape = (self.h_pad + 2 * self.pad, self.field_size + 2 * self.pad, self.nb_of_bands)
        return [torch.zeros(shape, dtype=torch.float32, device=dev) for dev in self.devices]

    def residency_report(self, include_canvas: bool = True) -> dict:
        """Bytes of the serving-resident buffers, read from the live
        tensors: ``field_bytes_per_device`` / ``canvas_bytes_per_device``
        (one band's, the largest), the formulas ``predicted_field_bytes`` =
        (band_h + 2 halo) x F x B x 4 and ``predicted_canvas_bytes``,
        ``per_shard`` (each band's field + canvas) and ``per_device`` ({device:
        total bytes}: on a mesh that repeats a device, the sum over its
        bands, the physical residency)."""
        f, b = self.field_size, self.nb_of_bands
        per_shard = [0] * self.n_bands_mesh
        per_dev: dict[str, int] = {}

        def account(tensors):
            most = 0
            for k, t in enumerate(tensors):
                nbytes = t.untyped_storage().nbytes()
                per_shard[k] += nbytes
                per_dev[str(t.device)] = per_dev.get(str(t.device), 0) + nbytes
                most = max(most, nbytes)
            return most

        out = {
            "field_bytes_per_device": account(self._field_shards()),
            "predicted_field_bytes": self.h_pad * f * b * 4,
        }
        if include_canvas:
            out["canvas_bytes_per_device"] = account(self._fresh_canvases())
            out["predicted_canvas_bytes"] = (self.h_pad + 2 * self.pad) * (f + 2 * self.pad) * b * 4
        out["per_shard"] = per_shard
        out["per_device"] = per_dev
        return out

    def _assign(self, centers: np.ndarray):
        """Host-side routing: extraction validity (true-field semantics) and
        band ownership by the truncated centre row."""
        f, cs = self.field_size, self.cutout_size
        half, fhalf = cs // 2, f // 2
        c_int = np.trunc(centers).astype(np.int64)
        starts = c_int + (fhalf - half)
        valid = np.all((starts >= 0) & (starts + cs <= f), axis=-1)
        owner = np.clip((c_int[:, 0] + fhalf) // self.band_h, 0, self.n_bands_mesh - 1)
        return starts, valid, owner

    # -------------------------------------------------------------- chunks

    def _band_chunk(self, k: int, band: torch.Tensor, reg_band, starts: np.ndarray, dets: np.ndarray,
                    canvases: dict, measure: bool, timings: dict, pending: list) -> dict:
        """One chunk of band k's sources on its device: the cutouts gathered
        from the haloed band at ``starts`` (band-local rows), then the
        single-device route's chunk step (``field._chunk_step``) with the
        band's forward, generator and canvases, the offsets re-based to the
        band and the registration windows kept inside the true field's
        rows.  Returns the per-source scalars, on the device.  The
        gather is the chunk's 'cutouts' span, the chunk step's the others
        (``timings`` through ``pending``, as on the single-device route)."""
        dev = self.devices[k]
        cs, f, bh, halo = self.cutout_size, self.field_size, self.band_h, self.halo
        gen = self._generators[k]
        with stage_timer(timings, "cutouts", dev, pending):
            st = torch.as_tensor(starts, device=dev)
            ar = torch.arange(cs, device=dev)
            raw = band[(st[:, 0, None] + ar)[:, :, None], (st[:, 1, None] + ar)[:, None, :]]  # (m, S, S, B)

        def forward(x):
            if self._quant_fwds is not None:
                return PixelNormal(*self._quant_fwds[k](x, gen))
            return deblend_tensor(self._nets[k], x, self.normalise, gen, self.z_mode)

        def epistemic(x):
            # band-local epistemic statistics of the un-normalised stamps
            # (the replicas apply the normalise bracket themselves)
            return sample_stats_tensor(self._nets[k], x, self.cfg.epistemic_samples, generator=gen,
                                       normalise=self.normalise)[1]

        # the integer re-base from the field's centre to the padded band's:
        # exact, so the interpolation fractions are the single-device ones
        base_delta = (f - cs) // 2 - (self.h_pad - cs) // 2 + halo
        delta = torch.tensor([float(base_delta - bh * k), 0.0], dtype=torch.float32, device=dev)
        # registration windows clamp at the true field's rows, not the
        # band's zero halo past the field's edge
        row_bounds = (max(0, halo - k * bh), min(self.h_pad, f - k * bh + halo))
        local = {name: c[k] for name, c in canvases.items()}
        scalars = _chunk_step(
            raw, torch.as_tensor(dets, device=dev) + delta, forward, local, (self.h_pad, f), self.cfg,
            2 if self.nb_of_bands > 2 else 0, measure,
            epistemic=epistemic if self.epistemic_uncertainty_estimation else None,
            reg_band=reg_band, row_bounds=row_bounds, timings=timings, pending=pending,
        )
        for name, c in local.items():
            canvases[name][k] = c
        return scalars

    @torch.no_grad()
    def _serve_stream(
        self,
        shards: list,
        centers: np.ndarray,
        optimise_positions: bool,
        mse_criterion: float,
        source_chunk_per_band: int | None = None,
        epistemic_criterion: float = 100.0,
        measure: bool = False,
        render_std: bool = False,
        render_epi: bool = False,
        timings=None,
        pending=None,
    ):
        """Chunk-streamed extract -> forward -> register -> render against
        the given haloed shards.  Returns (catalogue columns sorted by
        list_idx, {name: per-band padded canvases} or None, n_deblended).
        Each chunk's 'cutouts', 'forward' and 'render' spans go into
        ``timings`` through ``pending`` (``_band_chunk``)."""
        t = timings if timings is not None else {}
        pending = pending if pending is not None else []
        if render_epi and not self.epistemic_uncertainty_estimation:
            raise ValueError("render_epi=True requires epistemic_uncertainty_estimation")
        d, bh, halo = self.n_bands_mesh, self.band_h, self.halo
        starts_g, valid, owner = self._assign(centers)
        if not valid.all():
            print("Some galaxies are too close from the border of the field to be considered here.")
        per_band = [np.flatnonzero(valid & (owner == k)) for k in range(d)]
        max_len = max(len(ix) for ix in per_band)
        self.nb_of_detected_objects.append(len(centers))
        self.nb_of_deblended_galaxies.append(int(valid.sum()))
        cols = _stream_columns(measure)
        if max_len == 0:
            return cols, None, 0

        m = min(max_len, source_chunk_per_band or self.cfg.source_chunk)
        canvases = {"mean": self._fresh_canvases()}
        if render_std:
            canvases["std"] = self._fresh_canvases()
        if render_epi:
            canvases["epi"] = self._fresh_canvases()
        det_band = 2 if self.nb_of_bands > 2 else 0
        reg_bands = [s[:, :, det_band].contiguous() if optimise_positions else None for s in shards]

        # every band's chunks are queued before any scalar is read back
        queued = []
        for s0 in range(0, max_len, m):
            for k in range(d):
                take = per_band[k][s0 : s0 + m]
                if len(take) == 0:
                    continue
                st = starts_g[take].copy()
                st[:, 0] -= k * bh - halo  # rows local to the haloed band
                scalars = self._band_chunk(k, shards[k], reg_bands[k], st, centers[take], canvases, measure, t,
                                           pending)
                queued.append((take, scalars))
        for take, scalars in queued:
            got = {key: v.cpu().numpy() for key, v in scalars.items()}
            _append_chunk(cols, got, take, centers[take], mse_criterion, epistemic_criterion)
        order = np.argsort(np.asarray(cols["list_idx"], np.int64), kind="stable")
        cols = {key: [v[i] for i in order] for key, v in cols.items()}
        return cols, canvases, int(valid.sum())

    def _crop(self, canvases: list) -> np.ndarray:
        """Fold one canvas's strips and download its band-local field
        crops, concatenated on the host: (F, F, B)."""
        strip, bh, pad, f = self.halo + self.pad, self.band_h, self.pad, self.field_size
        _fold_strips(canvases, strip, bh)
        crops = [c[strip : strip + bh, pad : pad + f] for c in canvases]
        return np.concatenate([c.cpu().numpy() for c in crops])[:f]

    def _finish(self, shards: list, canvases: list, want_model: bool):
        """Fold the mean canvas's strips and download the band-local
        residual (and model): (residual (F, F, B), model or None)."""
        strip, bh, pad, f, halo = self.halo + self.pad, self.band_h, self.pad, self.field_size, self.halo
        _fold_strips(canvases, strip, bh)
        models = [c[strip : strip + bh, pad : pad + f] for c in canvases]
        resids = [s[halo : halo + bh] - mdl for s, mdl in zip(shards, models)]
        resid = np.concatenate([r.cpu().numpy() for r in resids])[:f]
        model = np.concatenate([mdl.cpu().numpy() for mdl in models])[:f] if want_model else None
        return resid, model

    # ------------------------------------------------------------- serving

    def deblend_and_render(
        self,
        galaxy_distances_to_center,
        optimise_positions: bool = False,
        epistemic_criterion: float = 100.0,
        mse_criterion: float = 100.0,
        measure: bool = False,
        return_model: bool = False,
        source_chunk_per_band: int | None = None,
        timings=None,
    ):
        """Catalogue + residual (+ model with ``return_model``) with every
        field-sized buffer sharded: the products of
        ``DeblendField.deblend_and_render``, with the same extraction,
        forward, registration and render a source; the band loop changes
        only the order of float sums.  ``source_chunk_per_band`` caps the
        sources a band takes a chunk (``cfg.source_chunk`` by default).
        ``timings`` accumulates the seconds of 'upload' (the bands' first
        upload), 'deblend_render' (with each chunk's 'cutouts', 'forward'
        and 'render' device seconds nested in it), 'field_download',
        'catalog' and 'residual_copy', as on the single-device route."""
        return self._serve(
            galaxy_distances_to_center, timings, return_model=return_model, optimise_positions=optimise_positions,
            epistemic_criterion=epistemic_criterion, mse_criterion=mse_criterion, measure=measure,
            source_chunk_per_band=source_chunk_per_band,
        )

    def deblend_and_predict(
        self,
        galaxy_distances_to_center,
        optimise_positions: bool = False,
        epistemic_criterion: float = 100.0,
        mse_criterion: float = 100.0,
        measure: bool = False,
        timings=None,
    ):
        """Sharded counterpart of ``DeblendField.deblend_and_predict``: the
        mean, aleatoric-stddev and (with
        ``epistemic_uncertainty_estimation=True``) epistemic canvases
        accumulate band by band in one stream; each field folds its strips
        and downloads band by band.  Returns (catalogue, fields) with the
        single-device dict's keys; ``timings`` as in
        ``deblend_and_render``."""
        return self._serve(
            galaxy_distances_to_center, timings, predict=True, optimise_positions=optimise_positions,
            epistemic_criterion=epistemic_criterion, mse_criterion=mse_criterion, measure=measure,
        )

    # the serving tail's layout steps (_ServingTail; the stream is _serve_stream)

    @staticmethod
    def _timings(timings) -> dict:
        return timings if timings is not None else {}

    def _served_field(self, timings: dict) -> list:
        with stage_timer(timings, "upload", self._distinct):
            return self._field_shards()

    def _download_fields(self, shards: list, canvases: dict, want_mean: bool, transfer_dtype=None) -> dict:
        """The served fields on the host, band by band: the std, then the
        epistemic canvas, then the residual and (``want_mean``) the mean
        (``_crop``, ``_finish``).  Every field is float32 here."""
        out = {k: self._crop(canvases.pop(k)) for k in ("std", "epi") if k in canvases}
        out["residual"], out["mean"] = self._finish(shards, canvases["mean"], want_mean)
        return out

    # ----------------------------------------------------------- detection

    def detect_objects(self, det_cfg=None, tile: int | None = None, overlap: int | None = None, timings=None,
                       shards=None) -> np.ndarray:
        """Tiled detection over the band-sharded field: each band tiles its
        own rows (plus ``overlap`` context rows from its halo) on its
        device, the stacks go through the detection core band by band
        (``ops.detection.detect_shards``), and the host keeps each source
        in the one tile core that contains it, with the band edges as
        further core cuts (the core partition of ``detect_objects_tiled``).
        Returns (N, 2) offsets from the field centre."""
        from debvader_tpu_torch.ops.detection import detect_shards
        from debvader_tpu_torch.pipeline.tiles import _core_bounds, _select_in_cores, tile_origins

        det_cfg = det_cfg or DetectionConfig()
        tile = tile or self.cfg.tile_size
        overlap = overlap or self.cfg.tile_overlap
        f, d, bh, halo = self.field_size, self.n_bands_mesh, self.band_h, self.halo
        if overlap > halo:
            raise ValueError(
                f"tile overlap {overlap} exceeds the shard halo {halo}; rebuild the deblender with "
                f"cfg.tile_overlap >= {overlap}"
            )
        if tile > bh:
            raise ValueError(f"tile size {tile} exceeds the {bh}-row band; use a smaller tile or fewer devices")
        det_band = det_cfg.detection_band if self.nb_of_bands > det_cfg.detection_band else 0
        if shards is None:
            shards = self._field_shards()

        # each band's row tiling over [band - overlap, band + overlap) ∩ field
        ys_band = []
        for k in range(d):
            lo, hi = max(0, k * bh - overlap), min(f, (k + 1) * bh + overlap)
            ys_band.append([lo + o for o in tile_origins(hi - lo, tile, overlap)])
        t_rows = max(len(ys) for ys in ys_band)
        xs = tile_origins(f, tile, overlap)
        x_cores = _core_bounds(xs, tile, 0, f)
        stacks, tiles = [], []
        for k, ys in enumerate(ys_band):
            # the edge bands are padded to a common row count with tiles
            # that have no core
            y_cores = list(_core_bounds(ys, tile, k * bh, min((k + 1) * bh, f))) + [(0, 0)] * (t_rows - len(ys))
            ys += [ys[-1]] * (t_rows - len(ys))
            tiles += [(oy, yb, ox, xb) for oy, yb in zip(ys, y_cores) for ox, xb in zip(xs, x_cores)]
            local = [y - (k * bh - halo) for y in ys]
            # origins are clipped to the field, so no tile leaves the band
            if min(local) < 0 or max(local) + tile > self.h_pad:
                raise AssertionError("band tiling escaped the shard extent")
            det2d = shards[k][:, :, det_band]
            stacks.append(torch.stack([det2d[y : y + tile, x : x + tile] for y in local for x in xs]))
        objs = detect_shards(stacks, det_cfg, timings=timings, want_map=False)
        return _select_in_cores(objs, tiles, f // 2)

    # ----------------------------------------------------------- iterative

    def _subtract(self, res: list, canvases: list):
        """One iterative step's tail: fold the canvas's strips, subtract
        the model from each band's interior rows (the bottom band's rows
        past the field stay zero), rebuild the halos from the neighbours'
        new interiors, and the model's power summed in band order on the
        first device.  Returns (new haloed residual bands, power)."""
        f, bh, halo, pad = self.field_size, self.band_h, self.halo, self.pad
        strip = halo + pad
        d = self.n_bands_mesh
        _fold_strips(canvases, strip, bh)
        new_int, power = [], []
        for k in range(d):
            model_int = canvases[k][strip : strip + bh, pad : pad + f]
            inside = (torch.arange(bh, device=self.devices[k]) + k * bh < f)[:, None, None]
            new_int.append(torch.where(inside, res[k][halo : halo + bh] - model_int, 0.0))
            power.append(torch.sum(torch.where(inside, torch.square(model_int), 0.0)))
        first = self.devices[0]
        total = power[0]
        for p in power[1:]:
            total = total + p.to(first, non_blocking=True)
        out = []
        for k in range(d):
            top = (new_int[k - 1][bh - halo :].to(self.devices[k], non_blocking=True) if k > 0
                   else torch.zeros_like(new_int[k][:halo]))
            bottom = (new_int[k + 1][:halo].to(self.devices[k], non_blocking=True) if k < d - 1
                      else torch.zeros_like(new_int[k][:halo]))
            out.append(torch.cat([top, new_int[k], bottom]))
        return out, total

    @torch.no_grad()
    def iterative_deblend_and_render(
        self,
        galaxy_distances_to_center=None,
        optimise_positions: bool = False,
        epistemic_criterion: float = 100.0,
        mse_criterion: float = 100.0,
        measure: bool = False,
        det_cfg=None,
        max_iterations: int = 20,
        timings=None,
    ):
        """Sharded detect -> deblend -> subtract: the running residual stays
        band-sharded between steps, and detection, the stream and the
        subtraction read and write it there.  The loop goes on while a step
        deblends strictly more sources than the last, stops on a step that
        detects or deblends nothing, or after ``max_iterations``; the
        catalogue gains an ``iteration`` column and ``self.mse`` each
        step's mean square model power.  Returns (catalogue,
        residual_field); ``timings`` accumulates 'upload', 'detect',
        'deblend_render', 'subtract' and 'field_download' seconds."""
        t = self._timings(timings)
        self.serving_timings = t
        f = self.field_size
        with stage_timer(t, "upload", self._distinct):
            # the running residual is a copy: the memoized field stays
            res = [s.clone() for s in self._field_shards()]
        all_cols: dict[str, list] = {}
        self.mse: list[float] = []
        n_prev = total = 0

        for it in range(max_iterations):
            if it == 0 and galaxy_distances_to_center is not None:
                centers = np.asarray(galaxy_distances_to_center, np.float32).reshape(-1, 2)
            else:
                with stage_timer(t, "detect", self._distinct):
                    centers = self.detect_objects(det_cfg, shards=res).astype(np.float32)
            if len(centers) == 0:
                print("No more galaxies found")
                break
            with stage_timer(t, "deblend_render", self._distinct):
                cols, canvases, n_new = self._serve_stream(
                    res, centers, optimise_positions, mse_criterion, None,
                    epistemic_criterion=epistemic_criterion, measure=measure,
                )
            if n_new == 0:
                print("No more galaxies found")
                break
            with stage_timer(t, "subtract", self._distinct):
                res, power = self._subtract(res, canvases["mean"])
                power = float(power.item())
            self.mse.append(power / (f * f * self.nb_of_bands))
            cols["list_idx"] = [i + total for i in cols["list_idx"]]
            cols["iteration"] = [it] * n_new
            for key, vals in cols.items():
                all_cols.setdefault(key, []).extend(vals)
            total += n_new
            print(f"iteration {it + 1}")
            print(f"{total} galaxies found up to this step.")
            if it > 0 and n_new <= n_prev:
                break
            n_prev = n_new

        print("converged !")
        if total == 0:
            return None, self._residual_field()
        with stage_timer(t, "field_download", self._distinct):
            resid = np.concatenate([r[self.halo : self.halo + self.band_h].cpu().numpy() for r in res])[:f]
        return _records(all_cols), self._residual_field(resid)
