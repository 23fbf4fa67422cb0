"""Scene-level field deblending on the device, in PyTorch.

Port of debvader_tpu.pipeline.field.DeblendField along its single-device
float path.  Two routes:

- the record-array route, ``deblend_field`` then ``get_residual_field`` /
  ``get_predicted_field``: cutouts in one gather (ops/extraction.py), the
  batched VAE forward (api.py), the centre-window mse cut, every source's
  mean and stddev stamp downloaded into a numpy record array (the
  reference's contract), and the fields rendered from it (ops/shift.py).
  The device copies of the field and of the last result's stamps are
  memoized, so the render does not upload again what the deblend
  downloaded;
- the streaming serving route, ``deblend_and_render`` /
  ``deblend_and_predict``: sources stream through in ``source_chunk``
  batches, each chunk's stamps render straight into a padded canvas on the
  device, and only per-source scalars and the final fields reach the host.

The catalogs are numpy record arrays with the columns, order and dtypes of
the JAX package's pandas ``to_records`` output, built without pandas.
Eager PyTorch needs no batch buckets, so chunks are not padded; the JAX
package's donated buffers become in-place accumulation into the canvas.

With ``epistemic_uncertainty_estimation=True`` both routes also compute
each source's epistemic stddev stamp from ``cfg.epistemic_samples``
stochastic decodes (api.sample_stats_tensor: one encode, Welford statistics
on the device), and the serving route renders them into a third canvas.

``optimise_positions=True`` registers every source (ops/registration.py:
a Gauss-Newton fit of its shift, a CUDA kernel on a card) and renders it
at its detected offset plus the shift.  ``upload_dtype`` /
``device_dtype`` hold the field on the device at a reduced precision;
under ``device_dtype='bfloat16'`` the serving route's canvases are
bfloat16 too, and the render kernels round every add to bfloat16.

``quantized=`` (a models/quantized.QuantizedVAE on the same device) runs
both routes' batched forward through the int8 layers
(kernels/int8_conv.py), with the bundle's own finite guard and
normalisation bracket and no flux calibration; the epistemic replicas stay
on the float model.  ``artifact=`` (an exported forward, utils/export.py)
runs both routes' batched forward through the exported program, with the
live route's bracket; the epistemic replicas stay on ``net`` there too.

``mesh=`` (parallel/mesh.py) splits both routes' batched forward over the
mesh's 'data' axis (parallel/sharded.py: the batch padded to a multiple of
the axis, each shard's forward on its device, the outputs gathered onto
the pipeline's device), the int8 forward too under ``quantized=``, and the
epistemic replicas the same way; the latent noise is drawn once for the
whole batch from ``generator``, so a mesh run gives the single-device
run's numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from debvader_tpu_torch.api import deblend_tensor, sample_stats_tensor
from debvader_tpu_torch.config import PipelineConfig
from debvader_tpu_torch.device import resolve_device
from debvader_tpu_torch.models.distributions import PixelNormal
from debvader_tpu_torch.models.quantized import make_quantized_forward, make_sharded_quantized_forward
from debvader_tpu_torch.ops.extraction import extract_cutouts, extract_cutouts_np
from debvader_tpu_torch.ops.measure import measure_batch
from debvader_tpu_torch.ops.registration import position_optimization_batch_windowed
from debvader_tpu_torch.ops.shift import render_field, render_pad
from debvader_tpu_torch.utils.profiling import settle_spans, stage_timer

__all__ = ["DeblendField"]

_MEASURE_COLUMNS = ("flux", "centroid", "ellipticity", "snr")

# Device memory one source of a stream chunk takes at its peak (cutouts,
# the forward's activations in float32, the mean and stddev stamps, the
# measurements): 2,781,654 bytes a source, measured by chip_smoke.py's
# stream_chunk_memory phase (torch.cuda.max_memory_allocated over one
# 295-source chunk of deblend_and_predict(measure=True), less the two
# canvases) on an NVIDIA H100 80GB HBM3, 700.00 W; rounded up.
_STREAM_BYTES_PER_SOURCE = 2_800_000
# Weights, cuDNN workspaces, the CUDA context and allocator slack: a margin
# chosen for the port, not a measurement.
_STREAM_RESERVE_BYTES = 2 << 30
_MIN_STREAM_CHUNK = 16


def _check_field_image(arr: np.ndarray) -> None:
    if arr.ndim != 4 or arr.shape[1] != arr.shape[2]:
        raise ValueError(
            f"field_image must be (1, F, F, B) with a square field (got {arr.shape}); "
            f"the centre-offset and extraction conventions are single-axis"
        )


def _check_reduced_dtype(name: str, value):
    """An opt-in reduced-precision transfer dtype: only the two float
    formats that keep a usable range at a shorter mantissa make sense for
    field pixels."""
    if value is not None and str(value) not in ("bfloat16", "float16"):
        raise ValueError(f"{name} must be 'bfloat16' or 'float16', got {value!r}")
    return None if value is None else str(value)


def _bfloat16_host(arr: np.ndarray) -> torch.Tensor:
    """A float32 array cast to bfloat16 on the host, as ``ml_dtypes`` casts
    it (the JAX package's host cast): round to nearest even, infinities
    kept, and a NaN becomes the quiet NaN of its sign (torch's own cast
    drops the sign)."""
    u = np.ascontiguousarray(arr, np.float32).view(np.uint32)
    rne = (u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    bits = np.where(nan, ((u >> 16) & np.uint32(0x8000)) | np.uint32(0x7FC0), rne).astype(np.uint16)
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def _records(res: dict) -> np.recarray:
    """A record array like ``pd.DataFrame(res).to_records(index=False)``:
    array-valued columns as objects, scalar columns in their own dtype."""
    n = len(res["list_idx"])
    fields, columns = [], []
    for name, values in res.items():
        if n and np.ndim(values[0]) > 0:
            col = np.empty(n, dtype=object)
            for i, v in enumerate(values):
                col[i] = v
        else:
            col = np.asarray(values)
        fields.append((name, col.dtype))
        columns.append(col)
    out = np.empty(n, dtype=fields)
    for (name, _), col in zip(fields, columns):
        out[name] = col
    return out.view(np.recarray)


_STREAM_COLUMNS = ("shifts", "list_idx", "galaxy_distances_to_center_x", "galaxy_distances_to_center_y",
                   "mse_center", "epistemic_norm", "passed_cuts")


def _stream_columns(measure: bool) -> dict:
    """The streaming catalogue's empty columns."""
    return {k: [] for k in _STREAM_COLUMNS + (_MEASURE_COLUMNS if measure else ())}


def _chunk_step(raw, dets, forward, canvases: dict, canvas_size, cfg: PipelineConfig, band: int, measure: bool,
                epistemic=None, reg_band=None, row_bounds=None, canvas_dtype=torch.float32, *, timings: dict,
                pending: list) -> dict:
    """One stream chunk of m sources on their device, shared by the
    single-device and the row-band routes: ``forward(raw)`` (a
    PixelNormal) of the raw cutouts (m, S, S, B), the mse cut's centre
    window, the epistemic norm (``epistemic(raw)`` gives the epistemic
    stddev stamps; zeros without it), the windowed registration against
    ``reg_band`` (when given; its windows inside ``row_bounds``) and the
    renders, at ``dets`` (m, 2) plus the shifts, into ``canvases``
    ({'mean' / 'std' / 'epi': padded canvas, or None before the first
    chunk}, updated in place) of ``canvas_size`` (F or (H, W)), the stamps
    cast to ``canvas_dtype``.  Returns the per-source scalars on the
    device; nothing here waits for the device: the 'forward' (the forward,
    its means and stddevs) and 'render' (the canvases' renders) spans
    record events into ``pending`` for ``settle_spans`` to add to
    ``timings`` (the wall clock's seconds at once on the CPU)."""
    with stage_timer(timings, "forward", raw.device, pending):
        dist = forward(raw)
        means = dist.mean()
        std = dist.stddev() if ("std" in canvases or measure) else None
    c0 = raw.shape[1] // 2 - cfg.mse_window
    c1 = raw.shape[1] // 2 + cfg.mse_window
    scalars = {"mse_center": torch.mean(torch.square(raw[:, c0:c1, c0:c1] - means[:, c0:c1, c0:c1]), dim=(1, 2, 3))}
    epi = None
    if epistemic is not None:
        epi = epistemic(raw)
        scalars["epistemic_norm"] = epi[..., band].sum(dim=(1, 2)) / torch.clamp(
            means[..., band].sum(dim=(1, 2)), min=1e-30)
    else:
        scalars["epistemic_norm"] = torch.zeros((raw.shape[0],), dtype=torch.float32, device=raw.device)
    offs = dets
    if reg_band is not None:
        scalars["shifts"] = position_optimization_batch_windowed(
            reg_band, means[..., band], dets, bound=cfg.position_bounds, iterations=cfg.gn_iterations,
            row_bounds=row_bounds,
        )
        offs = dets + scalars["shifts"]
    # the stddev canvas adds the sources' stddevs: the reference's
    # predicted-field convention
    stamps = {"mean": means, "std": std, "epi": epi}
    with stage_timer(timings, "render", raw.device, pending):
        for name, canvas in canvases.items():
            canvases[name] = render_field(stamps[name].to(canvas_dtype), offs, canvas_size,
                                          order=cfg.interp_order, canvas=canvas, crop=False)
    if measure:
        m = measure_batch(means, std)
        scalars.update({k: m[k] for k in _MEASURE_COLUMNS})
    return scalars


def _append_chunk(cols: dict, got: dict, list_idx, dets: np.ndarray, mse_criterion: float,
                  epistemic_criterion: float) -> None:
    """One chunk's scalars, read back to the host, added to the catalogue
    columns: the sources' indices, detected offsets, shifts (zero when
    positions were not optimised) and the cuts' verdict."""
    mse, epi = got["mse_center"], got["epistemic_norm"]
    passed = ~((epi > epistemic_criterion) | (mse > mse_criterion)) & np.isfinite(mse) & np.isfinite(epi)
    cols["shifts"].extend(list(got["shifts"] if "shifts" in got else np.zeros((len(dets), 2), np.float32)))
    cols["list_idx"].extend(list(list_idx))
    cols["galaxy_distances_to_center_x"].extend(list(dets[:, 0]))
    cols["galaxy_distances_to_center_y"].extend(list(dets[:, 1]))
    cols["mse_center"].extend(list(mse))
    cols["epistemic_norm"].extend(list(epi))
    cols["passed_cuts"].extend(list(passed))
    for k in _MEASURE_COLUMNS:
        if k in cols:
            cols[k].extend(list(got[k]))


def _crop_canvas(canvas: torch.Tensor, pad: int, out_dtype=None) -> torch.Tensor:
    """The field window of a padded render canvas, cast to the transfer
    dtype on the device when one is given."""
    f = canvas.shape[0] - 2 * pad
    out = canvas[pad : pad + f, pad : pad + f]
    return out if out_dtype is None else out.to(getattr(torch, out_dtype))


def _render_finish(field: torch.Tensor, canvas: torch.Tensor, pad: int, out_dtype=None) -> torch.Tensor:
    """field - crop(canvas), at the transfer dtype."""
    residual = field[0] - _crop_canvas(canvas, pad)
    return residual if out_dtype is None else residual.to(getattr(torch, out_dtype))


def _model_subtract(residual: torch.Tensor, canvas: torch.Tensor, pad: int, in_place: bool):
    """One iterative-serving step's update: (residual - crop(canvas), the
    mean square of the cropped model).  The power is summed in float32
    whatever the canvas's dtype; under ``device_dtype='bfloat16'`` the
    residual and the subtract stay bfloat16.  ``in_place`` writes into
    ``residual``, for a step that owns it (never the memoized field)."""
    model = _crop_canvas(canvas, pad)
    power = torch.mean(torch.square(model.to(torch.float32)))
    if in_place:
        residual[0] -= model
        return residual, power
    return residual - model[None], power


def _serving_chunk_cap(
    field_size: int,
    bands: int,
    hbm_bytes: int,
    resident_fields: int = 2,
    replica_chunk: bool = False,
    bytes_per_el: int = 4,
    extra_bytes: int = 0,
) -> int:
    """Largest forward chunk that fits beside the streaming loop's resident
    buffers: the stream holds the field and its padded render canvases
    (``resident_fields`` full-field buffers of ``bytes_per_el`` bytes an
    element: 4 for float32, 2 under ``device_dtype='bfloat16'``) and
    ``extra_bytes`` more (the float32 registration band) for its whole
    duration, and each source of a chunk takes
    ``_STREAM_BYTES_PER_SOURCE`` at the chunk's peak.  ``replica_chunk``
    leaves room for one chunk of epistemic replica decodes of the same
    size, which runs while the chunk's own stamps are alive: its decodes
    are budgeted like whole forwards."""
    resident = resident_fields * bytes_per_el * field_size * field_size * bands
    budget = hbm_bytes - resident - extra_bytes - _STREAM_RESERVE_BYTES
    per_source = _STREAM_BYTES_PER_SOURCE * (2 if replica_chunk else 1)
    return max(budget // per_source, _MIN_STREAM_CHUNK)


# Period-64 pseudo-random weights for the position-sensitive part of the
# content checksums (fixed seed: keys must be stable across calls).
_CKSUM_W = np.random.default_rng(12345).standard_normal(64)


def _weighted_sums(flat: np.ndarray) -> tuple[float, float]:
    """(plain sum, period-64 weighted sum) of a flat array in float64, from
    one pass over it (the 64 column sums give both).  A plain sum alone
    collides under compensating edits (pixel swaps, +x/-x pairs); the
    weighted sum changes unless the edited positions sit a multiple of 64
    apart and compensate under both weightings."""
    n = (flat.size // 64) * 64
    cols = flat[:n].reshape(-1, 64).sum(axis=0, dtype=np.float64)
    tail = flat[n:].astype(np.float64)
    return float(cols.sum() + tail.sum()), float(cols @ _CKSUM_W + tail @ _CKSUM_W[: tail.size])


class _ServingTail:
    """The serving tail of both field layouts, ``DeblendField`` on one
    device and ``ShardedFieldDeblender`` in row bands, written once: the
    stage dict, the 'deblend_render' stage and its event spans, the
    empty-field returns, 'field_download', 'catalog' and 'residual_copy'.
    Each layout gives ``_timings`` (its entry call's stage dict),
    ``_distinct`` (the devices its stages synchronise), ``_served_field``
    (the field on its devices, with the layout's own upload stages),
    ``_serve_stream`` (the chunk loop: catalogue columns, canvases,
    sources deblended) and ``_download_fields`` (the canvases back to the
    host, in the layout's own order)."""

    def _serve(self, centers, timings, predict: bool = False, return_model: bool = False, transfer_dtype=None,
               **stream):
        """``deblend_and_render`` (its 2- or 3-tuple) or, with ``predict``,
        ``deblend_and_predict`` (catalogue and fields dict); ``stream``:
        the stream's own arguments."""
        transfer_dtype = _check_reduced_dtype("transfer_dtype", transfer_dtype)
        t = self._timings(timings)
        self.serving_timings = t
        pending: list = []
        want_epi = predict and self.epistemic_uncertainty_estimation
        field = self._served_field(t)
        with stage_timer(t, "deblend_render", self._distinct):
            cols, canvases, n_deblended = self._serve_stream(
                field, np.asarray(centers, np.float32).reshape(-1, 2), render_std=predict, render_epi=want_epi,
                timings=t, pending=pending, **stream,
            )
        settle_spans(t, pending)
        if n_deblended == 0:
            print("No galaxy deblended. End of the iterative procedure.")
            catalog, residual_field = None, self._residual_field()
            zero = np.zeros((self.field_size, self.field_size, self.nb_of_bands), np.float32)
            fields = {"mean": zero}
            if predict:
                fields.update(std=zero.copy(), epi=zero.copy() if want_epi else None)
        else:
            with stage_timer(t, "field_download", self._distinct):
                fields = self._download_fields(field, canvases, predict or return_model, transfer_dtype)
            with stage_timer(t, "catalog"):
                catalog = _records(cols)
            with stage_timer(t, "residual_copy"):
                residual_field = self._residual_field(fields["residual"])
        if predict:
            return catalog, {
                "residual_field": residual_field,
                "predicted_mean_field": fields["mean"],
                "predicted_stddev_field": fields["std"],
                "predicted_epistemic_field": fields.get("epi"),
            }
        return (catalog, residual_field, fields["mean"]) if return_model else (catalog, residual_field)

    def _residual_field(self, residual: np.ndarray | None = None) -> np.ndarray:
        """The host residual field: a copy of the constructor's field with
        its (F, F, B) field replaced by the downloaded ``residual``; the
        plain copy when there is none (nothing was deblended)."""
        out = self.field_image.copy()
        if residual is not None:
            out[0] = residual
        return out


class DeblendField(_ServingTail):
    def __init__(
        self,
        net,
        field_image,
        cutout_size: int = 59,
        nb_of_bands: int = 6,
        epistemic_uncertainty_estimation: bool = False,
        normalise: bool = False,
        cfg: PipelineConfig | None = None,
        generator: torch.Generator | None = None,
        mesh=None,
        quantized=None,
        upload_dtype=None,
        device_dtype=None,
        z_mode: str = "sample",
        artifact=None,
        device="cuda",
    ):
        """net: a DeblenderVAE on ``device`` (load_deblender); field_image:
        (1, F, F, B).  ``z_mode`` is 'sample' (the reference's stochastic
        forward, latents from ``generator``, seeded 0 by default) or 'mean'
        (deterministic).  ``epistemic_uncertainty_estimation=True`` adds the
        per-source epistemic stddev from ``cfg.epistemic_samples`` stochastic
        decodes, drawn from the same ``generator``.

        ``upload_dtype``: 'bfloat16' or 'float16' for the host-to-device
        upload of the field (cast on the host, half the bytes), widened to
        float32 on the device.  ``device_dtype``: 'bfloat16' keeps the
        memoized field and the serving route's render canvases bfloat16 on
        the device (half their bytes; float16 is rejected, its range clips
        the canvases' sums); the per-chunk work (cutouts, forward, mse,
        registration) still runs in float32, and the record-array route
        renders in float32.  It implies the reduced upload, so an
        ``upload_dtype`` must be unset or equal.

        ``quantized``: a QuantizedVAE (models/quantized.py) on ``device``:
        the batched stamp forward of both routes runs its int8 path in
        ``z_mode``; its ``normalise`` must equal the pipeline's (int8
        activation scales only fit the flux distribution they were
        calibrated on).  Epistemic sampling stays on ``net``.

        ``artifact``: an exported forward (utils/export.py): the ``.pt2``
        bytes or a path from ``export_deblender``, or a callable
        ``(images, generator) -> (loc, scale)`` such as ``artifact_forward``
        returns.  The batched stamp forward of both routes runs it instead
        of ``net``; it carries its own weights, z_mode and flux
        calibration, and bytes or a path are served with the pipeline's
        ``normalise`` bracket on ``device``.  Exclusive with ``mesh`` and
        ``quantized``; epistemic sampling stays on ``net``.

        ``mesh``: a parallel.Mesh; the batched stamp forward of both routes
        (and, under ``quantized``, the int8 forward; and the epistemic
        replicas) is split over its 'data' axis, each shard on its own
        device with a copy of the weights, the results gathered onto
        ``device``.  The field, the cutouts and the canvases stay on
        ``device``.  Same numbers as without a mesh, for the same
        ``generator``."""
        if artifact is not None and (mesh is not None or quantized is not None):
            raise ValueError(
                "artifact serving is mutually exclusive with mesh and "
                "quantized modes (export one artifact per serving "
                "configuration instead)"
            )
        self.quantized = quantized
        if quantized is not None and bool(quantized.normalise) != bool(normalise):
            raise ValueError(
                f"quantized bundle was calibrated with normalise="
                f"{quantized.normalise} but the pipeline "
                f"runs with normalise={normalise}; int8 activation scales "
                f"only match the flux distribution they were calibrated "
                f"on — re-run quantize_vae(..., normalise={normalise})"
            )
        self.upload_dtype = _check_reduced_dtype("upload_dtype", upload_dtype)
        self.device_dtype = _check_reduced_dtype("device_dtype", device_dtype)
        if self.device_dtype == "float16":
            raise ValueError(
                "device_dtype='float16' is rejected: the resident canvases accumulate sums and "
                "float16 clips at +-65504, so bright or crowded fields would overflow to inf; "
                "use 'bfloat16' (float32 range at ~3 significant digits)"
            )
        if self.device_dtype is not None and self.upload_dtype not in (None, self.device_dtype):
            raise ValueError(
                f"device_dtype={self.device_dtype!r} already implies the reduced upload; "
                f"upload_dtype={self.upload_dtype!r} conflicts: set only device_dtype"
            )
        if z_mode not in ("sample", "mean"):
            raise ValueError(f"z_mode must be 'sample' or 'mean', got {z_mode!r}")
        self.device = resolve_device(device)
        self.net = net
        self.mesh = mesh
        self._sharded_apply = self._sharded_apply_sample = None
        if mesh is not None:
            from debvader_tpu_torch.parallel.mesh import require_single_process
            from debvader_tpu_torch.parallel.sharded import make_sharded_apply

            require_single_process(mesh, "DeblendField(mesh=)")
            self._sharded_apply = make_sharded_apply(net, mesh, z_mode=z_mode)
            # the epistemic replicas must sample even under z_mode='mean'
            self._sharded_apply_sample = (
                self._sharded_apply if z_mode == "sample" else make_sharded_apply(net, mesh, z_mode="sample")
            )
        self._quant_fwd = None
        if quantized is not None:
            if quantized.device.type != self.device.type:
                raise ValueError(f"the quantized bundle lies on {quantized.device}, the pipeline runs on {self.device}")
            if mesh is not None:
                self._quant_fwd = make_sharded_quantized_forward(quantized, mesh, z_mode=z_mode)
            else:
                self._quant_fwd = make_quantized_forward(quantized, z_mode=z_mode)
        self._artifact_fwd = None
        if artifact is not None:
            if callable(artifact):
                self._artifact_fwd = artifact
            else:
                from debvader_tpu_torch.utils.export import artifact_forward

                self._artifact_fwd = artifact_forward(artifact, normalise=normalise, device=self.device)
        # the construction's one stage, added to the first entry call's dict
        self._held_timings: dict = {}
        with stage_timer(self._held_timings, "field_copy"):
            self.field_image = np.array(field_image, dtype=np.float32)
            _check_field_image(self.field_image)
        self.field_size = self.field_image.shape[1]
        self.cutout_size = cutout_size
        self.nb_of_bands = nb_of_bands
        self.normalise = normalise
        self.cfg = cfg or PipelineConfig(cutout_size=cutout_size, nb_of_bands=nb_of_bands)
        self.z_mode = z_mode
        self.epistemic_uncertainty_estimation = bool(epistemic_uncertainty_estimation)
        self.generator = generator
        # the epistemic replicas draw even under z_mode='mean': decoding the
        # posterior mean every time would collapse the uncertainty to zero;
        # an artifact draws its eps whatever its own z_mode
        sampling = z_mode == "sample" or self.epistemic_uncertainty_estimation or artifact is not None
        if sampling and generator is None:
            self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.nb_of_detected_objects: list[int] = []
        self.nb_of_deblended_galaxies: list[int] = []
        self.res_deblend = None
        self.mse: list[float] = []
        self.serving_timings: dict = {}
        self._dev_field_key = None
        self._dev_field = None
        self._render_cache = None

    def _timings(self, timings) -> dict:
        """An entry call's stage dict: ``timings``, or a new one; the first
        such dict also takes the construction's 'field_copy' seconds."""
        t = timings if timings is not None else {}
        for k, v in self._held_timings.items():
            t[k] = t.get(k, 0.0) + v
        self._held_timings.clear()
        return t

    # ------------------------------------------------------ device residency

    @staticmethod
    def _field_checksum(field_np: np.ndarray) -> tuple:
        """NaN-safe content checksum of a field: the plain and the
        position-weighted sum with NaNs as 0, and the NaN count.  A field
        whose sums are finite holds no NaN and costs one pass."""
        flat = np.ravel(field_np)
        sums = _weighted_sums(flat)
        if np.isfinite(sums[0]) and np.isfinite(sums[1]):
            return sums + (0,)
        nan_mask = np.isnan(flat)
        return _weighted_sums(np.where(nan_mask, 0.0, flat)) + (int(np.count_nonzero(nan_mask)),)

    def _device_field(self, field_np: np.ndarray, timings=None) -> torch.Tensor:
        """Device copy of the field, memoized on array identity, shape,
        dtype, the two reduced dtypes and the content checksum, so an
        in-place edit of the same ndarray (``df.field_image[0] += ...``),
        sum-neutral ones included, uploads again instead of serving stale
        device contents.  The checksum is one pass over the host array.
        A reduced dtype is cast on the host (half the bytes to upload);
        ``device_dtype`` keeps it on the device, ``upload_dtype`` alone
        widens it back to float32 there.  ``timings`` takes the
        'field_checksum' seconds of every call and, when the memo misses,
        the 'upload' (host cast, copy and widening, the device
        synchronised)."""
        t = timings if timings is not None else {}
        key = (id(field_np), field_np.shape, str(field_np.dtype), self.upload_dtype, self.device_dtype)
        with stage_timer(t, "field_checksum"):
            key += self._field_checksum(field_np)
        if self._dev_field_key != key:
            with stage_timer(t, "upload", self.device):
                host = np.asarray(field_np, np.float32)
                reduced = self.device_dtype or self.upload_dtype
                if reduced == "bfloat16":
                    up = _bfloat16_host(host)
                elif reduced == "float16":
                    up = torch.from_numpy(host.astype(np.float16))
                else:
                    up = torch.from_numpy(host)
                # from_numpy shares the ndarray's memory; the memo must not
                # follow in-place edits
                dev = up.to(self.device, copy=True)
                if reduced is not None and self.device_dtype is None:
                    dev = dev.to(torch.float32)
            self._dev_field = dev
            self._dev_field_key = key
        return self._dev_field

    @property
    def _canvas_dtype(self) -> torch.dtype:
        """dtype of the serving route's resident render canvases."""
        return torch.float32 if self.device_dtype is None else getattr(torch, self.device_dtype)

    def _restore_dtype(self, arr: torch.Tensor) -> np.ndarray:
        """A downloaded field buffer as numpy at the field's dtype,
        widened through torch (numpy has no bfloat16)."""
        return arr.to(torch.float32).numpy().astype(self.field_image.dtype, copy=False)

    def _fetch_field(self, arr_dev: torch.Tensor) -> np.ndarray:
        """Download one derived full-field buffer and restore its dtype."""
        return self._restore_dtype(arr_dev.cpu())

    def _forward(self, cutouts: torch.Tensor):
        """(means, stddevs) on the device, forwarding ``source_chunk``
        stamps at a time."""
        means, stds = [], []
        for s0 in range(0, cutouts.shape[0], self.cfg.source_chunk):
            dist = self._deblend(cutouts[s0 : s0 + self.cfg.source_chunk])
            means.append(dist.mean())
            stds.append(dist.stddev())
        if len(means) == 1:
            return means[0], stds[0]
        return torch.cat(means), torch.cat(stds)

    def _deblend(self, cutouts: torch.Tensor) -> PixelNormal:
        """The batched stamp forward of (N, S, S, B) cutouts on the device:
        the int8 forward of ``quantized`` (its own guard and normalisation
        bracket, no flux calibration; split over the mesh when there is
        one), the exported program of ``artifact``, the mesh-sharded
        forward, else the float model's."""
        if self._quant_fwd is not None:
            return PixelNormal(*self._quant_fwd(cutouts, self.generator))
        if self._artifact_fwd is not None:
            return PixelNormal(*self._artifact_fwd(cutouts, self.generator))
        if self.mesh is not None:
            from debvader_tpu_torch.parallel.sharded import sharded_forward

            return sharded_forward(self._sharded_apply, cutouts, self.mesh, self.normalise, self.generator)
        return deblend_tensor(self.net, cutouts, self.normalise, self.generator, self.z_mode)

    def _epistemic(self, cutouts: torch.Tensor, max_chunk: int) -> torch.Tensor:
        """Epistemic stddev stamps (N, S, S, B) on the device: the spread
        of ``cfg.epistemic_samples`` stochastic decodes a source, at most
        ``max_chunk`` decodes at a time."""
        return sample_stats_tensor(
            self.net,
            cutouts,
            self.cfg.epistemic_samples,
            generator=self.generator,
            normalise=self.normalise,
            max_chunk=max_chunk,
            mesh=self.mesh,
            apply_fn=self._sharded_apply_sample,
        )[1]

    @property
    def _band(self) -> int:
        """The r band where there is one (the reference reads channel 2)."""
        return 2 if self.nb_of_bands > 2 else 0

    # ----------------------------------------------------------- deblending

    def deblend_field(
        self,
        galaxy_distances_to_center,
        cutout_images=None,
        optimise_positions: bool = False,
        epistemic_criterion: float = 100.0,
        mse_criterion: float = 100.0,
        field_image=None,
        measure: bool = False,
    ):
        """Single-pass scene deblend.  Returns a record array with columns
        cutout_images, output_images_mean, output_images_stddev, shifts,
        list_idx, galaxy_distances_to_center_x/y, epistemic_uncertainty,
        passed_cuts, or a dict of Nones when no source survives
        extraction.  ``measure=True`` appends flux, centroid, ellipticity
        and snr columns (ops/measure.py) of the deblended means.
        ``optimise_positions=True`` fills the shifts column with each
        source's registration (ops/registration.py) against the r band of
        the host field, within ``cfg.position_bounds`` over
        ``cfg.gn_iterations`` steps."""
        empty = {
            "cutout_images": None,
            "output_images_mean": None,
            "output_images_stddev": None,
            "shifts": None,
            "list_idx": None,
        }
        if field_image is None:
            field_image = self.field_image  # read-only below
        else:
            field_image = np.asarray(field_image, np.float32)
            _check_field_image(field_image)
        centers = np.asarray(galaxy_distances_to_center, np.float32).reshape(-1, 2)

        # A survey-scale field holds more sources than fit on the device
        # at once: the whole per-source pipeline runs in source_chunk
        # pieces whose results merge into one record array.
        chunk = self.cfg.source_chunk
        if cutout_images is None and len(centers) > chunk:
            parts = []
            n_chunks = (len(centers) + chunk - 1) // chunk
            for s0 in range(0, len(centers), chunk):
                r = self.deblend_field(
                    centers[s0 : s0 + chunk],
                    optimise_positions=optimise_positions,
                    epistemic_criterion=epistemic_criterion,
                    mse_criterion=mse_criterion,
                    field_image=field_image,
                    measure=measure,
                )
                if not isinstance(r, dict):
                    rr = r.copy()
                    rr.list_idx = rr.list_idx + s0
                    parts.append(rr)
            # collapse the sub-calls' counter entries into one per call
            del self.nb_of_detected_objects[-n_chunks:]
            deblended = sum(self.nb_of_deblended_galaxies[-n_chunks:])
            del self.nb_of_deblended_galaxies[-n_chunks:]
            self.nb_of_detected_objects.append(len(centers))
            self.nb_of_deblended_galaxies.append(deblended)
            # chunked results live on the host only: drop the last chunk's cache
            self._render_cache = None
            if not parts:
                print("No galaxy deblended. End of the iterative procedure.")
                return empty
            self.res_deblend = np.hstack(parts).view(np.recarray)
            return self.res_deblend

        if isinstance(cutout_images, np.ndarray):
            cut_np = np.asarray(cutout_images, np.float32)
            cutouts = torch.as_tensor(cut_np, device=self.device)
            list_idx = np.arange(len(cut_np))
        else:
            # extraction runs on the memoized device copy of the field, the
            # forward's input; the record array's cutouts (and the mse cut)
            # are sliced from the float32 host field, so no stamp is
            # downloaded for them
            all_cutouts, valid = extract_cutouts(
                self._device_field(field_image), centers, self.cutout_size
            )
            valid = valid.cpu().numpy()
            if not valid.any():
                print("No galaxy deblended. End of the iterative procedure.")
                self.nb_of_detected_objects.append(len(centers))
                self.nb_of_deblended_galaxies.append(0)
                return empty
            if not valid.all():
                print(
                    "Some galaxies are too close from the border of the "
                    "field to be considered here."
                )
            list_idx = np.flatnonzero(valid)
            # float32 whatever the resident field's device_dtype
            cutouts = all_cutouts[torch.as_tensor(list_idx, device=self.device)].to(torch.float32)
            cut_np = extract_cutouts_np(field_image, centers, self.cutout_size)[0][list_idx]

        n = len(list_idx)
        if n == 0:
            print("No galaxy deblended. End of the iterative procedure.")
            self.nb_of_detected_objects.append(len(centers))
            self.nb_of_deblended_galaxies.append(0)
            return empty

        means_dev, std_dev = self._forward(cutouts)
        means = means_dev.cpu().numpy()
        stddevs = std_dev.cpu().numpy()
        epi_dev = None
        if self.epistemic_uncertainty_estimation:
            epi_dev = self._epistemic(cutouts, self.cfg.source_chunk)
            epistemic = epi_dev.cpu().numpy()
            band = self._band
            epi_norm = epistemic[..., band].sum(axis=(1, 2)) / np.maximum(
                means[..., band].sum(axis=(1, 2)), 1e-30
            )
        else:
            epistemic = np.zeros_like(means)
            epi_norm = np.zeros(n)

        # centre-window mse cut
        w = self.cfg.mse_window
        c0 = self.cutout_size // 2 - w
        c1 = self.cutout_size // 2 + w
        mse_center = np.mean(
            np.square(cut_np[:, c0:c1, c0:c1] - means[:, c0:c1, c0:c1]), axis=(1, 2, 3)
        )
        dets = centers[list_idx]
        if optimise_positions:
            band = self._band
            shifts = (
                position_optimization_batch_windowed(
                    torch.as_tensor(np.ascontiguousarray(field_image[0, :, :, band]), device=self.device),
                    means_dev[..., band],
                    torch.as_tensor(dets, device=self.device),
                    bound=self.cfg.position_bounds,
                    iterations=self.cfg.gn_iterations,
                )
                .cpu()
                .numpy()
            )
        else:
            shifts = np.zeros((n, 2), np.float32)
        # a non-finite metric fails the cuts instead of slipping through a
        # comparison that is False for NaN
        passed_cuts = (
            ~((epi_norm > epistemic_criterion) | (mse_center > mse_criterion))
            & np.isfinite(mse_center)
            & np.isfinite(epi_norm)
        )
        self.nb_of_detected_objects.append(len(centers))
        self.nb_of_deblended_galaxies.append(n)
        res = {
            "cutout_images": list(cut_np),
            "output_images_mean": list(means),
            "output_images_stddev": list(stddevs),
            "shifts": list(shifts),
            "list_idx": list(np.asarray(list_idx)),
            "galaxy_distances_to_center_x": list(dets[:, 0]),
            "galaxy_distances_to_center_y": list(dets[:, 1]),
            "epistemic_uncertainty": list(epistemic),
            "passed_cuts": list(passed_cuts),
        }
        if measure:
            # the maps are still on the device: nothing is uploaded again
            m = measure_batch(means_dev, std_dev)
            for key in _MEASURE_COLUMNS:
                res[key] = list(m[key].cpu().numpy())
        self.res_deblend = _records(res)

        # Keep the stamp maps on the device for the renders that follow
        # (they would otherwise upload the batch the device just produced),
        # unless that would pin more than render_cache_bytes past the call.
        # The host copies in the record array stay the source of truth:
        # _stacked compares their checksums before it serves the device
        # copies.
        if means.nbytes * (2 if epi_dev is None else 3) <= self.cfg.render_cache_bytes:
            cached = {"output_images_mean": means_dev, "output_images_stddev": std_dev}
            if epi_dev is not None:
                cached["epistemic_uncertainty"] = epi_dev
            self._render_cache = {
                "token": self.res_deblend,
                "stamps": cached,
                "cksum": {col: self._stamps_checksum(self.res_deblend, col) for col in cached},
            }
        else:
            self._render_cache = None
        return self.res_deblend

    def drop_render_cache(self) -> None:
        """Release the stamp maps deblend_field kept on the device for
        rendering (they are uploaded from the record array when needed)."""
        self._render_cache = None

    # -------------------------------------------------------------- serving

    def deblend_and_render(
        self,
        galaxy_distances_to_center,
        optimise_positions: bool = False,
        epistemic_criterion: float = 100.0,
        mse_criterion: float = 100.0,
        measure: bool = False,
        return_model: bool = False,
        timings=None,
        transfer_dtype=None,
    ):
        """Serving path: deblend every source and assemble the residual in
        one device-resident pipeline.

        ``deblend_field`` brings every source's mean and stddev stamp back
        to the host; a field server wants the products, a catalog and the
        residual (and/or model) field.  Here every stamp stays on the
        device: sources stream through in ``source_chunk`` batches, each
        chunk's means render straight into the padded canvas
        (``render_field(..., canvas=, crop=False)``), and only per-source
        scalars and the final field cross to the host.

        Returns (catalog, residual_field), residual_field shaped like
        field_image; ``return_model=True`` appends the rendered model
        field.  The catalog holds the deblend_field columns without the
        stamp images, plus mse_center and epistemic_norm; it is None, and
        the residual the field, when no source survives extraction.

        ``timings``: a dict that accumulates the seconds of each stage,
        also kept as ``self.serving_timings``.  Top-level stages, in call
        order: 'field_copy' (the constructor's float32 copy and check of
        the field, in the first entry call's dict only), 'field_checksum'
        (the memo's content checksum), 'upload' (the field's host-to-device
        copy, only when the memo misses), 'deblend_render' (the chunk
        loop), 'field_download' (the residual's subtract and download),
        'catalog' (the record array), 'residual_copy' (the host residual
        field).  Nested in 'deblend_render', the device seconds of each
        chunk's 'cutouts' (extraction and the gather of valid rows),
        'forward' and 'render', read from CUDA events once
        'deblend_render' has synchronised (wall seconds on the CPU); the
        other stages end with the card synchronised.  ``transfer_dtype``:
        'bfloat16' or 'float16' casts the fields on the device before the
        download and widens them on the host; None transfers float32."""
        return self._serve(
            galaxy_distances_to_center, timings, return_model=return_model, transfer_dtype=transfer_dtype,
            optimise_positions=optimise_positions, epistemic_criterion=epistemic_criterion,
            mse_criterion=mse_criterion, measure=measure,
        )

    def deblend_and_predict(
        self,
        galaxy_distances_to_center,
        optimise_positions: bool = False,
        epistemic_criterion: float = 100.0,
        mse_criterion: float = 100.0,
        measure: bool = False,
        timings=None,
        transfer_dtype=None,
    ):
        """Predicted-field serving: the streaming counterpart of
        ``get_predicted_field`` + ``get_residual_field``.  The mean and the
        per-pixel stddev canvases accumulate on the device inside the same
        streamed loop as ``deblend_and_render``.

        Returns (catalog, fields), fields a dict with 'residual_field'
        (shaped like field_image), 'predicted_mean_field',
        'predicted_stddev_field' ((F, F, B)) and
        'predicted_epistemic_field' ((F, F, B); None unless the object was
        built with ``epistemic_uncertainty_estimation=True``).  The catalog
        is None and the predictions zero when no source survives
        extraction.  ``timings`` / ``transfer_dtype`` as in
        ``deblend_and_render``, whose stages these are ('field_download'
        takes the four fields' downloads)."""
        return self._serve(
            galaxy_distances_to_center, timings, predict=True, transfer_dtype=transfer_dtype,
            optimise_positions=optimise_positions, epistemic_criterion=epistemic_criterion,
            mse_criterion=mse_criterion, measure=measure,
        )

    # the serving tail's layout steps (_ServingTail)

    @property
    def _distinct(self) -> list:
        return [self.device]

    def _served_field(self, timings: dict) -> torch.Tensor:
        return self._device_field(self.field_image, timings)

    def _serve_stream(self, field_dev, centers, render_std: bool, render_epi: bool, **kw):
        # the field and the mean canvas, plus the std and epistemic canvases
        return self._stream_deblend(field_dev, centers, resident_fields=2 + render_std + render_epi,
                                    render_std=render_std, render_epistemic=render_epi, **kw)

    def _download_fields(self, field_dev, canvases: dict, want_mean: bool, transfer_dtype) -> dict:
        """The served fields on the host, one derived full-field buffer at a
        time so the peak stays field + canvases + one derived buffer: the
        std, then the epistemic canvas (each freed once fetched), then the
        mean (``want_mean``), then the residual."""
        pad = render_pad(self.cutout_size, self.cfg.interp_order)
        out = {k: self._fetch_field(_crop_canvas(canvases.pop(k), pad, transfer_dtype))
               for k in ("std", "epi") if k in canvases}
        if want_mean:
            out["mean"] = self._fetch_field(_crop_canvas(canvases["mean"], pad, transfer_dtype))
        out["residual"] = self._fetch_field(_render_finish(field_dev, canvases["mean"], pad, transfer_dtype))
        return out

    def _stream_chunk(self, resident_fields: int, optimise_positions: bool = False) -> int:
        """Sources per stream chunk: ``source_chunk``, capped on a card by
        what fits beside the resident full-field buffers (at the resident
        dtype's bytes), the float32 registration band when positions are
        optimised, and, with epistemic estimation, one replica chunk of the
        same size."""
        if self.device.type != "cuda":
            return self.cfg.source_chunk
        hbm = self.cfg.serving_hbm_bytes
        if hbm is None:
            hbm = torch.cuda.get_device_properties(self.device).total_memory
        f = self.field_size
        cap = _serving_chunk_cap(
            f, self.nb_of_bands, hbm, resident_fields=resident_fields,
            replica_chunk=self.epistemic_uncertainty_estimation,
            bytes_per_el=2 if self.device_dtype is not None else 4,
            extra_bytes=4 * f * f if optimise_positions else 0,
        )
        return min(self.cfg.source_chunk, cap)

    @torch.no_grad()
    def _stream_deblend(
        self,
        field_dev: torch.Tensor,
        galaxy_distances_to_center,
        optimise_positions: bool = False,
        epistemic_criterion: float = 100.0,
        mse_criterion: float = 100.0,
        measure: bool = False,
        resident_fields: int = 2,
        render_std: bool = False,
        render_epistemic: bool = False,
        timings=None,
        pending=None,
    ):
        """Streaming core of the serving entry points: chunks of sources
        run extract -> forward -> incremental canvas render against the
        device-resident ``field_dev`` (1, F, F, B).  Returns (catalog
        column dict, dict of padded render canvases on the device or None
        when nothing deblended, n_deblended).  The canvases come back
        uncropped so a caller fuses the crop into its subtract
        (``_render_finish``).  ``render_std`` / ``render_epistemic`` also
        accumulate the per-pixel stddev and epistemic canvases ('std',
        'epi'), each one more resident full-field buffer that the caller
        counts in ``resident_fields``.  ``optimise_positions`` registers each
        chunk after its forward against the field's r band, cast to float32
        once for the whole stream, and renders every source at its detected
        offset plus its shift.  Under ``device_dtype`` the cutouts are cast
        to float32 for the chunk's work and the stamps to the canvases'
        bfloat16 for the renders.  Each chunk's 'cutouts', 'forward' and
        'render' spans go into ``timings`` through ``pending``
        (``_chunk_step``)."""
        if render_epistemic and not self.epistemic_uncertainty_estimation:
            raise ValueError(
                "render_epistemic=True requires the pipeline to run with "
                "epistemic_uncertainty_estimation=True (the epistemic maps "
                "are only computed then)"
            )
        field_size = field_dev.shape[1]
        centers = np.asarray(galaxy_distances_to_center, np.float32).reshape(-1, 2)
        band = self._band
        cdt = self._canvas_dtype
        # registration reads the detection band at float32: cast once for
        # the whole stream, not once a chunk
        reg_band = field_dev[0, :, :, band].to(torch.float32).contiguous() if optimise_positions else None

        canvases = {"mean": None}
        if render_std:
            canvases["std"] = None
        if render_epistemic:
            canvases["epi"] = None
        cols = _stream_columns(measure)
        chunk = self._stream_chunk(resident_fields, optimise_positions)
        # the replicas take the guarded cutouts themselves and draw at most
        # one stream chunk of decodes at a time
        epistemic = (lambda x: self._epistemic(x, chunk)) if self.epistemic_uncertainty_estimation else None
        n_deblended = 0
        t = timings if timings is not None else {}
        pending = pending if pending is not None else []

        for s0 in range(0, len(centers), chunk):
            part = centers[s0 : s0 + chunk]
            with stage_timer(t, "cutouts", self.device, pending):
                all_cutouts, valid = extract_cutouts(field_dev, part, self.cutout_size)
                valid = valid.cpu().numpy()
                if not valid.any():
                    continue
                list_idx = np.flatnonzero(valid)
                # the forward zero-fills non-finite pixels (chip gaps)
                # itself, so no NaN reaches the rendered model; the mse cut
                # uses the raw cutouts, so a NaN in its window fails the cut
                # as on deblend_field's host path
                raw_cutouts = all_cutouts[torch.as_tensor(list_idx, device=self.device)].to(torch.float32)
            dets = part[list_idx]
            scalars = _chunk_step(
                raw_cutouts, torch.as_tensor(dets, device=self.device), self._deblend, canvases, field_size,
                self.cfg, band, measure, epistemic=epistemic, reg_band=reg_band, canvas_dtype=cdt, timings=t,
                pending=pending,
            )
            # per-source scalars only: a few KB a chunk to the host
            got = {k: v.cpu().numpy() for k, v in scalars.items()}
            _append_chunk(cols, got, s0 + list_idx, dets, mse_criterion, epistemic_criterion)
            n_deblended += len(list_idx)

        self.nb_of_detected_objects.append(len(centers))
        self.nb_of_deblended_galaxies.append(n_deblended)
        if n_deblended == 0:
            return cols, None, 0
        return cols, canvases, n_deblended

    # ------------------------------------------------------------ rendering

    @staticmethod
    def _stamps_checksum(res_deblend, key) -> tuple:
        """Content checksum of one stamp column, row by row (the column is
        never stacked again): the plain and the position-weighted float64
        sums.  NaNs poison the sums, which fails the comparison and
        uploads from the host again."""
        tot = wtot = 0.0
        for row in res_deblend:
            s, ws = _weighted_sums(np.ravel(np.asarray(row[key], np.float64)))
            tot += s
            wtot += ws
        return tot, wtot

    def _stacked(self, res_deblend, key) -> torch.Tensor:
        """Stamp stack of one column on the device.  When ``res_deblend``
        is the record array the last deblend_field call produced, by
        identity and by the content checksum of the column, the copy kept
        on the device is served; else (another array, a column edited in
        place) the host stamps are stacked and uploaded."""
        cache = self._render_cache
        if (
            cache is not None
            and res_deblend is cache["token"]
            and key in cache["stamps"]
            and cache["cksum"][key] == self._stamps_checksum(res_deblend, key)
        ):
            return cache["stamps"][key]
        stamps = np.stack([np.asarray(row[key]) for row in res_deblend]).astype(np.float32)
        return torch.as_tensor(stamps, device=self.device)

    @staticmethod
    def _offsets(res_deblend) -> np.ndarray:
        out = np.zeros((len(res_deblend), 2), np.float32)
        for i, row in enumerate(res_deblend):
            out[i, 0] = row["galaxy_distances_to_center_x"] + row["shifts"][0]
            out[i, 1] = row["galaxy_distances_to_center_y"] + row["shifts"][1]
        return out

    def _render(self, res_deblend, column: str) -> np.ndarray:
        rendered = render_field(
            self._stacked(res_deblend, column),
            torch.as_tensor(self._offsets(res_deblend), device=self.device),
            self.field_size,
            order=self.cfg.interp_order,
        )
        return rendered.cpu().numpy()

    def _catalog(self, res_deblend):
        if res_deblend is None:
            res_deblend = self.res_deblend
        if isinstance(res_deblend, dict):  # deblend_field's empty early exit
            return None
        return res_deblend

    def get_residual_field(self, res_deblend=None) -> np.ndarray:
        """field - the sum of every source's shifted predicted mean."""
        res_deblend = self._catalog(res_deblend)
        deblended_image = self.field_image.copy()
        if res_deblend is not None and len(res_deblend):
            deblended_image[0] -= self._render(res_deblend, "output_images_mean")
        return deblended_image

    def get_predicted_field(self, res_deblend=None) -> dict:
        """Rendered mean, stddev and epistemic canvases, one render a
        quantity (the epistemic canvas stays zero unless the object runs
        with ``epistemic_uncertainty_estimation=True``)."""
        res_deblend = self._catalog(res_deblend)
        shape = (self.field_size, self.field_size, self.nb_of_bands)
        out = {
            "predicted_mean_field": np.zeros(shape, np.float32),
            "predicted_stddev_field": np.zeros(shape, np.float32),
            "predicted_epistemic_field": np.zeros(shape, np.float32),
        }
        if res_deblend is not None and len(res_deblend):
            out["predicted_mean_field"] = self._render(res_deblend, "output_images_mean")
            out["predicted_stddev_field"] = self._render(res_deblend, "output_images_stddev")
            if self.epistemic_uncertainty_estimation:
                out["predicted_epistemic_field"] = self._render(res_deblend, "epistemic_uncertainty")
        return out

    def get_deblending_meta_data(self, res_deblend=None) -> dict:
        """The field, the residual and the predicted canvases in one dict."""
        meta = {"field_image": self.field_image}
        meta["deblended_image"] = self.get_residual_field(res_deblend)
        meta.update(self.get_predicted_field(res_deblend))
        return meta
