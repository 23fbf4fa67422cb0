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

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
position registration, epistemic uncertainty, reduced-precision residency
of the field (``upload_dtype`` / ``device_dtype``), mesh fan-out, int8
serving and exported artifacts.
"""

from __future__ import annotations

import numpy as np
import torch

from debvader_tpu_torch.api import deblend_tensor
from debvader_tpu_torch.config import PipelineConfig
from debvader_tpu_torch.device import resolve_device
from debvader_tpu_torch.ops.extraction import extract_cutouts, extract_cutouts_np
from debvader_tpu_torch.ops.measure import measure_batch
from debvader_tpu_torch.ops.shift import render_field, render_pad
from debvader_tpu_torch.utils.profiling import stage_timer

__all__ = ["DeblendField"]

_ROADMAP = "ROADMAP.md Queue 1"
_OPTIONS_ITEM = "2. DeblendField options"
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


def _not_ported(option: str, item: str):
    raise NotImplementedError(
        f"{option} is not ported to the PyTorch package yet ({_ROADMAP}, item: {item})"
    )


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


def _crop_canvas(canvas: torch.Tensor, pad: int, out_dtype=None) -> torch.Tensor:
    """The field window of a padded render canvas, cast to the transfer
    dtype on the device when one is given."""
    f = canvas.shape[0] - 2 * pad
    out = canvas[pad : pad + f, pad : pad + f]
    return out if out_dtype is None else out.to(getattr(torch, out_dtype))


def _render_finish(field: torch.Tensor, canvas: torch.Tensor, pad: int, out_dtype=None, want_model=False):
    """field - crop(canvas), at the transfer dtype; with ``want_model``
    also the cropped model: (residual, model)."""
    model = _crop_canvas(canvas, pad)
    residual = field[0] - model
    if out_dtype is not None:
        residual = residual.to(getattr(torch, out_dtype))
        if want_model:
            model = model.to(getattr(torch, out_dtype))
    return (residual, model) if want_model else residual


def _serving_chunk_cap(field_size: int, bands: int, hbm_bytes: int, resident_fields: int = 2) -> int:
    """Largest forward chunk that fits beside the streaming loop's resident
    buffers: the stream holds the float32 field and its padded render
    canvases (``resident_fields`` full-field buffers) for its whole
    duration, and each source of a chunk takes
    ``_STREAM_BYTES_PER_SOURCE`` at the chunk's peak."""
    resident = resident_fields * 4 * field_size * field_size * bands
    budget = hbm_bytes - resident - _STREAM_RESERVE_BYTES
    return max(budget // _STREAM_BYTES_PER_SOURCE, _MIN_STREAM_CHUNK)


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


class DeblendField:
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
        (deterministic)."""
        if epistemic_uncertainty_estimation:
            _not_ported("epistemic_uncertainty_estimation=True", _OPTIONS_ITEM)
        if mesh is not None:
            _not_ported("mesh=", "8. multi-device")
        if quantized is not None:
            _not_ported("quantized=", "6. quantized")
        if artifact is not None:
            _not_ported("artifact=", "7. precision and export")
        if upload_dtype is not None or device_dtype is not None:
            _not_ported("upload_dtype= / device_dtype=", _OPTIONS_ITEM)
        if z_mode not in ("sample", "mean"):
            raise ValueError(f"z_mode must be 'sample' or 'mean', got {z_mode!r}")
        self.device = resolve_device(device)
        self.net = net
        self.field_image = np.array(field_image, dtype=np.float32)
        _check_field_image(self.field_image)
        self.field_size = self.field_image.shape[1]
        self.cutout_size = cutout_size
        self.nb_of_bands = nb_of_bands
        self.normalise = normalise
        self.cfg = cfg or PipelineConfig(cutout_size=cutout_size, nb_of_bands=nb_of_bands)
        self.z_mode = z_mode
        self.generator = generator
        if z_mode == "sample" and generator is None:
            self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.nb_of_detected_objects: list[int] = []
        self.nb_of_deblended_galaxies: list[int] = []
        self.res_deblend = None
        self.serving_timings: dict = {}
        self._dev_field_key = None
        self._dev_field = None
        self._render_cache = None

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

    def _device_field(self, field_np: np.ndarray) -> torch.Tensor:
        """Device copy of the field, memoized on array identity, shape,
        dtype and the content checksum, so an in-place edit of the same
        ndarray (``df.field_image[0] += ...``), sum-neutral ones included,
        uploads again instead of serving stale device contents.  The
        checksum is one pass over the host array."""
        key = (id(field_np), field_np.shape, str(field_np.dtype)) + self._field_checksum(field_np)
        if self._dev_field_key != key:
            self._dev_field = torch.as_tensor(
                np.asarray(field_np, np.float32), device=self.device
            )
            if self._dev_field.device.type == "cpu":
                # as_tensor shares the ndarray's memory on the CPU; the
                # memo must not follow in-place edits
                self._dev_field = self._dev_field.clone()
            self._dev_field_key = key
        return self._dev_field

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
            dist = deblend_tensor(
                self.net,
                cutouts[s0 : s0 + self.cfg.source_chunk],
                self.normalise,
                self.generator,
                self.z_mode,
            )
            means.append(dist.mean())
            stds.append(dist.stddev())
        if len(means) == 1:
            return means[0], stds[0]
        return torch.cat(means), torch.cat(stds)

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
        and snr columns (ops/measure.py) of the deblended means."""
        if optimise_positions:
            _not_ported("optimise_positions=True", _OPTIONS_ITEM)
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
            # extraction runs on the memoized device copy of the field; the
            # record array's cutouts are sliced on the host, so no stamp
            # is downloaded for them
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
            cutouts = all_cutouts[torch.as_tensor(list_idx, device=self.device)]
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
        if 2 * means.nbytes <= self.cfg.render_cache_bytes:
            cached = {"output_images_mean": means_dev, "output_images_stddev": std_dev}
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

        ``timings``: a dict that accumulates wall seconds per stage
        ('upload', 'deblend_render', 'field_download'), also kept as
        ``self.serving_timings``.  ``transfer_dtype``: 'bfloat16' or
        'float16' casts the fields on the device before the download and
        widens them on the host; None transfers float32."""
        transfer_dtype = _check_reduced_dtype("transfer_dtype", transfer_dtype)
        t = timings if timings is not None else {}
        self.serving_timings = t
        with stage_timer(t, "upload", self.device):
            field_dev = self._device_field(self.field_image)
        with stage_timer(t, "deblend_render", self.device):
            cols, canvases, n_deblended = self._stream_deblend(
                field_dev,
                galaxy_distances_to_center,
                optimise_positions=optimise_positions,
                epistemic_criterion=epistemic_criterion,
                mse_criterion=mse_criterion,
                measure=measure,
            )

        if n_deblended == 0:
            print("No galaxy deblended. End of the iterative procedure.")
            if return_model:
                return None, self.field_image.copy(), np.zeros_like(self.field_image[0])
            return None, self.field_image.copy()

        with stage_timer(t, "field_download", self.device):
            pad = render_pad(self.cutout_size, self.cfg.interp_order)
            finished = _render_finish(
                field_dev, canvases["mean"], pad, transfer_dtype, want_model=return_model
            )
            if return_model:
                residual, model = (self._fetch_field(x) for x in finished)
            else:
                residual = self._fetch_field(finished)
        catalog = _records(cols)
        residual_field = self.field_image.copy()
        residual_field[0] = residual
        if return_model:
            return catalog, residual_field, model
        return catalog, residual_field

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
        'predicted_epistemic_field' (None: epistemic estimation is not
        ported yet).  The catalog is None and the predictions zero when no
        source survives extraction.  ``timings`` / ``transfer_dtype`` as in
        ``deblend_and_render``."""
        transfer_dtype = _check_reduced_dtype("transfer_dtype", transfer_dtype)
        t = timings if timings is not None else {}
        self.serving_timings = t
        with stage_timer(t, "upload", self.device):
            field_dev = self._device_field(self.field_image)
        with stage_timer(t, "deblend_render", self.device):
            cols, canvases, n_deblended = self._stream_deblend(
                field_dev,
                galaxy_distances_to_center,
                optimise_positions=optimise_positions,
                epistemic_criterion=epistemic_criterion,
                mse_criterion=mse_criterion,
                measure=measure,
                render_std=True,
                resident_fields=3,  # field + mean canvas + std canvas
            )

        f = self.field_size
        if n_deblended == 0:
            print("No galaxy deblended. End of the iterative procedure.")
            zero = np.zeros((f, f, self.nb_of_bands), np.float32)
            return None, {
                "residual_field": self.field_image.copy(),
                "predicted_mean_field": zero,
                "predicted_stddev_field": zero.copy(),
                "predicted_epistemic_field": None,
            }

        with stage_timer(t, "field_download", self.device):
            pad = render_pad(self.cutout_size, self.cfg.interp_order)
            # one derived full-field buffer at a time, so the peak stays
            # field + canvases + one derived buffer
            std = self._fetch_field(_crop_canvas(canvases.pop("std"), pad, transfer_dtype))
            mean = self._fetch_field(_crop_canvas(canvases["mean"], pad, transfer_dtype))
            residual = self._fetch_field(
                _render_finish(field_dev, canvases["mean"], pad, transfer_dtype)
            )
        catalog = _records(cols)
        residual_field = self.field_image.copy()
        residual_field[0] = residual
        return catalog, {
            "residual_field": residual_field,
            "predicted_mean_field": mean,
            "predicted_stddev_field": std,
            "predicted_epistemic_field": None,
        }

    def _stream_chunk(self, resident_fields: int) -> int:
        """Sources per stream chunk: ``source_chunk``, capped on a card by
        what fits beside the resident full-field buffers."""
        if self.device.type != "cuda":
            return self.cfg.source_chunk
        hbm = self.cfg.serving_hbm_bytes
        if hbm is None:
            hbm = torch.cuda.get_device_properties(self.device).total_memory
        cap = _serving_chunk_cap(
            self.field_size, self.nb_of_bands, hbm, resident_fields=resident_fields
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
    ):
        """Streaming core of the serving entry points: chunks of sources
        run extract -> forward -> incremental canvas render against the
        device-resident ``field_dev`` (1, F, F, B).  Returns (catalog
        column dict, dict of padded render canvases on the device or None
        when nothing deblended, n_deblended).  The canvases come back
        uncropped so a caller fuses the crop into its subtract
        (``_render_finish``).  ``render_std`` also accumulates the
        per-pixel stddev canvas, one more resident full-field buffer that
        the caller counts in ``resident_fields``."""
        if optimise_positions:
            _not_ported("optimise_positions=True", _OPTIONS_ITEM)
        field_size = field_dev.shape[1]
        centers = np.asarray(galaxy_distances_to_center, np.float32).reshape(-1, 2)
        order = self.cfg.interp_order

        canvases = {"mean": None}
        if render_std:
            canvases["std"] = None
        names = [
            "shifts",
            "list_idx",
            "galaxy_distances_to_center_x",
            "galaxy_distances_to_center_y",
            "mse_center",
            "epistemic_norm",
            "passed_cuts",
        ]
        if measure:
            names.extend(_MEASURE_COLUMNS)
        cols: dict[str, list] = {k: [] for k in names}

        w = self.cfg.mse_window
        c0 = self.cutout_size // 2 - w
        c1 = self.cutout_size // 2 + w
        chunk = self._stream_chunk(resident_fields)
        n_deblended = 0

        for s0 in range(0, len(centers), chunk):
            part = centers[s0 : s0 + chunk]
            all_cutouts, valid = extract_cutouts(field_dev, part, self.cutout_size)
            valid = valid.cpu().numpy()
            if not valid.any():
                continue
            list_idx = np.flatnonzero(valid)
            # the forward zero-fills non-finite pixels (chip gaps) itself,
            # so no NaN reaches the rendered model; the mse cut below uses
            # the raw cutouts, so a NaN in its window fails the cut as on
            # deblend_field's host path
            raw_cutouts = all_cutouts[torch.as_tensor(list_idx, device=self.device)]
            n = len(list_idx)
            dets = part[list_idx]

            dist = deblend_tensor(self.net, raw_cutouts, self.normalise, self.generator, self.z_mode)
            means_dev = dist.mean()
            std_dev = dist.stddev() if (render_std or measure) else None
            mse_center = torch.mean(
                torch.square(raw_cutouts[:, c0:c1, c0:c1] - means_dev[:, c0:c1, c0:c1]),
                dim=(1, 2, 3),
            )
            shifts = np.zeros((n, 2), np.float32)
            offs_dev = torch.as_tensor(dets + shifts, device=self.device)
            canvases["mean"] = render_field(
                means_dev, offs_dev, field_size, order=order, canvas=canvases["mean"], crop=False
            )
            if render_std:
                # additive stddev accumulation, the reference's
                # predicted-field convention
                canvases["std"] = render_field(
                    std_dev, offs_dev, field_size, order=order, canvas=canvases["std"], crop=False
                )

            # per-source scalars only: a few KB a chunk to the host
            fetch = {"mse_center": mse_center}
            if measure:
                m = measure_batch(means_dev, std_dev)
                fetch.update({k: m[k] for k in _MEASURE_COLUMNS})
            got = {k: v.cpu().numpy() for k, v in fetch.items()}
            epi_norm = np.zeros((n,), np.float32)
            passed = (
                ~((epi_norm > epistemic_criterion) | (got["mse_center"] > mse_criterion))
                & np.isfinite(got["mse_center"])
                & np.isfinite(epi_norm)
            )
            cols["shifts"].extend(list(shifts))
            cols["list_idx"].extend(list(s0 + list_idx))
            cols["galaxy_distances_to_center_x"].extend(list(dets[:, 0]))
            cols["galaxy_distances_to_center_y"].extend(list(dets[:, 1]))
            cols["mse_center"].extend(list(got["mse_center"]))
            cols["epistemic_norm"].extend(list(epi_norm))
            cols["passed_cuts"].extend(list(passed))
            for k in _MEASURE_COLUMNS if measure else ():
                cols[k].extend(list(got[k]))
            n_deblended += n

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
        """Rendered mean and stddev canvases (the epistemic canvas stays
        zero: epistemic estimation is not ported yet)."""
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
        return out

    def get_deblending_meta_data(self, res_deblend=None) -> dict:
        """The field, the residual and the predicted canvases in one dict."""
        meta = {"field_image": self.field_image}
        meta["deblended_image"] = self.get_residual_field(res_deblend)
        meta.update(self.get_predicted_field(res_deblend))
        return meta
