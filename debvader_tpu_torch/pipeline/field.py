"""Scene-level field deblending on the device, in PyTorch.

Port of debvader_tpu.pipeline.field.DeblendField along its single-device
float path: cutouts in one gather (ops/extraction.py), one batched VAE
forward (api.py), the centre-window mse cut, and the residual field
rendered in one scatter (ops/shift.py).  The catalog is a numpy record
array with the columns, order and dtypes of the JAX package's pandas
``to_records`` output, built without pandas.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
position registration, epistemic uncertainty, measurement, mesh fan-out,
int8 serving and exported artifacts.
"""

from __future__ import annotations

import numpy as np
import torch

from debvader_tpu_torch.api import deblend_tensor
from debvader_tpu_torch.config import PipelineConfig
from debvader_tpu_torch.device import resolve_device
from debvader_tpu_torch.ops.extraction import extract_cutouts, extract_cutouts_np
from debvader_tpu_torch.ops.shift import render_field

__all__ = ["DeblendField"]

_ROADMAP = "ROADMAP.md Queue 1"


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
        z_mode: str = "sample",
        artifact=None,
        device="cuda",
    ):
        """net: a DeblenderVAE on ``device`` (load_deblender); field_image:
        (1, F, F, B).  ``z_mode`` is 'sample' (the reference's stochastic
        forward, latents from ``generator``, seeded 0 by default) or 'mean'
        (deterministic)."""
        if epistemic_uncertainty_estimation:
            _not_ported("epistemic_uncertainty_estimation=True", "2. DeblendField options")
        if mesh is not None:
            _not_ported("mesh=", "8. multi-device")
        if quantized is not None:
            _not_ported("quantized=", "6. quantized")
        if artifact is not None:
            _not_ported("artifact=", "7. precision and export")
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

    def _forward(self, cutouts: torch.Tensor):
        """(means, stddevs) as numpy, forwarding ``source_chunk`` stamps at
        a time."""
        means, stds = [], []
        for s0 in range(0, cutouts.shape[0], self.cfg.source_chunk):
            dist = deblend_tensor(
                self.net,
                cutouts[s0 : s0 + self.cfg.source_chunk],
                self.normalise,
                self.generator,
                self.z_mode,
            )
            means.append(dist.mean().cpu().numpy())
            stds.append(dist.stddev().cpu().numpy())
        return np.concatenate(means), np.concatenate(stds)

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
        extraction."""
        if optimise_positions:
            _not_ported("optimise_positions=True", "2. DeblendField options")
        if measure:
            _not_ported("measure=True", "2. DeblendField options")
        empty = {
            "cutout_images": None,
            "output_images_mean": None,
            "output_images_stddev": None,
            "shifts": None,
            "list_idx": None,
        }
        if field_image is None:
            field_image = self.field_image
        else:
            field_image = np.asarray(field_image, np.float32)
            _check_field_image(field_image)
        centers = np.asarray(galaxy_distances_to_center, np.float32).reshape(-1, 2)

        if isinstance(cutout_images, np.ndarray):
            cut_np = np.asarray(cutout_images, np.float32)
            cutouts = torch.as_tensor(cut_np, device=self.device)
            list_idx = np.arange(len(cut_np))
        else:
            field_dev = torch.as_tensor(field_image, device=self.device)
            all_cutouts, valid = extract_cutouts(field_dev, centers, self.cutout_size)
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

        means, stddevs = self._forward(cutouts)
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
        passed_cuts = (
            ~((epi_norm > epistemic_criterion) | (mse_center > mse_criterion))
            & np.isfinite(mse_center)
            & np.isfinite(epi_norm)
        )
        self.nb_of_detected_objects.append(len(centers))
        self.nb_of_deblended_galaxies.append(n)
        self.res_deblend = _records(
            {
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
        )
        return self.res_deblend

    @staticmethod
    def _offsets(res_deblend) -> np.ndarray:
        out = np.zeros((len(res_deblend), 2), np.float32)
        for i, row in enumerate(res_deblend):
            out[i, 0] = row["galaxy_distances_to_center_x"] + row["shifts"][0]
            out[i, 1] = row["galaxy_distances_to_center_y"] + row["shifts"][1]
        return out

    def _render(self, res_deblend, column: str) -> np.ndarray:
        stamps = np.stack([np.asarray(row[column]) for row in res_deblend]).astype(np.float32)
        rendered = render_field(
            torch.as_tensor(stamps, device=self.device),
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
