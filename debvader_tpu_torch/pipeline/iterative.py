"""Iterative detect -> deblend -> subtract scene deblending.

Port of debvader_tpu.pipeline.iterative.IterativeDeblendField, the
reference's control flow and termination quirks kept:

- the first step deblends the raw field (optionally at given centres or
  cutouts);
- each further step detects on the residual field (``detect_objects`` at
  the default configuration: the clipped-statistics, detect-core and label
  kernels on a card) and deblends the new sources;
- the loop goes on while a step finds strictly more shifts than the one
  before it;
- a step that deblends nothing returns the whole accumulated record array;
- each step's ``list_idx`` is offset by the galaxies found before it;
- by default each step's residual subtracts only the latest step's
  galaxies from the original field (``cumulative_residual=False``).

``self.mse`` gains each step's mean squared change of the residual.

``iterative_deblend_and_render`` is the device-resident server of the
same loop: the running residual stays on the device, each step detects on
it through tiled detection (pipeline/tiles.py), streams the new sources
through ``_stream_deblend`` and subtracts their rendered model, and only
catalog scalars and the final residual reach the host.
"""

from __future__ import annotations

import numpy as np
import torch

from debvader_tpu_torch.ops.detection import detect_objects
from debvader_tpu_torch.ops.shift import render_pad
from debvader_tpu_torch.pipeline.field import DeblendField, _check_reduced_dtype, _model_subtract, _records
from debvader_tpu_torch.pipeline.tiles import detect_objects_tiled

__all__ = ["IterativeDeblendField"]


def _mse(a, b) -> float:
    return float(np.mean(np.square(np.asarray(a) - np.asarray(b))))


class IterativeDeblendField(DeblendField):
    def iterative_deblending(
        self,
        galaxy_distances_to_center=None,
        cutout_images=None,
        optimise_positions: bool = False,
        epistemic_criterion: float = 100.0,
        mse_criterion: float = 100.0,
        cumulative_residual: bool = False,
    ):
        """Detect, deblend and subtract until no new sources appear;
        returns the accumulated record array.

        ``cumulative_residual``: the reference computes each step's
        residual by subtracting only the latest step's galaxies from the
        original field (``get_residual_field`` renders ``self.res_deblend``,
        which each ``deblend_field`` overwrites), so earlier finds reappear
        in later residuals.  False (the default) keeps that; True subtracts
        every galaxy found so far."""
        field_image = self.field_image.copy()
        res_step = self.deblending_step(
            field_image,
            galaxy_distances_to_center=galaxy_distances_to_center,
            cutout_images=cutout_images,
            optimise_positions=optimise_positions,
            epistemic_criterion=epistemic_criterion,
            mse_criterion=mse_criterion,
        )
        res_deblend = res_step
        if res_step is None or res_step["list_idx"] is None:
            print("converged !")
            return self.res_deblend

        def residual():
            if cumulative_residual:
                return self.get_residual_field(res_deblend=res_deblend)
            return self.get_residual_field()

        new_residual_field = residual()
        self.mse.append(_mse(self.field_image, new_residual_field))
        shifts_previous: list = []
        k = 1

        while res_step["shifts"] is not None and len(res_step["shifts"]) > len(shifts_previous):
            print(f"iteration {k}")
            shifts_previous = res_step["shifts"]
            prev_residual_field = new_residual_field

            res_step = self.deblending_step(
                prev_residual_field,
                optimise_positions=optimise_positions,
                epistemic_criterion=epistemic_criterion,
                mse_criterion=mse_criterion,
            )

            if res_step is None or res_step["list_idx"] is None:
                new_residual_field = residual()
                self.mse.append(_mse(prev_residual_field, new_residual_field))
                break

            res_deblend = np.concatenate([res_deblend, res_step])
            new_residual_field = residual()
            self.mse.append(_mse(prev_residual_field, new_residual_field))
            k += 1
            print(f"{sum(self.nb_of_deblended_galaxies)} galaxies found up to this step.")

        print("converged !")
        self.res_deblend = res_deblend
        return self.res_deblend

    def iterative_deblend_and_render(
        self,
        galaxy_distances_to_center=None,
        optimise_positions: bool = False,
        epistemic_criterion: float = 100.0,
        mse_criterion: float = 100.0,
        measure: bool = False,
        det_cfg=None,
        max_iterations: int = 20,
        transfer_dtype=None,
    ):
        """Iterative detect -> deblend -> subtract with the residual on the
        device.

        Step 0 detects on the memoized device field (or takes the given
        centres), each later step on the device residual, through
        ``detect_objects_tiled`` at ``cfg.tile_size`` / ``cfg.tile_overlap``
        and ``det_cfg``.  The new sources stream through the chunked
        deblend and render core, and their model is subtracted on the
        device: every source found so far stays subtracted (the
        cumulative-residual semantics).  The loop goes on while a step
        deblends strictly more sources than the one before, and stops on a
        step that detects or deblends nothing, or after ``max_iterations``
        steps.  ``self.mse`` gains each step's mean square model power.

        Returns (catalog, residual_field): the catalog is the streaming
        route's, with ``list_idx`` offset by the sources of earlier steps
        and an ``iteration`` column (0-based step); (None, the field) when
        nothing is deblended.  ``transfer_dtype`` ('bfloat16' / 'float16')
        downloads the residual at that precision."""
        transfer_dtype = _check_reduced_dtype("transfer_dtype", transfer_dtype)
        residual_dev = self._device_field(self.field_image)
        pad = render_pad(self.cutout_size, self.cfg.interp_order)
        all_cols: dict[str, list] = {}
        n_prev = 0
        total = 0

        for k in range(max_iterations):
            if k == 0 and galaxy_distances_to_center is not None:
                centers = np.asarray(galaxy_distances_to_center)
            else:
                centers = detect_objects_tiled(
                    residual_dev,
                    det_cfg,
                    tile=self.cfg.tile_size,
                    overlap=self.cfg.tile_overlap,
                    mesh=self.mesh,
                    device=self.device,
                )
            if len(centers) == 0:
                print("No more galaxies found")
                break

            cols, canvases, n_new = self._stream_deblend(
                residual_dev,
                centers,
                optimise_positions=optimise_positions,
                epistemic_criterion=epistemic_criterion,
                mse_criterion=mse_criterion,
                measure=measure,
                # the memoized field, the running residual and the canvas
                resident_fields=3,
            )
            if n_new == 0:
                print("No more galaxies found")
                break

            # step 0's residual is the memoized field, which later calls
            # reuse: subtract into a new buffer; later steps own theirs
            residual_dev, step_mse = _model_subtract(residual_dev, canvases["mean"], pad, in_place=k > 0)
            self.mse.append(float(step_mse))

            cols["list_idx"] = [i + total for i in cols["list_idx"]]
            cols["iteration"] = [k] * n_new
            for key, vals in cols.items():
                all_cols.setdefault(key, []).extend(vals)
            total += n_new
            print(f"iteration {k + 1}")
            print(f"{total} galaxies found up to this step.")

            if k > 0 and n_new <= n_prev:
                break
            n_prev = n_new

        print("converged !")
        if total == 0:
            return None, self._residual_field()
        catalog = _records(all_cols)
        out_dev = residual_dev[0]
        if transfer_dtype is not None:
            out_dev = out_dev.to(getattr(torch, transfer_dtype))
        residual_field = self._residual_field(self._fetch_field(out_dev))
        self.res_deblend = catalog
        return catalog, residual_field

    def deblending_step(
        self,
        field_image,
        galaxy_distances_to_center=None,
        cutout_images=None,
        optimise_positions: bool = False,
        epistemic_criterion: float = 100.0,
        mse_criterion: float = 100.0,
    ):
        """One detect + deblend pass: the step's record array with its
        ``list_idx`` offset by the galaxies of earlier steps, or
        ``self.res_deblend`` when nothing is found or deblended."""
        if galaxy_distances_to_center is None:
            detection_k = detect_objects(field_image, device=self.device)
        else:
            detection_k = np.asarray(galaxy_distances_to_center)

        if len(detection_k) == 0:
            print("No more galaxies found")
            return self.res_deblend

        res_step = self.deblend_field(
            field_image=field_image,
            galaxy_distances_to_center=detection_k,
            cutout_images=cutout_images,
            optimise_positions=optimise_positions,
            epistemic_criterion=epistemic_criterion,
            mse_criterion=mse_criterion,
        )

        if res_step["list_idx"] is None or len(res_step["list_idx"]) == 0:
            print("No more galaxies found")
            return self.res_deblend

        # offset list_idx by the galaxies found in earlier steps
        offset = sum(self.nb_of_deblended_galaxies) - self.nb_of_deblended_galaxies[-1]
        if offset:
            res_step["list_idx"] += offset

        print(f"Deblend {self.nb_of_deblended_galaxies[-1]} more galaxy(ies)")
        return res_step
