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
"""

from __future__ import annotations

import numpy as np

from debvader_tpu_torch.ops.detection import detect_objects
from debvader_tpu_torch.pipeline.field import DeblendField, _not_ported

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

    def iterative_deblend_and_render(self, *args, **kwargs):
        """The device-resident iterative server detects through tiled
        detection, which is not ported yet."""
        _not_ported("iterative_deblend_and_render", "tiles and batched detection")

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
