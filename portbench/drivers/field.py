"""Survey fields: a closed loop of one client that deblends whole fields
one after another through ``TiledDeblendField.detect_deblend_render``:
tiled detection on the card, then the streaming serve (cutouts, the stamp
forward, the render into a padded canvas, the residual), the catalogue and
the residual back on the host.

The mix's parameters: a pool of ``pool_fields`` (1, ``field_size``,
``field_size``, 6) float32 fields made at set-up on the card from the seed
(``generators.make_field``: ``galaxies`` galaxies, ``noise``) and copied to
the host, cycled; the detection settings ``thresh`` and
``threshold_scaling``; the pipeline's ``tile_size``, ``tile_overlap``,
``interp_order`` and ``source_chunk``; ``warmup_steps`` fields before the
window.  The forward is the deterministic one (``z_mode='mean'``).

What is compared, for every field the window completed, against the
reference of its pool field: the detected centres (the catalogue's rows)
against the reference's own detection, as the share of either side's
centres that the other lacks; and the residual field (its relative
root-mean-square gap and its widest gap, each over the model's) against
the reference's serve at the reference's own centres, so that a source
that one side alone detected fails the residual too; and the mse_center
of each source that both sides deblended.
Beside the comparison, each run notes how the program's detection meets
the field's truth catalogue (``reference.field.truth_match``): a witness
that does not share the reference detection's algorithm.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from portbench.generators import make_field, make_generator
from portbench.harness import REPO
from portbench.port import load_net
from portbench.reference import field as ref_field
from portbench.reference import vae as ref

# DetectionConfig's defaults that the reference's detection reads
_DETECTION = {"minarea": 4, "deblend_nthresh": 64, "deblend_cont": 1e-5, "background_box": 64, "filter_fwhm": 3.0,
              "detection_band": 2, "clean": True, "clean_param": 1.0}
_STAMP, _MSE_WINDOW = 59, 5


def _det(mix: dict) -> dict:
    if mix["threshold_scaling"] != "matched":
        raise ValueError("the reference detects with the 'matched' threshold scaling")
    return dict(_DETECTION, thresh=float(mix["thresh"]))


class PortField:
    """The program: ``run(field)`` deblends one host field and returns its
    catalogue's centres and mse_center, the residual, and the program's
    stage seconds."""

    def __init__(self, config: dict, mix: dict, device, half_batch: bool = False, altered: bool = False):
        from debvader_tpu_torch.config import DetectionConfig, PipelineConfig

        self.net = load_net(config, device)
        self.det_cfg = DetectionConfig(thresh=float(mix["thresh"]), threshold_scaling=mix["threshold_scaling"])
        self.cfg = PipelineConfig(tile_size=int(mix["tile_size"]), tile_overlap=int(mix["tile_overlap"]),
                                  interp_order=int(mix["interp_order"]), source_chunk=int(mix["source_chunk"]))
        self.device, self.half, self.altered = device, half_batch, altered

    def run(self, field: np.ndarray) -> dict:
        from debvader_tpu_torch.pipeline.tiles import TiledDeblendField

        df = TiledDeblendField(self.net, field, det_cfg=self.det_cfg, cfg=self.cfg, z_mode="mean",
                               device=self.device)
        if self.half:  # the fault: half of the sources left out
            centres = df.detect(field=df._device_field(df.field_image))
            catalog, residual = df.deblend_and_render(centres[: len(centres) // 2])
        else:
            catalog, residual = df.detect_deblend_render()
        residual = residual[0]
        if self.altered:  # the fault: one answer altered where it is produced
            residual[residual.shape[0] // 2, residual.shape[1] // 2, 0] += 1.0
        if catalog is None:
            centres, mse, index = np.zeros((0, 2)), np.zeros(0), np.zeros(0, np.int64)
        else:
            centres = np.stack([catalog["galaxy_distances_to_center_x"], catalog["galaxy_distances_to_center_y"]], -1)
            mse = np.asarray(catalog["mse_center"], np.float64)
            index = np.asarray(catalog["list_idx"], np.int64)
        return {"centres": centres.astype(np.float64), "mse": mse, "index": index, "residual": residual,
                "timings": dict(df.detect_timings, **df.serving_timings)}


class ReferenceField:
    """The reference in the program's place, at ``precision`` (the
    control)."""

    def __init__(self, config: dict, mix: dict, device, precision: str):
        self.params = ref.load_params(REPO / config["weights"], device)
        self.mix, self.device, self.precision = mix, torch.device(device), precision

    def run(self, field: np.ndarray) -> dict:
        dev_field = torch.as_tensor(field, device=self.device)
        centres = ref_field.detect(dev_field, _det(self.mix), int(self.mix["tile_size"]),
                                   int(self.mix["tile_overlap"]), self.precision)
        residual, mse, kept = ref_field.serve(self.params, dev_field, centres, _STAMP, _MSE_WINDOW, self.precision)
        kept = kept.cpu().numpy()
        return {"centres": centres[kept], "mse": mse.cpu().numpy().astype(np.float64), "index": kept,
                "residual": residual.cpu().numpy(), "timings": {}}


def control(config: dict):
    """The control: the reference in the program's place, one precision
    below the configuration's."""
    return lambda cfg, mix, device: ReferenceField(cfg, mix, device, config["control_precision"])


# faults the cell can have, planted in the program: {name: program factory}
FAULTS = {
    "half_batch": lambda cfg, mix, device: PortField(cfg, mix, device, half_batch=True),
    "altered": lambda cfg, mix, device: PortField(cfg, mix, device, altered=True),
}


class Cell:
    rate_metric = "field_s"
    in_flight = 0  # a field's results are on the host when its step returns
    units_per_step = 1

    def __init__(self, config: dict, mix: dict, seed: int, device, program=None):
        self.config, self.mix, self.seed, self.device = config, mix, seed, torch.device(device)
        self._program = program
        self.program = None

    @staticmethod
    def rate(units: int, window: float) -> float:
        """Seconds from the window's start to the end of its last completed
        field, over the fields completed."""
        return window / units

    def setup(self) -> None:
        gen = make_generator(self.seed, 0, self.device)
        size, bands = int(self.mix["field_size"]), int(self.config["model"]["nb_of_bands"])
        self.pool, self.truth = [], []
        for _ in range(int(self.mix["pool_fields"])):
            field, centres = make_field(gen, size, int(self.mix["galaxies"]), bands, float(self.mix["noise"]))
            self.pool.append(field.cpu().numpy())
            self.truth.append(centres.cpu().numpy())
        self.program = (self._program or PortField)(self.config, self.mix, self.device)
        self.outputs: list[tuple[int, dict]] = []
        for i in range(int(self.mix["warmup_steps"])):
            self.program.run(self.pool[i % len(self.pool)])
        self.timings: dict = {}
        self.sources = 0

    def step(self, i: int) -> None:
        slot = i % len(self.pool)
        out = self.program.run(self.pool[slot])
        for k, v in out.pop("timings").items():
            self.timings[k] = self.timings.get(k, 0.0) + v
        self.sources += len(out["mse"])
        self.outputs.append((slot, out))

    def window_stats(self) -> dict:
        return {"stages_s": dict(self.timings), "sources": self.sources, "fields": len(self.outputs)}

    def trace_stats(self, steps: int) -> dict:
        """The traced fields' deblended centres and their indices among the
        detected ones (which stream chunk each rendered in)."""
        return {"fields": [(out["centres"], out["index"]) for _, out in self.outputs[-steps:]]}

    def failed_units(self) -> int:
        return sum(1 for _, out in self.outputs if not np.isfinite(out["residual"]).all())

    def release(self) -> None:
        self.program = None

    @torch.no_grad()
    def check(self) -> dict:
        """Every completed field against the reference of its pool field."""
        params = ref.load_params(REPO / self.config["weights"], self.device)
        precision = self.config["reference_precision"]
        refs = {}
        for slot in sorted({slot for slot, _ in self.outputs}):
            field = torch.as_tensor(self.pool[slot], device=self.device)
            centres = ref_field.detect(field, _det(self.mix), int(self.mix["tile_size"]),
                                       int(self.mix["tile_overlap"]), precision)
            residual, mse, kept = ref_field.serve(params, field, centres, _STAMP, _MSE_WINDOW, precision)
            model = field[0] - residual
            refs[slot] = (centres[kept.cpu().numpy()], mse.cpu().numpy().astype(np.float64), residual.cpu().numpy(),
                          float(torch.linalg.vector_norm(model.double())), float(torch.amax(torch.abs(model))))
        worst = {"centres_unmatched": 0.0, "residual_rel_rms": 0.0, "residual_rel_max": 0.0, "mse_center_rel": 0.0}
        self.truth_scores = {"truth_missed": 0.0, "truth_spurious": 0.0}
        f = self.pool[0].shape[1]
        for slot, out in self.outputs:
            want, want_mse, residual, model_norm, model_max = refs[slot]
            a, b = Counter(map(tuple, out["centres"].tolist())), Counter(map(tuple, want.tolist()))
            unmatched = (sum((a - b).values()) + sum((b - a).values())) / max(sum(b.values()), 1)
            got_mse, want_mse = _common(out["centres"], out["mse"], want, want_mse)
            d = out["residual"].astype(np.float64) - residual
            finite = np.isfinite(d).all()
            gaps = {
                "centres_unmatched": unmatched,
                "residual_rel_rms": float(np.sqrt(np.sum(d * d))) / model_norm if finite else np.inf,
                "residual_rel_max": float(np.max(np.abs(d))) / model_max if finite else np.inf,
                "mse_center_rel": (float(np.linalg.norm(got_mse - want_mse) / np.linalg.norm(want_mse))
                                   if len(want_mse) else np.inf),
            }
            worst = {k: max(worst[k], v) for k, v in gaps.items()}
            missed, spurious = ref_field.truth_match(out["centres"], self.truth[slot], f)
            self.truth_scores = {"truth_missed": max(self.truth_scores["truth_missed"], missed),
                                 "truth_spurious": max(self.truth_scores["truth_spurious"], spurious)}
        return worst

    def notes(self) -> dict:
        """The program's detection against the fields' truth catalogues, the
        worst field's (read after ``check``)."""
        return self.truth_scores


def _common(centres: np.ndarray, mse: np.ndarray, ref_centres: np.ndarray, ref_mse: np.ndarray):
    """The two sides' mse_center at the centres that both deblended, in
    one order (sources at one centre share their cutout, and so their
    mse_center); a source that one side alone has is ``centres_unmatched``'s."""
    mine = dict(zip(map(tuple, centres.tolist()), mse))
    theirs = dict(zip(map(tuple, ref_centres.tolist()), ref_mse))
    common = sorted(mine.keys() & theirs.keys())
    return np.array([mine[c] for c in common]), np.array([theirs[c] for c in common])
