"""Catalog deblending of cutouts: a closed loop of one client that
dispatches batches of stamps back to back through ``api.deblend_tensor``.

The mix's parameters: ``batch`` stamps a step, cycled from a pool of
``pool_batches`` distinct batches made at set-up on the card from the seed
(``generators.simulate_batch``'s blended noisy stamps, ``max_neighbors``,
``noise``); ``warmup_steps`` forwards before the window.  The forward is
the deterministic one (``z_mode='mean'``) and its outputs stay on the
card.

What is compared: the last output of every pool batch, all of its rows,
against the reference's forward of the same stamps at the configuration's
precision (``loc`` and ``scale``, each as the relative root-mean-square gap
and the widest gap over the largest reference value), and the float64 sum
of every step's outputs against the reference's sum for its batch.
"""

from __future__ import annotations

import torch

from portbench.generators import make_generator, simulate_batch
from portbench.harness import REPO
from portbench.port import load_net
from portbench.reference import vae as ref

_REF_BLOCK = 1024


def port_program(config: dict, device):
    """The program's forward for the configuration: ``x -> (loc, scale)``
    through ``api.deblend_tensor`` on the shipped weights."""
    from debvader_tpu_torch.api import deblend_tensor

    net = load_net(config, device)

    def forward(x):
        dist = deblend_tensor(net, x, z_mode="mean")
        return dist.loc, dist.scale

    return forward


def reference_program(config: dict, device, precision: str):
    """The reference put in the program's place, at ``precision``."""
    params = ref.load_params(REPO / config["weights"], device)

    @torch.no_grad()
    def forward(x):
        return ref.forward(params, x, precision)

    return forward


def control(config: dict):
    """The control: the reference in the program's place, one precision
    below the configuration's."""
    return lambda cfg, device: reference_program(cfg, device, config["control_precision"])


def _faulty(kind: str):
    def factory(config, device):
        forward = port_program(config, device)

        def broken(x):
            loc, scale = forward(x)
            loc, scale = loc.clone(), scale.clone()
            if kind == "half_batch":  # the second half of the batch left out
                half = x.shape[0] // 2
                loc[half:] = 0.0
                scale[half:] = 1.0
            elif kind == "altered":  # one answer altered where it is produced
                loc[0, loc.shape[1] // 2, loc.shape[2] // 2, 0] += 1.0
            return loc, scale

        return broken

    return factory


# faults the cell can have, planted in the program: {name: program factory}
FAULTS = {"half_batch": _faulty("half_batch"), "altered": _faulty("altered")}


class Cell:
    rate_metric = "stamps_per_s"

    def __init__(self, config: dict, mix: dict, seed: int, device, program=None):
        self.config, self.mix, self.seed, self.device = config, mix, seed, torch.device(device)
        self.units_per_step = int(mix["batch"])
        self._program = program
        self.forward = None

    def setup(self) -> None:
        model = self.config["model"]
        self.forward = (self._program or port_program)(self.config, self.device)
        gen = make_generator(self.seed, 0, self.device)
        self.pool = [
            simulate_batch(gen, self.units_per_step, model["stamp_size"], model["nb_of_bands"],
                           int(self.mix["max_neighbors"]), float(self.mix["noise"]))[0]
            for _ in range(int(self.mix["pool_batches"]))
        ]
        self.ring: dict[int, tuple] = {}
        self.sums: list[torch.Tensor] = []
        for i in range(int(self.mix["warmup_steps"])):
            self._forward(i)
        self.sums.clear()

    def _forward(self, i: int):
        slot = i % len(self.pool)
        loc, scale = self.forward(self.pool[slot])
        self.ring[slot] = (loc, scale)
        return slot, loc, scale

    def step(self, i: int) -> None:
        slot, loc, scale = self._forward(i)
        self.sums.append((slot, torch.stack([loc.sum(dtype=torch.float64), scale.sum(dtype=torch.float64)])))

    def failed_units(self) -> int:
        if not self.sums:
            return 0
        finite = torch.isfinite(torch.stack([s for _, s in self.sums])).all(dim=1).cpu()
        return int((~finite).sum()) * self.units_per_step

    def release(self) -> None:
        self.forward = None

    @torch.no_grad()
    def check(self) -> dict:
        """Every pool batch's last output and every step's sums against the
        reference at the configuration's precision."""
        params = ref.load_params(REPO / self.config["weights"], self.device)
        precision = self.config["reference_precision"]
        acc = {k: torch.zeros((), dtype=torch.float64, device=self.device)
               for k in ("loc_d2", "loc_r2", "scale_d2", "scale_r2")}
        widest = {k: torch.zeros((), device=self.device) for k in ("loc_d", "loc_r", "scale_d", "scale_r")}
        ref_sums = {}
        for slot, (loc, scale) in sorted(self.ring.items()):
            x = self.pool[slot]
            total = torch.zeros(2, dtype=torch.float64, device=self.device)
            absolute = torch.zeros(2, dtype=torch.float64, device=self.device)
            for b in range(0, x.shape[0], _REF_BLOCK):
                r_loc, r_scale = ref.forward(params, x[b: b + _REF_BLOCK], precision)
                for name, got, want in (("loc", loc[b: b + _REF_BLOCK], r_loc),
                                        ("scale", scale[b: b + _REF_BLOCK], r_scale)):
                    d = (got.to(torch.float64) - want.to(torch.float64))
                    acc[f"{name}_d2"] += torch.sum(d * d)
                    acc[f"{name}_r2"] += torch.sum(want.to(torch.float64) ** 2)
                    widest[f"{name}_d"] = torch.maximum(widest[f"{name}_d"], torch.nan_to_num(
                        torch.amax(torch.abs(got - want)), nan=float("inf")))
                    widest[f"{name}_r"] = torch.maximum(widest[f"{name}_r"], torch.amax(torch.abs(want)))
                total += torch.stack([r_loc.sum(dtype=torch.float64), r_scale.sum(dtype=torch.float64)])
                absolute += torch.stack([r_loc.abs().sum(dtype=torch.float64), r_scale.abs().sum(dtype=torch.float64)])
            ref_sums[slot] = (total, absolute)
        step_gap = torch.zeros((), dtype=torch.float64, device=self.device)
        for slot, got in self.sums:
            total, absolute = ref_sums[slot]
            step_gap = torch.maximum(step_gap, torch.nan_to_num(torch.amax(torch.abs(got - total) / absolute),
                                                                 nan=float("inf")))
        out = {
            "loc_rel_rms": torch.sqrt(acc["loc_d2"] / acc["loc_r2"]),
            "loc_rel_max": widest["loc_d"] / widest["loc_r"],
            "scale_rel_rms": torch.sqrt(acc["scale_d2"] / acc["scale_r2"]),
            "scale_rel_max": widest["scale_d"] / widest["scale_r"],
            "step_sum_rel": step_gap,
        }
        return {k: float(v) for k, v in out.items()}
