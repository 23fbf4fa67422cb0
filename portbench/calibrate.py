"""The readings that each cell's limits are set from, on the card.

``python3 -m portbench.calibrate --workload <name> --seeds 12
--control-seeds 3 --seconds 3 [--faults a,b] [--out FILE]`` runs the cell
through the harness (set-up, a short window at the cell's own size, the
comparison) once a seed in one process: the program on ``--seeds`` seeds,
then the control (the reference in the program's place one precision
below the configuration's) and each named fault of the driver's
``FAULTS`` on ``--control-seeds`` seeds.  It prints, for every number
compared, the program's largest reading (the lower end of its limit) and
the smallest reading of the control and of each fault (candidates for the
upper end).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from portbench.harness import load_cell, load_manifest, load_module, run_cell

# the calibration's seeds, apart from the full sets' and the driver's
_FIRST_SEED = 3_000_000_000


def readings(workload: str, seeds: list[int], program, seconds: float, device, mix_overrides=None) -> list[dict]:
    manifest = load_manifest()
    cell = load_cell(manifest, workload)
    out = []
    for seed in seeds:
        t = time.perf_counter()
        r = run_cell(manifest, cell, seed, seconds, False, device=device, program=program,
                     mix_overrides=mix_overrides)
        out.append({"seed": seed, "correct": r["correct"], "seconds": time.perf_counter() - t,
                    "checks": {k: v["value"] for k, v in r["checks"].items()}, "notes": r.get("notes"),
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()}})
        print(json.dumps(out[-1]), file=sys.stderr, flush=True)
    return out


def extremes(runs: list[dict], largest: bool) -> dict:
    pick = max if largest else min
    return {k: pick(r["checks"][k] for r in runs) for k in runs[0]["checks"]} if runs else {}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    manifest = load_manifest()
    cell = load_cell(manifest, args.workload)
    driver = load_module("drivers", cell["mix_data"]["driver"])
    seeds = [_FIRST_SEED + 7919 * i for i in range(args.seeds)]
    others = [_FIRST_SEED + 104729 + 7919 * i for i in range(args.control_seeds)]
    report = {"workload": args.workload, "program": readings(args.workload, seeds, None, args.seconds, "cuda")}
    report["control"] = readings(args.workload, others, driver.control(cell["config_data"]), args.seconds, "cuda")
    for name in filter(None, args.faults.split(",")):
        report[f"fault:{name}"] = readings(args.workload, others, driver.FAULTS[name], args.seconds, "cuda")
    summary = {"lower": extremes(report["program"], True)}
    for key in report:
        if key not in ("workload", "program"):
            summary[f"upper:{key}"] = extremes(report[key], False)
    report["summary"] = summary
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
