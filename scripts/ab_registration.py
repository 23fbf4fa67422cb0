"""Time the registration kernel of two checkouts of the port on one card, in
turns, on the same real inputs, and hold their shifts to each other.

    python3 scripts/ab_registration.py --parent DIR [--out FILE]

DIR holds another checkout of the repository's ``debvader_tpu_torch/``
(for example the parent commit's, unpacked with ``git archive`` into a
directory that .gitignore lists; its weights are not needed).  First this
tree runs ``chip_smoke.py``'s record-array route on its seeded 1024^2 field
and keeps the registration's real inputs: the field's r band, the r band
of every deblended source's mean and their detected offsets (295 sources
of 59 px).  Then one worker process a turn, in the order parent, this
tree, this tree, parent, imports ``debvader_tpu_torch`` from its own tree,
builds that tree's ``csrc/registration.cu`` and runs
``kernels.registration.register_windowed`` on the saved inputs (bound 3,
20 steps): the device time of ``register_windowed_kernel``
(torch.profiler, mean of 30) and the per-call time (CUDA events, median of
30).  The shifts of every turn must agree within 1e-4 px (the kernels sum
in different orders, so not bit for bit).  Needs a card; the last line is
one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BOUND, ITERATIONS = 3.0, 20
MAX_SHIFT_DIFF_PX = 1e-4


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(path: Path) -> None:
    """This tree's record-array route on chip_smoke.py's field; the
    registration's inputs saved to ``path``."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import debvader_tpu_torch as dt

    smoke = _smoke()
    field = smoke.make_field()
    net = dt.load_deblender("sim_demo", device="cuda")
    _, res, _, _ = smoke.run_main_path(torch, net, field, "cuda")
    preds = np.stack(list(res.output_images_mean))[..., 2]
    dets = np.stack([res.galaxy_distances_to_center_x, res.galaxy_distances_to_center_y], -1)
    torch.save({"band": torch.from_numpy(np.ascontiguousarray(field[0, :, :, 2])),
                "preds": torch.from_numpy(np.ascontiguousarray(preds, np.float32)),
                "offsets": torch.from_numpy(np.ascontiguousarray(dets, np.float32))}, path)


def worker(tree: Path, inputs: Path, out: Path) -> dict:
    """One turn: this tree's registration kernel on the saved inputs."""
    sys.path.insert(0, str(tree))
    import torch

    smoke = _smoke()
    from debvader_tpu_torch.kernels import _build
    from debvader_tpu_torch.kernels import registration as kr

    if not Path(kr.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {kr.__file__}, not from {tree}")
    logs = _build.build_all(["registration"])
    saved = torch.load(inputs)
    band, preds, offsets = (saved[k].cuda() for k in ("band", "preds", "offsets"))

    def unit():
        return kr.register_windowed(band, preds, offsets, BOUND, ITERATIONS)

    shifts = unit()
    torch.cuda.synchronize()
    torch.save(shifts.cpu(), out)
    return {
        "sources": int(preds.shape[0]),
        "device_ms": smoke.profiled_device_ms(torch, unit, "register_windowed_kernel"),
        "ms": smoke.cuda_ms(torch, unit),
        "ptxas": [line.strip() for log in logs.values() for line in log.splitlines()
                  if "registers" in line or "spill" in line],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="the other checkout, timed in turns with this one")
    ap.add_argument("--worker", type=Path, nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help="also write the summary to this JSON file")
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(*args.worker)))
        return 0
    if args.inputs is not None:
        make_inputs(args.inputs)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    work = ROOT / "chiprun_out" / "ab_registration"
    work.mkdir(parents=True, exist_ok=True)
    try:
        return compare_turns(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def compare_turns(args, work: Path) -> int:
    inputs = work / "inputs.pt"
    script = str(Path(__file__).resolve())
    subprocess.run([sys.executable, script, "--inputs", str(inputs)], check=True, timeout=600)
    turns, outputs = [], []
    for i, (label, tree) in enumerate((("parent", args.parent), ("change", ROOT), ("change", ROOT),
                                       ("parent", args.parent))):
        out = work / f"turn{i}_{label}.pt"
        proc = subprocess.run([sys.executable, script, "--worker", str(tree), str(inputs), str(out)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"the {label} turn failed:\n{proc.stderr[-4000:]}")
        turns.append({"tree": label, **json.loads(proc.stdout.strip().splitlines()[-1])})
        outputs.append(out)
        print(label, json.dumps({k: v for k, v in turns[-1].items() if k != "ptxas"}), flush=True)

    import torch

    shifts = [torch.load(p) for p in outputs]
    worst = max(float((s - shifts[0]).abs().max()) for s in shifts[1:])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    summary = {
        "card": card, "bound": BOUND, "iterations": ITERATIONS, "max_shift_diff_px": worst,
        "shifts_agree": worst <= MAX_SHIFT_DIFF_PX,
        "device_ms_in_turn_order": [t["device_ms"] for t in turns],
        "ms_in_turn_order": [t["ms"] for t in turns], "turns": turns,
    }
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps(summary))
    return 0 if summary["shifts_agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
