"""Time the order-3 record-array route with two versions of ops/spline.py
on one card, in turns.

    python3 scripts/ab_spline_order3.py --parent FILE [--pairs N] [--out FILE]

FILE is another version of ``debvader_tpu_torch/ops/spline.py`` (for
example the parent commit's, written out with ``git show``).  A spline
module imports only numpy and torch, so FILE is loaded on its own and put
in the place of ``ops/shift.py``'s ``subpixel_shift_spline_const``.

On chip_smoke.make_field's 1024² field with the sim_demo weights and the
smoke's detection settings (chip_smoke.py phase 4), each turn runs
``DeblendField(z_mode='mean').deblend_field`` and ``get_residual_field``
at the default ``interp_order=3``, each timed on the host clock up to a
device synchronise, in the order FILE, this tree, this tree, FILE (N
pairs).  Then the shift alone, at each input shape the route gives it,
by CUDA events (median of 20 calls) with both versions.  Prints the
turns, their medians, the largest difference between the two versions'
residual fields, and the card's name and power limit; the last line is
one JSON object.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True, help="the other version of ops/spline.py")
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--out", type=Path, default=None, help="also write the JSON object here")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import debvader_tpu_torch as dt
    from debvader_tpu_torch.ops import shift, spline

    smoke = _load(ROOT / "chip_smoke.py", "chip_smoke_ab")
    versions = {"parent": _load(args.parent, "spline_parent").subpixel_shift_spline_const,
                "this": spline.subpixel_shift_spline_const}
    field = smoke.make_field()
    net = dt.load_deblender("sim_demo", device="cuda")
    centers = dt.detect_objects(field, dt.DetectionConfig(**smoke.DETECTION), device="cuda")

    calls = []

    def turn(version: str, record: bool = False) -> tuple[float, float, np.ndarray]:
        fn = versions[version]
        if record:
            def wrapped(img, sh):
                calls.append((img.clone(), sh.clone()))
                return fn(img, sh)
            shift.subpixel_shift_spline_const = wrapped
        else:
            shift.subpixel_shift_spline_const = fn
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dfield = dt.DeblendField(net, field, z_mode="mean", device="cuda")
            dfield.deblend_field(centers)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            residual = dfield.get_residual_field()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            shift.subpixel_shift_spline_const = spline.subpixel_shift_spline_const
        return t1 - t0, t2 - t1, np.asarray(residual)

    # warm both, and record the shift's inputs once
    _, _, res_parent = turn("parent")
    _, _, res_this = turn("this", record=True)
    order = ["parent", "this", "this", "parent"] * args.pairs
    turns = []
    for version in order:
        deblend_s, residual_s, _ = turn(version)
        turns.append({"version": version, "deblend_s": deblend_s, "residual_s": residual_s})
        print(f"{version:6s} deblend_field {deblend_s * 1e3:.3f} ms, get_residual_field {residual_s * 1e3:.3f} ms")
    medians = {
        v: {k: float(np.median([t[k] for t in turns if t["version"] == v])) for k in ("deblend_s", "residual_s")}
        for v in versions
    }

    def cuda_ms(fn, img, sh, reps=20):
        fn(img, sh)
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(img, sh)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    shapes = {}
    for img, sh in calls:
        key = "x".join(map(str, img.shape))
        if key not in shapes:
            shapes[key] = {"calls": 0, **{f"{v}_ms": cuda_ms(fn, img, sh) for v, fn in versions.items()}}
        shapes[key]["calls"] += 1
    for key, rec in shapes.items():
        print(f"shift {key}: {rec['calls']} calls a turn, parent {rec['parent_ms']:.3f} ms, "
              f"this {rec['this_ms']:.3f} ms a call")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    out = {"card": card, "sources": int(len(centers)), "turns": turns, "median": medians, "shift": shapes,
           "residual_max_abs_diff": float(np.abs(res_this - res_parent).max()),
           "residual_scale": float(np.abs(res_parent).max())}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
