"""Time the fused detect core and the label resolution of two checkouts of
the port on one card, in turns.

    python3 scripts/ab_detect_label.py --parent DIR [--out FILE]

DIR holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  The script runs one worker process per turn, in the order
parent, this tree, this tree, parent; each worker imports
``debvader_tpu_torch`` from its own tree, builds that tree's kernels, and
times ``matched_filter_parents`` and ``label_fixpoint`` on the same seeded
inputs (chip_smoke.make_field's r band): at the main path's shape
(1, 1024, 1024), 5-sigma matched threshold, and on a (16, 1024, 1024)
stack of that field rolled and re-noised.  Per kernel and shape it prints
the device time (torch.profiler, mean of 30 launches), the per-call time
(CUDA events around the wrapper, median of 30) and, for the main shape,
the host time of the wrapper's pieces.  Outputs of the two trees are held
equal bit for bit (their SHA-256).  Needs a card; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: Path) -> dict:
    """One turn: this tree's kernels on the shared inputs."""
    sys.path.insert(0, str(tree))
    import torch

    smoke = _smoke()
    from debvader_tpu_torch.kernels import _build
    from debvader_tpu_torch.kernels import detect_fused as df
    from debvader_tpu_torch.kernels import label_select as ls
    from debvader_tpu_torch.ops.detection import default_filter_kernel, estimate_background

    if not Path(df.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {df.__file__}, not from {tree}")
    _build.build_all(["detect_fused", "label_select"])
    dev = torch.device("cuda")
    img = torch.as_tensor(smoke.make_field()[0, :, :, 2], device=dev)
    f = img.shape[0]
    back, _, _, grms = estimate_background(img, box=64)
    kernel = default_filter_kernel()
    thr1 = (5.0 * grms * float(np.sqrt(np.sum(np.square(kernel))))).reshape(1)
    gen = torch.Generator(device=dev).manual_seed(9)
    stack = torch.stack([
        torch.roll(img, (97 * i, 53 * i), (0, 1)) + 0.02 * torch.randn((f, f), generator=gen, device=dev)
        for i in range(16)
    ])
    shapes = {
        "main_1x1024": (img[None].contiguous(), back[None].contiguous(), thr1),
        "stack_16x1024": (stack, back.expand(16, f, f).contiguous(), grms * torch.linspace(1.5, 7.5, 16, device=dev)),
    }
    result, outputs, lab_args = {}, {}, {}
    for name, (images, backs, thr) in shapes.items():
        t = images.shape[0]
        filt, dirc, parent = df.matched_filter_parents(images, backs, kernel, thr)
        cur0, dir2 = parent.reshape(t * f, f), dirc.reshape(t * f, f)
        labels = ls.label_fixpoint(cur0, dir2)
        lab_args[name] = (cur0, dir2)
        torch.cuda.synchronize()
        outputs[name] = [hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest() for a in (filt, dirc, parent, labels)]
        result[name] = {
            "detect_fused": {
                "device_ms": smoke.profiled_device_ms(
                    torch, lambda: df.matched_filter_parents(images, backs, kernel, thr), "detect_fused_kernel"),
                "ms": smoke.cuda_ms(torch, lambda: df.matched_filter_parents(images, backs, kernel, thr)),
            },
            "label_select": {
                "device_ms": smoke.profiled_device_ms(
                    torch, lambda: ls.label_fixpoint(cur0, dir2), "label_resolve_kernel"),
                "ms": smoke.cuda_ms(torch, lambda: ls.label_fixpoint(cur0, dir2)),
            },
        }
    # host microseconds of the wrapper's pieces at the main shape, each the
    # median of 2,000 calls on the host clock (nothing synchronises)
    images, backs, thr = shapes["main_1x1024"]

    def host_us(fn, n=2000):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return float(np.median(times) * 1e6)

    pieces = {
        "launcher": lambda: _build.launcher("label_select", "dvt_label_resolve", 3, 2),
        "torch_empty_x3": lambda: (torch.empty_like(images), torch.empty_like(images), torch.empty_like(images)),
        "cuda_device_context_and_stream": lambda: _stream_in_context(torch, images.device),
        "matched_filter_parents": lambda: df.matched_filter_parents(images, backs, kernel, thr),
        "label_fixpoint": lambda: ls.label_fixpoint(*lab_args["main_1x1024"]),
    }
    if hasattr(df, "host_taps"):
        pieces["host_taps"] = lambda: df.host_taps(kernel)
    else:
        pieces["taps_on"] = lambda: df.taps_on(kernel, images.device)
    if hasattr(_build, "call"):
        pieces["raw_stream"] = lambda: _build._raw_stream(images.device.index or 0)
    result["host_us"] = {k: host_us(fn) for k, fn in pieces.items()}
    result["sha256"] = outputs
    return result


def _stream_in_context(torch, device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="the other checkout, timed in turns with this one")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/ab_detect_label.json"))
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker)))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    turns = []
    for label, tree in (("parent", args.parent), ("change", ROOT), ("change", ROOT), ("parent", args.parent)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(tree)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"the {label} turn failed:\n{proc.stderr[-4000:]}")
        turns.append({"tree": label, **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(label, json.dumps(turns[-1]), flush=True)
    for i, turn in enumerate(turns[1:], 1):
        if turn["sha256"] != turns[0]["sha256"]:
            raise AssertionError(f"turn {i} ({turn['tree']}) outputs differ from the first turn's")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    summary = {"card": card, "outputs_bit_identical": True, "turns": turns}
    args.out.write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
