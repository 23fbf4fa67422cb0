"""Time the two stand-alone tail kernels of two checkouts of the port on one
card, in turns.

    python3 scripts/ab_tails.py --parent DIR [--out FILE]

DIR holds another checkout of the repository (for example the parent
commit's ``debvader_tpu_torch/``, unpacked with ``git archive`` into a
directory that .gitignore lists).  The script runs one worker process per
turn, in the order parent, this tree, this tree, parent; each worker
imports ``debvader_tpu_torch`` from its own tree, builds that tree's tail
kernels and times ``fused_decoder_tail`` (float32 x, and bfloat16 x where
the tree takes it) and ``fused_tail_pair`` at the main path's tail shape,
(295, 64, 64, 32) -> 12, on the same seeded inputs (x normal, weights at
the decoder's scale; the kernels have no data-dependent work, so the time
does not depend on the values).  Per kernel it prints the device time
(torch.profiler, mean of 30 launches) and the per-call time (CUDA events
around the wrapper, median of 30), and holds each tree's output to its own
plain version: 5e-5 of the output scale for the float32 tail, 5e-6 for the
pair, one bf16 ulp of the scale on at most chip_smoke.BF16_SHARE_LIMIT of the
elements for the bfloat16 tail.  The two trees' kernels
sum in other orders, so their outputs are not compared bit for bit.  Needs a
card; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (295, 64, 64, 32, 12)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(torch, dev):
    n, s, _, c, o = SHAPE
    rng = np.random.default_rng(11)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    x = t(rng.normal(size=(n, s, s, c)))
    k2 = t(rng.normal(size=(3, 3, c, c)) * 0.06)
    b2 = t(rng.normal(size=(c,)) * 0.05)
    a2 = t(rng.uniform(0.0, 0.3, size=(s, s, c)))
    k3 = t(rng.normal(size=(3, 3, c, o)) * 0.06)
    b3 = t(rng.normal(size=(o,)) * 0.05)
    return x, k2, b2, a2, k3, b3


def worker(tree: Path) -> dict:
    """One turn: this tree's tail kernels on the shared inputs."""
    sys.path.insert(0, str(tree))
    import torch

    smoke = _smoke()
    from debvader_tpu_torch.kernels import _build
    from debvader_tpu_torch.kernels import decoder_tail as dtl
    from debvader_tpu_torch.kernels import tail_fused as tf

    if not Path(dtl.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {dtl.__file__}, not from {tree}")
    logs = _build.build_all(["decoder_tail", "tail_fused"])
    dev = torch.device("cuda")
    x, k2, b2, a2, k3, b3 = _inputs(torch, dev)
    # the pair's conv1 is the transposed conv written as a conv
    w1 = k2.flip(0, 1).permute(0, 1, 3, 2).contiguous()
    cases = {
        "decoder_tail": (dtl.fused_decoder_tail, dtl.decoder_tail_plain, (x, k2, b2, a2, k3, b3), "decoder_tail_kernel", 5e-5),
        "tail_fused": (tf.fused_tail_pair, tf.tail_pair_plain, (x, w1, b2, a2, k3, b3), "tail_", 5e-6),
    }
    xb = x.to(torch.bfloat16)
    # a tree whose tail computes in float32 whatever x's dtype has no
    # bfloat16 kernel to time
    if dtl.fused_decoder_tail(xb[:1], k2, b2, a2, k3, b3).dtype == torch.bfloat16:
        cases["decoder_tail_bf16"] = (dtl.fused_decoder_tail, dtl.decoder_tail_plain, (xb, k2, b2, a2, k3, b3),
                                      "tail_pair_kernel", None)
    result = {}
    for name, (fn, plain, args, kernel, tol) in cases.items():
        got, want = fn(*args), plain(*args)
        err, share, fault = smoke.tail_agreement(got, want, tol)
        if fault is not None:
            raise AssertionError(f"{name} against its plain version: {fault}")
        result[name] = {
            "device_ms": smoke.profiled_device_ms(torch, lambda: fn(*args), kernel),
            "ms": smoke.cuda_ms(torch, lambda: fn(*args)),
            "max_abs_err": err, "output_max_abs": float(want.float().abs().max()), "differing_share": share,
        }
    result["ptxas"] = {
        name: [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line or "smem" in line]
        for name, log in logs.items()
    }
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="the other checkout, timed in turns with this one")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help="also write the summary to this JSON file")
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker)))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    turns = []
    for label, tree in (("parent", args.parent), ("change", ROOT), ("change", ROOT), ("parent", args.parent)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(tree)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"the {label} turn failed:\n{proc.stderr[-4000:]}")
        turns.append({"tree": label, **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(label, json.dumps({k: v for k, v in turns[-1].items() if k != "ptxas"}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    summary = {"card": card, "shape": SHAPE, "turns": turns}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
