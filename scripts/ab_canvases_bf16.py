"""Time the bfloat16 render and place of two checkouts of the port on one
card, in turns, on the same inputs, and hold their canvases bit for bit.

    python3 scripts/ab_canvases_bf16.py --parent DIR [--split] [--iterative] [--out FILE]

DIR holds another checkout of the repository's ``debvader_tpu_torch/``
(for example the parent commit's, unpacked with ``git archive`` into a
directory that .gitignore lists; its weights are not needed: both trees
read this tree's).  First this tree detects the sources of chip_smoke.py's
seeded 1024^2 field.  Then one worker process a turn, in the order parent,
this tree, this tree, parent, imports ``debvader_tpu_torch`` from its own
tree, builds that tree's ``csrc/render.cu`` and times, on inputs made from
seeds:

- ``render_bf16``: a 128-source chunk of bf16 stamps (59 px) into the
  1024^2 window of a filled bf16 canvas (chip_smoke.py phase 12's shape),
  and into the 4096^2 window of a 4218^2 canvas (the tiled route's);
- ``place_bf16``: that chunk's order-3 patches (79 px) into a filled
  1182^2 bf16 canvas;
- ``render`` and ``place``, the float32 kernels, at the 1024^2 shapes;

each the device time of every kernel one call launches (torch.profiler,
mean of 30) and the per-call time (CUDA events, median of 30).  Then it
serves the field under ``device_dtype='bfloat16'`` at orders 1 and 3
(``deblend_and_render``, 128-source chunks) and profiles one warm call:
wall, device-busy time, idle share and the share of busy time in the
bfloat16 render and place kernels.  Every turn's canvases and served
fields must be bit for bit the first turn's.  The float32 tile kernels'
SASS (``cuobjdump -sass`` of each tree's built library) is compared too.

``--split`` also times variants of each tree's bf16 kernels, built from
its ``csrc/render.cu`` with a few lines edited (the edits must apply): for
a tree with the tile kernels (the parent), exiting at once (``exit``),
after listing the sources (``scan``) and without the adds (``stage``); for
a tree with the scan kernels, without touching any source (``scan``) and
without the interpolation (``loads``, the stamp's pairs added raw).

``--iterative`` then profiles, on this tree only, one step of
``IterativeDeblendField.iterative_deblend_and_render`` on chip_smoke.py's
4096^2 field (phase 16's) in float32 and under
``device_dtype='bfloat16'``, each on a fresh object after a first run, and
times three-step runs of each.  Needs a card; the last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHUNK, STAMP, BANDS = 128, 59, 6
# the edits of --split: {variant: [(old, new), ...]} for each design
SPLIT_TILE = {
    "exit": [("using Sh = TileShape<B, T>;\n  extern __shared__",
              "using Sh = TileShape<B, T>;\n  if (n >= 0) return;\n  extern __shared__"),
             ("using Sh = PlaceShape<B, T>;\n  extern __shared__",
              "using Sh = PlaceShape<B, T>;\n  if (n >= 0) return;\n  extern __shared__")],
    "scan": [("if (total == 0) continue;", "if (total >= 0) continue;")],
    "stage": [("if (col_in && ty0 + r >= py0 && ty0 + r < py0 + s + 2) acc[r] = add_into<T>(acc[r], v);", "(void)v;"),
              ("if (a0 + r >= 0 && a0 + r < p) acc[r] = add_into<T>(acc[r], widen(wb[r * Sh::kWinRow]));", "")],
}
SPLIT_SCAN = {
    "scan": [("    if (x >= f || x < q.x0 || x >= q.x0 + s + 2) return;", "    return;"),
             ("    if (x >= c || b < 0 || b >= p) return;", "    return;"),
             ("    for (int r = 0; r < R; ++r) acc[r] = x < f && ty0 + r < f ? o[r * (pitch / 2)] : zero2();", ""),
             ("    for (int r = 0; r < R; ++r) acc[r] = x < c && ty0 + r < c ? o[static_cast<long long>(r) * c * "
              "Sh::kPairs] : zero2();", "")],
    "loads": [("      const float lo = bilinear(q.fy, gy, q.fx, gx, u0.x, d0.x, u1.x, d1.x);\n"
               "      const float hi = bilinear(q.fy, gy, q.fx, gx, u0.y, d0.y, u1.y, d1.y);\n"
               "      acc[r] = __hadd2(acc[r], __float22bfloat162_rn(make_float2(lo, hi)));",
               "      acc[r] = __hadd2(acc[r], __hadd2(v0[r], v1[r + 1]));")],
}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(path: Path) -> None:
    """chip_smoke.py's field and this tree's detections, saved to ``path``."""
    sys.path.insert(0, str(ROOT))
    import torch

    import debvader_tpu_torch as dt

    smoke = _smoke()
    field = smoke.make_field()
    centers = dt.detect_objects(field, dt.DetectionConfig(**smoke.DETECTION), device="cuda")
    torch.save({"field": field, "centers": centers}, path)


def digest(torch, t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()


def units(torch, smoke, rd):
    """name -> (the canvas a unit starts from, the unit: one call on a
    copy of it): the kernels at the phase 12 shapes, from seeds."""
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(14)
    n, s, b, f = CHUNK, STAMP, BANDS, 1024
    stamps = torch.rand((n, s, s, b), generator=gen, device=dev).to(bf)
    offsets = (torch.rand((n, 2), generator=gen, device=dev) - 0.5) * (f - 80)
    pad = s + 2
    canvas = torch.randn((f + 2 * pad, f + 2 * pad, b), generator=gen, device=dev).to(bf)
    fs = 4096
    stamps4 = torch.rand((n, s, s, b), generator=gen, device=dev).to(bf)
    offsets4 = (torch.rand((n, 2), generator=gen, device=dev) - 0.5) * (fs + 40)
    canvas4 = torch.randn((fs + 2 * pad, fs + 2 * pad, b), generator=gen, device=dev).to(bf)
    patches, y, x, visible, c = smoke.place_inputs(torch, stamps.float(), offsets, f)
    patches = patches.contiguous()
    patches16 = patches.to(bf)
    pcanvas = torch.randn((c, c, b), generator=gen, device=dev)
    stamps32 = stamps.float()

    def window(t, size):
        return t[pad : pad + size, pad : pad + size]

    return {
        "render_bf16": (canvas, lambda w: rd.render_field_kernel(stamps, offsets, f, out=window(w, f))),
        "render_bf16_4096": (canvas4, lambda w: rd.render_field_kernel(stamps4, offsets4, fs, out=window(w, fs))),
        "place_bf16": (pcanvas.to(bf), lambda w: rd.place_patches(w, patches16, y, x, visible)),
        "render": (canvas.float(), lambda w: rd.render_field_kernel(stamps32, offsets, f, out=window(w, f))),
        "place": (pcanvas, lambda w: rd.place_patches(w, patches, y, x, visible)),
    }


def time_units(torch, smoke, rd, names=None) -> tuple[dict, dict]:
    """{name: {device_ms, ms}} and {name: digest of the canvas after one
    call on a fresh copy}."""
    times, digests = {}, {}
    for name, (canvas, unit) in units(torch, smoke, rd).items():
        if names is not None and name not in names:
            continue
        once = canvas.clone()
        unit(once)
        torch.cuda.synchronize()
        digests[name] = digest(torch, once)
        work = canvas.clone()
        times[name] = {"device_ms": smoke.profiled_all_ms(torch, lambda: unit(work)),
                       "ms": smoke.cuda_ms(torch, lambda: unit(work))}
        del once, work
    return times, digests


def split_times(torch, smoke, rd, _build, tree: Path) -> dict:
    """The bf16 units of variants of this tree's csrc/render.cu."""
    source = (tree / "debvader_tpu_torch" / "csrc" / "render.cu").read_text()
    edits = SPLIT_SCAN if "render_scan_kernel" in source else SPLIT_TILE
    tmp = Path(tempfile.mkdtemp())
    procs = {}
    for name, pairs in edits.items():
        text = source
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"--split variant {name}: the edit does not apply: {old[:60]!r}")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build._flags("render"), "-o", str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    whole = _build._loaded["render"]
    try:
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"--split variant {name} does not build:\n{log}")
            _build._loaded["render"] = ctypes.CDLL(str(tmp / f"{name}.so"))
            _build._launchers.clear()
            out[name] = time_units(torch, smoke, rd, ("render_bf16", "render_bf16_4096", "place_bf16"))[0]
    finally:
        _build._loaded["render"] = whole
        _build._launchers.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def kernel_kind(name: str) -> str | None:
    """Which bf16 kernel a profiler event is: the tile kernels' bf16
    instances or the scan kernels."""
    if "render_scan_kernel" in name or ("render_tile_kernel" in name and "bfloat16" in name):
        return "render_bf16"
    if "place_scan_kernel" in name or ("place_tile_kernel" in name and "bfloat16" in name):
        return "place_bf16"
    return None


def profiled_call(torch, fn) -> dict:
    """One warm call of ``fn`` under torch.profiler: wall, device-busy time,
    idle share, kernels, the bf16 render and place kernels' device time,
    and the ten largest device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = []
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))
        if str(e.device_type).endswith("CUDA") and us > 0:
            events.append({"name": e.key, "device_ms": us / 1e3, "calls": int(e.count)})
    events.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in events)
    kinds = {}
    for r in events:
        kind = kernel_kind(r["name"])
        if kind is not None:
            kinds[kind] = kinds.get(kind, 0.0) + r["device_ms"]
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
            "device_kernels": sum(r["calls"] for r in events if not r["name"].startswith(("Memcpy", "Memset"))),
            "bf16_kernels_ms": kinds, "bf16_kernels_share_of_busy": sum(kinds.values()) / busy,
            "top_events": [{**r, "name": r["name"][:90]} for r in events[:10]]}


def route_calls(torch, smoke, inputs: Path) -> tuple[dict, dict]:
    """The field served under device_dtype='bfloat16' at orders 1 and 3:
    one profiled warm call each, and the digests of the outputs."""
    import numpy as np

    import debvader_tpu_torch as dt

    saved = torch.load(inputs, weights_only=False)
    field, centers = saved["field"], saved["centers"]
    net = dt.load_deblender("sim_demo", device="cuda", weights_dir=ROOT / "debvader_tpu_torch" / "data" / "weights")
    out, digests = {}, {}
    for order in (1, 3):
        cfg = dt.PipelineConfig(interp_order=order, source_chunk=CHUNK)
        df = dt.DeblendField(net, field, z_mode="mean", cfg=cfg, device="cuda", device_dtype="bfloat16")
        _, residual, model = df.deblend_and_render(centers, return_model=True)
        digests[f"order{order}"] = digest(torch, torch.from_numpy(np.ascontiguousarray(
            np.concatenate([residual.ravel(), model.ravel()]))))
        out[f"order{order}"] = profiled_call(torch, lambda: df.deblend_and_render(centers))
    return out, digests


def worker(tree: Path, inputs: Path, out: Path, split: bool) -> dict:
    """One turn: this tree's kernels, their split, the served field."""
    sys.path.insert(0, str(tree))
    import torch

    smoke = _smoke()
    from debvader_tpu_torch.kernels import _build
    from debvader_tpu_torch.kernels import render as rd

    if not Path(rd.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {rd.__file__}, not from {tree}")
    logs = _build.build_all(["render"])
    times, digests = time_units(torch, smoke, rd)
    result = {"kernels": times,
              "ptxas": [line.strip() for log in logs.values() for line in log.splitlines()
                        if "registers" in line or "spill" in line]}
    if split:
        result["split"] = split_times(torch, smoke, rd, _build, tree)
    result["route"], route_digests = route_calls(torch, smoke, inputs)
    out.write_text(json.dumps({**digests, **route_digests}))
    return result


def iterative_profile() -> dict:
    """One step of iterative serving on the 4096^2 field, float32 against
    bfloat16 residency (this tree), profiled; and three-step walls.  The
    host functions that upload the field (the bfloat16 cast and the memo's
    checksum) are wrapped to record the seconds of each call."""
    sys.path.insert(0, str(ROOT))
    import torch

    import debvader_tpu_torch as dt
    from debvader_tpu_torch.pipeline import field as tfield

    smoke = _smoke()
    big = smoke.make_field(**smoke.BIG_FIELD)
    net = dt.load_deblender("sim_demo", device="cuda")
    det = dt.DetectionConfig(**smoke.DETECTION)
    host = {"bf16_cast_s": [], "checksum_s": []}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            result = fn(*args, **kwargs)
            host[key].append(time.perf_counter() - t)
            return result
        return wrapper

    tfield._bfloat16_host = timed(tfield._bfloat16_host, "bf16_cast_s")
    tfield.DeblendField._field_checksum = staticmethod(timed(tfield.DeblendField._field_checksum, "checksum_s"))
    out = {}
    for label, kw in (("float32", {}), ("bfloat16", {"device_dtype": "bfloat16"})):
        def step(max_iterations=1):
            idf = dt.IterativeDeblendField(net, big, z_mode="mean", cfg=smoke.tiled_cfg(), device="cuda", **kw)
            idf.iterative_deblend_and_render(det_cfg=det, max_iterations=max_iterations)

        for v in host.values():
            v.clear()
        rec = profiled_call(torch, step)
        # each call's seconds over profiled_call's two steps (warm, profiled)
        rec["host_calls_in_two_steps"] = {k: list(v) for k, v in host.items()}
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(3)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        out[label] = {**rec, "three_step_wall_s": walls}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="the other checkout, timed in turns with this one")
    ap.add_argument("--split", action="store_true", help="also time the kernels' variants (module docstring)")
    ap.add_argument("--iterative", action="store_true", help="also profile a step of iterative serving at 4096^2")
    ap.add_argument("--worker", type=Path, nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--iterative-only", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help="also write the summary to this JSON file")
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(*args.worker, args.split)))
        return 0
    if args.inputs is not None:
        make_inputs(args.inputs)
        return 0
    if args.iterative_only:
        print(json.dumps(iterative_profile()))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    work = ROOT / "chiprun_out" / "ab_canvases_bf16"
    work.mkdir(parents=True, exist_ok=True)
    try:
        return compare_turns(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def float32_sass(tree: Path) -> dict:
    """{kernel: its SASS instructions} for the float32 tile kernels of the
    tree's built csrc/render.cu (cuobjdump; addresses and encodings
    dropped), to tell a change of their code from a change of their
    source text."""
    import re

    sys.path.insert(0, str(tree))
    lib = sorted((tree / "debvader_tpu_torch" / "_build").glob("librender-*.so"), key=lambda q: q.stat().st_mtime)[-1]
    cuobjdump = str(Path(_nvcc_dir()) / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        # the float32 instance: <6, float> in a two-parameter template, <6> in a one-parameter one
        for kernel in ("render_tile_kernel", "place_tile_kernel"):
            if kernel in name and ("ILi6EfE" in name or "ILi6EEEvPKf" in name):
                out[kernel] = [re.sub(r"/\*[^*]*\*/", "", line).strip() for line in part.splitlines()[1:]
                               if re.search(r"/\*[0-9a-f]{4,}\*/", line)]
    return out


def _nvcc_dir() -> str:
    sys.path.insert(0, str(ROOT))
    from debvader_tpu_torch.kernels import _build

    return str(Path(_build.nvcc_path()).parent)


def run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[1:3])} failed:\n{proc.stderr[-4000:]}")
    return proc.stdout.strip().splitlines()[-1]


def compare_turns(args, work: Path) -> int:
    inputs = work / "inputs.pt"
    script = str(Path(__file__).resolve())
    subprocess.run([sys.executable, script, "--inputs", str(inputs)], check=True, timeout=600)
    turns, digests = [], []
    for i, (label, tree) in enumerate((("parent", args.parent), ("change", ROOT), ("change", ROOT),
                                       ("parent", args.parent))):
        out = work / f"turn{i}_{label}.json"
        cmd = [sys.executable, script, "--worker", str(tree), str(inputs), str(out)] + (["--split"] * args.split)
        turns.append({"tree": label, **json.loads(run(cmd))})
        digests.append(json.loads(out.read_text()))
        print(label, json.dumps({k: v for k, v in turns[-1].items() if k != "ptxas"}), flush=True)
    equal = {k: all(d[k] == digests[0][k] for d in digests) for k in digests[0]}
    parent_sass, change_sass = float32_sass(args.parent), float32_sass(ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    summary = {
        "card": card, "outputs_bit_for_bit": all(equal.values()), "equal": equal,
        "float32_kernels_same_sass": {k: bool(v) and v == change_sass.get(k) for k, v in parent_sass.items()},
        "float32_kernels_sass_lines": {k: len(v) for k, v in change_sass.items()},
        "device_ms_in_turn_order": {k: [t["kernels"][k]["device_ms"] for t in turns] for k in turns[0]["kernels"]},
        "ms_in_turn_order": {k: [t["kernels"][k]["ms"] for t in turns] for k in turns[0]["kernels"]},
        "route_in_turn_order": {o: [{"tree": t["tree"], **{k: t["route"][o][k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share", "device_kernels", "bf16_kernels_ms",
            "bf16_kernels_share_of_busy")}} for t in turns] for o in turns[0]["route"]},
        "turns": turns,
    }
    if args.split:
        summary["split_in_turn_order"] = [{"tree": t["tree"], **t["split"]} for t in turns]
    if args.iterative:
        summary["iterative_4096"] = json.loads(run([sys.executable, script, "--iterative-only"]))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps(summary))
    if not summary["outputs_bit_for_bit"]:
        print(f"the trees' canvases or served fields differ: {equal}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
