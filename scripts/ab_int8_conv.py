"""Time the int8 layers of two checkouts of the port on one card, in turns,
on the same real activations, and hold their outputs equal.

    python3 scripts/ab_int8_conv.py --parent DIR [--out FILE]

DIR holds another checkout of the repository's ``debvader_tpu_torch/``
(for example the parent commit's, unpacked with ``git archive`` into a
directory that .gitignore lists; its weights are not needed).  First this
tree runs one int8 forward of 128 seeded simulated stamps through the
packaged ``sim_demo_int8`` bundle and keeps, for each of its 18 int8
layers, the layer's int8 input, its int8 kernel and scales and the
epilogue the forward gives it (the PReLU alphas, the next layer's scale).
Then one worker process a turn, in the order parent, this tree, this tree,
parent, imports ``debvader_tpu_torch`` from its own tree, builds that
tree's ``csrc/int8_conv.cu`` and computes each layer's unit of work:

- a tree with ``conv_fused`` (the fused layer): one launch;
- a tree without it: ``conv_s8``'s float32 output, the eager PReLU, the
  flatten, the eager flat PReLU and ``quant_act``, as the forward chained
  them.

Per layer it prints the device time (torch.profiler, every kernel of the
unit, mean of 30) and the per-call time (CUDA events, median of 30).

Each turn then serves chip_smoke.py's seeded 1024^2 field through its
tree's int8 route, ``DeblendField(quantized=...).deblend_and_render`` in
128-source chunks at the sources this tree detected (both trees read this
tree's weights): the CUDA kernels one warm call launches, its wall and
device-busy time and the device's idle share (torch.profiler), and the
catalogue, residual and model field.  The two trees' outputs must be
equal, the layers' and the call's: int8 products are exact in any order,
and both trees round the same ops.  Needs a card; the last line is one
JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STAMPS = 128
SEED = 7


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(path: Path) -> None:
    """This tree's int8 forward of the seeded stamps, each int8 layer's
    work saved to ``path``."""
    sys.path.insert(0, str(ROOT))
    import torch

    import debvader_tpu_torch as dt
    from debvader_tpu_torch.data.simulate import simulate_batch
    from debvader_tpu_torch.models import quantized as tq

    qv = tq.load_quantized("sim_demo_int8", device="cuda")
    convs = _smoke().int8_calls(torch, qv, simulate_batch(SEED, STAMPS)[0])[0]
    layers = []
    for name, q, layer, (alpha, flat_alpha, next_scale) in convs:
        qk, wscale = qv.qweights[name]
        layers.append({
            "name": name, "kind": layer.kind, "stride": layer.stride, "qk": qk, "wscale": wscale,
            "s_in": qv.act_scales[name], "bias": layer.bias, "q": q, "alpha": alpha, "flat_alpha": flat_alpha,
            "next_scale": next_scale,
        })
    smoke = _smoke()
    field = smoke.make_field()
    centers = dt.detect_objects(field, dt.DetectionConfig(**smoke.DETECTION), device="cuda")
    torch.save({"layers": [{k: (v.detach().cpu() if isinstance(v, torch.Tensor) else v) for k, v in r.items()}
                           for r in layers], "field": field, "centers": centers}, path)


def worker(tree: Path, inputs: Path, out: Path) -> dict:
    """One turn: this tree's int8 layers on the saved work."""
    sys.path.insert(0, str(tree))
    import torch

    smoke = _smoke()
    from debvader_tpu_torch.kernels import _build
    from debvader_tpu_torch.kernels import int8_conv as ic

    if not Path(ic.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {ic.__file__}, not from {tree}")
    logs = _build.build_all(["int8_conv"])
    dev = torch.device("cuda")
    fused = hasattr(ic, "conv_fused")

    def eager_prelu(y, alpha):
        zero = y.new_zeros(())
        return torch.maximum(y, zero) + alpha * torch.minimum(y, zero)

    saved = torch.load(inputs, weights_only=False)
    result, outputs = {}, {}
    for r in saved["layers"]:
        r = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in r.items()}
        layer = ic.make_layer(r["kind"], r["qk"], r["wscale"], r["s_in"], r["bias"], r["stride"])
        q, alpha, flat_alpha, next_scale = r["q"], r["alpha"], r["flat_alpha"], r["next_scale"]

        if fused:
            def unit():
                return ic.conv_fused(q, layer, alpha, flat_alpha, next_scale)
        else:
            def unit():
                y = ic.conv_s8(q, layer)
                if alpha is not None:
                    y = eager_prelu(y, alpha)
                if next_scale is None:
                    return y
                nhwc = y.permute(0, 2, 3, 1) if y.ndim == 4 else y
                flat = nhwc.reshape(y.shape[0], -1)
                if flat_alpha is not None:
                    flat = eager_prelu(flat, flat_alpha)
                length = 1 if next_scale.ndim == 0 else next_scale.shape[0]
                return ic.quant_act(flat.reshape(-1, length), next_scale).reshape(nhwc.shape)

        y = unit()
        torch.cuda.synchronize()
        outputs[r["name"]] = y.cpu()
        result[r["name"]] = {"device_ms": smoke.profiled_all_ms(torch, unit), "ms": smoke.cuda_ms(torch, unit)}
    result["call"], outputs["call"] = int8_call(torch, smoke, saved["field"], saved["centers"])
    torch.save(outputs, out)
    result["ptxas"] = [line.strip() for log in logs.values() for line in log.splitlines()
                       if "registers" in line or "spill" in line]
    result["fused"] = fused
    return result


def int8_call(torch, smoke, field, centers) -> tuple[dict, dict]:
    """This tree's int8 deblend_and_render of the field, warm: one call
    profiled (kernels, wall, busy, idle share), four timed; and its
    outputs."""
    import numpy as np

    import debvader_tpu_torch as dt
    from debvader_tpu_torch.models import quantized as tq

    weights = ROOT / "debvader_tpu_torch" / "data" / "weights"
    net = dt.load_deblender("sim_demo", device="cuda", weights_dir=weights)
    qv = tq.load_quantized(weights / "sim_demo_int8", device="cuda")
    qdf = dt.DeblendField(net, field, z_mode="mean", quantized=qv, cfg=smoke.serving_cfg(smoke.QUANT_CHUNK),
                          device="cuda")
    catalog, residual, model = qdf.deblend_and_render(centers, return_model=True)
    prof = smoke.profile_run(torch, lambda: qdf.deblend_and_render(centers))
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        qdf.deblend_and_render(centers)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    outs = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in (("list_idx", catalog["list_idx"]), ("residual", residual), ("model", model))}
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_kernels", "device_idle_share")} | {
        "warm_s": walls, "sources": int(len(centers))}, outs


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
    # the activations and outputs (about 0.3 GB), removed at the end
    work = ROOT / "chiprun_out" / "ab_int8_conv"
    work.mkdir(parents=True, exist_ok=True)
    try:
        return compare_turns(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def compare_turns(args, work: Path) -> int:
    inputs = work / "inputs.pt"
    script = str(Path(__file__).resolve())
    subprocess.run([sys.executable, script, "--inputs", str(inputs)], check=True, timeout=600)
    turns, outputs = [], {}
    for i, (label, tree) in enumerate((("parent", args.parent), ("change", ROOT), ("change", ROOT),
                                       ("parent", args.parent))):
        out = work / f"turn{i}_{label}.pt"
        proc = subprocess.run([sys.executable, script, "--worker", str(tree), str(inputs), str(out)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"the {label} turn failed:\n{proc.stderr[-4000:]}")
        turns.append({"tree": label, **json.loads(proc.stdout.strip().splitlines()[-1])})
        outputs.setdefault(label, []).append(out)
        print(label, json.dumps({k: v for k, v in turns[-1].items() if k != "ptxas"}), flush=True)

    import torch

    def same(y, z):
        return y.dtype == z.dtype and y.shape == z.shape and (
            torch.equal(y, z) if y.dtype != torch.float32 else torch.equal(y.view(torch.int32), z.view(torch.int32)))

    ref = torch.load(outputs["change"][0])
    equal = {}
    for path in outputs["parent"] + outputs["change"][1:]:
        other = torch.load(path)
        for name, y in ref.items():
            if name == "call":
                for key, v in y.items():
                    equal[f"call_{key}"] = equal.get(f"call_{key}", True) and same(v, other[name][key])
            else:
                equal[name] = equal.get(name, True) and same(y, other[name])
    groups = {}
    for name in (n for n in ref if n != "call"):
        g = "enc_conv" if name.startswith("enc/Conv") else "dense" if "Dense" in name else "dec_convT"
        for turn in turns:
            for key in ("device_ms", "ms"):
                slot = groups.setdefault(g, {}).setdefault(f"{turn['tree']}_{key}", [0.0, 0.0])
                slot[turns.index(turn) in (2, 3)] += turn[name][key]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    calls = [{"tree": t["tree"], **t["call"]} for t in turns]
    summary = {"card": card, "stamps": STAMPS, "outputs_equal": all(equal.values()), "equal_by_layer": equal,
               "groups_in_turn_order": groups, "int8_call_in_turn_order": calls, "turns": turns}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps(summary))
    return 0 if summary["outputs_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
