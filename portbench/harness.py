"""One run of one cell: set-up, the measured window, the optional trace,
the comparison with the plain reference, and the result line.

Everything that belongs to a cell is found by name: ``BENCHMARK.json``'s
workload names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``, whose ``driver`` names the loop in
``drivers/<driver>.py``); its limits are ``limits/<workload>.json``; each
per-layer metric is read by ``metrics/<metric>.py``.  A new cell,
configuration, mix or metric is a new file and new entries.

A driver module defines ``Cell(config, mix, seed, device, program=None)``
with ``setup()``, ``step(i)`` (one unit of the window's work, launched
without waiting), ``units_per_step``, ``rate_metric``, ``failed_units()``,
optionally ``window_stats()`` (the driver's own spans over the window)
and ``trace_stats(steps)`` (what the traced steps produced, for readers),
``release()`` (frees the program's state), ``check()`` ({number:
value} from the comparison with the reference) and optionally ``notes()``
({name: value} read beside the comparison, held to no limit).  ``program`` replaces the program's call
for the control and the fault tests.

A metric module defines ``read(ctx) -> float | None``; ``ctx`` carries the
window's ``stats``, the ``trace`` summary (or None), the cell's
``config`` and ``mix``.  A reader that finds nothing returns None and the
metric is left out of the line.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

__all__ = ["ROOT", "REPO", "FORBIDDEN", "load_manifest", "load_cell", "run_cell", "forbidden_modules", "emit", "main"]

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "debvader_tpu")


def load_manifest(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(kind: str, name: str) -> dict:
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str) -> types.ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (metric names hold dots,
    so they are loaded by path, not imported)."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(manifest: dict, workload: str) -> dict:
    """The cell's manifest entry with its configuration, mix and limits."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = dict(cells[workload])
    cell["config_data"] = _load_json("configs", cell["config"])
    cell["mix_data"] = _load_json("traffic", cell["traffic"])
    cell["limits"] = _load_json("limits", workload)
    return cell


def _applies(metric: dict, cell_name: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def end_to_end_names(manifest: dict, cell_name: str) -> list[str]:
    return [m["name"] for m in manifest["end_to_end"] if _applies(m, cell_name, set())]


def per_layer_names(manifest: dict, cell_name: str) -> list[str]:
    reported = set(end_to_end_names(manifest, cell_name))
    return [m["name"] for m in manifest["per_layer"] if _applies(m, cell_name, reported)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class _Marker:
    """Completion of the work launched so far: a CUDA event on a card;
    nothing to wait for on the CPU, whose ops finish before they return."""

    def __init__(self, device):
        import torch

        self._event = None
        if torch.device(device).type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_window(cell, seconds: float, device) -> dict:
    """Steps back to back until a completion lands at or past ``seconds``.
    A driver whose steps return before the device is done keeps
    ``cell.in_flight`` (default 1) steps launched behind the one being
    waited for; one whose steps return their results sets it to 0.  The
    window runs from its first launch to the last completion it saw; steps
    still in flight then are drained and not counted."""
    depth = getattr(cell, "in_flight", 1)
    pending = collections.deque()
    _sync(device)
    t0 = time.perf_counter()
    t_last, done, i = t0, 0, 0
    while True:
        cell.step(i)
        pending.append(_Marker(device))
        if len(pending) > depth:
            pending.popleft().wait()
            t_last = time.perf_counter()
            done = i + 1 - depth
            if t_last - t0 >= seconds:
                break
        i += 1
    for marker in pending:
        marker.wait()
    window = t_last - t0
    units = done * cell.units_per_step
    rate = getattr(cell, "rate", lambda units, window: units / window)
    return {
        "steps": done,
        "steps_launched": i + 1,
        "units": units,
        "attempted": (i + 1) * cell.units_per_step,
        "window_s": window,
        cell.rate_metric: rate(units, window),
    }


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(manifest: dict, cell: dict, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
             program=None, mix_overrides: dict | None = None) -> dict:
    """One run of ``cell`` (``load_cell``): the result line's object.
    ``program`` and ``mix_overrides`` are for the tests (the control, the
    faults, a tiny size on the CPU)."""
    import torch

    from portbench import tracing

    t_start = time.perf_counter() if t_start is None else t_start
    mix = dict(cell["mix_data"], **(mix_overrides or {}))
    driver = load_module("drivers", mix["driver"])
    run = driver.Cell(cell["config_data"], mix, seed, device, program=program)
    run.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    stats = measure_window(run, seconds, device)
    stats.update(run.window_stats() if hasattr(run, "window_stats") else {})
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = None
    if trace:
        summary = tracing.capture(run.step, int(mix["trace_steps"]), stats["steps_launched"], device)
        if hasattr(run, "trace_stats"):
            summary["driver"] = run.trace_stats(int(mix["trace_steps"]))
    stats["failed"] = run.failed_units()
    run.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = run.check()
    notes = run.notes() if hasattr(run, "notes") else None

    metrics = {}
    defs = {m["name"]: m for m in manifest["end_to_end"] + manifest["per_layer"]}
    if not trace:
        for name in end_to_end_names(manifest, cell["name"]):
            value = setup_s if name == "setup_s" else stats.get(name)
            if value is None:
                raise RuntimeError(f"the cell's driver gives no {name}")
            metrics[name] = {"value": value, "unit": defs[name]["unit"]}
    else:
        ctx = types.SimpleNamespace(stats=stats, trace=summary, config=cell["config_data"], mix=mix, cell=cell)
        for name in per_layer_names(manifest, cell["name"]):
            value = load_module("metrics", name).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": defs[name]["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit"] = _power_limit()
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    limits = cell["limits"]
    compared = {name: {"value": value, "limit": limits.get(name)} for name, value in checks.items()}
    correct = bool(compared) and all(
        c["limit"] is not None and c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    result = {"correct": correct, "attempted": int(stats["attempted"]), "failed": int(stats["failed"]),
              "metrics": metrics, "device": dev, "setup_s": setup_s,
              "window": {k: stats[k] for k in ("steps", "units", "window_s")}}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    if notes:
        result["notes"] = notes
    result["checks"] = compared
    return result


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    parser = argparse.ArgumentParser(prog="python3 -m portbench", description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    manifest = load_manifest()
    cell = load_cell(manifest, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), found {found}", file=sys.stderr)
        return 3
    result = run_cell(manifest, cell, args.seed, args.seconds, bool(args.trace), device="cuda", t_start=t_start)
    return emit(result)


def emit(result: dict) -> int:
    """Refuse a process that loaded JAX or the JAX package; otherwise the
    numbers compared beside their limits as the last lines of standard
    error, and the result as the last line of standard output."""
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
