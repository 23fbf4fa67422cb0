"""The traced sub-window: ``torch.profiler`` over a few of the cell's
steps after the measured window, reduced to what the per-layer readers
and the result's ``breakdown`` need.

Device time is the union of the kernel, memcpy and memset intervals inside
the window's annotation; the window is that annotation, from a
synchronise before the first step to one after the last.  An idle gap is
labelled by the innermost host op running at its midpoint.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from pathlib import Path

__all__ = ["capture", "summarize"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_WINDOW = "portbench.traced_window"


def capture(step, steps: int, first_index: int, device) -> dict:
    """Trace ``steps`` calls of ``step(i)`` (i from ``first_index``) and
    summarise them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(_WINDOW):
            if cuda:
                torch.cuda.synchronize(device)
            for i in range(steps):
                step(first_index + i)
            if cuda:
                torch.cuda.synchronize(device)
    path = Path(tempfile.gettempdir()) / f"portbench_trace_{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return summarize(events, steps)


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list, steps: int) -> dict:
    """busy_s, window_s, the kernel count, every device op's seconds, the
    ten device ops that took most time and the ten host labels under which
    the device idled most, from Chrome-trace events (microseconds)."""
    window = [e for e in events if e.get("name") == _WINDOW and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS and "dur" in e]
    intervals = []
    by_name: dict[str, float] = {}
    kernels = 0
    for e in dev:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        intervals.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
        kernels += e.get("cat") == "kernel"
    busy = _merge(intervals)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, cursor = [], w0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if w1 > cursor:
        gaps.append((cursor, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") in _HOST_CATS and "dur" in e and e.get("name") != _WINDOW)
    starts = [h[0] for h in host]
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label, best = "no host op", None
        j = bisect.bisect_right(starts, mid)
        for k in range(j - 1, max(j - 4000, 0) - 1, -1):
            s, e, name = host[k]
            if e >= mid and (best is None or e - s < best):
                label, best = name, e - s
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "steps": steps,
        "kernels": kernels,
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": [[n, s] for n, s in top],
        "device_op_s": by_name,
        "idle_gaps": [[n, s] for n, s in gaps_top],
    }
