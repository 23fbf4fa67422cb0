"""Stage timing, device traces and structured training metrics, after
debvader_tpu.utils.profiling.

- ``stage_timer``: PyTorch returns from a CUDA call before the card has
  finished, so a stage that ran on a card ends with
  ``torch.cuda.synchronize``: its seconds are the card's, not the
  launches';
- ``trace``: a ``torch.profiler`` capture of the block, written to a
  logdir as a Chrome trace (TensorBoard's profiler plugin reads it);
- ``MetricsLog``: append-only step records (JSONL), what the training
  loop writes instead of prints.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Iterator

import torch

__all__ = ["stage_timer", "trace", "MetricsLog"]


@contextlib.contextmanager
def stage_timer(times: dict, name: str, device=None) -> Iterator[None]:
    """Add the wall seconds of a stage to ``times[name]``.

    ``device``: the device the stage ran on, or a list of them (a mesh's);
    each CUDA device is synchronised before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        for dev in device if isinstance(device, (list, tuple)) else [device]:
            if dev is not None and torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)
        times[name] = times.get(name, 0.0) + (time.perf_counter() - t0)


@contextlib.contextmanager
def trace(logdir: str | Path) -> Iterator[None]:
    """Profile the block (CPU, and CUDA where there is a card) into
    ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(logdir / "trace.json"))


class MetricsLog:
    """Append-only structured metrics: ``log(step, **metrics)`` keeps a
    record and, with a path, appends it to that JSONL file."""

    def __init__(self, path: str | Path | None = None):
        self.records: list[dict] = []
        self.path = Path(path) if path else None

    def log(self, step: int, **metrics: float) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def series(self, key: str) -> list[float]:
        return [r[key] for r in self.records if key in r]

    def last(self) -> dict:
        return self.records[-1] if self.records else {}
