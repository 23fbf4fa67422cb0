"""Stage timing, device traces and structured training metrics, after
debvader_tpu.utils.profiling.

- ``stage_timer``: the program's one span.  It adds a stage's seconds to
  a dict the entry call owns (``DeblendField.serving_timings``,
  ``TiledDeblendField.detect_timings``, a ``timings=`` argument) and,
  while ``torch.profiler`` runs, marks the block as ``dvt.<name>`` on the
  trace's timeline, beside the kernels and copies it launched; a span
  opened inside another nests in it there.  PyTorch returns from a CUDA
  call before the card has finished, so a stage that ran on a card ends
  with ``torch.cuda.synchronize``: its seconds are the card's, not the
  launches'.  A stage given a ``pending`` list records CUDA events
  instead and waits for nothing; ``settle_spans`` adds those seconds
  once the owning call has synchronised;
- ``trace``: a ``torch.profiler`` capture of the block, written to a
  logdir as a Chrome trace (TensorBoard's profiler plugin reads it);
- ``MetricsLog``: append-only step records (JSONL), what the training
  loop writes instead of prints.

The stage dicts hold seconds under stage names and, under ``count.``
names, counts taken at the same boundaries (``count.masked_px``: the
masked pixels detection's host merge takes); a reader sums or divides
them, it never adds a count to a time.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Iterator

import torch

__all__ = ["stage_timer", "settle_spans", "trace", "MetricsLog"]


def _annotation(name: str):
    """``record_function('dvt.<name>')`` while a profiler runs; otherwise
    nothing (the check costs a fraction of a microsecond, the annotation
    about ten)."""
    if torch.autograd._profiler_enabled():
        from torch.profiler import record_function

        return record_function(f"dvt.{name}")
    return contextlib.nullcontext()


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@contextlib.contextmanager
def stage_timer(times: dict, name: str, device=None, pending: list | None = None) -> Iterator[None]:
    """Add the seconds of a stage to ``times[name]``; under a profiler the
    block is the ``user_annotation`` ``dvt.<name>``.

    ``device``: the device the stage ran on, or a list of them (a mesh's);
    each CUDA device is synchronised before the clock stops.

    ``pending``: a list, for a stage that must not wait for the card.  On
    a CUDA ``device`` the stage then records a start and an end event on
    that device's current stream and synchronises nothing; ``(name,
    start, end)`` goes into ``pending`` and ``settle_spans(times,
    pending)`` adds the device seconds between the two events.  Elsewhere
    (the CPU, whose ops finish before they return) the wall seconds are
    added at once."""
    events = pending is not None and _on_card(device)
    with _annotation(name):
        if events:
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if events:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                pending.append((name, start, end))
            else:
                for dev in device if isinstance(device, (list, tuple)) else [device]:
                    if _on_card(dev):
                        torch.cuda.synchronize(dev)
                times[name] = times.get(name, 0.0) + (time.perf_counter() - t0)


def settle_spans(times: dict, pending: list) -> None:
    """Add the seconds of the event spans in ``pending`` (``stage_timer``'s
    ``pending=``) to ``times`` and empty the list, so each is added once.
    Waits for each end event: call it after the owning call has
    synchronised, where that costs nothing."""
    for name, start, end in pending:
        end.synchronize()
        times[name] = times.get(name, 0.0) + start.elapsed_time(end) * 1e-3
    pending.clear()


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
