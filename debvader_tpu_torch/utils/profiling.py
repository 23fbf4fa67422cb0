"""Stage timing for the pipeline's entry points.

Port of ``stage_timer`` of debvader_tpu.utils.profiling.  PyTorch returns
from a CUDA call before the card has finished, so a stage that ran on a
card ends with ``torch.cuda.synchronize``: its seconds are the card's, not
the launches'.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch

__all__ = ["stage_timer"]


@contextlib.contextmanager
def stage_timer(times: dict, name: str, device=None) -> Iterator[None]:
    """Add the wall seconds of a stage to ``times[name]``.

    ``device``: the device the stage ran on; a CUDA device is synchronised
    before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        times[name] = times.get(name, 0.0) + (time.perf_counter() - t0)
