"""Watershed label resolution: CUDA kernel and plain version.

Port of the Pallas kernel debvader_tpu/kernels/label_select.py
(label_select_step / label_select_fixpoint): iterate cur[p] <-
cur[parent(p)], parent given as a direction code (0..8, 4 = self), until
nothing changes.  The plain version runs that 9-way select to its
fixpoint.  The fixpoint is unique, so the CUDA kernel
(csrc/label_select.cu, bound by bytes) follows each pixel's chain of codes
to its self-coded root instead, one thread a pixel in 2-D blocks (no
division), a code outside 0..8 ending a chain as it selects nothing in
the iteration: the labels are bit-identical.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from debvader_tpu_torch.kernels import _build

__all__ = ["label_fixpoint", "label_fixpoint_plain"]

_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def label_fixpoint_plain(cur0: torch.Tensor, dir_code: torch.Tensor) -> torch.Tensor:
    """The direction-coded select iteration, run until it stops changing."""
    h, w = cur0.shape

    def step(cur):
        curp = F.pad(cur, (1, 1, 1, 1))
        acc = cur
        for code, (dy, dx) in enumerate(_OFFSETS):
            if code != 4:
                acc = torch.where(dir_code == code, curp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w], acc)
        return acc

    cur, nxt = cur0, step(cur0)
    while not torch.equal(cur, nxt):
        cur, nxt = nxt, step(nxt)
    return nxt


def _launch(cur0: torch.Tensor, dir_code: torch.Tensor) -> torch.Tensor:
    h, w = cur0.shape
    fn = _build.launcher("label_select", "dvt_label_resolve", 3, 2)
    out = torch.empty_like(cur0)
    status = _build.call(fn, cur0.device, cur0.data_ptr(), dir_code.data_ptr(), out.data_ptr(), h, w)
    _build.check(status, "label_select")
    label_fixpoint.launches += 1
    return out


def label_fixpoint(cur0: torch.Tensor, dir_code: torch.Tensor) -> torch.Tensor:
    """Labels (H, W) int32 at the fixpoint of the select iteration.

    cur0: (H, W) int32 initial labels (the parent index on masked pixels,
    0 elsewhere); dir_code: (H, W) int32 in 0..8, 4 = self, never pointing
    out of the array.  A stack of fields may be row-flattened into one
    (T*F, F) array: parents never leave their field.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if cur0.ndim != 2 or dir_code.shape != cur0.shape:
        raise ValueError("cur0 and dir_code must be matching (H, W) arrays")
    if cur0.dtype != torch.int32 or dir_code.dtype != torch.int32:
        raise ValueError("cur0 and dir_code must be int32")
    cur0 = cur0.contiguous()
    dir_code = dir_code.contiguous()
    if cur0.device.type == "cpu":
        return label_fixpoint_plain(cur0, dir_code)
    if cur0.device.type == "cuda":
        return _launch(cur0, dir_code)
    raise ValueError(f"unsupported device {cur0.device}")


label_fixpoint.launches = 0
