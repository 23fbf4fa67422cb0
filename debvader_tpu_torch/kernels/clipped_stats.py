"""Sigma-clipped background statistics: CUDA kernel and plain version.

Port of the Pallas kernel debvader_tpu/kernels/clipped_stats.py
(sigma_clipped_stats_pallas).  Per box: three rounds of clipping to
median +- (3*std + 1e-12), then (mean, median, std).  The median is the
exact (count-1)//2 order statistic of monotonic int32 keys of the float
bits; -0.0 orders below +0.0.  Two quirks are kept: an empty clip (its
std NaN after a mean that overflowed) admits |x| <= 1e-12 next round, and
a zero count gives zeros.

The CUDA kernel (csrc/clipped_stats.cu), one block per box, is bound on
the H100 by the 8 bytes a pixel it reads; a direct port of the TPU kernel
is held far above that by about 140 serial block-wide steps a box (a
32-step one-bit radix descend and three block sums each round).  It keeps
a box's pixels in registers (in shared memory above ``32 * 512`` pixels),
selects each round's median as a rank of the valid set through cached
11/11/10-bit key histograms, and fuses each round's four sums into one
reduction.
Medians are bit-identical to the plain version; mean and std differ only
by summation order.  The plain version below is the 32-step descend.
No TMA: a box is read once, 4 bytes a thread, straight into registers
(the 16-byte stride rule that keeps TMA off the render's stamps does not
bind here, and staging would buy nothing).
"""

from __future__ import annotations

import torch

from debvader_tpu_torch.kernels import _build

__all__ = ["MAX_BOX_PIXELS", "sigma_clipped_stats", "sigma_clipped_stats_plain"]

_SIGN = torch.tensor(-(2**31), dtype=torch.int32)
_INT32_MAX = 2**31 - 1
# Largest box the kernel takes: above 32 * 512 pixels it holds the box in
# shared memory, 4 bytes a pixel beside 24 KB of histograms and sums, in
# the 227 KB a block may use.
MAX_BOX_PIXELS = (232448 - 24 * 1024) // 4


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    bits = x.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _subset_stats(y, w, member):
    """(mean_y, med, std, count) over ``member`` of each row; y is x centred
    on the row's unclipped mean, w the order keys."""
    # sums over members only, as XLA computes the JAX package's y * m (a
    # select): a non-member whose y overflowed adds nothing, not inf * 0
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    n = member.sum(-1)
    nf = torch.clamp(n, min=1).to(torch.float32)
    mean_y = torch.sum(torch.where(member, y, zero), -1) / nf
    var = torch.clamp(torch.sum(torch.where(member, y * y, zero), -1) / nf - mean_y * mean_y, min=0.0)
    k = torch.clamp(n - 1, min=0) // 2
    wm = torch.where(member, w, torch.full_like(w, _INT32_MAX))
    sign = _SIGN.to(w.device)
    base = torch.zeros(k.shape, dtype=torch.int32, device=w.device)
    for b in range(31, -1, -1):
        t = base | (sign if b == 31 else torch.tensor(1 << b, dtype=torch.int32, device=w.device))
        below = torch.sum(wm < (t ^ sign)[:, None], -1)
        base = torch.where(below <= k, t, base)
    wk = base ^ sign
    med = torch.where(wk < 0, wk ^ 0x7FFFFFFF, wk).view(torch.float32)
    med = torch.where(n > 0, med, torch.zeros_like(med))
    return mean_y, med, torch.sqrt(var), n


def sigma_clipped_stats_plain(x: torch.Tensor, valid: torch.Tensor, iters: int = 3):
    """(mean, median, std) of each row of x (B, P) over ``valid > 0``."""
    vm = valid > 0
    n_all = vm.sum(-1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    c = torch.sum(torch.where(vm, x, zero), -1) / torch.clamp(n_all, min=1).to(torch.float32)
    y = torch.where(vm, x - c[:, None], zero)
    w = _order_keys(x)
    member = vm
    for _ in range(iters):
        _, med, std, _ = _subset_stats(y, w, member)
        thr = 3.0 * std + 1e-12
        member = vm & (x >= (med - thr)[:, None]) & (x <= (med + thr)[:, None])
    mean_y, med, std, n = _subset_stats(y, w, member)
    return torch.where(n > 0, mean_y + c, zero), med, std


def check_box_pixels(p: int) -> None:
    """Raise for a box the kernel cannot hold (more than MAX_BOX_PIXELS)."""
    if p > MAX_BOX_PIXELS:
        raise ValueError(f"boxes of {p} pixels exceed the kernel's {MAX_BOX_PIXELS}")


def _launch(x: torch.Tensor, v: torch.Tensor, iters: int):
    n, p = x.shape
    check_box_pixels(p)
    fn = _build.launcher("clipped_stats", "dvt_clipped_stats", 5, 3)
    mean, med, std = (torch.empty(n, dtype=torch.float32, device=x.device) for _ in range(3))
    status = _build.call(
        fn, x.device, x.data_ptr(), v.data_ptr(), mean.data_ptr(), med.data_ptr(), std.data_ptr(), n, p, iters,
    )
    _build.check(status, "clipped_stats")
    sigma_clipped_stats.launches += 1
    return mean, med, std


def sigma_clipped_stats(boxes: torch.Tensor, valid: torch.Tensor | None = None, iters: int = 3):
    """(mean, median, std), each shaped like boxes[..., 0], for boxes
    (..., P) float32 with an optional valid mask (non-zero = usable; all
    values must be finite).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    shape = boxes.shape[:-1]
    p = boxes.shape[-1]
    x = boxes.reshape(-1, p).to(torch.float32).contiguous()
    v = (
        torch.ones_like(x)
        if valid is None
        else valid.reshape(-1, p).to(device=x.device, dtype=torch.float32).contiguous()
    )
    if x.device.type == "cpu":
        out = sigma_clipped_stats_plain(x, v, iters)
    elif x.device.type == "cuda":
        out = _launch(x, v, iters)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return tuple(o.reshape(shape) for o in out)


sigma_clipped_stats.launches = 0
