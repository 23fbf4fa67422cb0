"""Multi-pass bf16-limb precision schemes, per layer, as explicit PyTorch ops.

Port of debvader_tpu/models/precision.py.  A float32 value splits exactly
into three bf16 limbs (24 = 3 x 8 mantissa bits): x = xh + xm + xl.  A
scheme is a set of limb-pair products to accumulate; the product of two
bf16 values is exact in float32, so a scheme computes the same numbers on
every backend up to the order of the float32 sums.  The schemes are what
the JAX package's fidelity serving mode and its fused tail kernel
(kernels/tail_fused.py) are defined by.

The limbs here are bf16-*valued* float32 tensors and the contractions run
in float32 (callers keep TF32 off, device.fp32_math): a contraction of
``torch.bfloat16`` tensors would return bf16, there being no counterpart of
``preferred_element_type=float32``.

The native rungs ('default', 'high', 'highest') count passes of a TPU's
matrix unit.  Off a TPU they leave the arithmetic float32, in the JAX
package and here; ``limb_emulation=True`` runs them through their limb
equivalents (``EMULATION``).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = [
    "SCHEMES",
    "EMULATION",
    "NATIVE_RUNGS",
    "split_limbs",
    "apply_scheme",
    "resolve",
]

# scheme -> (number of limbs, ((x_limb, w_limb), ...), split mode); limb 0 is
# the high one.  'rne' rounds each limb to nearest even, 'rtz' truncates
# toward zero (what XLA's own three-pass decomposition does).  Term sets are
# ordered so the largest product accumulates first.
SCHEMES: dict[str, tuple[int, tuple[tuple[int, int], ...], str]] = {
    "bf16x1": (1, ((0, 0),), "rne"),
    "bf16x3t": (2, ((0, 0), (0, 1), (1, 0)), "rtz"),
    "bf16x2": (2, ((0, 0), (1, 0)), "rne"),
    "bf16x2t": (2, ((0, 0), (1, 0)), "rtz"),
    "bf16x3": (2, ((0, 0), (0, 1), (1, 0)), "rne"),
    "bf16x4": (2, ((0, 0), (0, 1), (1, 0), (1, 1)), "rne"),
    "bf16x5": (3, ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0)), "rne"),
    "bf16x6": (3, ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0)), "rne"),
    # the exact product of the 3-limb (= full float32) representation
    "bf16x9": (
        3,
        (
            (0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0),
            (1, 2), (2, 1), (2, 2),
        ),
        "rne",
    ),
}

# the native rungs as explicit limbs (None = 'default': one rounded pass)
EMULATION: dict[str | None, str] = {
    None: "bf16x1",
    "default": "bf16x1",
    "high": "bf16x3t",
    "highest": "bf16x6",
}

NATIVE_RUNGS = ("default", "high", "highest")


def _round_bf16(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The bf16-representable value of float32 ``x``, in float32: rounded
    to nearest even ('rne': eager PyTorch's cast does that on the CPU and
    on a card) or with the low 16 bits cleared ('rtz')."""
    if mode == "rne":
        return x.to(torch.bfloat16).to(torch.float32)
    if mode == "rtz":
        return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)
    raise ValueError(f"split mode must be 'rne' or 'rtz', got {mode!r}")


def split_limbs(x: torch.Tensor, n: int, mode: str = "rne") -> list[torch.Tensor]:
    """Split a float32 tensor into ``n`` bf16-valued float32 limbs.

    The limbs sum to x exactly for n >= 3; for n < 3 the last limb is the
    remainder rounded to bf16 (nearest even in both modes, as the JAX
    package's cast does)."""
    limbs = []
    r = x.to(torch.float32)
    for _ in range(n - 1):
        h = _round_bf16(r, mode)
        limbs.append(h)
        r = r - h
    limbs.append(_round_bf16(r, "rne"))
    return limbs


def apply_scheme(
    x: torch.Tensor,
    w: torch.Tensor,
    scheme: str,
    w_out_axis: int,
    contract: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    out_axis: int = -1,
) -> torch.Tensor:
    """Accumulate the scheme's limb products: sum over (i, j) of
    contract(x_i, w_j), in float32.

    ``contract`` is linear in both operands and puts the output channels
    on ``out_axis`` of its result.  As in the JAX package the terms are
    grouped by x-limb, lowest index first, and the w-limbs a group needs
    are concatenated along ``w_out_axis`` so that one contraction computes
    them; the blocks are added in the scheme's term order, then the
    groups."""
    nlimbs, terms, mode = SCHEMES[scheme]
    xl = split_limbs(x, nlimbs, mode)
    wl = split_limbs(w, nlimbs, mode)
    groups: dict[int, list[int]] = {}
    for i, j in terms:
        groups.setdefault(i, []).append(j)
    out = None
    for i in sorted(groups):
        js = groups[i]
        if len(js) == 1:
            y = contract(xl[i], wl[js[0]])
        else:
            blocks = contract(xl[i], torch.cat([wl[j] for j in js], dim=w_out_axis))
            y = None
            for block in torch.chunk(blocks, len(js), dim=out_axis):
                y = block if y is None else y + block
        out = y if out is None else out + y
    return out


def resolve(cfg, key: str) -> tuple[str | None, str | None]:
    """(native rung, explicit scheme) of layer ``key`` under ``cfg``.

    At most one is not None.  A scheme means the layer runs
    :func:`apply_scheme`; a native rung (or neither) means the plain
    float32 layer.  ``cfg.layer_precision`` wins over
    ``cfg.matmul_precision``, and ``cfg.limb_emulation`` maps a native rung
    to its limb equivalent."""
    rung = cfg.layer_rung(key)
    if rung is None or rung in NATIVE_RUNGS:
        effective = rung if rung is not None else cfg.matmul_precision
        if cfg.limb_emulation:
            return None, EMULATION[effective]
        return effective, None
    return None, rung
