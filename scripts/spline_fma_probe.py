"""Probe of ROADMAP.md Queue 3's order-3 item: does the port's float32
spline prefilter (debvader_tpu_torch/ops/spline.py) come closer to the JAX
package's ``lax.scan`` recurrences under XLA's CPU backend when its
recurrences are contracted like fused multiply-adds, or when the causal
initial value is summed in another order?

    JAX_PLATFORMS=cpu python scripts/spline_fma_probe.py

Prints, for two line lengths (79, the order-3 patch of a 59-px stamp, and
23), the share of prefilter coefficients that differ from JAX's jitted
``_prefilter_last_axis`` for each variant, then the share of a whole
``subpixel_shift_spline_const`` (79^2 x 6 patches, random fractional
shifts) that differs from JAX's jitted and vmapped one, with the current
taps and with FMA-contracted taps.  An FMA is emulated exactly: the
float32 product is exact in float64, the add is rounded in float64 and
then to float32 (double rounding is possible only when the float64 sum
is itself inexact and lands on a float32 midpoint).  CPU only; needs JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from debvader_tpu.ops import spline as js  # noqa: E402
from debvader_tpu_torch.ops import spline as ts  # noqa: E402

Z = ts._POLE


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def prefilter(x, fwd_fma=False, bwd_fma=False, init="tensordot"):
    """ops/spline._prefilter_last_axis with the recurrences optionally
    contracted and the causal initial value summed by ``init``:
    'tensordot' (the port's), 'seq_fma' (left to right, FMA) or 'f64'
    (float64, rounded once)."""
    n = x.shape[-1]
    c = 6.0 * x
    k = np.arange(n)
    w = np.power(Z, k) + np.power(Z, 2 * n - 2 - k)
    w[0], w[n - 1] = 1.0, Z ** (n - 1)
    wt = torch.as_tensor(w / (1.0 - Z ** (2 * n - 2)), dtype=c.dtype)
    if init == "tensordot":
        cp0 = torch.tensordot(c, wt, dims=([-1], [0]))
    elif init == "seq_fma":
        cp0 = c[..., 0] * wt[0]
        for i in range(1, n):
            cp0 = fma(c[..., i], wt[i].expand_as(cp0), cp0)
    else:
        cp0 = torch.tensordot(c.double(), wt.double(), dims=([-1], [0])).float()
    zt = torch.tensor(Z, dtype=torch.float32)
    cp = [cp0]
    for i in range(1, n):
        cp.append(fma(zt.expand_as(cp[-1]), cp[-1], c[..., i]) if fwd_fma else c[..., i] + Z * cp[-1])
    cm = [None] * n
    last = fma(zt.expand_as(cp[n - 2]), cp[n - 2], cp[n - 1]) if bwd_fma else cp[n - 1] + Z * cp[n - 2]
    cm[n - 1] = (Z / (Z * Z - 1.0)) * last
    for i in range(n - 2, -1, -1):
        cm[i] = Z * (cm[i + 1] - cp[i])
    return torch.stack(cm, dim=-1)


def shift(img, sh, tap_fma, **kw):
    """ops/spline.subpixel_shift_spline_const on ``prefilter(**kw)``, the
    taps optionally contracted."""
    n, h, w, _ = img.shape
    coef = prefilter(torch.movedim(img, -1, -3), **kw)
    coef = torch.movedim(prefilter(coef.transpose(-1, -2), **kw).transpose(-1, -2), -3, -1)
    coef_p = F.pad(coef.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="reflect").permute(0, 2, 3, 1)
    fy, fx = sh[:, 0].reshape(n, 1, 1, 1), sh[:, 1].reshape(n, 1, 1, 1)
    tmp = torch.zeros(())
    for k in range(-2, 3):
        wk, sl = ts._bspline3(k + fy), coef_p[:, 2 + k : 2 + k + h]
        tmp = fma(wk.expand_as(sl), sl, tmp.expand_as(sl)) if tap_fma else tmp + wk * sl
    out = torch.zeros(())
    for k in range(-2, 3):
        wk, sl = ts._bspline3(k + fx), tmp[:, :, 2 + k : 2 + k + w]
        out = fma(wk.expand_as(sl), sl, out.expand_as(sl)) if tap_fma else out + wk * sl
    rows = torch.arange(h, dtype=torch.float32).reshape(1, h, 1, 1)
    cols = torch.arange(w, dtype=torch.float32).reshape(1, 1, w, 1)
    return torch.where((rows >= fy) & (cols >= fx), out, torch.zeros(()))


def main():
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    variants = {
        "port (tensordot, plain recurrences)": {},
        "FMA forward recurrence": dict(fwd_fma=True),
        "FMA both recurrences": dict(fwd_fma=True, bwd_fma=True),
        "FMA both, initial value left to right with FMA": dict(fwd_fma=True, bwd_fma=True, init="seq_fma"),
        "FMA both, initial value in float64": dict(fwd_fma=True, bwd_fma=True, init="f64"),
    }
    for n in (79, 23):
        x = (rng.normal(size=(6, 37, n)) * 0.3).astype(np.float32)
        want = np.asarray(jax.jit(js._prefilter_last_axis)(jnp.asarray(x)))
        for name, kw in variants.items():
            got = prefilter(torch.from_numpy(x), **kw).numpy()
            print(f"prefilter n={n}, {name}: share differing from JAX {float((got != want).mean()):.4f}")
    img = np.abs(rng.normal(size=(4, 79, 79, 6))).astype(np.float32)
    sh = rng.uniform(0, 1, (4, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(js.subpixel_shift_spline_const))(jnp.asarray(img), jnp.asarray(sh)))
    base = ts.subpixel_shift_spline_const(torch.from_numpy(img), torch.from_numpy(sh)).numpy()
    print(f"whole shift 79^2x6, the port's: share differing {float((base != want).mean()):.4f}")
    for tap_fma in (False, True):
        got = shift(torch.from_numpy(img), torch.from_numpy(sh), tap_fma, fwd_fma=True, bwd_fma=True).numpy()
        print(f"whole shift, FMA recurrences, taps {'FMA' if tap_fma else 'plain'}: share differing "
              f"{float((got != want).mean()):.4f}")
    jw = np.asarray(jax.jit(jax.vmap(js._bspline3))(jnp.asarray(sh[:, 0] + 1)))
    tw = ts._bspline3(torch.from_numpy(sh[:, 0] + 1)).numpy()
    print(f"tap weights B3(1 + f) equal to JAX's: {bool(np.array_equal(jw, tw))}")


if __name__ == "__main__":
    main()
