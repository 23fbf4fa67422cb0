"""Probe of ROADMAP.md Queue 3's order-3 item: which float32 arithmetic
order makes the port's spline shift (debvader_tpu_torch/ops/spline.py)
equal to the JAX package's jitted, vmapped ``subpixel_shift_spline_const``
on XLA's CPU backend?

    JAX_PLATFORMS=cpu python scripts/spline_fma_probe.py [--hlo shift_hlo.txt]

``--hlo`` writes the optimized HLO of JAX's shift at (8, 79, 79, 6).  The
machine code of each fusion, which shows where LLVM contracts a multiply
and an add into an FMA and how it vectorizes the prefilter's dot, comes
from running this script under
``XLA_FLAGS=--xla_dump_to=DIR`` and disassembling ``DIR/*.o`` with
``objdump -d``.

Prints:

1. for two line lengths (79, the order-3 patch of a 59-px stamp, and 23),
   the share of prefilter coefficients (one pass) that differ from JAX's
   jitted ``_prefilter_last_axis`` for each variant of the initial value
   and the recurrences;
2. the share of a whole shift (random stamps, fractional shifts U(0, 1))
   that differs from JAX's, for the port as it is (XLA's order everywhere)
   at several line lengths and batch sizes, and with each piece of XLA's
   order put back to the plain float32 form one at a time: the dot's
   order, the FMA recurrences, the weights' FMA polynomial and reciprocal
   of 6, the taps' FMA chain and which tap it starts from.

An FMA is emulated in float64: the float32 product is exact there, the add
is rounded in float64 and then to float32.  CPU only; needs JAX.
"""

import argparse
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
fma = ts._fma


def prefilter(x, dot="xla", fwd_fma=True, last_fma=True):
    """ops/spline._prefilter_last_axis with the causal initial value summed
    by ``dot`` ('xla': XLA's vectorized order; 'tensordot': torch's) and
    the causal recurrence and the anticausal initial value contracted or
    not."""
    n = x.shape[-1]
    c = 6.0 * x
    k = np.arange(n)
    w = np.power(Z, k) + np.power(Z, 2 * n - 2 - k)
    w[0], w[n - 1] = 1.0, Z ** (n - 1)
    wt = torch.as_tensor(w / (1.0 - Z ** (2 * n - 2)), dtype=c.dtype)
    cp = [ts._xla_cpu_dot(c, wt) if dot == "xla" else torch.tensordot(c, wt, dims=([-1], [0]))]
    for i in range(1, n):
        cp.append(fma(cp[-1], ts._POLE32, c[..., i]) if fwd_fma else c[..., i] + Z * cp[-1])
    last = fma(cp[n - 2], ts._POLE32, cp[n - 1]) if last_fma else cp[n - 1] + Z * cp[n - 2]
    cm = [None] * n
    cm[n - 1] = (Z / (Z * Z - 1.0)) * last
    for i in range(n - 2, -1, -1):
        cm[i] = Z * (cm[i + 1] - cp[i])
    return torch.stack(cm, dim=-1)


def weights(d, poly_fma=True, reciprocal=True):
    a = torch.abs(d)
    if poly_fma:
        inner = fma((a * 3.0) * a, a, fma(-(a * 6.0), a, torch.full_like(a, 4.0)))
    else:
        inner = 4.0 - 6.0 * a * a + 3.0 * a * a * a
    t = 2.0 - a
    t = (t * t) * t
    inner, t = (inner * ts._SIXTH32, t * ts._SIXTH32) if reciprocal else (inner / 6.0, t / 6.0)
    return torch.where(a < 1.0, inner, torch.where(a < 2.0, t, torch.zeros_like(a)))


def taps(ws, sls, tap_fma=True, start_second=True):
    if not tap_fma:
        acc = 0.0
        for wk, sl in zip(ws, sls):
            acc = acc + wk * sl
        return acc
    if start_second:
        acc = fma(ws[0].expand_as(sls[0]), sls[0], ws[1] * sls[1])
    else:
        acc = fma(ws[1].expand_as(sls[1]), sls[1], ws[0] * sls[0])
    for wk, sl in zip(ws[2:], sls[2:]):
        acc = fma(wk.expand_as(sl), sl, acc)
    return acc


def shift(img, sh, pre=None, wkw=None, tkw=None):
    """subpixel_shift_spline_const with each piece's order selectable."""
    pre, wkw, tkw = pre or {}, wkw or {}, tkw or {}
    n, h, w, _ = img.shape
    coef = prefilter(torch.movedim(img, -1, -3), **pre)
    coef = torch.movedim(prefilter(coef.transpose(-1, -2), **pre).transpose(-1, -2), -3, -1)
    coef_p = F.pad(coef.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="reflect").permute(0, 2, 3, 1)
    fy, fx = sh[:, 0].reshape(n, 1, 1, 1), sh[:, 1].reshape(n, 1, 1, 1)
    ks = range(-2, 3)
    tmp = taps([weights(k + fy, **wkw) for k in ks], [coef_p[:, 2 + k: 2 + k + h] for k in ks], **tkw)
    out = taps([weights(k + fx, **wkw) for k in ks], [tmp[:, :, 2 + k: 2 + k + w] for k in ks], **tkw)
    rows = torch.arange(h, dtype=torch.float32).reshape(1, h, 1, 1)
    cols = torch.arange(w, dtype=torch.float32).reshape(1, 1, w, 1)
    return torch.where((rows >= fy) & (cols >= fx), out, torch.zeros(()))


def jax_shift(img, sh):
    return np.asarray(jax.jit(jax.vmap(js.subpixel_shift_spline_const))(jnp.asarray(img), jnp.asarray(sh)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--hlo", help="write the optimized HLO of JAX's shift at (8, 79, 79, 6) here")
    args = parser.parse_args()
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    if args.hlo:
        z = jnp.zeros((8, 79, 79, 6), jnp.float32)
        text = jax.jit(jax.vmap(js.subpixel_shift_spline_const)).lower(z, jnp.zeros((8, 2))).compile().as_text()
        Path(args.hlo).write_text(text)
    variants = {
        "XLA's order (the port's)": {},
        "tensordot initial value": dict(dot="tensordot"),
        "plain causal recurrence": dict(fwd_fma=False),
        "plain anticausal initial value": dict(last_fma=False),
        "all plain (the port before)": dict(dot="tensordot", fwd_fma=False, last_fma=False),
    }
    for n in (79, 23):
        x = (rng.normal(size=(6, 37, n)) * 0.3).astype(np.float32)
        want = np.asarray(jax.jit(js._prefilter_last_axis)(jnp.asarray(x)))
        for name, kw in variants.items():
            got = prefilter(torch.from_numpy(x), **kw).numpy()
            print(f"prefilter n={n}, {name}: share differing from JAX {float((got != want).mean()):.4f}")
    for n, b in ((79, 8), (79, 128), (43, 8), (30, 8)):
        img = rng.normal(size=(b, n, n, 6)).astype(np.float32)
        sh = rng.uniform(0, 1, (b, 2)).astype(np.float32)
        got = ts.subpixel_shift_spline_const(torch.from_numpy(img), torch.from_numpy(sh)).numpy()
        print(f"whole shift ({b}, {n}, {n}, 6), the port: share differing {float((got != jax_shift(img, sh)).mean()):.4f}")
    img = rng.normal(size=(8, 79, 79, 6)).astype(np.float32)
    sh = rng.uniform(0, 1, (8, 2)).astype(np.float32)
    want = jax_shift(img, sh)
    ablations = {
        "tensordot initial value": dict(pre=dict(dot="tensordot")),
        "plain causal recurrence": dict(pre=dict(fwd_fma=False)),
        "plain anticausal initial value": dict(pre=dict(last_fma=False)),
        "weights' polynomial without FMA": dict(wkw=dict(poly_fma=False)),
        "weights divided by 6": dict(wkw=dict(reciprocal=False)),
        "taps' FMA chain from the first tap": dict(tkw=dict(start_second=False)),
        "taps without FMA": dict(tkw=dict(tap_fma=False)),
        "all plain (the port before)": dict(pre=dict(dot="tensordot", fwd_fma=False, last_fma=False),
                                            wkw=dict(poly_fma=False, reciprocal=False), tkw=dict(tap_fma=False)),
    }
    for name, kw in ablations.items():
        got = shift(torch.from_numpy(img), torch.from_numpy(sh), **kw).numpy()
        print(f"whole shift (8, 79, 79, 6), XLA's order but {name}: share differing {float((got != want).mean()):.4f}")


if __name__ == "__main__":
    main()
