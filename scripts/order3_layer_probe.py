"""Which layer of the sim_demo forward carries the order-3 bfloat16 share
(ROADMAP.md Queue 3, item 1)?  The port's float32 forward against the
JAX package's, one layer at a time, on the CPU.

    JAX_PLATFORMS=cpu python scripts/order3_layer_probe.py [--hlo forward_hlo.txt]

The stamps are the cutouts that tests/test_torch_residency.py's
``test_device_dtype_serving_matches_jax[3]`` serves (``_blob_field(seed=6)``,
chunks of 2, padded to JAX's batch bucket).  JAX's jitted forward runs
once with ``capture_intermediates`` (checked bit for bit against the same
forward without it), and every layer of the port is then fed the jitted
forward's input to that layer (teacher-forced).  For each layer it prints
the share of output elements whose bits differ

- between the port and JAX jitted,
- between the port and JAX un-jitted (the flax module alone under
  ``jax.disable_jit()``, fed the same input),
- between JAX un-jitted and JAX jitted,
- for the BatchNorm and the PReLUs, between JAX jitted and the port's
  inputs put through XLA's fused form: ``fma(x - mean, mul, bias)`` with
  JAX's ``mul`` (``rsqrt`` correctly rounded), ``fma(alpha, min(x, 0),
  max(x, 0))``.

``--hlo`` writes the jitted forward's optimized HLO and prints each fusion
that feeds a multiply into an add, the places where LLVM may contract an
FMA.  An FMA is emulated in float64 (the product of two float32 values is
exact there).  CPU only; needs JAX.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

import debvader_tpu as dt  # noqa: E402
from debvader_tpu.api import _bucket  # noqa: E402
from debvader_tpu.config import PipelineConfig as JaxPipelineConfig  # noqa: E402
from debvader_tpu.models.layers import ConvTranspose2DTF  # noqa: E402
from debvader_tpu.models.layers import PReLU as JaxPReLU  # noqa: E402


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _differ(a, b) -> int:
    return int((np.asarray(a, np.float32).view(np.int32) != np.asarray(b, np.float32).view(np.int32)).sum())


def served_cutouts(jnet, field, centers, order: int = 3, chunk: int = 2) -> list:
    """The (n, S, S, B) cutouts that JAX's device_dtype='bfloat16' stream
    hands its forward, one array a chunk."""
    cuts = []
    forward = dt.DeblendField._batched_forward

    def record(self, cut):
        cuts.append(np.array(cut, np.float32))
        return forward(self, cut)

    dt.DeblendField._batched_forward = record
    try:
        jdf = dt.DeblendField(jnet, field, z_mode="mean", device_dtype="bfloat16",
                              cfg=JaxPipelineConfig(interp_order=order, source_chunk=chunk))
        jdf.deblend_and_render(centers, return_model=True)
    finally:
        dt.DeblendField._batched_forward = forward
    return cuts


def _eager(module, variables, x) -> np.ndarray:
    with jax.disable_jit():
        return np.asarray(module.apply(variables, jnp.asarray(x)))


def _captured(model, variables, x):
    """JAX's jitted forward on x with every module's output captured."""
    def run(v, x, capture):
        kwargs = {"capture_intermediates": True, "mutable": ["intermediates"]} if capture else {}
        return model.apply(v, x, rng=jax.random.PRNGKey(0), z_mode="mean", **kwargs)

    (dist, _), state = jax.jit(lambda v, x: run(v, x, True))(variables, x)
    plain, _ = jax.jit(lambda v, x: run(v, x, False))(variables, x)
    if not np.array_equal(np.asarray(dist.loc).view(np.int32), np.asarray(plain.loc).view(np.int32)):
        raise AssertionError("capturing the intermediates changed JAX's jitted forward")
    return jax.tree_util.tree_map(np.asarray, state["intermediates"])


def layer_shares(jnet, tnet, cuts) -> dict:
    """{layer: (elements, port != jitted, port != un-jitted, un-jitted !=
    jitted, XLA's fused form != jitted or None)}, counts of elements summed
    over the chunks ``cuts``."""
    model, variables = jnet
    params, stats = variables["params"], variables["batch_stats"]
    pe, pd = params["encoder"], params["decoder"]
    enc, dec = tnet.encoder, tnet.decoder
    f32 = {"dtype": jnp.float32, "param_dtype": jnp.float32}
    counts: dict = {}

    def count(name, port, jitted, eager, fused=None):
        c = counts.setdefault(name, [0, 0, 0, 0, None if fused is None else 0])
        c[0] += np.asarray(jitted).size
        c[1] += _differ(port, jitted)
        c[2] += _differ(port, eager)
        c[3] += _differ(eager, jitted)
        if fused is not None:
            c[4] += _differ(fused, jitted)

    def prelu(name, module, flax_params, x, jitted, nchw):
        xt = _nchw(x) if nchw else torch.from_numpy(np.array(x, np.float32))
        zero = xt.new_zeros(())
        back = _nhwc if nchw else (lambda t: t.numpy())
        fused = back(_fma(module.alpha, torch.minimum(xt, zero), torch.maximum(xt, zero)))
        count(name, back(module(xt)), jitted, _eager(JaxPReLU(), {"params": flax_params}, x), fused)

    for cut in cuts:
        n = cut.shape[0]
        x = np.concatenate([cut, np.zeros((_bucket(n) - n,) + cut.shape[1:], np.float32)])
        x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
        inter = _captured(model, variables, jnp.asarray(x))
        out = {f"{side}/{k}": v["__call__"][0] for side in ("encoder", "decoder")
               for k, v in inter[side].items() if k != "__call__"}
        with torch.no_grad():
            bn = enc.bn
            xt = _nchw(x)
            mul = jax.jit(lambda v, s: jax.lax.rsqrt(v + 1e-3) * s)(stats["encoder"]["BatchNorm_0"]["var"],
                                                                    pe["BatchNorm_0"]["scale"])
            fused = _fma(xt - bn.mean.view(1, -1, 1, 1), torch.from_numpy(np.asarray(mul)).view(1, -1, 1, 1),
                         bn.bias.view(1, -1, 1, 1))
            flax_bn = nn.BatchNorm(use_running_average=True, momentum=0.99, epsilon=1e-3, **f32)
            count("enc/BatchNorm_0", _nhwc(bn(xt)), out["encoder/BatchNorm_0"],
                  _eager(flax_bn, {"params": pe["BatchNorm_0"], "batch_stats": stats["encoder"]["BatchNorm_0"]}, x),
                  _nhwc(fused))
            h = out["encoder/BatchNorm_0"]
            for i, conv in enumerate(enc.convs):
                jc = out[f"encoder/Conv_{i}"]
                flax_conv = nn.Conv(jc.shape[-1], (3, 3), strides=(2, 2) if i % 2 else None, padding="SAME", **f32)
                count(f"enc/Conv_{i}", _nhwc(conv(_nchw(h))), jc, _eager(flax_conv, {"params": pe[f"Conv_{i}"]}, h))
                h = out[f"encoder/PReLU_{i}"]
                prelu(f"enc/PReLU_{i}", enc.prelus[i], pe[f"PReLU_{i}"], jc, h, True)
            flat = h.reshape(h.shape[0], -1)
            last = len(enc.convs)
            h = out[f"encoder/PReLU_{last}"]
            prelu(f"enc/PReLU_{last} (flatten)", enc.flat_prelu, pe[f"PReLU_{last}"], flat, h, False)
            jd = out["encoder/Dense_0"]
            count("enc/Dense_0", enc.dense(torch.from_numpy(np.array(h))).numpy(), jd,
                  _eager(nn.Dense(jd.shape[-1], **f32), {"params": pe["Dense_0"]}, h))
            h = jd[:, : tnet.cfg.latent_dim]  # z_mode='mean': the posterior's loc
            for name, module in (("PReLU_0", dec.prelu_in), ("Dense_0", dec.dense0), ("PReLU_1", dec.prelu0),
                                 ("Dense_1", dec.dense1), ("PReLU_2", dec.prelu1)):
                jo = out[f"decoder/{name}"]
                if name.startswith("PReLU"):
                    prelu(f"dec/{name}", module, pd[name], h, jo, False)
                else:
                    count(f"dec/{name}", module(torch.from_numpy(np.array(h))).numpy(), jo,
                          _eager(nn.Dense(jo.shape[-1], **f32), {"params": pd[name]}, h))
                h = jo
            h = h.reshape(h.shape[0], dec.width, dec.width, -1)
            for j, convt in enumerate(dec.convts):
                jc = out[f"decoder/ConvTranspose2DTF_{j}"]
                flax_convt = ConvTranspose2DTF(jc.shape[-1], (3, 3), strides=(convt.stride,) * 2, dtype=jnp.float32)
                count(f"dec/ConvTranspose2DTF_{j}", _nhwc(convt(_nchw(h))), jc,
                      _eager(flax_convt, {"params": pd[f"ConvTranspose2DTF_{j}"]}, h))
                h = out[f"decoder/PReLU_{3 + j}"]
                prelu(f"dec/PReLU_{3 + j}", dec.prelus[j], pd[f"PReLU_{3 + j}"], jc, h, True)
            jc = out["decoder/Conv_0"]
            count("dec/Conv_0 (head)", _nhwc(dec.head(_nchw(h))), jc,
                  _eager(nn.Conv(jc.shape[-1], (3, 3), padding="SAME", **f32), {"params": pd["Conv_0"]}, h))
    return {k: tuple(v) for k, v in counts.items()}


def format_table(counts: dict) -> str:
    lines = [f"{'layer':28s} {'elements':>9s} {'port/jit':>9s} {'port/eager':>10s} {'eager/jit':>9s} {'fused/jit':>9s}"]
    for name, (n, pj, pe, ej, fj) in counts.items():
        fused = "" if fj is None else f"{fj / n:9.4%}"
        lines.append(f"{name:28s} {n:9d} {pj / n:9.4%} {pe / n:10.4%} {ej / n:9.4%} {fused:>9s}")
    return "\n".join(lines)


def multiply_add_fusions(hlo: str) -> list:
    """(fusion, op_name) of every add or subtract in a fused computation
    that takes a multiply of the same computation as an operand."""
    found = []
    for block in re.split(r"\n(?=%?\S*fused_computation)", hlo):
        head = block.split("(", 1)[0].strip()
        if "fused_computation" not in head:
            continue
        muls = set(re.findall(r"(%[\w.]+) = f32\[[^\]]*\]\S* multiply\(", block))
        for line in block.splitlines():
            m = re.search(r"= f32\[[^\]]*\]\S* (add|subtract)\(([^)]*)\)", line)
            if m and any(op.strip() in muls for op in m.group(2).split(",")):
                name = re.search(r'op_name="([^"]*)"', line)
                found.append((head, name.group(1) if name else "?"))
    return found


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--hlo", help="write the jitted forward's optimized HLO (a batch of 8) here")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
    from test_torch_residency import _blob_field

    import debvader_tpu_torch as dtt

    torch.set_num_threads(1)
    jnet, tnet = dt.load_deblender("sim_demo"), dtt.load_deblender("sim_demo", device="cpu")
    if args.hlo:
        model, variables = jnet
        fwd = jax.jit(lambda v, x: model.apply(v, x, rng=jax.random.PRNGKey(0), z_mode="mean")[0].loc)
        text = fwd.lower(variables, jnp.zeros((8, 59, 59, 6), jnp.float32)).compile().as_text()
        Path(args.hlo).write_text(text)
        print(f"wrote {args.hlo}; multiply-adds inside fusions (LLVM may contract them):")
        for fusion, op in multiply_add_fusions(text):
            print(f"  {fusion}: {op}")
    field, centers = _blob_field(seed=6)
    print(format_table(layer_shares(jnet, tnet, served_cutouts(jnet, field, centers))))


if __name__ == "__main__":
    main()
