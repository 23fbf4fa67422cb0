"""The port's quantized serving bundle and pipeline held against the JAX
package on the CPU: save_quantized / load_quantized, the validation
errors, the packaged sim_demo_int8 bundle at full width and
DeblendField(quantized=) on both routes.  The tolerances are
tests/test_torch_quantized.py's (its docstring says why).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debvader_tpu.config import ModelConfig as JaxModelConfig
from debvader_tpu.models import quantized as jq
from debvader_tpu.models.vae import DeblenderVAE as JaxVAE

import debvader_tpu_torch as dtt
from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.models import quantized as tq
from debvader_tpu_torch.models.vae import DeblenderVAE
from debvader_tpu_torch.weights import default_weights_dir, quantized_from_jax
from test_torch_quantized import (BF16_ULPS, LOC_TOL, REPO, TINY_KW, _bf16_ulp, _bits, _bundles, _dtype_case,
                                  _record_int8_inputs, _record_quant_act, _stamps, _tiny)

torch.set_num_threads(1)


# ------------------------------------------------------- save, load, errors


@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor", "per_channel_bf16", "per_tensor_bf16_loose"])
def test_save_load_round_trip(tmp_path, granularity):
    """save_quantized / load_quantized keep every array and flag: the
    float model's parameters and buffers, the int8 kernels and their
    scales, 0-d or per-channel activation scales, and the int8 forward;
    ``_bf16`` (``_loose``: strict_cast=False) a bfloat16 bundle's config
    too."""
    granularity, dtype, strict = _dtype_case(granularity)
    _, tqv = _bundles(granularity, dtype=dtype, strict=strict)
    tqv = dataclasses.replace(tqv, teacher_fingerprint="0123456789abcdef")
    tq.save_quantized(tqv, tmp_path / "bundle")
    meta = json.loads((tmp_path / "bundle.json").read_text())
    assert set(meta) == {"model_cfg", "quantize_dense", "quantize_final_conv", "calib_stats", "normalise",
                         "teacher_fingerprint", "act_granularity"}
    back = tq.load_quantized(tmp_path / "bundle", device="cpu")
    assert set(back.qweights) == set(tqv.qweights) and set(back.act_scales) == set(tqv.act_scales)
    for name, (qk, ws) in tqv.qweights.items():
        assert torch.equal(back.qweights[name][0], qk) and torch.equal(back.qweights[name][1], ws)
    for name, s in tqv.act_scales.items():
        assert back.act_scales[name].shape == s.shape and torch.equal(back.act_scales[name], s)
    assert (back.teacher_fingerprint, back.act_granularity, back.normalise) == ("0123456789abcdef", granularity,
                                                                                 False)
    assert back.cfg == tqv.cfg and (back.cfg.dtype, back.cfg.strict_cast) == (dtype, strict)
    want_sd, got_sd = tqv.model.state_dict(), back.model.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    a, _ = tq.quantized_forward(tqv, _stamps(), z_mode="mean")
    b, _ = tq.quantized_forward(back, _stamps(), z_mode="mean")
    np.testing.assert_array_equal(_bits(a.loc.numpy()), _bits(b.loc.numpy()))


def _jax_bundle_from_port(arrays: dict, meta: dict):
    """The JAX package's QuantizedVAE of a port bundle file's arrays and
    meta.json (the inverse of weights.quantized_from_jax): the float
    variables as a tree, each int8 kernel back in JAX's layout (conv (out,
    in, kh, kw) -> HWIO, transposed conv (in, out, kh, kw) -> TF's (kh,
    kw, out, in), the dense as it is)."""
    from debvader_tpu.config import ModelConfig as JCfg

    tree, qweights, act_scales = {}, {}, {}
    for key, a in arrays.items():
        if key.startswith("qweights/") and key.endswith("/kernel"):
            tag = key.split("/")[1]
            kernel = np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a
            qweights[tag.replace("|", "/")] = (jnp.asarray(kernel), jnp.asarray(arrays[f"qweights/{tag}/scale"]))
        elif key.startswith("act_scales/"):
            act_scales[key.split("/", 1)[1].replace("|", "/")] = jnp.asarray(a)
        elif not key.startswith("qweights/"):
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(a)
    kw = dict(meta["model_cfg"])
    kw["filters"], kw["kernels"] = tuple(kw["filters"]), tuple(kw["kernels"])
    return jq.QuantizedVAE(
        model=JaxVAE(JCfg(**kw)), variables=tree, qweights=qweights, act_scales=act_scales,
        quantize_dense=meta["quantize_dense"], quantize_final_conv=meta["quantize_final_conv"],
        calib_stats=meta["calib_stats"], normalise=meta["normalise"],
        teacher_fingerprint=meta["teacher_fingerprint"], act_granularity=meta["act_granularity"])


@pytest.mark.parametrize("strict", [True, False], ids=["strict_cast", "no_strict_cast"])
def test_bf16_bundles_cross_both_ways(tmp_path, strict):
    """A bfloat16 bundle both ways: JAX's save_quantized (orbax), read by
    its load_quantized and written in the port's format
    (weights.quantized_from_jax, as scripts/convert_sim_demo_int8_to_torch.py
    does), loads in the port's load_quantized; the port's save_quantized,
    read back into JAX's QuantizedVAE, goes through JAX's save_quantized and
    load_quantized.  Each side's int8 forward on the other's bundle bit for
    bit its own."""
    jqv, _ = _bundles("per_channel", dtype="bfloat16", strict=strict)
    x = _stamps(seed=13)
    jq.save_quantized(jqv, tmp_path / "jax_bundle")
    arrays, meta = quantized_from_jax(jq.load_quantized(tmp_path / "jax_bundle"))
    np.savez(tmp_path / "converted.npz", **arrays)
    (tmp_path / "converted.json").write_text(json.dumps(meta))
    tqv = tq.load_quantized(tmp_path / "converted", device="cpu")
    assert (tqv.cfg.dtype, tqv.cfg.strict_cast) == ("bfloat16", strict)
    jd, _ = jq.quantized_forward(jqv, jnp.asarray(x), jax.random.PRNGKey(0), z_mode="mean")
    td, _ = tq.quantized_forward(tqv, x, z_mode="mean")
    np.testing.assert_array_equal(_bits(td.loc.numpy()), _bits(jd.loc))
    tq.save_quantized(tqv, tmp_path / "port_bundle")
    with np.load(tmp_path / "port_bundle.npz") as z:
        back = _jax_bundle_from_port({k: z[k] for k in z.files}, json.loads((tmp_path / "port_bundle.json").read_text()))
    jq.save_quantized(back, tmp_path / "jax_again")
    again = jq.load_quantized(tmp_path / "jax_again")
    assert (again.cfg.dtype, again.cfg.strict_cast) == ("bfloat16", strict)
    ja, _ = jq.quantized_forward(again, jnp.asarray(x), jax.random.PRNGKey(0), z_mode="mean")
    np.testing.assert_array_equal(_bits(np.asarray(ja.loc)), _bits(jd.loc))


def _raises_both(exc, match, jax_call, torch_call):
    with pytest.raises(exc, match=match) as want:
        jax_call()
    with pytest.raises(exc, match=match) as got:
        torch_call()
    return str(want.value), str(got.value)


def test_validation_errors_match_jax():
    """The same errors, with JAX's messages: unknown layers, a bad
    act_granularity, decoder_f32_stages, the re-teaching guard."""
    jmodel, variables, model, x = _tiny()
    j, t = _raises_both(ValueError, "unknown quantization layers",
                        lambda: jq.quantize_vae(jmodel, variables, jnp.asarray(x), layers=["enc/Conv_99"]),
                        lambda: tq.quantize_vae(model, x, layers=["enc/Conv_99"]))
    assert j == t
    j, t = _raises_both(ValueError, "act_granularity",
                        lambda: jq.quantize_vae(jmodel, variables, jnp.asarray(x), act_granularity="per_row"),
                        lambda: tq.quantize_vae(model, x, act_granularity="per_row"))
    assert j == t
    jm2 = JaxVAE(JaxModelConfig(**TINY_KW, decoder_f32_stages=1))
    m2 = DeblenderVAE(ModelConfig(**TINY_KW))
    object.__setattr__(m2.cfg, "decoder_f32_stages", 1)
    j, t = _raises_both(ValueError, "decoder_f32_stages",
                        lambda: jq.quantize_vae(jm2, variables, jnp.asarray(x)),
                        lambda: tq.quantize_vae(m2, x))
    assert j == t
    jqv, tqv = _bundles("per_tensor")
    j, t = _raises_both(ValueError, "re-teach",
                        lambda: jq.qat_finetune(dataclasses.replace(jqv, teacher_fingerprint="f"), steps=1),
                        lambda: tq.qat_finetune(dataclasses.replace(tqv, teacher_fingerprint="f"), steps=1))
    assert j == t
    with pytest.raises(ValueError, match="loss"):
        tq.qat_finetune(tqv, steps=1, loss="mse")


@pytest.mark.parametrize("normalise", [False, True])
def test_sharded_quantized_forward_matches_jax_and_single_device(normalise):
    """make_sharded_quantized_forward over 4 shards (an odd batch of 7,
    padded): JAX's sharded closure on its mesh within LOC_TOL of the
    scale under 'mean', and the port's single-device closure to float
    reassociation under 'mean' and under 'sample' with one seeded
    generator (the noise drawn once and split)."""
    from debvader_tpu.parallel import make_mesh as jax_make_mesh

    from debvader_tpu_torch.parallel import make_mesh

    jqv, tqv = _bundles("per_channel", normalise)
    x = _stamps(n=7, seed=9) * 3.0
    x[0, 3, 4, 1] = np.nan
    mesh = make_mesh(4, devices=["cpu"] * 4)
    jloc, jscale = jq.make_sharded_quantized_forward(jqv, jax_make_mesh(4), z_mode="mean")(
        jnp.asarray(np.concatenate([x, np.zeros((1,) + x.shape[1:], np.float32)])), jax.random.PRNGKey(0))
    tloc, tscale = tq.make_sharded_quantized_forward(tqv, mesh, z_mode="mean")(x)
    for got, want in ((tloc, jloc[:7]), (tscale, jscale[:7])):
        want = np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got.numpy()).all()
        assert float(np.abs(got.numpy() - want).max()) <= LOC_TOL * float(np.abs(want).max())
    for z_mode in ("mean", "sample"):
        one = tq.make_quantized_forward(tqv, z_mode=z_mode)(x, torch.Generator().manual_seed(2))
        four = tq.make_sharded_quantized_forward(tqv, mesh, z_mode=z_mode)(x, torch.Generator().manual_seed(2))
        for got, want in zip(four, one):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    # host stamps and a tensor of them give the same bits
    fed = tq.make_sharded_quantized_forward(tqv, mesh, z_mode="mean")(torch.from_numpy(x))
    for got, want in zip(fed, (tloc, tscale)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deblend_field_quantized_on_a_mesh_matches_single_device(dtype):
    """DeblendField(quantized=, mesh=) reproduces the single-device int8
    pipeline (JAX's test_quantized_mesh_composes: rtol 1e-4, atol 1e-5),
    and JAX's DeblendField(quantized=, mesh=) on its mesh.  bfloat16: at 2
    shards and 4, bit for bit the single device (each shard's int8 forward
    is the same arithmetic on its rows); JAX's jitted bfloat16 route within
    BF16_ULPS bfloat16 ulps of the field's scale."""
    import debvader_tpu as dt
    from debvader_tpu.config import PipelineConfig as JaxPipelineConfig
    from debvader_tpu.parallel import make_mesh as jax_make_mesh

    from debvader_tpu_torch.parallel import make_mesh

    jmodel, variables, model, _ = _tiny(dtype)
    jqv, tqv = _bundles("per_tensor", dtype=dtype)
    field, centers = _field()
    kw = dict(cutout_size=23, nb_of_bands=3, z_mode="mean")
    cfg = dtt.PipelineConfig(cutout_size=23, nb_of_bands=3, interp_order=1)
    _, single = dtt.DeblendField(model, field, quantized=tqv, device="cpu", cfg=cfg, **kw).deblend_and_render(centers)
    cat, sharded = dtt.DeblendField(model, field, quantized=tqv, device="cpu", cfg=cfg,
                                    mesh=make_mesh(4, devices=["cpu"] * 4), **kw).deblend_and_render(centers)
    np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-5)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(sharded, single)
        _, two = dtt.DeblendField(model, field, quantized=tqv, device="cpu", cfg=cfg,
                                  mesh=make_mesh(2, devices=["cpu"] * 2), **kw).deblend_and_render(centers)
        np.testing.assert_array_equal(two, single)
    jcat, jres = dt.DeblendField((jmodel, variables), field, quantized=jqv, mesh=jax_make_mesh(4),
                                 cfg=JaxPipelineConfig(cutout_size=23, nb_of_bands=3, interp_order=1),
                                 **kw).deblend_and_render(centers)
    np.testing.assert_array_equal(cat.list_idx, jcat.list_idx)
    err = float(np.abs(sharded - jres).max())
    print(f"{dtype} int8 on a mesh: residual {err} off JAX's")
    assert err <= (1e-5 * float(np.abs(field).max()) if dtype == "float32" else
                   BF16_ULPS * _bf16_ulp(float(np.abs(field).max())))


@pytest.mark.parametrize("bundle_normalise", [False, True])
def test_deblend_field_normalise_mismatch_raises_as_jax(bundle_normalise):
    """A bundle calibrated with one normalise setting is refused by a
    pipeline with the other, with JAX's message."""
    import debvader_tpu as dt

    jmodel, variables, model, _ = _tiny()
    jqv, tqv = _bundles("per_tensor", bundle_normalise)
    field = np.zeros((1, 64, 64, 3), np.float32)
    j, t = _raises_both(
        ValueError, "normalise",
        lambda: dt.DeblendField((jmodel, variables), field, cutout_size=23, nb_of_bands=3,
                                normalise=not bundle_normalise, quantized=jqv),
        lambda: dtt.DeblendField(model, field, cutout_size=23, nb_of_bands=3, normalise=not bundle_normalise,
                                 quantized=tqv, device="cpu"),
    )
    assert j == t


# ------------------------------------------------------ the packaged bundle


def test_packaged_int8_bundle_holds_the_orbax_leaves():
    """data/weights/sim_demo_int8.npz (scripts/convert_sim_demo_int8_to_
    torch.py) holds every leaf of the JAX bundle exactly: int8 bytes and
    float32 bits, re-laid-out, the QAT-fine-tuned float kernels of the 18
    quantized layers included; sim_demo_int8.json is JAX's meta.json; and
    the port's float model loaded from it is JAX's (its fingerprint)."""
    src = REPO / "debvader_tpu" / "data" / "weights" / "sim_demo_int8"
    jqv = jq.load_quantized(src)
    want, want_meta = quantized_from_jax(jqv)
    with np.load(default_weights_dir() / "sim_demo_int8.npz") as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(want)
    assert len(jqv.qweights) == 18
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        assert got[k].tobytes() == np.ascontiguousarray(a).tobytes(), k
    meta = json.loads((default_weights_dir() / "sim_demo_int8.json").read_text())
    assert meta == json.loads((src / "meta.json").read_text()) == json.loads(json.dumps(want_meta))
    tqv = tq.load_quantized("sim_demo_int8", device="cpu")
    assert tq.params_fingerprint(tqv.model) == jq.params_fingerprint(jqv.variables["params"])
    assert tq.params_fingerprint(tqv.model) != tqv.teacher_fingerprint


def test_packaged_int8_bundle_serves_as_jax(monkeypatch):
    """load_quantized('sim_demo_int8') at full width on 16 stamps: the int8
    activations that differ from JAX's at each of the 18 quantization
    points counted (read: none), loc within LOC_TOL of JAX's eager
    quantized_forward of the orbax bundle (read: equal), the total-flux
    error against the float sim_demo forward within JAX's envelope (mean <
    5e-2, tests/test_quantized.py:352), and the teacher fingerprint equal
    to the port's sim_demo weights'; the float forward (quant=False)
    within LOC_TOL of JAX's on the same bundle."""
    from debvader_tpu.data.simulate import simulate_batch

    jqv = jq.load_quantized(REPO / "debvader_tpu" / "data" / "weights" / "sim_demo_int8")
    tqv = tq.load_quantized("sim_demo_int8", device="cpu")
    assert tqv.cfg.stamp_size == 59 and len(tqv.qweights) == 18 and tqv.act_granularity == "per_channel"
    x = np.asarray(simulate_batch(jax.random.PRNGKey(123), 16)[0])
    jacts, tacts = [], []
    _record_quant_act(monkeypatch, jq, jacts)
    _record_int8_inputs(monkeypatch, tacts)
    jd, _ = jq.quantized_forward(jqv, x, jax.random.PRNGKey(0), z_mode="mean")
    td, _ = tq.quantized_forward(tqv, x, z_mode="mean")
    assert len(jacts) == len(tacts) == 18
    flips = [int(np.count_nonzero(a != b)) for a, b in zip(jacts, tacts)]
    print(f"sim_demo_int8: int8 activations differing from JAX's at each point {flips} "
          f"of {sum(a.size for a in jacts)}")
    want = np.asarray(jd.loc)
    err = float(np.abs(td.loc.numpy() - want).max())
    print(f"sim_demo_int8: max abs difference from JAX {err} of scale {float(np.abs(want).max())}, "
          f"share differing {float((td.loc.numpy() != want).mean())}")
    assert err <= LOC_TOL * float(np.abs(want).max())
    # the bundle's float model is JAX's QAT-fine-tuned one
    jf, _ = jq.quantized_forward(jqv, x, jax.random.PRNGKey(0), z_mode="mean", quant=False)
    tf, _ = tq.quantized_forward(tqv, x, z_mode="mean", quant=False)
    want_f = np.asarray(jf.loc)
    err_f = float(np.abs(tf.loc.numpy() - want_f).max())
    print(f"sim_demo_int8: float forward's max abs difference from JAX {err_f} of scale {float(np.abs(want_f).max())}")
    assert err_f <= LOC_TOL * float(np.abs(want_f).max())
    net = dtt.load_deblender("sim_demo", device="cpu")
    assert tq.params_fingerprint(net) == tqv.teacher_fingerprint == "a9c76466ebb29188"
    ff = dtt.deblend(net, x, z_mode="mean", device="cpu")[0].astype(np.float64).sum(axis=(1, 2, 3))
    fq = td.loc.numpy().astype(np.float64).sum(axis=(1, 2, 3))
    rel = np.abs(fq - ff) / np.maximum(np.abs(ff), 1e-9)
    print(f"sim_demo_int8: total-flux error against the float forward, mean {rel.mean()}, max {rel.max()}")
    assert rel.mean() < 5e-2


# --------------------------------------------------------------- the field


def _field(size=96, bands=3, seed=4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    field = 0.02 * rng.normal(size=(size, size, bands))
    centers = np.array([[-20.0, -18.0], [0.0, 3.0], [15.4, -10.7], [22.0, 25.0]])
    for cy, cx in centers:
        prof = np.exp(-((yy - size // 2 - cy) ** 2 + (xx - size // 2 - cx) ** 2) / (2 * 2.2**2))
        field += rng.uniform(0.5, 2.0) * prof[..., None]
    return field[None].astype(np.float32), centers.astype(np.float32)


@pytest.mark.parametrize("route", ["record_array", "streaming", "record_array_bf16", "streaming_bf16"])
def test_deblend_field_quantized_matches_jax(route):
    """DeblendField(quantized=) on both routes against JAX's
    DeblendField(quantized=) (TINY model, 23-px stamps, z_mode='mean'):
    the catalogue's rows, and the means and residual within LOC_TOL and
    1e-5 of their scales.  ``_bf16``: JAX's bfloat16 bundle, whose serving
    closure is jitted (XLA keeps float32 where the eager forward rounds):
    the means within BF16_ULPS bfloat16 ulps of their scale, the residual
    within as many of the field's."""
    import debvader_tpu as dt
    from debvader_tpu.config import PipelineConfig as JaxPipelineConfig

    route, dtype, _ = _dtype_case(route)
    jmodel, variables, model, _ = _tiny(dtype)
    jqv, tqv = _bundles("per_channel", dtype=dtype)
    field, centers = _field()
    kw = dict(cutout_size=23, nb_of_bands=3, z_mode="mean")
    jdf = dt.DeblendField((jmodel, variables), field, quantized=jqv,
                          cfg=JaxPipelineConfig(cutout_size=23, nb_of_bands=3, interp_order=1), **kw)
    tdf = dtt.DeblendField(model, field, quantized=tqv, device="cpu",
                           cfg=dtt.PipelineConfig(cutout_size=23, nb_of_bands=3, interp_order=1), **kw)
    if route == "record_array":
        want, got = jdf.deblend_field(centers), tdf.deblend_field(centers)
        np.testing.assert_array_equal(got.list_idx, want.list_idx)
        np.testing.assert_array_equal(got.passed_cuts, want.passed_cuts)
        wm, gm = np.stack(list(want.output_images_mean)), np.stack(list(got.output_images_mean))
        wres, gres = jdf.get_residual_field(), tdf.get_residual_field()
    else:
        wcat, wres, wmodel = jdf.deblend_and_render(centers, return_model=True)
        gcat, gres, gmodel = tdf.deblend_and_render(centers, return_model=True)
        np.testing.assert_array_equal(gcat.list_idx, wcat.list_idx)
        wm, gm = np.asarray(wmodel), np.asarray(gmodel)
    err_m, err_r = float(np.abs(gm - wm).max()), float(np.abs(np.asarray(gres) - np.asarray(wres)).max())
    if dtype == "float32":
        assert err_m <= LOC_TOL * float(np.abs(wm).max())
        assert err_r <= 1e-5 * float(np.abs(field).max())
    else:
        print(f"bfloat16 int8 {route}: means {err_m} of {float(np.abs(wm).max())}, residual {err_r} off JAX's")
        assert err_m <= BF16_ULPS * _bf16_ulp(float(np.abs(wm).max()))
        assert err_r <= BF16_ULPS * _bf16_ulp(float(np.abs(field).max()))
