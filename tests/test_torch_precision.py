"""The port's precision schemes, flux calibration, simulated stamps and
fidelity-precision tail pair, held against the JAX package on the CPU.

Both frameworks get the same numpy inputs.  The explicit bf16-limb schemes
compute the same exact products on both sides (a bf16 x bf16 product is
exact in float32), so outputs differ only by the order of the float32
sums: 2e-6 of the output scale for one layer, 2e-5 for a whole model (the
bound tests/test_torch_model.py holds the float32 model to).  Limbs are
pure bit manipulation and must be bit-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import debvader_tpu_torch as dtt
from debvader_tpu.config import ModelConfig as JaxModelConfig
from debvader_tpu.config import fidelity_serving_config as jax_fidelity_serving_config
from debvader_tpu.models import precision as jmp
from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
from debvader_tpu.models.vae import init_vae
from debvader_tpu_torch.config import FIDELITY_NEEDS_FLUX_CAL, ModelConfig, fidelity_serving_config
from debvader_tpu_torch.kernels.tail_fused import fused_tail_pair, tail_pair_params, tail_pair_plain
from debvader_tpu_torch.models import precision as mp
from debvader_tpu_torch.models.layers import Conv2dSame, ConvTranspose2dTF, Dense
from debvader_tpu_torch.utils.flux_cal import (
    apply_flux_calibration,
    attach_flux_calibration,
    compute_flux_calibration,
    flux_gain,
)
from debvader_tpu_torch.weights import flatten_flax, state_dict_from_flax

torch.set_num_threads(1)

TINY_KW = dict(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))
TINY_KEYS = (
    [f"enc/Conv_{i}" for i in range(4)]
    + ["enc/Dense_0", "dec/Dense_0", "dec/Dense_1"]
    + [f"dec/ConvT_{i}" for i in range(4)]
    + ["dec/Conv_0"]
)


def _close(got, want, rel):
    """|got - want| <= rel * max|want| elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _perturbed(variables, seed):
    """Init values plus noise (init leaves PReLU alphas and biases at 0),
    positive BatchNorm variances."""
    rng = np.random.default_rng(seed)
    flat = flatten_flax(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k, v in flat.items():
        noise = 0.05 * rng.normal(size=v.shape).astype(np.float32)
        out[k] = (np.abs(v) + 0.5 + noise if k.endswith("/var") else v + noise).astype(np.float32)
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.fixture(scope="module")
def tiny():
    flat = _perturbed(init_vae(JaxVAE(JaxModelConfig(**TINY_KW)), jax.random.PRNGKey(0)), seed=0)
    # keep every output band above the head's ReLU, so each has flux to calibrate
    flat["params/decoder/Conv_0/bias"] = flat["params/decoder/Conv_0/bias"] + np.float32(0.5)
    x = np.random.default_rng(0).normal(size=(4, 23, 23, 3)).astype(np.float32)
    return flat, _unflatten(flat), x


def _torch_loc(cfg, flat, x):
    net = dtt.DeblenderVAE(cfg).eval()
    net.load_state_dict(state_dict_from_flax(flat, cfg))
    with torch.no_grad():
        return net(torch.from_numpy(x), z_mode="mean")[0].loc.numpy()


def _uniform(rung):
    return {k: rung for k in TINY_KEYS}


# ------------------------------------------------------------------ limbs


@pytest.mark.parametrize("mode", ["rne", "rtz"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_split_limbs_bit_identical_to_jax(mode, n):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4096,)) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0, -3.0]
    want = jmp.split_limbs(jnp.asarray(x), n, mode)
    got = mp.split_limbs(torch.from_numpy(x), n, mode)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w32 = np.asarray(w.astype(jnp.float32))
        np.testing.assert_array_equal(g.numpy().view(np.int32), w32.view(np.int32))
        # every limb is bf16-valued
        np.testing.assert_array_equal(g.numpy().view(np.int32) & 0xFFFF, 0)


@pytest.mark.parametrize("mode", ["rne", "rtz"])
def test_split_limbs_reconstructs_exactly(mode):
    x = (np.random.default_rng(3).normal(size=(256,)) * 100).astype(np.float32)
    limbs = mp.split_limbs(torch.from_numpy(x), 3, mode)
    total = sum(l.numpy().astype(np.float64) for l in limbs)
    np.testing.assert_array_equal(total.astype(np.float32), x)


def test_split_limbs_rejects_unknown_mode():
    with pytest.raises(ValueError, match="split mode"):
        mp.split_limbs(torch.ones(3), 2, "up")


def test_scheme_tables_equal_jax():
    assert mp.SCHEMES == jmp.SCHEMES
    assert mp.EMULATION == jmp.EMULATION
    assert mp.NATIVE_RUNGS == jmp.NATIVE_RUNGS


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("scheme", sorted(mp.SCHEMES))
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_scheme_matches_mpconv(scheme, stride):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 11, 11, 5)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 5, 7)) * 0.3).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    want = jmp.MPConv(7, (3, 3), strides=(stride, stride), scheme=scheme).apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}, jnp.asarray(x)
    )
    layer = Conv2dSame(5, 7, 3, stride, scheme=scheme)
    layer.load_state_dict({"weight": torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.numpy(), want, 2e-6)


@pytest.mark.parametrize("scheme", sorted(mp.SCHEMES))
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_transpose_scheme_matches_mpconvtranspose(scheme, stride):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 6, 6, 5)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 7, 5)) * 0.3).astype(np.float32)  # TF (kh, kw, out, in)
    b = rng.normal(size=(7,)).astype(np.float32)
    want = jmp.MPConvTranspose2DTF(7, (3, 3), strides=(stride, stride), scheme=scheme).apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}, jnp.asarray(x)
    )
    layer = ConvTranspose2dTF(5, 7, 3, stride, scheme=scheme)
    layer.load_state_dict({"weight": torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    # the bias is large beside the products: added once, not once a term
    _close(got.numpy(), want, 2e-6)


@pytest.mark.parametrize("scheme", sorted(mp.SCHEMES))
def test_dense_scheme_matches_mpdense(scheme):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    k = (rng.normal(size=(40, 9)) * 0.3).astype(np.float32)
    b = rng.normal(size=(9,)).astype(np.float32)
    want = jmp.MPDense(9, scheme=scheme).apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}, jnp.asarray(x)
    )
    layer = Dense(40, 9, scheme=scheme)
    layer.load_state_dict({"kernel": torch.from_numpy(k), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    _close(got.numpy(), want, 2e-6)


def test_layers_reject_unknown_scheme():
    with pytest.raises(ValueError, match="scheme"):
        Dense(3, 3, scheme="bf16x7")


# ------------------------------------------------------------ whole model


@pytest.mark.parametrize(
    "kw",
    [
        dict(layer_precision=_uniform("bf16x1")),
        dict(layer_precision=_uniform("bf16x3t")),
        dict(layer_precision=_uniform("bf16x3")),
        dict(layer_precision=_uniform("bf16x6")),
        dict(layer_precision=_uniform("bf16x9")),
        dict(matmul_precision="high", limb_emulation=True),  # fidelity_serving_config, emulated
        dict(matmul_precision="high"),  # a native rung is float32 on both sides
        dict(matmul_precision="highest", layer_precision={"dec/ConvT_3": "bf16x3", "dec/Conv_0": "bf16x3"}),
    ],
    ids=["bf16x1", "bf16x3t", "bf16x3", "bf16x6", "bf16x9", "fidelity-emulated", "native-high", "mixed"],
)
def test_tiny_model_matches_jax_under_schemes(tiny, kw):
    flat, variables, x = tiny
    want = JaxVAE(JaxModelConfig(**TINY_KW, **kw)).apply(variables, jnp.asarray(x), z_mode="mean")[0].loc
    got = _torch_loc(ModelConfig(**TINY_KW, **kw), flat, x)
    _close(got, want, 2e-5)


def test_fidelity_serving_config_equals_jax():
    ours = fidelity_serving_config(limb_emulation=True)
    theirs = jax_fidelity_serving_config(limb_emulation=True)
    for name in ("matmul_precision", "layer_precision", "limb_emulation", "stamp_size", "filters"):
        assert getattr(ours, name) == getattr(theirs, name)
    assert fidelity_serving_config().matmul_precision == "high"
    assert FIDELITY_NEEDS_FLUX_CAL is True


def test_scheme_ladder_orders(tiny):
    """More terms -> closer to float32; the truncating split is worse than
    the rounding one at the same number of terms."""
    flat, _, x = tiny
    ref = _torch_loc(ModelConfig(**TINY_KW), flat, x)
    err = {
        rung: float(np.abs(_torch_loc(ModelConfig(**TINY_KW, layer_precision=_uniform(rung)), flat, x) - ref).max())
        for rung in ("bf16x1", "bf16x3t", "bf16x3", "bf16x6")
    }
    assert err["bf16x1"] > err["bf16x3t"] > err["bf16x3"] > err["bf16x6"]
    exact = _torch_loc(ModelConfig(**TINY_KW, layer_precision=_uniform("bf16x9")), flat, x)
    assert float(np.abs(exact - ref).max()) < 1e-5 * float(np.abs(ref).max())


def test_resolve_mapping():
    assert mp.resolve(ModelConfig(), "enc/Conv_0") == (None, None)
    assert mp.resolve(ModelConfig(matmul_precision="high"), "enc/Conv_0") == ("high", None)
    cfg_emul = ModelConfig(matmul_precision="high", limb_emulation=True)
    assert mp.resolve(cfg_emul, "enc/Conv_0") == (None, "bf16x3t")
    assert mp.resolve(ModelConfig(limb_emulation=True), "dec/Dense_1") == (None, "bf16x1")
    cfg_mix = ModelConfig(matmul_precision="high", layer_precision={"enc/Conv_0": "bf16x4", "enc/Conv_2": "highest"})
    assert mp.resolve(cfg_mix, "enc/Conv_0") == (None, "bf16x4")
    assert mp.resolve(cfg_mix, "enc/Conv_1") == ("high", None)
    assert mp.resolve(cfg_mix, "enc/Conv_2") == ("highest", None)
    # the scheme column agrees with the JAX package's for every key
    jcfg = JaxModelConfig(matmul_precision="high", layer_precision={"enc/Conv_0": "bf16x4"}, limb_emulation=True)
    tcfg = ModelConfig(matmul_precision="high", layer_precision={"enc/Conv_0": "bf16x4"}, limb_emulation=True)
    for key in sorted(tcfg.precision_layer_keys()):
        assert mp.resolve(tcfg, key)[1] == jmp.resolve(jcfg, key)[1]


def test_layer_precision_validation():
    with pytest.raises(ValueError, match="layer_precision"):
        ModelConfig(layer_precision={"enc/Conv_0": "bf16x7"})
    with pytest.raises(ValueError, match="matmul_precision"):
        ModelConfig(matmul_precision="medium")
    # a dict is canonicalised to sorted pairs, and pairs pass through replace()
    cfg = ModelConfig(layer_precision={"enc/Conv_1": "high", "dec/Conv_0": "bf16x3"})
    assert cfg.layer_precision == (("dec/Conv_0", "bf16x3"), ("enc/Conv_1", "high"))
    assert dataclasses.replace(cfg, limb_emulation=True).layer_precision == cfg.layer_precision
    assert cfg.layer_rung("dec/Conv_0") == "bf16x3" and cfg.layer_rung("enc/Conv_0") is None


def test_layer_precision_rejects_unknown_keys():
    with pytest.raises(ValueError, match="names no MXU layer"):
        ModelConfig(layer_precision={"dec/Convt_0": "highest"})
    with pytest.raises(ValueError, match="names no MXU layer"):
        ModelConfig(layer_precision={"dec/ConvT_8": "high"})
    cfg = ModelConfig()
    assert cfg.precision_layer_keys() == JaxModelConfig().precision_layer_keys()
    ModelConfig(layer_precision={k: "high" for k in cfg.precision_layer_keys()})


def test_state_dict_unchanged_across_precision_configs():
    plain = dtt.DeblenderVAE(ModelConfig(**TINY_KW)).state_dict()
    for kw in (dict(layer_precision=_uniform("bf16x9")), dict(matmul_precision="high", limb_emulation=True)):
        other = dtt.DeblenderVAE(ModelConfig(**TINY_KW, **kw)).state_dict()
        assert list(other) == list(plain)
        assert all(other[k].shape == plain[k].shape for k in plain)
    assert "flux_cal_scale" not in plain


# -------------------------------------------------------------- tail pair


def _tail_inputs(B, H, W, CIN, C1, C2, seed=0):
    rng = np.random.default_rng(seed)
    return [
        np.asarray(v, np.float32)
        for v in (
            rng.normal(size=(B, H, W, CIN)),
            rng.normal(size=(3, 3, CIN, C1)) * 0.1,
            rng.normal(size=(C1,)) * 0.1,
            rng.normal(size=(H, W, C1)) * 0.2,
            rng.normal(size=(3, 3, C1, C2)) * 0.1,
            rng.normal(size=(C2,)) * 0.1,
        )
    ]


@pytest.mark.parametrize("B,H,W,tile", [(1, 16, 16, 16), (2, 32, 32, 16), (1, 24, 16, 16)])
def test_tail_pair_plain_matches_pallas_interpret(B, H, W, tile):
    from debvader_tpu.kernels.tail_fused import fused_tail_pair as jax_tail
    from debvader_tpu.kernels.tail_fused import fused_tail_pair_reference

    args = _tail_inputs(B, H, W, 8, 8, 4)
    jargs = [jnp.asarray(a) for a in args]
    got = fused_tail_pair(*[torch.from_numpy(a) for a in args]).numpy()
    # same limbs and products as the Pallas kernel, another order of sums
    _close(got, jax_tail(*jargs, tile=tile, interpret=True), 2e-6)
    # against the float32 chain: the scheme's own error, the JAX test's bound
    _close(got, fused_tail_pair_reference(*jargs), 5e-5)


def test_tail_pair_border_zeroing():
    """The second SAME conv must see zeros outside the image, not the first
    conv's values there: a constant input shows any leak at the border."""
    from debvader_tpu.kernels.tail_fused import fused_tail_pair_reference

    args = _tail_inputs(1, 16, 16, 8, 8, 4, seed=3)
    args[0] = np.ones_like(args[0])
    ref = fused_tail_pair_reference(*[jnp.asarray(a) for a in args])
    got = tail_pair_plain(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-4, atol=5e-5)


def test_tail_pair_params_reproduce_the_decoder_tail():
    """tail_pair_params + fused_tail_pair equal the model's own last two
    layers when those run under bf16x3 (the transposed conv as a SAME conv
    with flipped taps)."""
    cfg = ModelConfig(**TINY_KW, layer_precision={"dec/ConvT_3": "bf16x3", "dec/Conv_0": "bf16x3"})
    net = dtt.DeblenderVAE(cfg).eval()
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    caught = {}
    pre = net.decoder.convts[-1].register_forward_pre_hook(lambda m, a: caught.update(x=a[0]))
    post = net.decoder.head.register_forward_hook(lambda m, a, out: caught.update(y=out))
    with torch.no_grad():
        net.decode(torch.randn((3, 4), generator=gen))
    pre.remove()
    post.remove()
    got = fused_tail_pair(caught["x"].permute(0, 2, 3, 1), *tail_pair_params(net.decoder))
    want = torch.relu(caught["y"]).permute(0, 2, 3, 1)
    _close(got.numpy(), want.numpy(), 2e-6)


def test_tail_pair_checks_shapes():
    args = [torch.from_numpy(a) for a in _tail_inputs(1, 8, 8, 4, 4, 2)]
    with pytest.raises(ValueError, match="alpha1"):
        fused_tail_pair(args[0], args[1], args[2], args[3][:4], args[4], args[5])
    with pytest.raises(ValueError, match="x must be"):
        fused_tail_pair(args[0][0], *args[1:])


# ------------------------------------------------------- flux calibration


def test_flux_calibration_attach_and_apply(tiny):
    """deblend() honours an attached calibration: outputs divide by the
    per-band gain; without one the forward is unchanged.  Under the native
    rungs the model and its reference are the same float32 arithmetic, so
    the measured gain is 1."""
    flat, _, x = tiny
    cfg = ModelConfig(**TINY_KW)
    net = dtt.DeblenderVAE(cfg).eval()
    net.load_state_dict(state_dict_from_flax(flat, cfg))
    base, _ = dtt.deblend(net, x, z_mode="mean", device="cpu")
    attach_flux_calibration(net, n=8)
    scale = net.flux_cal_scale.numpy()
    assert scale.shape == (3,)
    np.testing.assert_allclose(scale, 1.0, atol=1e-6)
    out, _ = dtt.deblend(net, x, z_mode="mean", device="cpu")
    np.testing.assert_allclose(out, base / scale, rtol=1e-6)
    # a non-unit gain divides out of loc and scale, band by band
    attach_flux_calibration(net, scale=[0.5, 1.0, 2.0])
    out2, dist2 = dtt.deblend(net, x, z_mode="mean", device="cpu")
    np.testing.assert_allclose(out2, base / np.asarray([0.5, 1.0, 2.0], np.float32), rtol=1e-6)
    net.flux_cal_scale = None
    _, dist0 = dtt.deblend(net, x, z_mode="mean", device="cpu")
    np.testing.assert_allclose(
        dist2.scale.numpy(), dist0.scale.numpy() / np.asarray([0.5, 1.0, 2.0], np.float32), rtol=1e-6
    )
    with pytest.raises(ValueError, match="entries"):
        attach_flux_calibration(net, scale=[1.0, 2.0])


def test_flux_calibration_follows_the_state_dict(tiny):
    flat, _, _ = tiny
    cfg = ModelConfig(**TINY_KW)
    with_cal = dict(flat, **{"flux_cal/scale": np.asarray([0.9, 1.0, 1.1], np.float32)})
    sd = state_dict_from_flax(with_cal, cfg)
    net = dtt.DeblenderVAE(cfg)
    net.load_state_dict(sd)
    want = np.asarray([0.9, 1.0, 1.1], np.float32)
    np.testing.assert_array_equal(net.flux_cal_scale.numpy(), want)
    assert "flux_cal_scale" in net.state_dict()
    again = dtt.DeblenderVAE(ModelConfig(**TINY_KW, matmul_precision="high", limb_emulation=True))
    again.load_state_dict(net.state_dict())
    np.testing.assert_array_equal(again.flux_cal_scale.numpy(), want)
    dist = apply_flux_calibration(dtt.models.distributions.PixelNormal(torch.ones(1, 2, 2, 3), torch.ones(1, 2, 2, 3)), again)
    np.testing.assert_allclose(dist.loc[0, 0, 0].numpy(), 1 / want, rtol=1e-6)


def test_tiny_flux_gain_matches_jax_under_emulation(tiny):
    """The gain of the emulated 'high' rung against the emulated 'highest'
    one, on the same stamps, port against JAX.  Tolerance 1e-5 relative:
    where the two frameworks' float32 sums differ in the last bit, a value
    on a limb boundary truncates to the other side and moves its products
    by 2^-16; the gain's own offset from 1 is 1e-4."""
    flat, variables, _ = tiny
    rng = np.random.default_rng(5)
    stamps = np.abs(rng.normal(size=(8, 23, 23, 3))).astype(np.float32)
    kw = dict(matmul_precision="high", limb_emulation=True)
    jmodel = JaxVAE(JaxModelConfig(**TINY_KW, **kw))
    jref = JaxVAE(JaxModelConfig(**TINY_KW, matmul_precision="highest", limb_emulation=True))
    loc = jmodel.apply(variables, jnp.asarray(stamps), z_mode="mean")[0].loc
    ref = jref.apply(variables, jnp.asarray(stamps), z_mode="mean")[0].loc
    want = np.asarray(loc.sum(axis=(0, 1, 2)) / ref.sum(axis=(0, 1, 2)))
    cfg = ModelConfig(**TINY_KW, **kw)
    net = dtt.DeblenderVAE(cfg).eval()
    net.load_state_dict(state_dict_from_flax(flat, cfg))
    got = flux_gain(net, stamps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fidelity_mode_compliant_emulated_full_width():
    """The fidelity serving mode (fidelity_serving_config + flux
    calibration) under limb emulation, at the full width of sim_demo on the
    JAX package's own simulated stamps: the port's calibration equals the
    JAX package's (to 1e-5 relative: limb-boundary flips, as in the tiny
    test above, measured 3.4e-6 here), the raw 'high' rung misses the 1e-4
    flux clause against the float32 model and the calibrated one meets it."""
    import debvader_tpu as dt
    from debvader_tpu.data.simulate import simulate_batch
    from debvader_tpu.utils.flux_cal import compute_flux_calibration as jax_compute

    n = 32
    model, variables = dt.load_deblender("sim_demo")
    jmodel = JaxVAE(jax_fidelity_serving_config(limb_emulation=True))
    want_scale = np.asarray(jax_compute(jmodel, variables, n=n))
    cal_stamps = np.asarray(simulate_batch(jax.random.PRNGKey(11), n)[0], np.float32)
    test_stamps = np.asarray(simulate_batch(jax.random.PRNGKey(7), n)[0], np.float32)

    net = dtt.load_deblender("sim_demo", device="cpu", cfg=fidelity_serving_config(limb_emulation=True))
    scale = flux_gain(net, cal_stamps)
    np.testing.assert_allclose(scale.numpy(), want_scale, rtol=1e-5)
    attach_flux_calibration(net, scale=scale)

    ref_net = dtt.load_deblender("sim_demo", device="cpu")  # true float32
    x = torch.from_numpy(test_stamps)
    with torch.no_grad():
        ref = ref_net(x, z_mode="mean")[0].loc.numpy()
        dist = net(x, z_mode="mean")[0]
        raw = dist.loc.numpy()
        cal = apply_flux_calibration(dist, net).loc.numpy()
    tr = ref.astype(np.float64).sum(axis=(1, 2, 3))

    def max_rel(a):
        return float(np.max(np.abs(a.astype(np.float64).sum(axis=(1, 2, 3)) - tr) / np.abs(tr)))

    raw_err, cal_err = max_rel(raw), max_rel(cal)
    assert raw_err > 1e-4
    assert cal_err < 1e-4
    assert cal_err < raw_err / 2


def test_load_deblender_precision_arguments():
    net = dtt.load_deblender("sim_demo", device="cpu", matmul_precision="high", flux_calibration=False)
    assert net.cfg.matmul_precision == "high" and net.flux_cal_scale is None
    assert net.decoder.head.scheme is None  # a native rung is the float32 layer
    emu = dtt.load_deblender("sim_demo", device="cpu", cfg=fidelity_serving_config(limb_emulation=True))
    assert emu.decoder.head.scheme == "bf16x3t" and emu.encoder.dense.scheme == "bf16x3t"
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(), emu.state_dict().values()))


# --------------------------------------------------------- simulated stamps


def test_simulate_profile_and_psf_match_jax():
    from debvader_tpu.data import simulate as jsim
    from debvader_tpu_torch.data import simulate as tsim

    rng = np.random.default_rng(8)
    for _ in range(3):
        cy, cx = rng.uniform(20, 38, 2)
        flux, r50 = rng.uniform(5, 50), rng.uniform(1.5, 4.0)
        e1, e2 = rng.uniform(-0.3, 0.3, 2)
        bscale = np.exp(rng.uniform(-0.15, 0.15) * np.arange(6)).astype(np.float32)
        want = jsim._profile(59, cy, cx, flux, r50, e1, e2, jnp.asarray(bscale))
        got = tsim._profile(59, cy, cx, flux, r50, e1, e2, bscale)
        _close(got, want, 1e-5)
        _close(tsim._psf_blur(got), jsim._psf_blur(jnp.asarray(got)), 1e-5)


def test_simulate_batch_contract():
    from debvader_tpu.data.simulate import simulate_batch as jax_simulate
    from debvader_tpu_torch.data.simulate import simulate_batch

    blend, iso, clean = simulate_batch(7, 48)
    for a in (blend, iso, clean):
        assert a.shape == (48, 59, 59, 6) and a.dtype == np.float32 and np.isfinite(a).all()
    # seeded: the same seed gives the same stamps, another seed others
    np.testing.assert_array_equal(simulate_batch(7, 48)[0], blend)
    assert not np.array_equal(simulate_batch(8, 48)[0], blend)
    flux = clean.sum(axis=(1, 2, 3)) / 6
    assert flux.min() > 4.0 and flux.max() < 51.0  # flux in [5, 50], a little lost off the stamp
    assert (blend - iso).sum() > 0  # neighbours add light
    assert 0.015 < float((iso - clean).std()) < 0.025  # noise 0.02
    # same distribution as the JAX package's generator: mean flux of the batch
    jflux = np.asarray(jax_simulate(jax.random.PRNGKey(7), 48)[2]).sum(axis=(1, 2, 3)) / 6
    assert abs(flux.mean() - jflux.mean()) < 10.0
    small = simulate_batch(np.random.default_rng(1), 3, stamp=23, bands=3, max_neighbors=1, noise=0.0)
    assert small[0].shape == (3, 23, 23, 3)
    np.testing.assert_array_equal(small[1], small[2])


def test_compute_flux_calibration_uses_simulated_stamps(tiny):
    flat, _, _ = tiny
    cfg = ModelConfig(**TINY_KW, matmul_precision="high", limb_emulation=True)
    net = dtt.DeblenderVAE(cfg).eval()
    net.load_state_dict(state_dict_from_flax(flat, cfg))
    a = compute_flux_calibration(net, n=8, seed=11)
    b = compute_flux_calibration(net, n=8, seed=11)
    assert a.shape == (3,) and torch.equal(a, b) and bool(torch.isfinite(a).all())
