"""The model options of the JAX ``ModelConfig`` in the port, held against
the JAX package on the CPU: ``dtype='bfloat16'`` (layer by layer and the
whole forward, on TINY and on sim_demo), ``decoder_subpixel`` (the pack
functions, each branch of the layers, the whole forward),
``decoder_f32_stages`` (the dtype split), ``strict_cast=False``, the
configuration fields and their validation, ``load_deblender(dtype=)``, one
bfloat16 training step, ``utils/flops`` and the quantized bundles under the
options.  Both sides' JAX forwards are jitted.

Tolerances:

- **bfloat16, layer by layer**: each port layer is fed JAX's bfloat16
  input to it (flax's captured intermediates) and must be within one
  bfloat16 ulp of JAX's output element by element; the share that differs
  at all is printed and bounded by ``LAYER_SHARE`` (read 0.09% at most,
  Dense_0).  A conv or dense layer rounds twice, its contraction and then
  the add of its bias, so its ulp is that of the larger of the output and
  the output less the bias (the rounded contraction): where the bias
  cancels most of the contraction, one ulp of the contraction is several
  of the output (read up to 8 on sim_demo, all within this bound).
- **bfloat16, whole forward**: J = max |JAX bf16 - JAX f32| and P = max
  |port bf16 - JAX f32|, over the float32 output's largest magnitude;
  P <= 1.25 J.  The port against JAX bf16 is pinned: on TINY's 8 stamps
  at most ``TINY_PIN_ERR`` of the scale on at most ``TINY_PIN_SHARE`` of
  the elements (read 0.41% on 0.0079%: one element whose bfloat16
  rounding went the other way, its difference carried through the
  decoder; other seeds read bit for bit), on sim_demo's 4 stamps at most
  ``SIM_PIN_ERR`` on at most ``SIM_PIN_SHARE`` (read 0.575% on 3.3%).  The
  port's float32 forward, and a bias folded into the bfloat16 contraction
  (one rounding where flax has two), must fail the pin.
- **float32 options** (sub-pixel, the f32 stages, strict_cast=False):
  2e-5 of the output's scale against JAX, the bound the float32 forward
  is held to (tests/test_torch_model.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debvader_tpu.config import ModelConfig as JaxModelConfig
from debvader_tpu.models import layers as jlayers
from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
from debvader_tpu.models.vae import init_vae as jax_init_vae

import debvader_tpu_torch as dtt
from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.models import layers as tlayers
from debvader_tpu_torch.models.vae import DeblenderVAE
from debvader_tpu_torch.weights import flatten_flax, state_dict_from_flax

torch.set_num_threads(1)

TINY_KW = dict(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))
LAYER_SHARE = 0.005
TINY_PIN_ERR = 5e-3
TINY_PIN_SHARE = 2e-4
SIM_PIN_ERR = 6.5e-3
SIM_PIN_SHARE = 0.04
F32_REL = 2e-5


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _tiny_flat(seed=0):
    """TINY's init with non-zero alphas and biases, as a flat flax dict."""
    v = jax_init_vae(JaxVAE(JaxModelConfig(**TINY_KW)), jax.random.PRNGKey(seed))
    flat = flatten_flax(jax.tree_util.tree_map(np.asarray, v))
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("alpha") or k.endswith("bias"):
            flat[k] = (0.1 * rng.normal(size=flat[k].shape)).astype(np.float32)
    return flat


def _pair(flat, **kw):
    """(JAX model, JAX variables, port model) of one configuration on the
    same weights."""
    jm = JaxVAE(JaxModelConfig(**kw))
    cfg = ModelConfig(**kw)
    tm = DeblenderVAE(cfg)
    tm.load_state_dict(state_dict_from_flax(flat, cfg))
    return jm, _unflatten(flat), tm.eval()


def _jax_loc(jm, variables, x):
    return np.asarray(jax.jit(lambda v, x: jm.apply(v, x, z_mode="mean")[0].loc)(variables, x))


def _port_loc(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x), z_mode="mean")[0].loc.numpy()


def _stamps(n, size, bands, seed=1):
    return np.random.default_rng(seed).normal(size=(n, size, size, bands)).astype(np.float32)


@pytest.fixture(scope="module")
def sim_demo_flat():
    from debvader_tpu.training.checkpoint import load_weights

    return flatten_flax(jax.tree_util.tree_map(np.asarray, load_weights("sim_demo")))


@pytest.fixture(scope="module")
def sim_stamps():
    from debvader_tpu_torch.data.simulate import simulate_batch

    return simulate_batch(3, 4)[0].astype(np.float32)


# ----------------------------------------------------------- configuration


@pytest.mark.parametrize(
    "extra",
    [
        dict(kl_weight=0.05),
        dict(dtype="bfloat16"),
        dict(strict_cast=False),
        dict(decoder_subpixel=True),
        dict(decoder_f32_stages=2),
        dict(dtype="bfloat16", decoder_f32_stages=4, matmul_precision="high", layer_precision={"dec/Conv_0": "bf16x9"}),
    ],
)
def test_config_carries_every_jax_field(extra):
    jcfg = JaxModelConfig(**extra)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    assert [f.name for f in dataclasses.fields(cfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.asdict(cfg) == {k: (tuple(v) if isinstance(v, list) else v)
                                      for k, v in dataclasses.asdict(jcfg).items()}
    assert cfg.compute_dtype == getattr(torch, jcfg.dtype)


def test_config_validation_as_jax():
    for bad in (-1, 5):
        with pytest.raises(ValueError) as j:
            JaxModelConfig(decoder_f32_stages=bad)
        with pytest.raises(ValueError) as t:
            ModelConfig(decoder_f32_stages=bad)
        assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="dtype must be 'float32' or 'bfloat16'"):
        ModelConfig(dtype="float16")
    # the positional order is JAX's
    assert ModelConfig(59, 6, 32, (32,), (3,), 1e-4, 1e-5, 0.01, "bfloat16").dtype == "bfloat16"


# ------------------------------------------------------- bfloat16, layers


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |a| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0**-126))) - 7)


def _nhwc(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _port_layer_out(module, inp_nhwc, conv):
    x = torch.from_numpy(inp_nhwc)
    if conv:
        x = x.permute(0, 3, 1, 2)
    x = x.to(torch.bfloat16)
    with torch.no_grad():
        y = module(x)
    assert y.dtype == torch.bfloat16, module
    y = y.to(torch.float32)
    return (y.permute(0, 2, 3, 1) if conv else y).numpy()


def _layer_pairs(tm, jinter, x, z):
    """(name, port module, JAX input NHWC, JAX output, is-spatial) for every
    layer of the bfloat16 forward."""
    enc, dec = jinter["encoder"], jinter["decoder"]
    out = lambda node, name: _nhwc(node[name]["__call__"][0])  # noqa: E731
    n = len(tm.encoder.convs)
    rows = [("enc/BatchNorm_0", tm.encoder.bn, x, out(enc, "BatchNorm_0"), True)]
    prev = out(enc, "BatchNorm_0")
    for i in range(n):
        rows.append((f"enc/Conv_{i}", tm.encoder.convs[i], prev, out(enc, f"Conv_{i}"), True))
        rows.append((f"enc/PReLU_{i}", tm.encoder.prelus[i], out(enc, f"Conv_{i}"), out(enc, f"PReLU_{i}"), True))
        prev = out(enc, f"PReLU_{i}")
    flat = prev.reshape(prev.shape[0], -1)
    rows.append((f"enc/PReLU_{n}", tm.encoder.flat_prelu, flat, out(enc, f"PReLU_{n}"), False))
    rows.append(("enc/Dense_0", tm.encoder.dense, out(enc, f"PReLU_{n}"), out(enc, "Dense_0"), False))
    rows.append(("dec/PReLU_0", tm.decoder.prelu_in, z, out(dec, "PReLU_0"), False))
    rows.append(("dec/Dense_0", tm.decoder.dense0, out(dec, "PReLU_0"), out(dec, "Dense_0"), False))
    rows.append(("dec/PReLU_1", tm.decoder.prelu0, out(dec, "Dense_0"), out(dec, "PReLU_1"), False))
    w = tm.decoder.width
    prev = out(dec, "PReLU_2").reshape(-1, w, w, tm.cfg.filters[-1])
    for j in range(n):
        name = f"ConvTranspose2DTF_{j}"
        rows.append((f"dec/{name}", tm.decoder.convts[j], prev, out(dec, name), True))
        rows.append((f"dec/PReLU_{j + 3}", tm.decoder.prelus[j], out(dec, name), out(dec, f"PReLU_{j + 3}"), True))
        prev = out(dec, f"PReLU_{j + 3}")
    rows.append(("dec/Conv_0", tm.decoder.head, prev, out(dec, "Conv_0"), True))
    return rows


def _bf16_layers(flat, x, **kw):
    jm, variables, tm = _pair(flat, **kw)

    def fwd(v, x):
        _, st = jm.apply(v, x, z_mode="mean", mutable=["intermediates"], capture_intermediates=True)
        z = jm.apply(v, x, method=lambda m, x: m.encode(x).mean())
        return st["intermediates"], z

    jinter, z = jax.jit(fwd)(variables, x)
    shares = {}
    for name, module, inp, want, conv in _layer_pairs(tm, jinter, x, np.asarray(z)):
        if isinstance(module, tlayers.PReLU) and conv:
            got = _port_layer_out(module, inp.transpose(0, 3, 1, 2), False).transpose(0, 2, 3, 1)
        elif isinstance(module, tlayers.BatchNorm):
            with torch.no_grad():
                got = module(torch.from_numpy(inp).to(torch.bfloat16).permute(0, 3, 1, 2))
            got = got.to(torch.float32).permute(0, 2, 3, 1).numpy()
        else:
            got = _port_layer_out(module, inp, conv)
        assert got.shape == want.shape, name
        ulp = _bf16_ulp(want)
        bias = getattr(module, "bias", None)
        if bias is not None and not isinstance(module, tlayers.BatchNorm):
            contraction = want - bias.detach().to(torch.bfloat16).float().numpy()
            ulp = np.maximum(ulp, _bf16_ulp(contraction))
        diff = np.abs(got - want)
        assert np.all(diff <= ulp), (name, float((diff / ulp).max()))
        shares[name] = float(np.mean(diff != 0))
    print("share of each bfloat16 layer's outputs one ulp off JAX's:", shares)
    assert max(shares.values()) <= LAYER_SHARE
    return shares


def test_bf16_layers_tiny():
    _bf16_layers(_tiny_flat(), _stamps(4, 23, 3), **TINY_KW, dtype="bfloat16")


def test_bf16_layers_sim_demo(sim_demo_flat, sim_stamps):
    _bf16_layers(sim_demo_flat, sim_stamps[:2], dtype="bfloat16")


# ------------------------------------------------ bfloat16, whole forward


def _errors(flat, x, tm=None, **kw):
    """(J, P, port-vs-JAX error, share differing), errors over the float32
    output's scale."""
    jm, variables, port = _pair(flat, **kw)
    jm32 = JaxVAE(JaxModelConfig(**{**kw, "dtype": "float32"}))
    j16 = _jax_loc(jm, variables, x)
    j32 = _jax_loc(jm32, variables, x)
    p16 = _port_loc(tm if tm is not None else port, x)
    scale = np.abs(j32).max()
    return (np.abs(j16 - j32).max() / scale, np.abs(p16 - j32).max() / scale,
            np.abs(p16 - j16).max() / scale, float(np.mean(p16 != j16)))


def test_bf16_forward_tiny():
    flat, x = _tiny_flat(), _stamps(8, 23, 3)
    j, p, err, share = _errors(flat, x, **TINY_KW, dtype="bfloat16")
    print(f"TINY bf16: J {j}, P {p}, port vs JAX {err} on {share}")
    assert p <= 1.25 * j
    assert err <= TINY_PIN_ERR and share <= TINY_PIN_SHARE


def test_bf16_forward_sim_demo(sim_demo_flat, sim_stamps):
    j, p, err, share = _errors(sim_demo_flat, sim_stamps, dtype="bfloat16")
    print(f"sim_demo bf16: J {j}, P {p}, port vs JAX {err} on {share}")
    assert p <= 1.25 * j
    assert err <= SIM_PIN_ERR and share <= SIM_PIN_SHARE


def test_bf16_pin_controls(sim_demo_flat, sim_stamps, monkeypatch):
    """The pins catch what they are there for: the float32 forward in place
    of the bfloat16 one on sim_demo, and a bias folded into the bfloat16
    contraction on TINY."""
    f32 = DeblenderVAE(ModelConfig())
    f32.load_state_dict(state_dict_from_flax(sim_demo_flat, ModelConfig()))
    _, _, err, share = _errors(sim_demo_flat, sim_stamps, tm=f32.eval(), dtype="bfloat16")
    print(f"control, float32 port forward: {err} on {share}")
    assert not (err <= SIM_PIN_ERR and share <= SIM_PIN_SHARE)

    def folded(x, weight, bias, dtype, fn):
        return fn(x.to(dtype), weight.to(dtype), bias.to(dtype))

    monkeypatch.setattr(tlayers, "_contract", folded)
    _, _, err, share = _errors(_tiny_flat(), _stamps(8, 23, 3), **TINY_KW, dtype="bfloat16")
    print(f"control, bias folded: {err} on {share}")
    assert not (err <= TINY_PIN_ERR and share <= TINY_PIN_SHARE)


def test_bf16_load_deblender_and_flux_calibration(sim_stamps):
    """load_deblender(dtype=, decoder_f32_stages=) builds the config before
    loading, and the bf16 flux gain is measured against the float32
    'highest' forward, as JAX's attach_flux_calibration measures it."""
    from debvader_tpu.training.checkpoint import load_deblender as jax_load
    from debvader_tpu.utils.flux_cal import compute_flux_calibration

    net = dtt.load_deblender("sim_demo", device="cpu", dtype="bfloat16", decoder_f32_stages=1)
    assert net.cfg.dtype == "bfloat16" and net.cfg.decoder_f32_stages == 1
    jm, jv = jax_load("sim_demo", dtype="bfloat16")
    from debvader_tpu_torch.utils.flux_cal import compute_flux_calibration as port_gain

    tnet = dtt.load_deblender("sim_demo", device="cpu", dtype="bfloat16")
    want = np.asarray(compute_flux_calibration(jm, jv, n=16))
    got = port_gain(tnet, n=16).numpy()
    print("bf16 flux gain, JAX then port:", want, got)
    assert np.all(np.abs(want - 1) > 1e-5)  # a bf16 model has a gain to measure
    # JAX's gain is drawn on its own simulated stamps; both are the same
    # arithmetic property of the bf16 layers
    np.testing.assert_allclose(got, want, atol=3e-3)


# ----------------------------------------------------------- sub-pixel


def test_pack_functions_equal_jax():
    rng = np.random.default_rng(0)
    w_tf = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)  # (kh, kw, out, in)
    w_fwd = rng.normal(size=(3, 3, 7, 5)).astype(np.float32)  # HWIO
    for name, w in [("pack_subpixel_kernel", w_tf), ("pack_subpixel_kernel_s1", w_tf),
                    ("pack_subpixel_kernel_fwd", w_fwd)]:
        want = np.asarray(getattr(jlayers, name)(jnp.asarray(w)))
        got = getattr(tlayers, name)(torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError, match="3x3"):
        tlayers.pack_subpixel_kernel(torch.zeros(5, 5, 2, 2))


@pytest.mark.parametrize(
    "stride,size", [(2, 8), (2, 7), (1, 8), (1, 7)], ids=["s2", "s2-odd", "s1-even", "s1-odd-fallback"]
)
def test_subpixel_convt_branches_equal_jax(stride, size):
    rng = np.random.default_rng(stride * 10 + size)
    cin, cout = 6, 5
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    w_tf = (0.3 * rng.normal(size=(3, 3, cout, cin))).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    jmod = jlayers.ConvTranspose2DTF(cout, (3, 3), strides=(stride, stride), subpixel=True)
    want = np.asarray(jax.jit(jmod.apply)({"params": {"kernel": w_tf, "bias": b}}, x))
    mod = tlayers.ConvTranspose2dTF(cin, cout, 3, stride, subpixel=True)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w_tf).permute(3, 2, 0, 1))
        mod.bias.copy_(torch.from_numpy(b))
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_REL * scale)


@pytest.mark.parametrize("size", [8, 7], ids=["even", "odd-fallback"])
def test_subpixel_head_equals_jax(size):
    rng = np.random.default_rng(size)
    cin, cout = 4, 6
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    w = (0.3 * rng.normal(size=(3, 3, cin, cout))).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    want = np.asarray(jax.jit(jlayers.SubpixelConv2D(cout).apply)({"params": {"kernel": w, "bias": b}}, x))
    mod = tlayers.SubpixelConv2d(cin, cout)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        mod.bias.copy_(torch.from_numpy(b))
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_REL * np.abs(want).max())


@pytest.mark.parametrize(
    "extra",
    [dict(decoder_subpixel=True), dict(strict_cast=False), dict(decoder_f32_stages=2)],
    ids=["subpixel", "strict_cast_off", "f32_stages"],
)
def test_float32_options_forward_equal_jax(sim_demo_flat, sim_stamps, extra):
    jm, variables, tm = _pair(sim_demo_flat, **extra)
    want = _jax_loc(jm, variables, sim_stamps)
    got = _port_loc(tm, sim_stamps)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_REL * np.abs(want).max())
    assert isinstance(tm.decoder.head, tlayers.SubpixelConv2d) == bool(extra.get("decoder_subpixel"))


def test_bf16_subpixel_and_strict_cast_off_tiny():
    """The bf16 forward with the sub-pixel layers and with dec/Dense_1 in
    bfloat16, on TINY: P <= 1.25 J and the port within TINY's pin of
    JAX's bfloat16 forward."""
    flat, x = _tiny_flat(1), _stamps(4, 23, 3, seed=2)
    for extra in (dict(decoder_subpixel=True), dict(strict_cast=False)):
        j, p, err, share = _errors(flat, x, **TINY_KW, dtype="bfloat16", **extra)
        print(extra, f"J {j}, P {p}, port vs JAX {err} on {share}")
        assert p <= 1.25 * j and err <= TINY_PIN_ERR and share <= TINY_PIN_SHARE, extra


@pytest.mark.parametrize(
    "layer_precision",
    [{"dec/Conv_0": "bf16x3", "enc/Conv_1": "bf16x9", "dec/Dense_0": "bf16x6"}, {"dec/ConvT_1": "bf16x3t"}],
    ids=["schemes", "truncating"],
)
def test_bf16_forward_with_limb_schemes(layer_precision):
    """Limb-scheme layers take no dtype (JAX's MP layers contract float32
    limbs of a bf16 input and return float32): the bf16 forward with some
    of them, P <= 1.25 J and the port differing from JAX's bf16 forward on
    at most TINY's pinned share (read 0 and 0.016%)."""
    flat, x = _tiny_flat(4), _stamps(8, 23, 3, seed=9)
    j, p, err, share = _errors(flat, x, **TINY_KW, dtype="bfloat16", layer_precision=layer_precision)
    print(layer_precision, f"J {j}, P {p}, port vs JAX {err} on {share}")
    assert p <= 1.25 * j and share <= TINY_PIN_SHARE


# ------------------------------------------------------- the f32 stages


def test_decoder_f32_stages_dtype_split():
    """Under dtype='bfloat16' with decoder_f32_stages=1 every decoder layer
    emits the dtype JAX's does (JAX's test_decoder_f32_stages_mixed_precision
    reads the same split); the flag leaves the float32 model unchanged."""
    flat = _tiny_flat(2)
    x = _stamps(2, 23, 3)
    jm, variables, tm = _pair(flat, **TINY_KW, dtype="bfloat16", decoder_f32_stages=1)
    _, st = jm.apply(variables, x, z_mode="mean", mutable=["intermediates"], capture_intermediates=True)
    dec = st["intermediates"]["decoder"]
    seen = {}
    hooks = [m.register_forward_hook(lambda mod, i, o, n=name: seen.__setitem__(n, o.dtype))
             for name, m in [(f"ConvTranspose2DTF_{j}", c) for j, c in enumerate(tm.decoder.convts)]
             + [("Conv_0", tm.decoder.head), ("Dense_1", tm.decoder.dense1), ("Dense_0", tm.decoder.dense0)]]
    _port_loc(tm, x)
    for h in hooks:
        h.remove()
    for name, dtype in seen.items():
        want = dec[name]["__call__"][0].dtype
        assert str(dtype).replace("torch.", "") == str(want), name
    assert seen["ConvTranspose2DTF_0"] == torch.bfloat16 and seen["ConvTranspose2DTF_3"] == torch.float32
    base = _pair(flat, **TINY_KW)[2]
    split = _pair(flat, **TINY_KW, decoder_f32_stages=2)[2]
    np.testing.assert_array_equal(_port_loc(split, x), _port_loc(base, x))


# ------------------------------------------------------------ training


def test_bf16_train_step_terms_as_jax(monkeypatch):
    """One training step of the bfloat16 TINY model from the same
    parameters and eps: the loss terms within 2e-3 of JAX's (bfloat16
    forwards; read 4.1e-4 at most, the nll), the train-mode BatchNorm statistics taken
    in float32 within 1e-6, and Adam on float32 parameters."""
    from debvader_tpu.config import TrainConfig as JaxTrainConfig
    from debvader_tpu.training import train as jtrain

    from debvader_tpu_torch.config import TrainConfig
    from debvader_tpu_torch.training import train as tt

    kw = dict(TINY_KW, dtype="bfloat16")
    jcfg, tcfg = JaxTrainConfig(batch_size=8), TrainConfig(batch_size=8)
    flat = _tiny_flat(3)
    jstate = jtrain.create_train_state(JaxVAE(JaxModelConfig(**kw)), jcfg, rng=jax.random.PRNGKey(0),
                                       variables=_unflatten(flat))
    tstate = tt.create_train_state(DeblenderVAE(ModelConfig(**kw)), tcfg, variables=flat, device="cpu")
    rng = np.random.default_rng(4)
    y = np.abs(rng.normal(size=(8, 23, 23, 3))).astype(np.float32)
    x = (y + 0.05 * rng.normal(size=y.shape)).astype(np.float32)
    eps = np.asarray(jax.random.normal(jax.random.split(jstate.rng)[0], (8, 4)))
    monkeypatch.setattr(tt, "_latent_noise", lambda gen, shape, like: torch.from_numpy(eps))
    jnew, jterms = jtrain.make_train_step(JaxVAE(JaxModelConfig(**kw)), jcfg, donate=False)(
        jstate, jnp.asarray(x), jnp.asarray(y))
    tstate, tterms = tt.make_train_step(tcfg)(tstate, torch.from_numpy(x), torch.from_numpy(y))
    for k in jterms:
        rel = abs(float(tterms[k]) / float(jterms[k]) - 1)
        print(f"bf16 step: {k} relative difference {rel}")
        assert rel <= 2e-3, k
    got = tstate.variables()
    want = flatten_flax({"batch_stats": jax.device_get(jnew.batch_stats)})
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    assert all(p.dtype == torch.float32 for p in tstate.module.parameters())
    assert all(m.dtype == torch.float32 for m in tstate.mu.values())


# --------------------------------------------------------------- flops


@pytest.mark.parametrize(
    "kw", [dict(), dict(stamp_size=45), TINY_KW], ids=["default", "45x45x6", "tiny"]
)
def test_flops_equal_jax(kw):
    from debvader_tpu.utils import flops as jflops

    from debvader_tpu_torch.utils import flops

    assert flops.per_layer_macs(ModelConfig(**kw)) == jflops.per_layer_macs(JaxModelConfig(**kw))
    assert flops.forward_macs(ModelConfig(**kw)) == jflops.forward_macs(JaxModelConfig(**kw))


# ---------------------------------------------------- quantized bundles


def test_quantized_bundle_options():
    """A float32 bundle whose config says decoder_subpixel=True (and
    strict_cast=False, another kl_weight) serves bit for bit the int8
    forward of the same bundle without them, as JAX's int8 forward reads
    none of them; a bfloat16 bundle's config loads, and quantize_vae of a
    bfloat16 model gives a bundle whose int8 layers round in bfloat16
    (dec/Dense_1 in float32 under strict_cast) and serves finite
    outputs."""
    from debvader_tpu.models import quantized as jq

    from debvader_tpu_torch.models import quantized as tq

    qv = tq.load_quantized("sim_demo_int8", device="cpu")
    cfg = dataclasses.replace(qv.cfg, decoder_subpixel=True, strict_cast=False, kl_weight=0.05)
    model = DeblenderVAE(cfg)
    model.load_state_dict(qv.model.state_dict())
    qv_sub = dataclasses.replace(qv, model=model.eval(), _layers={})
    x = np.random.default_rng(5).normal(size=(3, 59, 59, 6)).astype(np.float32)
    a = tq.quantized_forward(qv, x, z_mode="mean")[0].loc
    b = tq.quantized_forward(qv_sub, x, z_mode="mean")[0].loc
    np.testing.assert_array_equal(b.numpy(), a.numpy())
    # the float forward of the same weights differs: the option is live there
    with torch.no_grad():
        assert not torch.equal(model(torch.from_numpy(x), z_mode="mean")[0].loc,
                               qv.model(torch.from_numpy(x), z_mode="mean")[0].loc)
    # and JAX's int8 forward does not read the options either
    jqv = jq.load_quantized(str(_jax_bundle_dir()))
    jcfg = dataclasses.replace(jqv.model.cfg, decoder_subpixel=True, strict_cast=False, kl_weight=0.05)
    jqv_sub = dataclasses.replace(jqv, model=JaxVAE(jcfg))
    ja = jq.quantized_forward(jqv, x, jax.random.PRNGKey(0), z_mode="mean")[0].loc
    jb = jq.quantized_forward(jqv_sub, x, jax.random.PRNGKey(0), z_mode="mean")[0].loc
    np.testing.assert_array_equal(np.asarray(jb), np.asarray(ja))

    meta = tq._meta(qv_sub)
    assert meta["model_cfg"]["decoder_subpixel"] is True
    assert tq._port_cfg(meta["model_cfg"]) == cfg
    assert tq._port_cfg(dict(meta["model_cfg"], dtype="bfloat16")) == dataclasses.replace(cfg, dtype="bfloat16")
    bf = DeblenderVAE(dataclasses.replace(qv.cfg, dtype="bfloat16"))
    bf.load_state_dict(qv.model.state_dict())
    qbf = tq.quantize_vae(bf.eval(), x)
    layers = qbf.int8_layers()
    assert {n: (l.dtype, l.out_dtype) for n, l in layers.items() if n != "dec/Dense_1"} == dict.fromkeys(
        set(layers) - {"dec/Dense_1"}, (torch.bfloat16, torch.bfloat16))
    assert (layers["dec/Dense_1"].dtype, layers["dec/Dense_1"].out_dtype) == (torch.float32, torch.bfloat16)
    loc = tq.quantized_forward(qbf, x, z_mode="mean")[0].loc
    assert loc.dtype == torch.float32 and bool(torch.isfinite(loc).all())


def _jax_bundle_dir():
    from pathlib import Path

    import debvader_tpu

    return Path(debvader_tpu.__file__).resolve().parent / "data" / "weights" / "sim_demo_int8"
