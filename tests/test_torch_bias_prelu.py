"""The one-pass bias and PReLU of the stamp forward (kernels/bias_prelu.py
and its route in models/vae.py) on the CPU.

- The plain version, which CPU tensors take, at the 16 conv layers' and
  the two biased dense layers' shapes at batch 2, in float32 and bfloat16,
  on inputs seeded with NaN, signed zeros, infinities, subnormals and
  exact cancellations of the bias: bit for bit the layers' own ops
  (``PReLU`` after the bias add), and equal, NaN as a class and zeros by
  value, to a numpy reference that rounds each op as the kernel's
  comment states (float32: every op once; bfloat16: the bias, alpha, the
  sum, the product and the result each rounded to bfloat16).  A bfloat16
  control that adds the unrounded bias must differ.  The crop views of the
  transposed convs give what their contiguous copies give.
- The route: with the CPU let onto it, ``Encoder``, ``Decoder`` and
  ``DeblenderVAE`` under ``no_grad`` send every conv, transposed conv and
  biased dense layer through ``bias_prelu`` (18 calls a forward) and are
  ``torch.equal`` to the layer composition as a card computes it: the
  layers' own forwards with ATen's separate add of a convolution's bias
  after the contraction (a CPU convolution folds it into the sum, a
  cuDNN one does not).  Float32, bfloat16 (strict_cast), decoder_f32_stages
  2 and decoder_subpixel.
- A grad-enabled forward takes the layers' ops (no call) and gives the same
  gradients, a tie at zero included; one with nothing that requires a
  gradient takes the route.  CPU tensors (off the test's seam), a
  precision scheme and fake tensors keep the ops; the route calls the
  layer's module, so its hooks run; ``torch.export`` traces the ops (every
  convolution keeps its bias in the graph).
"""

import io

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.kernels import bias_prelu as bp
from debvader_tpu_torch.models import vae as tvae
from debvader_tpu_torch.models.layers import PReLU
from debvader_tpu_torch.utils.export import export_deblender

torch.set_num_threads(1)

CFG = ModelConfig()
BATCH = 2
OPTIONS = {
    "float32": {},
    "bfloat16": {"dtype": "bfloat16", "strict_cast": True},
    "f32_stages_2": {"decoder_f32_stages": 2},
    "subpixel": {"decoder_subpixel": True},
}


def _layer_shapes(cfg):
    """{name: activation shape without the batch} of the 16 conv layers and
    the two biased dense layers that a PReLU follows."""
    shapes, size, cin = {}, cfg.stamp_size, cfg.nb_of_bands
    for i, f in enumerate(cfg.filters):
        shapes[f"enc/Conv_{2 * i}"] = (f, size, size)
        size = -(-size // 2)
        shapes[f"enc/Conv_{2 * i + 1}"] = (f, size, size)
    hidden = cfg.latent_dim + cfg.latent_dim * (cfg.latent_dim + 1) // 2
    shapes["dec/Dense_0"] = (hidden,)
    shapes["dec/Dense_1"] = (size * size * cfg.filters[-1],)
    for j, f in enumerate(reversed(cfg.filters)):
        size *= 2
        shapes[f"dec/ConvT_{2 * j}"] = (f, size, size)
        shapes[f"dec/ConvT_{2 * j + 1}"] = (f, size, size)
    return shapes


SHAPES = _layer_shapes(CFG)
DECODER_CONVS = [k for k in SHAPES if k.startswith("dec/ConvT")]


def test_layer_shapes_are_the_models():
    net = tvae.DeblenderVAE(CFG)
    got = [tuple(a.alpha.shape) for a in [*net.encoder.prelus, net.decoder.prelu0, net.decoder.prelu1,
                                          *net.decoder.prelus]]
    assert got == list(SHAPES.values())


def _inputs(shape, dtype, seed):
    """(y, bias, alpha) with special values seeded into y and the bias."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[0]
    y = torch.randn((BATCH, *shape), generator=gen) * 0.7
    bias = torch.randn(c, generator=gen) * 0.3
    alpha = torch.randn(shape, generator=gen) * 0.4
    flat = y.view(-1)
    picks = torch.randperm(flat.numel(), generator=gen)[:64]
    specials = [float("nan"), 0.0, -0.0, float("inf"), -float("inf"), 1e-40, -1e-40, 3e-39, -7e-41]
    for k, p in enumerate(picks[: len(specials) * 4].tolist()):
        flat[p] = specials[k % len(specials)]
    y = y.to(dtype)
    # exact cancellations: t = y + bias is exactly 0 where y = -bias
    per = y[0].reshape(c, -1)
    per[:, 0] = -bias.to(dtype)
    bias[: min(c, 3)] = torch.tensor([0.0, -0.0, 1e-40])[: min(c, 3)]
    return y, bias, alpha


def _round_bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32; NaN kept."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), x, rounded)


def _numpy_reference(y, bias, alpha, low):
    y = y.float().numpy()
    view = (-1,) + (1,) * (y.ndim - 2)
    b = bias.numpy().reshape(view)
    a = alpha.numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        if low:
            t = _round_bf16(y + _round_bf16(b))
            lo = np.where(np.isnan(t), t, np.minimum(t, np.float32(0)))
            hi = np.where(np.isnan(t), t, np.maximum(t, np.float32(0)))
            return _round_bf16(hi + _round_bf16(_round_bf16(a) * lo))
        t = y + b
        lo = np.where(np.isnan(t), t, np.minimum(t, np.float32(0)))
        hi = np.where(np.isnan(t), t, np.maximum(t, np.float32(0)))
        return hi + a * lo


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _composition(y, bias, alpha):
    """The layers' ops: the bias cast to y's dtype and added, then PReLU."""
    act = PReLU(alpha.shape)
    with torch.no_grad():
        act.alpha.copy_(alpha)
        return act(y + bias.to(y.dtype).view((-1,) + (1,) * (y.ndim - 2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("layer", list(SHAPES))
def test_plain_version_is_the_layer_ops(layer, dtype):
    y, bias, alpha = _inputs(SHAPES[layer], dtype, seed=len(layer) + 7 * list(SHAPES).index(layer))
    kept = y.clone()
    got = bp.bias_prelu(y, bias, alpha)
    assert got.dtype == dtype and got.shape == y.shape
    assert torch.equal(_bits(y), _bits(kept))  # the CPU version leaves y as it was
    assert torch.equal(_bits(got), _bits(_composition(y, bias, alpha)))
    want = _numpy_reference(y, bias, alpha, dtype == torch.bfloat16)
    assert np.array_equal(got.float().numpy(), want, equal_nan=True)
    assert torch.isnan(got).any() and (got == 0).any() and torch.isinf(got).any()
    if dtype == torch.bfloat16:
        # the bias added unrounded (y + b rounded once) is another result
        t = (y.float() + bias.view((-1,) + (1,) * (y.ndim - 2))).to(dtype)
        control = _composition(t, torch.zeros_like(bias), alpha)
        assert not torch.equal(control.float().nan_to_num(7.0), got.float().nan_to_num(7.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("layer", DECODER_CONVS)
def test_plain_version_reads_a_crop_view(layer, dtype):
    """A TF transposed conv's output is a crop of the full one (stride 2:
    the last row and column cut; stride 1: a one-pixel ring)."""
    c, h, w = SHAPES[layer]
    stride2 = int(layer.rsplit("_", 1)[1]) % 2 == 0
    y, bias, alpha = _inputs((c, h, w), dtype, seed=h + c)
    full = torch.randn(BATCH, c, h + (1 if stride2 else 2), w + (1 if stride2 else 2)).to(dtype)
    lo = 0 if stride2 else 1
    full[:, :, lo: lo + h, lo: lo + w] = y
    view = full[:, :, lo: lo + h, lo: lo + w]
    assert not view.is_contiguous()
    got = bp.bias_prelu(view, bias, alpha)
    assert torch.equal(_bits(got.contiguous()), _bits(bp.bias_prelu(y.contiguous(), bias, alpha)))


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("layer", [k for k in SHAPES if "Dense" not in k])
def test_the_kernel_writes_the_plain_results_layout(layer, layout):
    """A dense y (either layout) is written in place; a crop view into a new
    tensor laid out as the plain ops lay out their result.  A thread's
    elements are consecutive in y in place and in a channels-last crop."""
    c, h, w = SHAPES[layer]
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    y, bias, alpha = _inputs((c, h, w), torch.float32, seed=c + h)
    y = y.contiguous(memory_format=fmt)
    want = bp.bias_prelu(y, bias, alpha)
    assert bp.output_like(y) is y and want.stride() == y.stride()
    assert torch.equal(_bits(want.contiguous()), _bits(bp.bias_prelu(y.contiguous(), bias, alpha)))
    assert bp.consecutive(y, y, 4) and bp.consecutive(y, y, 8)
    full = torch.zeros(BATCH, c, h + 2, w + 2).contiguous(memory_format=fmt)
    view = full[:, :, 1: h + 1, 1: w + 1]
    view.copy_(y)
    out = bp.output_like(view)
    assert out is not view and out.stride() == bp.bias_prelu(view, bias, alpha).stride() == y.stride()
    for v in (4, 8):
        assert bp.consecutive(view, out, v) == (layout == "channels_last" and c % v == 0)


def test_bias_prelu_refuses_what_the_kernel_does_not_take():
    y, vec, alpha = torch.zeros(2, 3, 4, 4), torch.zeros(3), torch.zeros(3, 4, 4)
    for call in (
        lambda: bp.bias_prelu(y[0], vec, alpha[0]),
        lambda: bp.bias_prelu(y.half(), vec, alpha),
        lambda: bp.bias_prelu(y, torch.zeros(4), alpha),
        lambda: bp.bias_prelu(y, vec, alpha[:, :2]),
        lambda: bp.bias_prelu(y, vec.double(), alpha),
        lambda: bp.bias_prelu(y, vec.to("meta"), alpha),
        lambda: bp.bias_prelu(y.to("meta"), vec.to("meta"), alpha.to("meta")),
    ):
        with pytest.raises(ValueError):
            call()


# ------------------------------------------------------------- the route


def _model(options, seed=3):
    """The default model with random weights, biases and alphas."""
    torch.manual_seed(seed)
    net = tvae.init_vae(tvae.DeblenderVAE(ModelConfig(**options)), seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("bias", "alpha")):
                p.uniform_(-0.3, 0.3)
    return net.eval()


def _stamps(seed=11):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(BATCH, CFG.stamp_size, CFG.stamp_size, CFG.nb_of_bands, generator=gen) * 0.2


@pytest.fixture
def card_conv_bias(monkeypatch):
    """F.conv2d and F.conv_transpose2d with a bias as ATen runs them on a
    card: the contraction, then a separate add of the bias."""
    fn = torch.nn.functional
    conv, convt = fn.conv2d, fn.conv_transpose2d

    def split(op):
        def run(x, w, b=None, *args, **kwargs):
            y = op(x, w, None, *args, **kwargs)
            return y if b is None else y + b.view(-1, 1, 1)
        return run

    monkeypatch.setattr(fn, "conv2d", split(conv))
    monkeypatch.setattr(fn, "conv_transpose2d", split(convt))


@pytest.fixture
def route(monkeypatch):
    """The CPU let onto the one-pass route; the calls of bias_prelu
    counted."""
    calls = []

    def counted(y, bias, alpha):
        calls.append((tuple(y.shape), y.dtype))
        got = bp.bias_prelu(y, bias, alpha)
        # the tensor the kernel would write has the plain result's layout
        assert bp.output_like(y).stride() == got.stride()
        return got

    card_only = tvae._one_pass

    def on(enabled=True):
        # the route's rule without its device test lets the CPU on
        monkeypatch.setattr(tvae, "_one_pass", tvae._fusable if enabled else card_only)

    monkeypatch.setattr(tvae, "bias_prelu", counted)
    return calls, on


def _outputs(module, kind, x, z):
    if kind == "encoder":
        return (module(x),)
    if kind == "decoder":
        dist = module(z)
        return dist.loc, dist.scale
    dist, post = module(x, z_mode="mean")
    return dist.loc, dist.scale, post.loc, post.scale_tril


@pytest.mark.parametrize("kind", ["encoder", "decoder", "vae"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_route_is_the_layer_composition(option, kind, card_conv_bias, route):
    calls, on = route
    net = _model(OPTIONS[option])
    module = {"encoder": net.encoder, "decoder": net.decoder, "vae": net}[kind]
    x = _stamps()
    z = torch.randn(BATCH, CFG.latent_dim, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = _outputs(module, kind, x, z)
        assert not calls
        on()
        got = _outputs(module, kind, x, z)
    assert len(calls) == {"encoder": 8, "decoder": 10, "vae": 18}[kind]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if option == "bfloat16" and kind != "encoder":
        assert {dtype for _, dtype in calls} == {torch.bfloat16, torch.float32}  # dec/Dense_1 under strict_cast


def test_grad_enabled_forward_keeps_the_ops_and_their_gradients(route):
    """Training's forward and backward, a tie at zero included: the
    PReLU of enc/Conv_0's channel 0 receives exact zeros."""
    calls, on = route

    def grads(enabled):
        on(enabled)
        net = _model({})
        with torch.no_grad():
            net.encoder.convs[0].weight[0].zero_()
            net.encoder.convs[0].bias[0] = 0.0
        caught = {}
        hook = net.encoder.prelus[0].register_forward_pre_hook(lambda m, a: caught.update(x=a[0]))
        dist, post = net(_stamps(), z_mode="mean")
        hook.remove()
        assert (caught["x"][:, 0] == 0).all()
        (dist.loc.sum() + dist.scale.sum() + post.loc.sum()).backward()
        return {k: p.grad.clone() for k, p in net.named_parameters()}

    want = grads(False)
    got = grads(True)
    assert not calls
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert want["encoder.prelus.0.alpha"][0].eq(0).all()  # min(0, 0) = 0 wherever the tie is


def test_grad_enabled_without_parameters_that_need_it_takes_the_route(card_conv_bias, route):
    calls, on = route
    net = _model({}).requires_grad_(False)
    want = net(_stamps(), z_mode="mean")[0].loc
    on()
    got = net(_stamps(), z_mode="mean")[0].loc
    assert torch.is_grad_enabled() and len(calls) == 18 and torch.equal(got, want)


@pytest.mark.parametrize("case", ["cpu", "grad", "scheme", "fake_tensor"])
def test_cpu_grad_schemes_and_fake_tensors_keep_the_ops(case):
    net = _model({})
    conv, act = net.encoder.convs[0], net.encoder.prelus[0]
    x = torch.zeros(1, CFG.nb_of_bands, CFG.stamp_size, CFG.stamp_size)
    with torch.no_grad():
        assert tvae._fusable(x, conv, act)
        if case == "cpu":
            assert not tvae._one_pass(x, conv, act)
        elif case == "scheme":
            conv.scheme = "bf16x3"
            assert not tvae._fusable(x, conv, act)
        elif case == "fake_tensor":
            with FakeTensorMode():
                assert not tvae._fusable(torch.zeros(1, 6, 59, 59), conv, act)
    if case == "grad":  # grad enabled, parameters that need it
        assert not tvae._fusable(x, conv, act)


def test_the_route_calls_the_layers_module(card_conv_bias, route):
    """The route runs the layer through its module (bias=False), so a hook
    on it sees the layer's input as on the ops' route."""
    calls, on = route
    net = _model({})
    seen = []
    hook = net.decoder.convts[-1].register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    with torch.no_grad():
        want = net(_stamps(), z_mode="mean")[0].loc
        on()
        got = net(_stamps(), z_mode="mean")[0].loc
    hook.remove()
    assert len(calls) == 18 and len(seen) == 2 and torch.equal(seen[0], seen[1]) and torch.equal(got, want)


def test_export_traces_the_ops(route):
    """torch.export runs the forward on fake tensors: the route stays off
    and every convolution of the graph keeps its bias."""
    calls, on = route
    on()
    net = _model({}).requires_grad_(False)
    blob = export_deblender(net, z_mode="mean")
    assert not calls
    program = torch.export.load(io.BytesIO(blob))
    convs = [n for n in program.graph.nodes if n.op == "call_function" and "aten.conv" in str(n.target)]
    assert len(convs) == 17  # 8 convs, 8 transposed convs, the band head
    assert all(n.args[2] is not None for n in convs)
