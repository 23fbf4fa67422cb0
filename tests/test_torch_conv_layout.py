"""The activation layout of the stamp forward's convolutions
(models/layers.py ``conv_input``) on the CPU.

A convolution's input is cast to its compute dtype and laid out for its
engines: on a card NCHW-dense in float32 (cuDNN's float32 engines are
NCHW ones), as it comes in bfloat16 (channels-last, for the bf16
tensor-core kernels).  With the CPU let onto the card's rule (the
``card_rule`` fixture), for the float32, bfloat16, bfloat16 with
``decoder_f32_stages=2`` and float32 ``decoder_subpixel`` models:

- forward pre-hooks on every ``Conv2dSame`` / ``ConvTranspose2dTF`` see
  each layer's input as it arrives, and a wrapped ``F.conv2d`` /
  ``F.conv_transpose2d`` what reaches the convolution: float32 layers
  convolve NCHW-dense inputs, bfloat16 ones channels-last;
- ``conv_input``'s counters read, a forward, 17 NCHW / 0 channels-last
  and 2 copies (enc/Conv_0's input and dec/ConvT_0's reshaped one) in
  float32, 0 / 17 / 0 in bfloat16, 5 / 12 / 0 with two float32 stages
  (their first input is cast and laid out in one copy);
- the forward that autograd records (training) takes the same layouts as
  the one under ``no_grad``;
- the output is (N, S, S, B) float32 with its bands innermost, and its
  values are those of the same forward with every input left in the
  layout it comes in, to float32 summation order.

Off the seam the CPU keeps every input as it comes (its convolutions sum
on channels-last as the JAX package's XLA ones do), and the forward is
bit for bit the cast-only one.  ``conv_input`` alone on each case of its
rule; a precision-scheme layer takes its input as it comes, uncounted.
"""

import pytest
import torch
import torch.nn.functional as F

from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.models import layers
from debvader_tpu_torch.models import vae as tvae

torch.set_num_threads(1)

BATCH = 2
MODELS = {
    "float32": {},
    "bfloat16": {"dtype": "bfloat16", "strict_cast": True},
    "bf16_f32_stages_2": {"dtype": "bfloat16", "strict_cast": True, "decoder_f32_stages": 2},
    "float32_subpixel": {"decoder_subpixel": True},
}
# conv_input's (nchw, channels_last, copies) a forward under the card's
# rule, and on the CPU (the sub-pixel layers' depth-to-space writes NCHW)
COUNTS = {
    "float32": (17, 0, 2),
    "bfloat16": (0, 17, 0),
    "bf16_f32_stages_2": (5, 12, 0),
    "float32_subpixel": (17, 0, 2),
}
CPU_COUNTS = {
    "float32": (0, 17, 0),
    "bfloat16": (0, 17, 0),
    "bf16_f32_stages_2": (0, 17, 0),
    "float32_subpixel": (8, 9, 0),
}


def _layout(t):
    if t.is_contiguous():
        return "nchw"
    if t.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    return "strided"


def _model(options, seed=28):
    net = tvae.init_vae(tvae.DeblenderVAE(ModelConfig(**options)), seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("bias", "alpha")):
                p.uniform_(-0.3, 0.3)
    return net.eval()


def _stamps(seed=11):
    gen = torch.Generator().manual_seed(seed)
    cfg = ModelConfig()
    return torch.randn(BATCH, cfg.stamp_size, cfg.stamp_size, cfg.nb_of_bands, generator=gen) * 0.2


def _convs(net):
    """The 17 convolutions in the order the forward runs them."""
    return [*net.encoder.convs, *net.decoder.convts, net.decoder.head]


def _counters():
    c = layers.conv_input
    return c.nchw, c.channels_last, c.copies


@pytest.fixture
def card_rule(monkeypatch):
    """The CPU let onto the card's rule: float32 inputs NCHW-dense."""
    monkeypatch.setattr(layers, "_nchw_engines", lambda x: True)


def _cast_only(x, dtype, param):
    return x.to(param.dtype if dtype == torch.float32 else dtype)


@pytest.fixture
def seen(monkeypatch):
    """What the convolutions receive: {"conv": [(layout, dtype)]} of every
    F.conv2d / F.conv_transpose2d call, in order."""
    got = {"conv": []}

    def wrap(op):
        def run(x, *args, **kwargs):
            got["conv"].append((_layout(x), x.dtype))
            return op(x, *args, **kwargs)
        return run

    monkeypatch.setattr(F, "conv2d", wrap(F.conv2d))
    monkeypatch.setattr(F, "conv_transpose2d", wrap(F.conv_transpose2d))
    return got


def _forward(net, seen, grad=False):
    """One forward's (layer input layouts, conv input layouts, counters,
    output); ``grad`` records it with autograd, the input requiring a
    gradient as in training."""
    arrived = []
    hooks = [m.register_forward_pre_hook(lambda m, a: arrived.append(_layout(a[0]))) for m in _convs(net)]
    seen["conv"].clear()
    before = _counters()
    x = _stamps()
    try:
        if grad:
            with torch.enable_grad():
                dist, _ = net(x.requires_grad_(), z_mode="mean")
        else:
            with torch.no_grad():
                dist, _ = net(x, z_mode="mean")
    finally:
        for h in hooks:
            h.remove()
    counts = tuple(a - b for a, b in zip(_counters(), before))
    return arrived, list(seen["conv"]), counts, dist


def _conv_layout(module):
    """The layout a convolution of this layer runs on: its compute dtype's."""
    return "channels_last" if module.dtype == torch.bfloat16 else "nchw"


@pytest.mark.parametrize("name", list(MODELS))
def test_each_convolution_runs_on_its_dtypes_layout(name, card_rule, seen):
    net = _model(MODELS[name])
    arrived, convs, counts, dist = _forward(net, seen)
    modules = _convs(net)
    assert [layout for layout, _ in convs] == [_conv_layout(m) for m in modules]
    assert counts == COUNTS[name]
    assert sum(counts[:2]) == len(convs) == 17
    # the layer inputs as they arrive: the forward's float32 activations
    # are NCHW but for the two inputs the rule copies; bfloat16 ones
    # channels-last throughout; a float32 stage's first input comes from a
    # bfloat16 layer
    if name.startswith("float32"):
        assert arrived == ["channels_last"] + ["nchw"] * 7 + ["channels_last"] + ["nchw"] * 8
    elif name == "bfloat16":
        assert arrived == ["channels_last"] * 17
    else:
        assert arrived == ["channels_last"] * 13 + ["nchw"] * 4
    assert tuple(dist.loc.shape) == tuple(dist.scale.shape) == (BATCH, 59, 59, 6)
    assert dist.loc.dtype == dist.scale.dtype == torch.float32
    assert dist.loc.stride()[-1] == dist.scale.stride()[-1] == 1


@pytest.mark.parametrize("name", list(MODELS))
def test_the_recorded_forward_takes_the_same_layouts(name, card_rule, seen):
    net = _model(MODELS[name])
    served = _forward(net, seen)
    recorded = _forward(net, seen, grad=True)
    assert recorded[3].loc.requires_grad
    assert recorded[:3] == served[:3]
    assert torch.equal(recorded[3].loc.detach(), served[3].loc)
    assert torch.equal(recorded[3].scale.detach(), served[3].scale)


@pytest.mark.parametrize("name", list(MODELS))
def test_values_are_those_of_the_inputs_left_as_they_come(name, card_rule, monkeypatch):
    """The layout moves no value beyond float32 summation order: against
    the same forward whose convolutions take every input in the layout it
    comes in (the CPU's convolutions sum in another order for another
    layout, so 1e-5 of the output's scale)."""
    net = _model(MODELS[name])
    with torch.no_grad():
        got, _ = net(_stamps(), z_mode="mean")
        monkeypatch.setattr(layers, "conv_input", _cast_only)
        want, _ = net(_stamps(), z_mode="mean")
    for g, w in ((got.loc, want.loc), (got.scale, want.scale)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if name == "bfloat16":
            assert torch.equal(g, w)
        else:
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def _counted(x, dtype, param):
    before = _counters()
    y = layers.conv_input(x, dtype, param)
    return y, tuple(a - b for a, b in zip(_counters(), before))


@pytest.mark.parametrize("name", list(MODELS))
def test_the_cpu_keeps_each_input_as_it_comes(name, seen, monkeypatch):
    """Off the seam: no copy, the counters read the layouts as they come,
    and the forward is bit for bit the cast-only one's."""
    net = _model(MODELS[name])
    arrived, convs, counts, got = _forward(net, seen)
    assert [layout for layout, _ in convs] == arrived
    assert counts == CPU_COUNTS[name]
    assert tuple(got.loc.shape) == (BATCH, 59, 59, 6) and got.loc.stride()[-1] == 1
    monkeypatch.setattr(layers, "conv_input", _cast_only)
    with torch.no_grad():
        want, _ = net(_stamps(), z_mode="mean")
    assert torch.equal(got.loc, want.loc) and torch.equal(got.scale, want.scale)


@pytest.mark.parametrize("case", ["nchw_kept", "channels_last_copied", "bf16_kept", "bf16_to_f32_cast",
                                  "f32_to_bf16_cast", "float64_params"])
def test_conv_input_rule(case, card_rule):
    x = torch.randn(2, 8, 5, 5)
    cl = x.contiguous(memory_format=torch.channels_last)
    w32 = torch.zeros(4, 8, 3, 3)
    if case == "nchw_kept":
        y, counts = _counted(x, torch.float32, w32)
        assert y is x and counts == (1, 0, 0)
    elif case == "channels_last_copied":
        y, counts = _counted(cl, torch.float32, w32)
        assert y.is_contiguous() and torch.equal(y, x) and counts == (1, 0, 1)
    elif case == "bf16_kept":
        y, counts = _counted(cl.bfloat16(), torch.bfloat16, w32)
        assert y.dtype == torch.bfloat16 and _layout(y) == "channels_last" and counts == (0, 1, 0)
    elif case == "bf16_to_f32_cast":  # a float32 stage after a bfloat16 one: one copy, not counted
        y, counts = _counted(cl.bfloat16(), torch.float32, w32)
        assert y.dtype == torch.float32 and y.is_contiguous() and counts == (1, 0, 0)
        assert torch.equal(y, cl.bfloat16().float())
    elif case == "f32_to_bf16_cast":
        y, counts = _counted(cl, torch.bfloat16, w32)
        assert y.dtype == torch.bfloat16 and _layout(y) == "channels_last" and counts == (0, 1, 0)
    else:  # "float32" means the parameters' dtype: a .double() model runs NCHW float64
        y, counts = _counted(cl, torch.float32, w32.double())
        assert y.dtype == torch.float64 and y.is_contiguous() and counts == (1, 0, 0)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("kind", ["conv", "transposed"])
def test_a_scheme_layer_takes_its_input_as_it_comes(kind, layout, card_rule, seen):
    """The rule is the scheme-less layers': a precision-scheme layer
    convolves its float32 limbs in the layout that arrives, uncounted."""
    cls = layers.Conv2dSame if kind == "conv" else layers.ConvTranspose2dTF
    layer = cls(8, 4, 3, 2, scheme="bf16x3")
    x = torch.randn(2, 8, 9, 9, generator=torch.Generator().manual_seed(7))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    before = _counters()
    with torch.no_grad():
        layer(x)
    assert _counters() == before
    assert seen["conv"] and {got for got, _ in seen["conv"]} == {layout}
