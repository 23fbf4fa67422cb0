"""TF 'SAME' padding inside the convolution (models/layers.py ``conv2d_same``).

Where the SAME pads are symmetric on both axes, ``conv2d_same`` hands them
to the convolution as its own ``padding``; the (0, 1) pads of stride 2 on
an even input are still materialised with ``F.pad``.  Both routes sum the
same products, so on the CPU the results are held bit for bit to the
explicit pad written out here, at each of the nine geometries of the
default model (the eight encoder convs and the band head), and the whole
model and a training step's gradients to the same model with the explicit
pad patched back in.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import debvader_tpu_torch as dtt
from debvader_tpu_torch.models import layers
from debvader_tpu_torch.models.layers import conv2d_same
from debvader_tpu_torch.training.train import make_loss_fn

torch.set_num_threads(1)

# (in channels, out channels, input size, stride, SAME pads (lo, hi)) of
# enc/Conv_0 ... enc/Conv_7 and the band head dec/Conv_0
GEOMETRIES = [
    (6, 32, 59, 1, (1, 1)),
    (32, 32, 59, 2, (1, 1)),
    (32, 64, 30, 1, (1, 1)),
    (64, 64, 30, 2, (0, 1)),
    (64, 128, 15, 1, (1, 1)),
    (128, 128, 15, 2, (1, 1)),
    (128, 256, 8, 1, (1, 1)),
    (256, 256, 8, 2, (0, 1)),
    (32, 12, 64, 1, (1, 1)),
]


def _explicit_pad(x, weight, stride, bias=None):
    """The pad-then-convolve form: TF SAME's (lo, hi) pads along each axis
    (lo = total // 2, the extra pixel at the bottom and right), written
    out, then an unpadded convolution."""
    k = weight.shape[-1]
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), weight, bias, stride=stride)


def _counts():
    return conv2d_same.in_conv, conv2d_same.pad_copies


@pytest.mark.parametrize("with_bias", (False, True), ids=("no_bias", "bias"))
@pytest.mark.parametrize("channels_last", (False, True), ids=("contiguous", "channels_last"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("float32", "bfloat16"))
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: f"{g[0]}to{g[1]}@{g[2]}s{g[3]}")
def test_conv2d_same_equals_the_explicit_pad(geometry, dtype, channels_last, with_bias):
    cin, cout, size, stride, _ = geometry
    gen = torch.Generator().manual_seed(cin * 1000 + size * 10 + stride)
    x = torch.randn(3, cin, size, size, generator=gen).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w = (torch.randn(cout, cin, 3, 3, generator=gen) / (3 * cin**0.5)).to(dtype)
    b = torch.randn(cout, generator=gen).to(dtype) if with_bias else None
    got = conv2d_same(x, w, stride, b)
    want = _explicit_pad(x, w, stride, b)
    assert got.dtype == want.dtype and got.shape == want.shape == (3, cout, -(-size // stride), -(-size // stride))
    assert torch.equal(got, want)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: f"{g[0]}@{g[2]}s{g[3]}")
def test_the_route_follows_the_same_geometry(geometry):
    cin, cout, size, stride, (lo, hi) = geometry
    before = _counts()
    conv2d_same(torch.zeros(1, cin, size, size), torch.zeros(cout, cin, 3, 3), stride)
    in_conv, pad_copies = (a - b for a, b in zip(_counts(), before))
    assert (in_conv, pad_copies) == ((1, 0) if lo == hi else (0, 1))


def test_rectangular_input_pads_each_axis_on_its_own():
    """A 15 x 30 input at stride 2 pads (1, 1) rows and (0, 1) columns: not
    symmetric on both axes, so the pad is materialised."""
    x, w = torch.randn(2, 4, 15, 30), torch.randn(5, 4, 3, 3)
    before = _counts()
    got = conv2d_same(x, w, 2)
    assert _counts()[1] - before[1] == 1
    assert torch.equal(got, _explicit_pad(x, w, 2))


@pytest.fixture(scope="module")
def sim_demo_models():
    return {
        "float32": dtt.load_deblender("sim_demo", device="cpu"),
        "bfloat16": dtt.load_deblender("sim_demo", device="cpu", dtype="bfloat16"),
        "float32_subpixel": dtt.load_deblender("sim_demo", device="cpu",
                                               cfg=dtt.ModelConfig(decoder_subpixel=True)),
    }


def _stamps(n, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:59, :59] - 29.0
    prof = np.exp(-(yy**2 + xx**2) / (2 * 3.0**2))
    amp = rng.uniform(0.1, 1.0, (n, 1, 1, 6))
    noisy = amp * prof[None, :, :, None] + 0.02 * rng.normal(size=(n, 59, 59, 6))
    return torch.from_numpy(noisy.astype(np.float32))


@pytest.mark.parametrize("name,want_counts", [("float32", (7, 2)), ("bfloat16", (7, 2)),
                                              ("float32_subpixel", (6, 2))])
def test_one_forward_counts_the_routes_and_equals_the_explicit_pad(sim_demo_models, monkeypatch, name,
                                                                    want_counts):
    """One forward of the default model pads inside 7 convs (the stride-1
    ones and enc/Conv_1, enc/Conv_5 on odd inputs) and copies 2 pads
    (enc/Conv_3, enc/Conv_7); the sub-pixel head packs its own pad.  Its
    loc and scale are those of the explicit pad's forward."""
    net = sim_demo_models[name]
    x = _stamps(4)
    before = _counts()
    with torch.no_grad():
        got, _ = net(x, z_mode="mean")
    assert tuple(a - b for a, b in zip(_counts(), before)) == want_counts
    monkeypatch.setattr(layers, "conv2d_same", _explicit_pad)
    with torch.no_grad():
        want, _ = net(x, z_mode="mean")
    assert torch.equal(got.loc, want.loc)
    assert torch.equal(got.scale, want.scale)


def test_training_gradients_equal_the_explicit_pads(monkeypatch):
    """A train-mode loss's gradients through in-conv padding against the
    explicit pad's.  The backward of a padded convolution may sum in
    another order than that of F.pad and an unpadded one, so each gradient
    is held to float32 ordering: 1e-5 of its largest element."""
    net = dtt.load_deblender("sim_demo", device="cpu").train()
    x = _stamps(4, seed=1)
    y = _stamps(4, seed=2)
    eps = torch.randn(4, net.cfg.latent_dim, generator=torch.Generator().manual_seed(3))
    loss_fn = make_loss_fn()
    params = [p for p in net.parameters() if p.requires_grad]

    def grads():
        state = {k: v.clone() for k, v in net.state_dict().items()}
        loss, _ = loss_fn(net, x, y, eps, 0)
        g = torch.autograd.grad(loss, params)
        net.load_state_dict(state)
        return loss.detach(), g

    loss, got = grads()
    monkeypatch.setattr(layers, "conv2d_same", _explicit_pad)
    loss_p, want = grads()
    assert torch.equal(loss, loss_p)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * max(scale, 1e-30)
