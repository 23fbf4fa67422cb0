"""The PyTorch port's reduced-precision residency held against the JAX
package on the CPU: ``upload_dtype`` / ``device_dtype`` (the host cast, the
memoized field's dtype and bits, validation), the serving chunk cap's
accounting of 2-byte residency and the registration band, the bfloat16
render and place (every add rounded), and the serving and record-array
routes under ``device_dtype='bfloat16'``, with the sim_demo weights and
z_mode='mean'.

What is exact and what is not: the host cast and the memo are
bit-identical to JAX.  XLA keeps the rounding of each shifted stamp to
bfloat16 before its add (no excess precision): where both sides' float32
blend is exact (offsets with fractions 0 and 1/2) the order-1 canvases are
bit-identical.  Elsewhere XLA contracts the float32 blend into fused
multiply-adds, so a third of its values differ from the port's in the last
float32 bit, and a rounding to bfloat16 flips on a few elements (one
bfloat16 ulp of the scale on at most 0.1% of them).  End to end the
model's float32 means differ from JAX's by up to 2e-5 of their scale,
which flips the roundings of small values in the stamps' wings; at order 1
that stays within the 0.1% share.

Order 3 misses the 0.1% share.  The float32 spline patches are JAX's
bit for bit on lines of 43 pixels or more (ops/spline.py follows XLA's
CPU order; on the shorter lines of the render tests below they differ in
the last bits on a few percent of their elements), and given the port's
forward JAX serves the same fields (test_order3_bf16_serving_equals_jax_
given_the_ports_forward); but the model's own float32 means differ from
JAX's, so the bfloat16 roundings of the small values in the wings flip on
up to 8.9% of a served model's elements (39% while the spline's order
differed too).  Those differences are tiny against the scale (at most
2**-6 of a bfloat16 ulp of it), so order 3 is held to the shares read
before and to 2**-5 ulp, and each such test also holds a control: a
float32 canvas rounded to bfloat16 once at the end must fail the same
check.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import debvader_tpu as dt
import debvader_tpu_torch as dtt
from debvader_tpu.config import PipelineConfig as JaxPipelineConfig
from debvader_tpu.ops.shift import render_field as jax_render
from debvader_tpu.pipeline import field as jfield
from debvader_tpu_torch.kernels import render as rd
from debvader_tpu_torch.models import layers as tlayers
from debvader_tpu_torch.ops.shift import render_field
from debvader_tpu_torch.ops.spline import subpixel_shift_spline_const as spline_const
from debvader_tpu_torch.pipeline import field as tfield

torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16


def _blob_field(size=160, bands=6, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    field = 0.02 * rng.normal(size=(size, size, bands))
    centers = np.array([[-30.0, -25.0], [0.0, 3.0], [20.4, -10.7], [35.0, 40.0], [-6.0, 30.0], [70.0, 0.0]])
    for cy, cx in centers:
        s = rng.uniform(1.5, 3.0)
        sed = np.exp(rng.uniform(-0.15, 0.15) * np.arange(bands))
        prof = np.exp(-((yy - size // 2 - cy) ** 2 + (xx - size // 2 - cx) ** 2) / (2 * s * s))
        field += rng.uniform(0.5, 2.0) * prof[..., None] * sed
    return field[None].astype(np.float32), centers.astype(np.float32)


def _bits(a) -> np.ndarray:
    """The raw bits of a bfloat16 / float16 / float32 array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.int16 if a.dtype == torch.float16 else np.int32)
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


# Order 3's limits against JAX, from the readings (tests below): the
# largest difference is 2**-6 of a bfloat16 ulp of the scale, the
# control's 0.5 to 2 ulp.
ORDER3_MAX_ULPS = 2.0**-5

# The readings of the order-3 attribution (Queue 3, item 1): the port's
# model field against JAX's fed its un-jitted forward, and each layer's
# share of output elements off JAX's jitted forward, teacher-forced.
PORT_AGAINST_UNJITTED = 0.0839
# The readings that closed it: JAX's jitted stream (J) and the port's (P)
# against the same stream fed a float64 forward rounded once to float32.
JAX_AGAINST_FLOAT64 = 0.1644
PORT_AGAINST_FLOAT64 = 0.1757
LAYER_SHARES_READ = {
    "enc/BatchNorm_0": 0.78, "enc/Conv_0": 0.0, "enc/Conv_1": 0.0, "enc/Conv_2": 0.0, "enc/Conv_3": 0.8883,
    "enc/Conv_4": 0.8447, "enc/Conv_5": 0.9179, "enc/Conv_6": 0.8993, "enc/Conv_7": 0.9317,
    "enc/Dense_0": 0.8974, "dec/Dense_0": 0.0459, "dec/Dense_1": 0.8203,
    "dec/ConvTranspose2DTF_0": 0.5104, "dec/ConvTranspose2DTF_1": 0.8892, "dec/ConvTranspose2DTF_2": 0.5519,
    "dec/ConvTranspose2DTF_3": 0.8338, "dec/ConvTranspose2DTF_4": 0.5056, "dec/ConvTranspose2DTF_5": 0.7193,
    "dec/ConvTranspose2DTF_6": 0.3439, "dec/ConvTranspose2DTF_7": 0.6908, "dec/Conv_0 (head)": 0.0,
    **{f"enc/PReLU_{i}": 0.0 for i in range(8)}, "enc/PReLU_8 (flatten)": 0.0,
    **{f"dec/PReLU_{i}": 0.0 for i in range(11)},
}


def _ulp_agreement(got, want, max_share=1e-3, max_ulps=1.0):
    """Equal, or within ``max_ulps`` bfloat16 ulp of the scale on at most
    ``max_share`` of the elements; returns the share that differs."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    diff = np.abs(got - want)
    share = float((diff > 0).mean())
    assert float(diff.max()) <= max_ulps * ulp, (float(diff.max()), ulp)
    assert share <= max_share, share
    return share


def _cast_at_end(a) -> np.ndarray:
    """The control: a float32 result rounded to bfloat16 once."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _control_fails(control, want, **limits):
    with pytest.raises(AssertionError):
        _ulp_agreement(_cast_at_end(control), want, **limits)


def _special_values():
    return np.array(
        [np.nan, -np.nan, np.inf, -np.inf, 3.4e38, -3.39e38, 1e-40, -1e-45, -0.0, 0.0,
         1.00390625, 1.01171875, 1.0 + 2**-9, -(1.0 + 3 * 2**-9), 65519.0, 65520.0, 1e5]
        + [np.frombuffer(np.uint32(v).tobytes(), np.float32)[0] for v in (0xFFC00001, 0x7F800001, 0x7FBFFFFF)],
        np.float32,
    )


def test_host_bfloat16_cast_matches_ml_dtypes():
    """Round to nearest even, ties, overflow to inf, denormals, and NaN of
    either sign (torch's own cast drops the sign)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([_special_values(), rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 4096)])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(_bits(tfield._bfloat16_host(x)), _bits(x.astype(BF16)))


@pytest.mark.parametrize(
    "kwargs",
    [
        {"upload_dtype": "bfloat16"},
        {"upload_dtype": "float16"},
        {"device_dtype": "bfloat16"},
        {"device_dtype": "bfloat16", "upload_dtype": "bfloat16"},
    ],
)
def test_memoized_field_dtype_and_bits_match_jax(nets, kwargs):
    """The memo holds the host-cast field: kept reduced under device_dtype,
    widened back to float32 under upload_dtype alone, bit for bit as the
    JAX package's; NaN, infinities and float16 overflow included."""
    jnet, tnet = nets
    field, _ = _blob_field(seed=1)
    special = _special_values()
    field[0, 0, : len(special), 0] = special
    jdf = dt.DeblendField(jnet, field, **kwargs)
    tdf = dtt.DeblendField(tnet, field, device="cpu", **kwargs)
    want = jdf._device_field(jdf.field_image)
    got = tdf._device_field(tdf.field_image)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))
    assert got.dtype == (torch.bfloat16 if "device_dtype" in kwargs else torch.float32)
    assert tdf._canvas_dtype == (torch.bfloat16 if "device_dtype" in kwargs else torch.float32)
    # the memo is keyed on the dtypes: another residency uploads again
    plain = dtt.DeblendField(tnet, field, device="cpu")
    assert plain._device_field(plain.field_image).dtype == torch.float32
    assert got.untyped_storage().nbytes() == field.size * (2 if "device_dtype" in kwargs else 4)


@pytest.mark.parametrize(
    "kwargs, match",
    [
        ({"device_dtype": "float16"}, "device_dtype='float16' is rejected"),
        ({"device_dtype": "bfloat16", "upload_dtype": "float16"}, "conflicts"),
        ({"upload_dtype": "int8"}, "upload_dtype must be 'bfloat16' or 'float16'"),
        ({"device_dtype": "float8"}, "device_dtype must be 'bfloat16' or 'float16'"),
    ],
)
def test_residency_options_are_validated_as_jax_validates_them(nets, kwargs, match):
    jnet, tnet = nets
    field, _ = _blob_field(seed=2)
    with pytest.raises(ValueError, match=match):
        dt.DeblendField(jnet, field, **kwargs)
    with pytest.raises(ValueError, match=match):
        dtt.DeblendField(tnet, field, device="cpu", **kwargs)


@pytest.mark.parametrize(
    "field_size, resident, bytes_per_el, extra",
    [(8192, 2, 4, 0), (12288, 2, 2, 0), (12288, 3, 2, 4 * 12288**2), (16384, 2, 2, 4 * 16384**2), (4096, 4, 4, 0)],
)
def test_serving_chunk_cap_counts_residency_as_jax(monkeypatch, field_size, resident, bytes_per_el, extra):
    """The resident accounting (full-field buffers at bytes_per_el, plus
    the registration band's extra_bytes) is JAX's: with the JAX package's
    per-source bytes and reserve, and snapped down to its buckets, the
    port's cap is JAX's on a 16 GB budget."""
    from debvader_tpu.api import _PADDED_BATCH_BUCKETS

    monkeypatch.setattr(tfield, "_STREAM_BYTES_PER_SOURCE", (5 << 20) // 4)
    monkeypatch.setattr(tfield, "_STREAM_RESERVE_BYTES", 3 << 29)
    monkeypatch.setattr(tfield, "_MIN_STREAM_CHUNK", _PADDED_BATCH_BUCKETS[0])
    hbm = 16 << 30
    cap = tfield._serving_chunk_cap(field_size, 6, hbm, resident, bytes_per_el=bytes_per_el, extra_bytes=extra)
    snapped = max([b for b in _PADDED_BATCH_BUCKETS if b <= cap], default=_PADDED_BATCH_BUCKETS[0])
    want = jfield._serving_chunk_cap(field_size, 6, hbm, resident, bytes_per_el=bytes_per_el, extra_bytes=extra)
    assert snapped == want
    # 2-byte residency leaves more room, the band less
    assert tfield._serving_chunk_cap(field_size, 6, hbm, resident, bytes_per_el=2) >= tfield._serving_chunk_cap(
        field_size, 6, hbm, resident, bytes_per_el=4
    )
    assert tfield._serving_chunk_cap(field_size, 6, hbm, resident, extra_bytes=1 << 30) <= tfield._serving_chunk_cap(
        field_size, 6, hbm, resident
    )


def _numpy_bf16_canvas_loop(canvas, patches, y, x, visible):
    """The reference for the bfloat16 adds: in source order, canvas =
    bf16(canvas + patch) element by element (ml_dtypes rounding)."""
    out = np.asarray(canvas, BF16).copy()
    p = patches.shape[1]
    for i in range(len(y)):
        q = np.where(visible[i], np.asarray(patches[i], BF16), np.zeros((), BF16))
        win = out[y[i] : y[i] + p, x[i] : x[i] + p]
        out[y[i] : y[i] + p, x[i] : x[i] + p] = (win.astype(np.float32) + q.astype(np.float32)).astype(BF16)
    return out


def test_bf16_plain_place_matches_a_numpy_loop():
    rng = np.random.default_rng(3)
    c, p, b, n = 40, 9, 2, 14
    canvas = rng.normal(size=(c, c, b)).astype(np.float32).astype(BF16)
    patches = (rng.normal(size=(n, p, p, b)) * 10.0 ** rng.integers(-3, 3, (n, 1, 1, 1))).astype(np.float32).astype(BF16)
    y, x = rng.integers(0, c - p + 1, n), rng.integers(0, c - p + 1, n)
    visible = rng.uniform(size=n) > 0.2
    want = _numpy_bf16_canvas_loop(canvas, patches, y, x, visible)
    got = torch.from_numpy(canvas.astype(np.float32)).to(torch.bfloat16)
    rd.place_patches(
        got, torch.from_numpy(patches.astype(np.float32)).to(torch.bfloat16), torch.from_numpy(y), torch.from_numpy(x),
        torch.from_numpy(visible),
    )
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_bf16_plain_render_matches_a_numpy_loop():
    """Order 1 into a filled bfloat16 window: each source shifted in
    float32, rounded, and added with a rounding, in source order."""
    rng = np.random.default_rng(4)
    f, s, b, n = 48, 11, 2, 12
    stamps = torch.from_numpy(rng.uniform(0, 3, (n, s, s, b)).astype(np.float32)).to(torch.bfloat16)
    offsets = torch.from_numpy(rng.uniform(-22, 22, (n, 2)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=n) > 0.2)
    out = torch.from_numpy(rng.normal(size=(f, f, b)).astype(np.float32)).to(torch.bfloat16)
    start = out.clone()
    rd.render_field_kernel(stamps, offsets, f, mask, out=out)
    patches, int_off = rd.shift_patches(stamps, offsets, 1, rd.subpixel_shift_const)
    pad = s + 2
    y, x, visible = rd.place_corners(int_off, mask, f, s, 1, f + 2 * pad)
    canvas = np.zeros((f + 2 * pad, f + 2 * pad, b), BF16)
    canvas[pad : pad + f, pad : pad + f] = start.float().numpy().astype(BF16)
    want = _numpy_bf16_canvas_loop(
        canvas, patches.numpy().astype(BF16), y.numpy(), x.numpy(), visible.numpy()
    )[pad : pad + f, pad : pad + f]
    np.testing.assert_array_equal(_bits(out), _bits(want))
    # the float32 sum rounded once is another number
    assert not np.array_equal(_bits(out), _bits((start.float() + rd.render_field_plain(stamps.float(), offsets, f, mask)).to(torch.bfloat16)))


def _bf16_render_pair(order, fractions):
    """JAX's and the port's canvases after two incremental renders of 40
    bfloat16 stamps into one bfloat16 canvas, as the stream renders its
    chunks; and the inputs."""
    rng = np.random.default_rng(5)
    stamps = rng.uniform(0, 1, (40, 21, 21, 2)).astype(np.float32)
    offs = rng.uniform(-20, 20, (40, 2)).astype(np.float32)
    if fractions == "half":
        offs = np.round(2 * offs) / 2
    offs2 = offs[::-1] + 0.5
    jb = jnp.asarray(stamps).astype(jnp.bfloat16)
    want = jax_render(jb, jnp.asarray(offs), 64, order=order, crop=False)
    want = jax_render(jb, jnp.asarray(offs2), 64, order=order, canvas=want, crop=False)
    tb = torch.from_numpy(stamps).to(torch.bfloat16)
    got = render_field(tb, torch.from_numpy(offs), 64, order=order, crop=False)
    got = render_field(tb, torch.from_numpy(offs2), 64, order=order, canvas=got, crop=False)
    assert got.dtype == torch.bfloat16
    return got, np.asarray(want), stamps, (offs, offs2)


@pytest.mark.parametrize("fractions", ["half", "any"])
def test_bf16_order1_render_matches_jax(fractions):
    """With offsets whose fractions are 0 or 1/2 (a float32 blend exact on
    both sides) bit for bit; otherwise within one bf16 ulp of the scale on
    at most 0.1% of the elements (XLA's contracted blend)."""
    got, want, stamps, (offs, _) = _bf16_render_pair(1, fractions)
    if fractions == "half":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        _ulp_agreement(got.float().numpy(), want.astype(np.float32))
    with pytest.raises(ValueError, match="bfloat16 canvas takes bfloat16 stamps"):
        render_field(torch.from_numpy(stamps), torch.from_numpy(offs), 64, order=1, canvas=got, crop=False)


@pytest.mark.parametrize(
    "fractions, max_share", [pytest.param("half", 0.025, id="half"), pytest.param("any", 1e-3, id="any")]
)
def test_bf16_order3_render_rounds_each_add_as_jax(fractions, max_share):
    """Order 3: each side's bfloat16 canvas is, bit for bit, its own
    float32 spline patches rounded and added with a rounding in source
    order (so XLA keeps no excess precision here either).  The two sides'
    float32 splines differ by summation order (up to 5.4e-7, on most
    elements), which flips the rounding of some patch elements to bfloat16
    and so of small values in the canvas: read 2.0% of the elements with
    fractions 0 and 1/2, none otherwise.  A float32 canvas cast at the end
    fails the same check (read: 12% of the elements, 2 ulp)."""
    from debvader_tpu.ops.spline import subpixel_shift_spline_const as jax_spline

    import jax

    got, want, stamps, offsets = _bf16_render_pair(3, fractions)
    s, pad = 21, 21 + 20
    c = 64 + 2 * pad
    jax_canvas = np.zeros((c, c, 2), BF16)
    port_canvas = jax_canvas.copy()
    tb = torch.from_numpy(stamps).to(torch.bfloat16)
    for offs in offsets:
        int_off = np.floor(offs)
        padded = jnp.pad(jnp.asarray(stamps).astype(jnp.bfloat16).astype(jnp.float32), ((0, 0), (10, 10), (10, 10), (0, 0)))
        jp = np.asarray(jax.jit(jax.vmap(jax_spline))(padded, jnp.asarray(offs - int_off)))
        tp, ti = rd.shift_patches(tb, torch.from_numpy(offs), 10, spline_const)
        tp = tp.numpy()
        # the cause: float32 patches a few ulp apart, some roundings flipped
        assert float(np.abs(tp - jp).max()) <= 1e-6
        print(f"order 3 patches, fractions {fractions}: float32 max diff {float(np.abs(tp - jp).max())}, "
              f"float32 share differing {float((tp != jp).mean())}, "
              f"bfloat16 share differing {float((tp.astype(BF16) != jp.astype(BF16)).mean())}")
        y, x, vis = rd.place_corners(ti, None, 64, s, 10, c)
        jax_canvas = _numpy_bf16_canvas_loop(jax_canvas, jp.astype(BF16), y.numpy(), x.numpy(), vis.numpy())
        port_canvas = _numpy_bf16_canvas_loop(port_canvas, tp.astype(BF16), y.numpy(), x.numpy(), vis.numpy())
    np.testing.assert_array_equal(_bits(want), _bits(jax_canvas))
    np.testing.assert_array_equal(_bits(got), _bits(port_canvas))
    limits = {"max_share": max_share, "max_ulps": ORDER3_MAX_ULPS}
    share = _ulp_agreement(got.float().numpy(), want.astype(np.float32), **limits)
    print(f"order 3, fractions {fractions}: share off JAX's {share}")
    f32 = torch.from_numpy(stamps).to(torch.bfloat16).float()
    control = render_field(f32, torch.from_numpy(offsets[0]), 64, order=3, crop=False)
    control = render_field(f32, torch.from_numpy(offsets[1]), 64, order=3, canvas=control, crop=False)
    _control_fails(control.numpy(), want.astype(np.float32), **limits)


@pytest.fixture(scope="module")
def nets():
    return dt.load_deblender("sim_demo"), dtt.load_deblender("sim_demo", device="cpu")


def _pair(nets, field, order, chunk=2, **kwargs):
    jnet, tnet = nets
    jdf = dt.DeblendField(
        jnet, field, z_mode="mean", cfg=JaxPipelineConfig(interp_order=order, source_chunk=chunk), **kwargs
    )
    tdf = dtt.DeblendField(
        tnet, field, z_mode="mean", device="cpu", cfg=dtt.PipelineConfig(interp_order=order, source_chunk=chunk),
        **kwargs,
    )
    return jdf, tdf


class _StandIn:
    """A forward both packages compute bit for bit: mean = cutout / 2,
    stddev = |cutout| / 4 (exact in any float format), non-finite pixels
    as 0."""

    def __init__(self, cut, xp):
        self._cut = xp.where(xp.isfinite(cut), cut, 0.0 * cut)
        self._xp = xp

    def mean(self):
        return self._cut * 0.5

    def stddev(self):
        return self._xp.abs(self._cut) * 0.25


_STREAM_FIELDS = ("residual_field", "predicted_mean_field", "predicted_stddev_field")


def _stream_outputs(df, centers) -> dict:
    _, res, model = df.deblend_and_render(centers, return_model=True)
    _, fields = df.deblend_and_predict(centers)
    return {"residual": res, "model": model, **{k: fields[k] for k in _STREAM_FIELDS}}


@pytest.mark.parametrize("order", [1, 3])
def test_device_dtype_stream_renders_as_jax(nets, monkeypatch, order):
    """The bfloat16 stream on stamps that are bit-identical on both sides
    (a stand-in forward) at offsets with fractions 0 and 1/2, so only the
    residency, the per-add rounding of the canvases and the bfloat16
    subtract can differ: order 1 bit for bit on every field; order 3
    within 2**-5 bf16 ulp of the scale on at most 18% of the elements
    (read: 0 since the spline follows XLA's order; 16.6% before, from its
    summation order), which a float32
    canvas cast at the end fails (read: 19%, 1 ulp)."""
    monkeypatch.setattr(dt.DeblendField, "_batched_forward", lambda self, cut: _StandIn(cut, jnp))
    monkeypatch.setattr(tfield, "deblend_tensor", lambda net, cut, *a: _StandIn(cut, torch))
    field, centers = _blob_field(seed=6)
    centers = np.round(2 * centers) / 2
    jdf, tdf = _pair(nets, field, order, device_dtype="bfloat16")
    want, got = _stream_outputs(jdf, centers), _stream_outputs(tdf, centers)
    if order == 3:
        control = _stream_outputs(_pair(nets, field, order, upload_dtype="bfloat16")[1], centers)
    for name in got:
        assert got[name].dtype == np.float32
        if order == 1:
            np.testing.assert_array_equal(got[name].view(np.int32), np.asarray(want[name]).view(np.int32), err_msg=name)
        else:
            limits = {"max_share": 0.18, "max_ulps": ORDER3_MAX_ULPS}
            print(f"order 3 stream, {name}: share off JAX's {_ulp_agreement(got[name], want[name], **limits)}")
            _control_fails(control[name], want[name], **limits)


@pytest.mark.parametrize(
    "order, limits",
    [
        pytest.param(1, {"max_share": 1e-3}, id="1"),
        pytest.param(3, {"max_share": 0.42, "max_ulps": ORDER3_MAX_ULPS}, id="3"),
    ],
)
def test_device_dtype_serving_matches_jax(nets, order, limits):
    """deblend_and_render and deblend_and_predict under
    device_dtype='bfloat16' with the sim_demo model, in chunks of 2: the
    catalog equal, the outputs float32, and within 2e-2 of the float32
    route's scale (JAX's own bound, tests/test_pipeline.py).  The model's
    float32 means differ from JAX's by up to 2e-5 of their scale, so the
    roundings of small values in the stamps' wings flip.  Order 1: every
    field within one bf16 ulp of its scale of JAX's on at most 0.1% of the
    elements (read: 3.6e-4 at most).  Order 3 misses that share: the
    spline's tails put most of the field in the wings (read: 8.9% of the
    model's elements, at most 2**-6 ulp; 39% while the spline's summation
    order differed too), so it is held to 42% and 2**-5 ulp.  At
    both orders a float32 canvas cast at the end (the upload_dtype route)
    fails the same check (read at order 1: 0.7% to 4.4% of the elements;
    at order 3: 0.5 to 1 ulp)."""
    field, centers = _blob_field(seed=6)
    jdf, tdf = _pair(nets, field, order, device_dtype="bfloat16")
    jcat, jres, jmodel = jdf.deblend_and_render(centers, return_model=True)
    tcat, tres, tmodel = tdf.deblend_and_render(centers, return_model=True)
    assert tres.dtype == tmodel.dtype == np.float32
    np.testing.assert_array_equal(tcat.list_idx, jcat.list_idx)
    np.testing.assert_array_equal(tcat.passed_cuts, jcat.passed_cuts)
    want, got = _stream_outputs(jdf, centers), _stream_outputs(tdf, centers)
    control = _stream_outputs(_pair(nets, field, order, upload_dtype="bfloat16")[1], centers)
    shares = {}
    for key in got:
        shares[key] = _ulp_agreement(got[key], want[key], **limits)
        _control_fails(control[key], want[key], **limits)
    print(f"order {order}: shares of elements off JAX's: {shares}")
    _, ref = _pair(nets, field, order)
    _, rres = ref.deblend_and_render(centers)
    assert float(np.abs(tres - rres).max()) / float(np.abs(rres).max()) < 2e-2


class _Forward:
    """A forward's result handed to the other package: its means and
    stddevs."""

    def __init__(self, mean, stddev):
        self._mean, self._stddev = mean, stddev

    def mean(self):
        return self._mean

    def stddev(self):
        return self._stddev


def test_order3_bf16_serving_equals_jax_given_the_ports_forward(nets, monkeypatch):
    """What is left of order 3's share is the forward: with JAX's batched
    forward replaced by the port's (the sim_demo model's float32 means and
    stddevs on the same cutouts), JAX's device_dtype='bfloat16' stream at
    order 3 serves the port's fields: the residuals and the stddev field
    bit for bit, the model and mean fields but for values below 1e-37
    (XLA's CPU backend flushes subnormal intermediates to zero; read
    4.7e-38 at most, on 0.6% of the elements)."""
    _, tnet = nets

    def ported(self, cut):
        dist = dtt.api.deblend_tensor(tnet, torch.from_numpy(np.array(cut, np.float32)), False, None, "mean")
        return _Forward(jnp.asarray(dist.mean().numpy()), jnp.asarray(dist.stddev().numpy()))

    monkeypatch.setattr(dt.DeblendField, "_batched_forward", ported)
    field, centers = _blob_field(seed=6)
    jdf, tdf = _pair(nets, field, 3, device_dtype="bfloat16")
    want, got = _stream_outputs(jdf, centers), _stream_outputs(tdf, centers)
    for name in ("residual", "residual_field", "predicted_stddev_field"):
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]), err_msg=name)
    for name in ("model", "predicted_mean_field"):
        diff = np.abs(np.asarray(got[name], np.float64) - np.asarray(want[name], np.float64))
        print(f"order 3 given the port's forward, {name}: {float((diff > 0).mean())} of the elements differ, "
              f"by {float(diff.max())} at most")
        assert float(diff.max()) < 1e-37, name


@pytest.fixture(scope="module")
def order3_streams(nets):
    """The model field of the order-3 device_dtype='bfloat16' stream on the
    field of test_device_dtype_serving_matches_jax[3], three ways: JAX's
    stream fed its jitted forward, the same stream fed its un-jitted
    forward (model.apply under jax.disable_jit(), the finite guard and flux
    calibration as deblend_jit applies them), and the port's."""
    from debvader_tpu.utils.flux_cal import apply_flux_calibration

    field, centers = _blob_field(seed=6)
    jdf, tdf = _pair(nets, field, 3, device_dtype="bfloat16")
    jitted, port = _stream_outputs(jdf, centers), _stream_outputs(tdf, centers)

    def eager(self, cut):
        model, variables = self.net
        with jax.disable_jit():
            x = jnp.asarray(np.array(cut, np.float32))
            dist, _ = model.apply(variables, jnp.where(jnp.isfinite(x), x, 0.0), rng=jax.random.PRNGKey(0),
                                  z_mode="mean")
            dist = apply_flux_calibration(dist, variables)
            return _Forward(jnp.asarray(np.asarray(dist.mean())), jnp.asarray(np.asarray(dist.stddev())))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dt.DeblendField, "_batched_forward", eager)
        unjitted = _stream_outputs(_pair(nets, field, 3, device_dtype="bfloat16")[0], centers)
    return {"jitted": jitted["model"], "unjitted": unjitted["model"], "port": port["model"]}


_ORDER3_LIMITS = {"max_share": 0.42, "max_ulps": ORDER3_MAX_ULPS}


def test_order3_bf16_share_of_jax_against_itself(order3_streams):
    """The order-3 share measured on the JAX package alone, on the field
    and limits of test_device_dtype_serving_matches_jax[3]: JAX's
    device_dtype='bfloat16' stream fed its un-jitted forward against the
    same stream fed its jitted one.  The model field differs on 3.4% of
    its elements (read), the port's on 8.9%.  JAX's two forwards sum their
    convolutions in the same order, so this control cannot see the
    summation order that carries the port's share; the float64 control
    (test_order3_bf16_share_against_a_float64_forward) can, and decides
    the fault.  This reading stays pinned: should JAX's own share reach
    half the port's, this test fails."""
    jax_share = _ulp_agreement(order3_streams["unjitted"], order3_streams["jitted"], **_ORDER3_LIMITS)
    port_share = _ulp_agreement(order3_streams["port"], order3_streams["jitted"], **_ORDER3_LIMITS)
    print(f"order 3, model field: JAX un-jitted against JAX jitted {jax_share}, the port against JAX jitted "
          f"{port_share}")
    assert 0.0 < jax_share < port_share / 2


def test_order3_bf16_share_of_the_port_against_jax_unjitted(order3_streams):
    """The third reading: the port's model field against JAX's stream fed
    its un-jitted forward, which rounds every elementwise op on its own as
    the port does.  Read: 8.39% of the elements, against 8.88% off the
    jitted forward: without the jitted code's fused multiply-adds the port
    comes only a little closer, and JAX's two forwards differ on 3.36%
    where the port differs from both on more than 8%: the summation order
    of the convolutions and dense layers carries the share
    (test_order3_layer_shares_teacher_forced)."""
    share = _ulp_agreement(order3_streams["port"], order3_streams["unjitted"], **_ORDER3_LIMITS)
    print(f"order 3, model field: the port against JAX un-jitted {share}")
    assert PORT_AGAINST_UNJITTED - 5e-4 < share < PORT_AGAINST_UNJITTED + 5e-4


def _float64_forward(tnet, perturb: bool = False):
    """A ``DeblendField._batched_forward`` for the JAX package: the port's
    sim_demo modules cast to float64 on the CPU, with the stream's finite
    guard and flux calibration, the means and stddevs rounded once to
    float32.  ``perturb`` adds one float32 ulp of the means' scale (their
    largest magnitude) to band 0 of every mean (the control)."""
    import copy

    from debvader_tpu_torch.utils.flux_cal import apply_flux_calibration

    net64 = copy.deepcopy(tnet).double()

    def forward(self, cut):
        x = torch.from_numpy(np.array(cut, np.float64))
        x = torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype))
        with torch.no_grad():
            dist, _ = net64(x, z_mode="mean")
        dist = apply_flux_calibration(dist, net64)
        mean, std = dist.mean().float().numpy(), dist.stddev().float().numpy()
        if perturb:
            mean = mean.copy()
            mean[..., 0] += np.spacing(np.abs(mean).max())
        return _Forward(jnp.asarray(mean), jnp.asarray(std))

    return forward


@pytest.fixture(scope="module")
def order3_float64(nets):
    """The model field of JAX's order-3 device_dtype='bfloat16' stream on
    the field of test_device_dtype_serving_matches_jax[3] fed a float64
    forward (``exact``) and the same forward perturbed (``perturbed``); and
    the served cutouts' means from the float64 forward, JAX's jitted
    float32 forward and the port's float32 forward."""
    jnet, tnet = nets
    field, centers = _blob_field(seed=6)
    streams, cuts = {}, []
    jitted = dt.DeblendField._batched_forward
    exact = _float64_forward(tnet)
    for name, forward in (("exact", exact), ("perturbed", _float64_forward(tnet, perturb=True))):
        def fed(self, cut, forward=forward):
            cuts.append(np.array(cut, np.float32))
            return forward(self, cut)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dt.DeblendField, "_batched_forward", fed)
            jdf = _pair(nets, field, 3, device_dtype="bfloat16")[0]
            streams[name] = _stream_outputs(jdf, centers)["model"]
    cut = np.concatenate(cuts)
    streams["means"] = {
        "float64": np.asarray(exact(jdf, cut).mean()),
        "jax": np.asarray(jitted(jdf, cut).mean()),
        "port": dtt.api.deblend_tensor(tnet, torch.from_numpy(cut), False, None, "mean").mean().numpy(),
    }
    return streams


def test_float64_forward_within_parity_of_both_float32_forwards(order3_float64):
    """The yardstick is right: on the served cutouts, the float64 forward's
    means lie within the model's 2e-5 parity tolerance of JAX's jitted
    float32 forward and of the port's (read: 6.5e-7 and 1.3e-6 of the
    scale), and both float32 forwards differ from it."""
    means = order3_float64["means"]
    exact = means["float64"]
    scale = float(np.abs(exact).max())
    for name in ("jax", "port"):
        err = float(np.abs(means[name] - exact).max()) / scale
        print(f"float64 forward against {name}'s float32 forward: {err} of the scale")
        assert 0.0 < err <= 2e-5, name


def test_order3_bf16_share_against_a_float64_forward(order3_streams, order3_float64):
    """Queue 3 item 1 decided against a forward that sums more exactly than
    either package: JAX's order-3 bf16 stream fed a float64 forward (the
    port's modules cast to float64, rounded once to float32).  Read under
    the order-3 limits: JAX's jitted stream differs from it on J = 16.44%
    of the model field's elements, the port's on P = 17.57%, where the port
    differs from JAX jitted on 8.88%.  So J >= 8.88% / 2 and P <= 1.25 J:
    JAX's float32 forward lies as far from the float64 one as the port lies
    from JAX, and the port's is no further from it than JAX's.  The share
    is float32 summation order on both sides, and the fault moved to the
    standing traps (ROADMAP).  J and P are pinned at their readings; the
    control, the float64 forward moved by one float32 ulp on band 0 of its
    means, must move P off its pin."""
    jax_share = _ulp_agreement(order3_streams["jitted"], order3_float64["exact"], **_ORDER3_LIMITS)
    port_share = _ulp_agreement(order3_streams["port"], order3_float64["exact"], **_ORDER3_LIMITS)
    port_jax = _ulp_agreement(order3_streams["port"], order3_streams["jitted"], **_ORDER3_LIMITS)
    moved = _ulp_agreement(order3_streams["port"], order3_float64["perturbed"], **_ORDER3_LIMITS)
    print(f"order 3, model field against the float64 forward's stream: JAX jitted {jax_share}, the port "
          f"{port_share} (the port against JAX jitted {port_jax}; against the perturbed forward {moved})")
    assert abs(jax_share - JAX_AGAINST_FLOAT64) < 5e-4
    assert abs(port_share - PORT_AGAINST_FLOAT64) < 5e-4
    assert jax_share >= port_jax / 2 and port_share <= 1.25 * jax_share
    assert abs(moved - PORT_AGAINST_FLOAT64) >= 5e-4


def _layer_probe():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "order3_layer_probe.py"
    spec = importlib.util.spec_from_file_location("order3_layer_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_order3_layer_shares_teacher_forced(nets, order3_streams):
    """Which layer carries the order-3 share (scripts/order3_layer_probe.py):
    each of the port's layers fed the input that JAX's jitted forward gives
    that layer, on the stamps of test_device_dtype_serving_matches_jax[3].
    Pinned at the readings (the shares of output elements whose bits
    differ):

    - the PReLUs: 0 against jitted and un-jitted JAX.  XLA contracts
      alpha * min(x, 0) + max(x, 0) into an FMA, but one term is always
      an exact 0, so the FMA rounds as the separate ops;
    - the BatchNorm: 78% against jitted.  XLA computes fma(x - mean, mul,
      bias) with a correctly rounded rsqrt (that form is 0 off jitted);
      torch.rsqrt on the CPU misses the last bit of 4 of the 6 channels'
      mul.  Yet putting XLA's form into the port's forward does not lower
      the served share (read: 9.26% against 8.88%), so the BatchNorm does
      not carry it;
    - the convolutions from enc/Conv_3 on, every transposed convolution and
      the two large dense layers: 34% to 93% against both JAX forwards,
      while JAX's jitted and un-jitted convolutions agree bit for bit:
      the summation order of the CPU's convolution library, not any
      elementwise op, carries the share, and no elementwise repair can
      follow XLA there."""
    probe = _layer_probe()
    field, centers = _blob_field(seed=6)
    jnet, tnet = nets
    counts = probe.layer_shares(jnet, tnet, probe.served_cutouts(jnet, field, centers))
    print(probe.format_table(counts))
    shares = {name: (c[1] / c[0], c[2] / c[0], c[3] / c[0], None if c[4] is None else c[4] / c[0])
              for name, c in counts.items()}
    assert set(shares) == set(LAYER_SHARES_READ)
    for name, (port_jit, port_eager, eager_jit, fused_jit) in shares.items():
        want = LAYER_SHARES_READ[name]
        assert abs(port_jit - want) < 5e-4, (name, port_jit, want)
        if "PReLU" in name:
            assert port_jit == port_eager == eager_jit == fused_jit == 0.0, name
        if "Conv" in name:
            assert eager_jit == 0.0, name
    assert shares["enc/BatchNorm_0"][3] == 0.0

    bn = tlayers.BatchNorm.forward

    def xla_batchnorm(self, x, train=False):
        shape = (1, -1, 1, 1)
        mul = ((1.0 / torch.sqrt((self.var + self.eps).double())).float() * self.scale).view(shape)
        d = (x - self.mean.view(shape)).double()
        return (d * mul.double() + self.bias.view(shape).double()).float()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlayers.BatchNorm, "forward", xla_batchnorm)
        repaired = _stream_outputs(_pair(nets, field, 3, device_dtype="bfloat16")[1], centers)["model"]
    assert tlayers.BatchNorm.forward is bn
    share = _ulp_agreement(repaired, order3_streams["jitted"], **_ORDER3_LIMITS)
    port = _ulp_agreement(order3_streams["port"], order3_streams["jitted"], **_ORDER3_LIMITS)
    print(f"order 3, model field: the port with XLA's BatchNorm against JAX jitted {share} (as it is: {port})")
    assert share > port - 1e-3


def test_upload_dtype_serving_matches_jax(nets):
    """upload_dtype alone: the field is rounded once on the host and served
    in float32 (float32 canvases): within 2e-5 of JAX's scale, like the
    float32 route."""
    field, centers = _blob_field(seed=7)
    for dtype in ("bfloat16", "float16"):
        jdf, tdf = _pair(nets, field, 1, upload_dtype=dtype)
        _, jres = jdf.deblend_and_render(centers)
        _, tres = tdf.deblend_and_render(centers)
        np.testing.assert_allclose(tres, jres, rtol=0, atol=2e-5 * float(np.abs(jres).max()))


def test_record_array_route_under_device_dtype_matches_jax(nets):
    """The JAX behaviour of tests/test_pipeline.py:438 on the record-array
    route: the forward reads the bfloat16 field's cutouts (cast to
    float32), the record array's cutouts and the mse cut the float32 host
    field, and the render is float32."""
    jnet, tnet = nets
    field, centers = _blob_field(seed=8)
    jdf = dt.DeblendField(jnet, field, z_mode="mean", device_dtype="bfloat16")
    tdf = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu", device_dtype="bfloat16")
    want, got = jdf.deblend_field(centers), tdf.deblend_field(centers)
    ref = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu").deblend_field(centers)
    gm, wm, rm = (np.stack(list(r.output_images_mean)) for r in (got, want, ref))
    np.testing.assert_allclose(gm, wm, rtol=0, atol=2e-5 * float(np.abs(wm).max()))
    assert not np.array_equal(gm, rm)  # the forward saw the rounded field
    assert float(np.abs(gm - rm).max()) / max(1.0, float(np.abs(rm).max())) < 2e-2
    for i in range(len(got)):
        # the record array's cutouts come from the float32 host field
        np.testing.assert_array_equal(got.cutout_images[i], want.cutout_images[i])
        np.testing.assert_array_equal(got.cutout_images[i], ref.cutout_images[i])
    np.testing.assert_array_equal(got.passed_cuts, want.passed_cuts)
    tres, jres = tdf.get_residual_field(), jdf.get_residual_field()
    assert tres.dtype == np.float32
    np.testing.assert_allclose(tres, jres, rtol=0, atol=2e-5 * float(np.abs(jres).max()))


def test_device_dtype_with_registration_matches_jax(nets):
    """Registration reads the bfloat16 field's r band cast to float32 once
    for the whole stream: the residual within one bf16 ulp of the scale on
    at most 0.1% of the elements (read: 1.3e-5), which a float32 canvas
    cast at the end fails (read: 2.5%)."""
    field, centers = _blob_field(seed=9)
    jdf, tdf = _pair(nets, field, 1, device_dtype="bfloat16")
    jcat, jres = jdf.deblend_and_render(centers, optimise_positions=True)
    tcat, tres = tdf.deblend_and_render(centers, optimise_positions=True)
    np.testing.assert_allclose(np.stack(list(tcat.shifts)), np.stack(list(jcat.shifts)), rtol=0, atol=1e-4)
    _ulp_agreement(tres, jres)
    _, control = _pair(nets, field, 1, upload_dtype="bfloat16")[1].deblend_and_render(centers, optimise_positions=True)
    _control_fails(control, jres)
