"""The plain versions of the port's matched-filter, render and decoder-tail
kernels held against the JAX package on the CPU.

The port's wrappers run their plain versions here (CPU tensors); the JAX
side runs its Pallas kernels in interpret mode, as the JAX package's own
tests do, and its XLA formulations.  Tolerances are stated where they are
used: both sides compute in float32 and differ by the order of their sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import debvader_tpu_torch as dtt
from debvader_tpu.kernels.decoder_tail import decoder_tail_reference
from debvader_tpu.kernels.matched_filter import matched_filter_threshold as jax_mft
from debvader_tpu.kernels.render import render_field_pallas
from debvader_tpu.ops.shift import render_field as jax_render
from debvader_tpu_torch.kernels import _build
from debvader_tpu_torch.kernels.decoder_tail import (
    decoder_tail_params,
    decoder_tail_plain,
    fused_decoder_tail,
)
from debvader_tpu_torch.kernels.detect_fused import (
    apply_filter,
    filter_taps,
    full_filter,
    matched_filter_parents,
    parent_race,
)
from debvader_tpu_torch.kernels.matched_filter import (
    matched_filter_threshold,
    matched_filter_threshold_plain,
)
from debvader_tpu_torch.kernels.render import render_field_kernel, render_field_plain
from debvader_tpu_torch.ops import detection as td
from debvader_tpu_torch.ops.shift import render_field, render_pad

torch.set_num_threads(1)


def _filters():
    """The stock separable filter and one that does not separate."""
    sep = td.default_filter_kernel()
    rng = np.random.default_rng(5)
    return {"separable": sep, "non_separable": (sep + 0.05 * rng.random((7, 7))).astype(np.float32)}


def _image(f=96, seed=0):
    rng = np.random.default_rng(seed)
    img = 0.05 * rng.normal(size=(f, f)) + 0.01
    yy, xx = np.mgrid[:f, :f]
    for _ in range(8):
        cy, cx = rng.uniform(4, f - 4, 2)
        img += rng.uniform(0.3, 3.0) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 2.0**2))
    back = 0.01 + 0.002 * rng.normal(size=(f, f))
    return img.astype(np.float32), back.astype(np.float32)


# ------------------------------------------------------------ matched filter


@pytest.mark.parametrize("which", ["separable", "non_separable"])
def test_filter_taps_pick_the_branch(which):
    separable, taps = filter_taps(_filters()[which])
    assert separable == (which == "separable")
    assert taps.shape == ((14,) if separable else (49,)) and taps.dtype == np.float32


@pytest.mark.parametrize("which", ["separable", "non_separable"])
def test_matched_filter_plain_matches_pallas_interpret(which):
    """filt within 5e-6 of its scale (sum order); the masks agree wherever
    filt is further than 1e-5 from the threshold (closer pixels may flip,
    as the Pallas kernel's own notes say)."""
    img, back = _image()
    k = _filters()[which]
    thr = 0.4
    jf, jm = jax_mft(jnp.asarray(img), jnp.asarray(back), k, jnp.float32(thr), tile=128, interpret=True)
    jf, jm = np.asarray(jf), np.asarray(jm) > 0
    filt, mask = matched_filter_threshold(torch.from_numpy(img), torch.from_numpy(back), k, thr)
    assert filt.dtype == torch.float32 and mask.dtype == torch.bool
    np.testing.assert_allclose(filt.numpy(), jf, rtol=0, atol=5e-6 * np.abs(jf).max())
    clear = np.abs(jf - thr) > 1e-5
    np.testing.assert_array_equal(mask.numpy()[clear], jm[clear])
    assert mask.any() and not mask.all()


@pytest.mark.parametrize("which", ["separable", "non_separable"])
def test_matched_filter_plain_matches_conv(which):
    """Against the port's library formulation (F.conv2d + compare), the
    filter of the chain when the kernel is not asked for."""
    img, back = _image(seed=1)
    k = _filters()[which]
    thr = torch.tensor(0.4)
    filt, mask = matched_filter_threshold_plain(torch.from_numpy(img), torch.from_numpy(back), k, thr)
    want = td._conv2d_same(torch.from_numpy(img - back), torch.from_numpy(k))
    np.testing.assert_allclose(filt.numpy(), want.numpy(), rtol=0, atol=5e-6 * float(want.abs().max()))
    clear = (want - thr).abs() > 1e-5
    assert torch.equal(mask[clear], (want > thr)[clear])
    assert torch.equal(mask, filt > thr)


def test_matched_filter_threshold_as_tensor_or_float():
    img, back = (torch.from_numpy(a) for a in _image(seed=2))
    k = td.default_filter_kernel()
    a = matched_filter_threshold(img, back, k, 0.4)
    b = matched_filter_threshold(img, back, k, torch.tensor([0.4]))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize(
    "image,back",
    [(torch.zeros(8, 9), torch.zeros(8, 9)), (torch.zeros(8, 8), torch.zeros(9, 9)), (torch.zeros(2, 8, 8), torch.zeros(2, 8, 8))],
)
def test_matched_filter_rejects_bad_shapes(image, back):
    with pytest.raises(ValueError):
        matched_filter_threshold(image, back, td.default_filter_kernel(), 0.1)


def test_matched_filter_rejects_other_filter_sizes():
    with pytest.raises(ValueError, match="7x7"):
        matched_filter_threshold(torch.zeros(8, 8), torch.zeros(8, 8), np.ones((5, 5), np.float32), 0.1)


def test_fused_core_takes_a_non_separable_filter():
    """The fused core's 49-tap branch: filt against the Pallas kernel
    (interpret) within 1e-5 of its scale, dir_code and parent bit-identical
    to the port's race on JAX's filt."""
    from debvader_tpu.kernels.detect_fused import matched_filter_parents as jax_mfp

    img, back = _image(f=128, seed=3)
    k = _filters()["non_separable"]
    thr = np.array([0.4], np.float32)
    jf, jdir, jpar = jax_mfp(jnp.asarray(img[None]), jnp.asarray(back[None]), k, jnp.asarray(thr), tile=64, interpret=True)
    jf, jdir, jpar = (np.asarray(a)[:, :128, :128] for a in (jf, jdir, jpar))
    filt, dirc, parent = matched_filter_parents(
        torch.from_numpy(img[None]), torch.from_numpy(back[None]), k, torch.from_numpy(thr)
    )
    np.testing.assert_allclose(filt.numpy(), jf, rtol=0, atol=1e-5 * np.abs(jf).max())
    rdir, rpar = parent_race(torch.from_numpy(np.array(jf)), torch.from_numpy(thr))
    np.testing.assert_array_equal(rdir.numpy(), jdir)
    np.testing.assert_array_equal(rpar.numpy(), jpar)
    # the port's own outputs are its race on its own filt
    pdir, ppar = parent_race(filt, torch.from_numpy(thr))
    assert torch.equal(dirc, pdir) and torch.equal(parent, ppar)
    assert (jdir != 4).sum() > 0


def test_full_filter_tap_order_is_row_major():
    """One non-zero pixel maps the filter flipped onto the output: the
    49-tap branch is a correlation, taps in (dy, dx) order."""
    k = np.arange(49, dtype=np.float32).reshape(7, 7)
    fore = torch.zeros(1, 9, 9)
    fore[0, 4, 4] = 1.0
    out = full_filter(fore, k)[0].numpy()
    np.testing.assert_array_equal(out[1:8, 1:8], k[::-1, ::-1])
    assert torch.equal(apply_filter(fore, k), full_filter(fore, k))


# -------------------------------------------------------------------- render


def _render_case(n, s, b, f, seed=0):
    rng = np.random.default_rng(seed)
    stamps = rng.random((n, s, s, b)).astype(np.float32)
    offsets = rng.uniform(-f / 2, f / 2, size=(n, 2)).astype(np.float32)
    return stamps, offsets


def _render_cases():
    """The cases of tests/test_pallas_render.py: name -> (stamps, offsets,
    field size, mask, Pallas tile)."""
    cases = {}
    for f, tile in ((64, 32), (100, 32), (128, 128)):
        cases[f"parity_{f}"] = (*_render_case(6, 9, 2, f), f, None, tile)
    st, _ = _render_case(3, 7, 1, 50)
    cases["fractional"] = (st, np.array([[0.3, -0.7], [10.25, 5.5], [-12.9, 0.1]], np.float32), 50, None, 32)
    st, off = _render_case(4, 7, 2, 40)
    cases["mask"] = (st, off, 40, np.array([True, False, True, False]), 32)
    st, _ = _render_case(1, 7, 1, 30)
    cases["off_field"] = (st, np.array([[100.0, 100.0]], np.float32), 30, None, 32)
    cases["dc2_scale"] = (*_render_case(12, 59, 6, 259, seed=3), 259, None, 128)
    return cases


_RENDER_CASES = _render_cases()


@pytest.mark.parametrize("name", sorted(_RENDER_CASES))
def test_render_plain_matches_jax_render(name):
    """Against the XLA scan renderer at order 1: 1e-5 absolute on stamps in
    [0, 1) (the scatter adds overlapping patches in another order)."""
    stamps, offsets, f, mask, _ = _RENDER_CASES[name]
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jax_render(jnp.asarray(stamps), jnp.asarray(offsets), f, jmask))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = render_field_plain(torch.from_numpy(stamps), torch.from_numpy(offsets), f, tmask)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    via_wrapper = render_field_kernel(torch.from_numpy(stamps), torch.from_numpy(offsets), f, tmask)
    assert torch.equal(via_wrapper, got)


@pytest.mark.parametrize("name", sorted(_RENDER_CASES))
def test_render_plain_matches_pallas_interpret(name):
    """Against the Pallas kernel (interpret): 3e-5 absolute, the bound its
    own test holds it to at the DC2 scale (it subtracts large float
    coordinates where the port splits floor and fraction)."""
    stamps, offsets, f, mask, tile = _RENDER_CASES[name]
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(
        render_field_pallas(jnp.asarray(stamps), jnp.asarray(offsets), f, mask=jmask, tile=tile, interpret=True)
    )
    tmask = None if mask is None else torch.from_numpy(mask)
    got = render_field_plain(torch.from_numpy(stamps), torch.from_numpy(offsets), f, tmask)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)


@pytest.mark.parametrize("order", [1, 3])
def test_render_field_canvas_over_two_calls_equals_one(order):
    """canvas= / crop=False: two chunks accumulated into one padded canvas
    equal one call, and equal the JAX package's incremental render."""
    stamps, offsets = _render_case(7, 15, 3, 90, seed=4)
    offsets[2] = [44.6, -44.2]  # hangs over the field's edge
    st, off = torch.from_numpy(stamps), torch.from_numpy(offsets)
    one = render_field(st, off, 90, order=order)
    canvas = render_field(st[:3], off[:3], 90, order=order, crop=False)
    pad = render_pad(15, order)
    assert canvas.shape == (90 + 2 * pad, 90 + 2 * pad, 3)
    again = render_field(st[3:], off[3:], 90, order=order, canvas=canvas, crop=False)
    assert again is canvas  # accumulated in place
    two = canvas[pad : pad + 90, pad : pad + 90]
    np.testing.assert_allclose(two.numpy(), one.numpy(), rtol=0, atol=1e-6 * float(one.abs().max()))
    jc = jax_render(jnp.asarray(stamps[:3]), jnp.asarray(offsets[:3]), 90, order=order, crop=False)
    jc = jax_render(jnp.asarray(stamps[3:]), jnp.asarray(offsets[3:]), 90, order=order, canvas=jc, crop=False)
    want = np.asarray(jc)[pad : pad + 90, pad : pad + 90]
    np.testing.assert_allclose(two.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    cropped = render_field(st[3:], off[3:], 90, order=order, canvas=torch.zeros_like(canvas))
    assert cropped.shape == (90, 90, 3)


def test_render_field_rejects_a_wrong_canvas():
    stamps, offsets = _render_case(2, 9, 2, 40)
    with pytest.raises(ValueError, match="canvas"):
        render_field(torch.from_numpy(stamps), torch.from_numpy(offsets), 40, canvas=torch.zeros(40, 40, 2))
    with pytest.raises(ValueError, match="order"):
        render_field(torch.from_numpy(stamps), torch.from_numpy(offsets), 40, order=2)


def test_render_kernel_out_accumulates_into_a_canvas_window():
    """out= adds in place into a strided window of a larger canvas, the
    call the streaming path makes on a card."""
    stamps, offsets = _render_case(5, 9, 2, 40, seed=6)
    st, off = torch.from_numpy(stamps), torch.from_numpy(offsets)
    canvas = torch.ones(62, 62, 2)
    window = canvas[11:51, 11:51]
    got = render_field_kernel(st, off, 40, out=window)
    assert got is window
    want = 1.0 + render_field_plain(st, off, 40)
    np.testing.assert_allclose(window.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"offsets": torch.zeros(3, 2)},
        {"mask": torch.ones(3, dtype=torch.bool)},
        {"out": torch.zeros(40, 40, 3)},
        {"out": torch.zeros(40, 40, 2, dtype=torch.float64)},
        {"out": torch.zeros(40, 2, 40).permute(0, 2, 1)},
    ],
)
def test_render_kernel_rejects_bad_arguments(kwargs):
    args = {"stamps": torch.zeros(2, 9, 9, 2), "offsets": torch.zeros(2, 2), "field_size": 40}
    args.update(kwargs)
    with pytest.raises(ValueError):
        render_field_kernel(**args)


def test_render_with_no_sources_is_zero():
    out = render_field(torch.zeros(0, 9, 9, 2), torch.zeros(0, 2), 30)
    assert out.shape == (30, 30, 2) and not out.any()


# -------------------------------------------------------------- decoder tail


def _tail_inputs(n=8, s=16, c=8, o=6, seed=0):
    rng = np.random.default_rng(seed)
    return (
        (rng.normal(size=(n, s, s, c)) * 0.3).astype(np.float32),
        (rng.normal(size=(3, 3, c, c)) * 0.1).astype(np.float32),
        (rng.normal(size=(c,)) * 0.1).astype(np.float32),
        rng.uniform(0, 0.5, size=(s, s, c)).astype(np.float32),
        (rng.normal(size=(3, 3, c, o)) * 0.1).astype(np.float32),
        (rng.normal(size=(o,)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize(
    "case,atol",
    [("small", 2e-5), ("all_negative", 2e-5), ("model_scale", 5e-5)],
)
def test_decoder_tail_plain_matches_reference(case, atol):
    """Against the JAX package's XLA op chain, at the bounds its own Pallas
    parity tests use (absolute, outputs of order 1)."""
    args = _tail_inputs(n=2, s=64, c=32, o=12, seed=1) if case == "model_scale" else _tail_inputs(seed=2)
    if case == "all_negative":  # the PReLU branch and the ReLU floor
        args = (-np.abs(args[0]),) + args[1:]
    want = np.asarray(decoder_tail_reference(*(jnp.asarray(a) for a in args)))
    got = fused_decoder_tail(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == want.shape and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert want.max() > 0.1


def test_decoder_tail_ring_outside_the_image_is_zero():
    """The second conv pads the intermediate with zeros, not with the first
    conv's values beyond the image: a numpy rendition that zeroes the ring
    agrees, one that keeps it does not."""
    x, k2, b2, a2, k3, b3 = _tail_inputs(n=1, s=6, c=4, o=3, seed=3)
    s = 6
    w2 = k2[::-1, ::-1].transpose(0, 1, 3, 2)  # [sy][sx][ci][co]
    xp = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)))
    h = sum(
        np.einsum("nyxi,io->nyxo", xp[:, sy : sy + s + 2, sx : sx + s + 2], w2[sy, sx])
        for sy in range(3)
        for sx in range(3)
    ) + b2
    h = np.maximum(h, 0) + np.pad(a2, ((1, 1), (1, 1), (0, 0))) * np.minimum(h, 0)
    inside = np.zeros((s + 2, s + 2, 1), np.float32)
    inside[1:-1, 1:-1] = 1

    def second(hh):
        out = sum(
            np.einsum("nyxc,co->nyxo", hh[:, ty : ty + s, tx : tx + s], k3[ty, tx])
            for ty in range(3)
            for tx in range(3)
        )
        return np.maximum(out + b3, 0)

    got = decoder_tail_plain(*(torch.from_numpy(a) for a in (x, k2, b2, a2, k3, b3))).numpy()
    np.testing.assert_allclose(got, second(h * inside), rtol=0, atol=2e-5)
    assert np.abs(got - second(h)).max() > 1e-3


@pytest.fixture(scope="module")
def sim_demo():
    import debvader_tpu as dt

    return dt.load_deblender("sim_demo"), dtt.load_deblender("sim_demo", device="cpu")


def test_decoder_tail_params_reproduce_the_decoder(sim_demo):
    """On sim_demo's own tail: the function on decoder_tail_params equals
    the decoder's output before the crop, and the JAX reference on the
    Flax parameters equals the port's function on the converted ones."""
    (_, variables), net = sim_demo
    caught = {}
    hook = net.decoder.convts[-1].register_forward_pre_hook(lambda m, a: caught.update(x=a[0]))
    head = net.decoder.head.register_forward_hook(lambda m, a, out: caught.update(y=out))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        net.decode(torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32)))
    hook.remove()
    head.remove()
    x = caught["x"].permute(0, 2, 3, 1).contiguous()
    want = torch.relu(caught["y"]).permute(0, 2, 3, 1)
    params = decoder_tail_params(net.decoder)
    assert [tuple(p.shape) for p in params] == [(3, 3, 32, 32), (32,), (64, 64, 32), (3, 3, 32, 12), (12,)]
    got = fused_decoder_tail(x, *params)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5 * float(want.abs().max()))

    dec = variables["params"]["decoder"]
    n = 2 * len(net.cfg.filters)
    flax = (
        dec[f"ConvTranspose2DTF_{n - 1}"]["kernel"],
        dec[f"ConvTranspose2DTF_{n - 1}"]["bias"],
        dec[f"PReLU_{n + 2}"]["alpha"],
        dec["Conv_0"]["kernel"],
        dec["Conv_0"]["bias"],
    )
    for mine, theirs in zip(params, flax):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    ref = np.asarray(decoder_tail_reference(jnp.asarray(x.numpy()), *(jnp.asarray(a) for a in flax)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-5 * np.abs(ref).max())


@pytest.mark.parametrize(
    "bad",
    [
        {"k2": torch.zeros(3, 3, 8, 4)},
        {"a2": torch.zeros(15, 16, 8)},
        {"b3": torch.zeros(5)},
        {"x": torch.zeros(2, 16, 15, 8)},
    ],
)
def test_decoder_tail_rejects_bad_shapes(bad):
    names = ("x", "k2", "b2", "a2", "k3", "b3")
    args = dict(zip(names, (torch.from_numpy(a) for a in _tail_inputs(n=2))))
    args.update(bad)
    with pytest.raises(ValueError):
        fused_decoder_tail(**args)


# --------------------------------------------------------------------- build


def test_fmad_is_a_per_source_flag_in_the_library_hash():
    """Kernels held bit for bit build without contraction; the decoder
    tail, held to a tolerance, builds with it, and the flag enters the
    library's name, so a change of flags rebuilds."""
    assert "-fmad=false" in _build._flags("matched_filter")
    assert "-fmad=false" in _build._flags("render")
    assert "-fmad=true" in _build._flags("decoder_tail")
    assert not any(f.startswith("-fmad") for f in _build.NVCC_FLAGS)
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == [
        "clipped_stats", "decoder_tail", "detect_fused", "label_select", "matched_filter", "parent_race", "render",
        "tail_fused",
    ]
    assert "-fmad=false" in _build._flags("parent_race")
    # the tail pair keeps contraction off: its bias, PReLU and limb sums
    # use rounding intrinsics, and its products run on the tensor cores
    assert "-fmad=false" in _build._flags("tail_fused")
    paths = {_build._lib_path(name).name for name in sources}
    assert len(paths) == len(sources)


@pytest.mark.parametrize(
    "fn",
    [matched_filter_threshold, render_field_kernel, fused_decoder_tail],
)
def test_cpu_calls_do_not_count_as_launches(fn):
    assert fn.launches == 0
