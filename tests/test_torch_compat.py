"""The port's reference-shaped namespace (debvader_tpu_torch/compat.py) and
the ops it needed, held against the JAX package on the CPU.

- ``extract_cutouts`` (``extract_cutouts_host``), ``subpixel_shift``,
  ``subpixel_shift_const`` and ``shift_full`` bit for bit against the JAX
  functions called eagerly (op by op; jitted, XLA contracts their
  multiply-adds into FMAs);
- ``subpixel_shift_spline`` bit for bit against JAX's jitted function on
  images of 50 px or more a side (where the port's prefilter is bit for
  bit XLA's for this unbatched layout, ops/spline.py), to float32
  rounding below;
- ``position_optimization`` within 1e-5 px of JAX's on well-posed fits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import debvader_tpu.compat as jcompat
from debvader_tpu.ops import extraction as jext
from debvader_tpu.ops import registration as jreg
from debvader_tpu.ops import shift as jshift
from debvader_tpu.ops import spline as jspline

import debvader_tpu_torch as dtt
import debvader_tpu_torch.compat as compat
from debvader_tpu_torch.ops import shift as tshift
from debvader_tpu_torch.ops import spline as tspline

torch.set_num_threads(1)


def test_every_jax_compat_name_is_there():
    assert sorted(compat.__all__) == sorted(jcompat.__all__)
    for name in jcompat.__all__:
        assert callable(getattr(compat, name)), name
    assert compat.extract_cutouts is __import__(
        "debvader_tpu_torch.ops.extraction", fromlist=["x"]).extract_cutouts_host
    for name in ("create_encoder", "create_decoder", "create_model_vae"):
        assert getattr(dtt, name) is getattr(compat, name)


def test_extract_cutouts_bit_for_bit():
    rng = np.random.default_rng(0)
    field = rng.normal(size=(1, 101, 101, 3)).astype(np.float32)
    centers = np.concatenate([rng.uniform(-45, 45, size=(20, 2)), [[49.7, 0.0], [-50.2, 3.0]]]).astype(np.float32)
    want, want_idx = jext.extract_cutouts_host(field, 101, centers, 23, 3)
    got, got_idx = compat.extract_cutouts(field, 101, centers, 23, 3)
    np.testing.assert_array_equal(got, want)
    assert [int(i) for i in got_idx] == [int(i) for i in want_idx]
    assert len(got_idx) < len(centers)


@pytest.mark.parametrize("shape", [(79, 79, 6), (23, 23), (40, 31, 3)])
@pytest.mark.parametrize("name", ["subpixel_shift", "subpixel_shift_const", "shift_full"])
def test_bilinear_shifts_bit_for_bit(shape, name):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    img = (10 * rng.normal(size=shape)).astype(np.float32)
    shifts = [rng.uniform(0, 1, 2), [0.0, 0.0], [0.5, 0.999]] if name.endswith("const") else [
        rng.uniform(-5, 5, 2), [0.0, 0.0], [-3.0, 2.5], [40.0, -1.25]]
    for s in shifts:
        s = np.asarray(s, np.float32)
        want = np.asarray(getattr(jshift, name)(jnp.asarray(img), jnp.asarray(s)))
        got = getattr(tshift, name)(torch.from_numpy(img), torch.from_numpy(s)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {s}")


@pytest.mark.parametrize("shape", [(79, 79, 6), (64, 56, 2), (59, 59), (100, 90, 3)])
def test_spline_shift_bit_for_bit_jitted(shape):
    rng = np.random.default_rng(shape[0] + shape[1])
    img = (rng.normal(size=shape) * rng.uniform(0.1, 100)).astype(np.float32)
    for s in (rng.uniform(-5, 5, 2), [0.25, -0.75], [0.0, 0.0]):
        s = np.asarray(s, np.float32)
        want = np.asarray(jax.jit(jspline.subpixel_shift_spline)(img, s))
        got = tspline.subpixel_shift_spline(torch.from_numpy(img), torch.from_numpy(s)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(s))


@pytest.mark.parametrize("shape", [(23, 23, 3), (64, 48, 2)])
def test_spline_shift_small_image_within_float32(shape):
    """Below 50 px a side the prefilter's dot runs in another order than
    XLA's, so the shift agrees to float32 rounding (2e-6 of the scale)."""
    rng = np.random.default_rng(3)
    img = rng.normal(size=shape).astype(np.float32)
    s = np.asarray([1.3, -0.4], np.float32)
    want = np.asarray(jax.jit(jspline.subpixel_shift_spline)(img, s))
    got = tspline.subpixel_shift_spline(torch.from_numpy(img), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


def _registration_case(seed, f=61, sigma=2.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:f, :f]
    d = rng.uniform(-3, 3, 2)
    true = rng.uniform(-1.5, 1.5, 2)

    def blob(y, x):
        return np.exp(-((yy - f // 2 - y) ** 2 + (xx - f // 2 - x) ** 2) / (2 * sigma**2))

    field = np.repeat(blob(d[0] + true[0], d[1] + true[1])[..., None], 3, -1).astype(np.float32)
    field += (0.001 * rng.normal(size=field.shape)).astype(np.float32)
    pred = np.repeat(blob(0, 0)[..., None], 3, -1).astype(np.float32)
    return field, pred, d.astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_position_optimization_as_jax(seed):
    field, pred, d = _registration_case(seed)
    want = np.asarray(jreg.position_optimization(field, pred, d))
    got = np.asarray(compat.position_optimization(field, pred, d, device="cpu"))
    print(f"position_optimization: JAX {want}, port {got}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert isinstance(compat.position_optimization(field, pred, d, device="cpu")[0], float)


def test_losses_as_jax():
    from debvader_tpu.models.distributions import PixelNormal as JaxPixelNormal
    from debvader_tpu.training import losses as jlosses

    from debvader_tpu_torch.models.distributions import PixelNormal

    rng = np.random.default_rng(4)
    loc, scale, y = (rng.normal(size=(2, 9, 9, 3)).astype(np.float32) for _ in range(3))
    scale = np.abs(scale) + 0.1
    want = np.asarray(jcompat.vae_loss(jnp.asarray(y), JaxPixelNormal(jnp.asarray(loc), jnp.asarray(scale))))
    got = compat.vae_loss(torch.from_numpy(y), PixelNormal(torch.from_numpy(loc), torch.from_numpy(scale))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(float(compat.mse(torch.from_numpy(loc), torch.from_numpy(y))),
                               float(jlosses.mse(jnp.asarray(loc), jnp.asarray(y))), rtol=2e-6)


def test_load_deblender_reference_signature():
    net = compat.load_deblender("sim_demo", (59, 59, 6), 32, (32, 64, 128, 256), (3, 3, 3, 3), False, None,
                                "bfloat16", 1, None, False, device="cpu")
    assert net.cfg == dataclasses.replace(dtt.ModelConfig(), dtype="bfloat16", decoder_f32_stages=1)
    model, encode, decode = compat.load_deblender("sim_demo", return_encoder_decoder_z=True, device="cpu")
    x = torch.zeros(1, 59, 59, 6)
    assert tuple(decode(encode(x).mean()).loc.shape) == (1, 59, 59, 6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            compat.load_deblender("sim_demo")


def test_deblend_and_detect_through_compat():
    net = compat.create_model_vae(dtt.ModelConfig(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8),
                                                  kernels=(3, 3)))
    dtt.init_vae(net, 0)
    means, _ = compat.deblend(net, np.zeros((2, 23, 23, 3), np.float32), z_mode="mean", device="cpu")
    assert means.shape == (2, 23, 23, 3)
    assert len(compat.detect_objects(np.zeros((64, 64), np.float32), device="cpu")) == 0
    x = torch.linspace(-2, 2, 9)
    torch.testing.assert_close(compat.denormalize_non_linear(compat.normalize_non_linear(x)), x, rtol=1e-5,
                               atol=1e-5)
