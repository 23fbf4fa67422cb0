"""The port's stochastic stamp API (deblend_samples, deblend_sample_stats)
held against the JAX package on the CPU.

JAX's threefry and torch's generators never share a stream, so the latent
noise is made with numpy and injected on both sides: the JAX side encodes,
forms ``loc + tril @ eps`` and decodes the same latents.  Tolerances: the
model's 2e-5 of the output scale (tests/test_torch_model.py) for samples;
statistics against the sample cube's own mean and population std to 1e-5 of
the scale; chunking changes only the order of the Welford merges, 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import debvader_tpu_torch as dtt
from debvader_tpu import api as japi
from debvader_tpu.config import ModelConfig as JaxModelConfig
from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
from debvader_tpu.models.vae import init_vae
from debvader_tpu.ops.normalize import denormalize_distribution as jax_denormalize
from debvader_tpu.ops.normalize import normalize_non_linear as jax_normalize
from debvader_tpu.utils.flux_cal import apply_flux_calibration as jax_apply_cal
from debvader_tpu_torch import api as tapi
from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.weights import flatten_flax, state_dict_from_flax

torch.set_num_threads(1)

TINY_KW = dict(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))
N, REPS = 5, 7


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


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
    """(jax model, jax variables, torch net, stamps, eps): random weights
    with live PReLU alphas and a positive head bias, so every band has
    signal and the latent draw moves the output."""
    jmodel = JaxVAE(JaxModelConfig(**TINY_KW))
    rng = np.random.default_rng(0)
    flat = flatten_flax(jax.tree_util.tree_map(np.asarray, init_vae(jmodel, jax.random.PRNGKey(0))))
    for k, v in flat.items():
        noise = 0.05 * rng.normal(size=v.shape).astype(np.float32)
        flat[k] = (np.abs(v) + 0.5 + noise if k.endswith("/var") else v + noise).astype(np.float32)
    flat["params/decoder/Conv_0/bias"] = flat["params/decoder/Conv_0/bias"] + np.float32(0.5)
    cfg = ModelConfig(**TINY_KW)
    net = dtt.DeblenderVAE(cfg).eval()
    net.load_state_dict(state_dict_from_flax(flat, cfg))
    x = np.abs(rng.normal(size=(N, 23, 23, 3))).astype(np.float32)
    x[1, 3, 3, 0] = np.nan  # the finite guard runs before the encode
    eps = rng.normal(size=(REPS, N, 4)).astype(np.float32)
    return jmodel, _unflatten(flat), net, x, eps


def _jax_samples(jmodel, variables, x, eps, normalise=False, scale=None):
    """The JAX package's decode of the same latents, replica axis first."""
    xj = jnp.asarray(x)
    xj = jnp.where(jnp.isfinite(xj), xj, 0.0)
    if normalise:
        xj = jax_normalize(xj)
    post = jmodel.apply(variables, xj, method=lambda m, v: m.encode(v))
    z = post.loc[None] + jnp.einsum("nij,rnj->rni", post.scale_tril, jnp.asarray(eps))
    reps, n = eps.shape[:2]
    dist = jmodel.apply(variables, z.reshape(reps * n, -1), method=lambda m, v: m.decode(v))
    if scale is not None:
        dist = jax_apply_cal(dist, {"flux_cal": {"scale": jnp.asarray(scale, jnp.float32)}})
    if normalise:
        dist = jax_denormalize(dist)
    return np.asarray(dist.loc).reshape((reps, n) + x.shape[1:])


@pytest.mark.parametrize("normalise", [False, True])
@pytest.mark.parametrize("max_chunk", [8192, 2 * N, 1])
def test_deblend_samples_match_jax_decode_of_the_same_latents(tiny, normalise, max_chunk):
    jmodel, variables, net, x, eps = tiny
    want = _jax_samples(jmodel, variables, x, eps, normalise)
    got = dtt.deblend_samples(net, x, REPS, normalise=normalise, max_chunk=max_chunk, eps=eps, device="cpu")
    assert got.shape == (REPS, N, 23, 23, 3)
    # a transposed (N, reps) reshape would pass the shape check and fail here
    _close(got.numpy(), want, 2e-5)
    assert np.abs(want[0] - want[1]).max() > 1e-3 * np.abs(want).max()


def test_deblend_samples_apply_the_flux_calibration(tiny):
    jmodel, variables, net, x, eps = tiny
    # gains above 1 keep the calibrated outputs away from the pole of the
    # denormalisation (arctanh at 1), which would amplify the 2e-5
    scale = np.asarray([2.0, 1.5, 4.0], np.float32)
    want = _jax_samples(jmodel, variables, x, eps, normalise=True, scale=scale)
    net.flux_cal_scale = torch.from_numpy(scale)
    try:
        got = dtt.deblend_samples(net, x, REPS, normalise=True, eps=eps, device="cpu")
        mean, _ = dtt.deblend_sample_stats(net, x, REPS, normalise=True, eps=eps, device="cpu")
    finally:
        net.flux_cal_scale = None
    _close(got.numpy(), want, 2e-5)
    _close(mean.numpy(), want.mean(axis=0), 2e-5)


@pytest.mark.parametrize("max_chunk", [8192, 3 * N, N, 1])
def test_sample_stats_equal_the_statistics_of_the_sample_cube(tiny, max_chunk):
    """Welford merge over replica chunks (singleton chunks at max_chunk=1)
    against the cube's mean and population std; and against the JAX decode
    of the same latents."""
    jmodel, variables, net, x, eps = tiny
    cube = dtt.deblend_samples(net, x, REPS, eps=eps, device="cpu").numpy().astype(np.float64)
    mean, std = dtt.deblend_sample_stats(net, x, REPS, eps=eps, max_chunk=max_chunk, device="cpu")
    scale = np.abs(cube).max()
    np.testing.assert_allclose(mean.numpy(), cube.mean(axis=0), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(std.numpy(), cube.std(axis=0), rtol=0, atol=1e-5 * scale)
    jcube = _jax_samples(jmodel, variables, x, eps).astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), jcube.mean(axis=0), rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(std.numpy(), jcube.std(axis=0), rtol=0, atol=2e-5 * scale)
    assert float(std.max()) > 1e-3 * scale


def test_chunking_does_not_change_the_statistics(tiny):
    _, _, net, x, eps = tiny
    whole = dtt.deblend_sample_stats(net, x, REPS, eps=eps, device="cpu")
    scale = float(whole[0].abs().max())
    for max_chunk in (2 * N, N - 1, 1):
        part = dtt.deblend_sample_stats(net, x, REPS, eps=eps, max_chunk=max_chunk, device="cpu")
        for a, b in zip(part, whole):
            assert float((a - b).abs().max()) <= 1e-6 * scale


def test_welford_merge_matches_jax():
    rng = np.random.default_rng(2)
    mean, m2, c_mean, c_m2 = (rng.normal(size=(3, 4)).astype(np.float32) for _ in range(4))
    m2, c_m2 = np.abs(m2), np.abs(c_m2)
    want = japi._welford_merge_jit(
        jnp.asarray(mean), jnp.asarray(m2), jnp.float32(5), jnp.asarray(c_mean), jnp.asarray(c_m2), jnp.float32(3)
    )
    got = tapi._welford_merge(
        torch.from_numpy(mean), torch.from_numpy(m2), 5.0, torch.from_numpy(c_mean), torch.from_numpy(c_m2), 3.0
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_sampling_is_seeded_by_its_generator(tiny):
    _, _, net, x, _ = tiny
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    a = dtt.deblend_samples(net, x, 3, generator=gen(5), device="cpu")
    b = dtt.deblend_samples(net, x, 3, generator=gen(5), device="cpu")
    c = dtt.deblend_samples(net, x, 3, generator=gen(6), device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    # no generator: a fresh one seeded 0, so two calls agree
    assert torch.equal(
        dtt.deblend_samples(net, x, 2, device="cpu"), dtt.deblend_samples(net, x, 2, generator=gen(0), device="cpu")
    )
    # the statistics see the draws deblend_samples makes from the same state
    mean, std = dtt.deblend_sample_stats(net, x, 3, generator=gen(5), device="cpu")
    scale = float(a.abs().max())
    assert float((mean - a.mean(dim=0)).abs().max()) <= 1e-5 * scale
    assert float((std - a.std(dim=0, unbiased=False)).abs().max()) <= 1e-5 * scale
    # one (S, S, B) stamp is a batch of one
    assert dtt.deblend_samples(net, x[0], 2, device="cpu").shape == (2, 1, 23, 23, 3)


def test_sampling_validates_its_arguments(tiny):
    _, _, net, x, eps = tiny
    with pytest.raises(ValueError, match="eps must be"):
        dtt.deblend_samples(net, x, REPS, eps=eps.transpose(1, 0, 2), device="cpu")
    with pytest.raises(ValueError, match="n_samples"):
        dtt.deblend_sample_stats(net, x, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dtt.deblend_samples(net, x, 2)
