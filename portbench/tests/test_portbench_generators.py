"""The torch copy of simulate_batch against the program's numpy one: the
same profile and blur arithmetic, and the same statistics at a small
size."""

import numpy as np
import torch

from debvader_tpu_torch.data import simulate as np_sim
from portbench import generators


def test_profile_and_blur_match_the_numpy_version():
    rng = np.random.default_rng(3)
    n = 16
    params = [rng.uniform(20, 38, n), rng.uniform(20, 38, n), rng.uniform(5, 50, n), rng.uniform(1.5, 4, n),
              rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n)]
    scale = np_sim._band_scale(rng.uniform(-0.15, 0.15, n).astype(np.float32), 6)
    want = np_sim._profile(59, *params, scale)
    got = generators._profile(59, *(torch.tensor(p, dtype=torch.float32) for p in params), torch.tensor(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(generators._psf_blur(torch.tensor(want)).numpy(), np_sim._psf_blur(want),
                               rtol=1e-5, atol=1e-7)


def test_statistics_match_simulate_batch():
    n = 2000
    want = np_sim.simulate_batch(np.random.default_rng(11), n)
    got = [a.numpy() for a in generators.simulate_batch(generators.make_generator(11, 0, "cpu"), n)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        flux_g, flux_w = g.sum(axis=(1, 2, 3)), w.sum(axis=(1, 2, 3))
        assert abs(flux_g.mean() / flux_w.mean() - 1) < 0.05
        assert abs(flux_g.std() / flux_w.std() - 1) < 0.1
        assert abs(g.max(axis=(1, 2, 3)).mean() / w.max(axis=(1, 2, 3)).mean() - 1) < 0.05
    # the noise: isolated noisy against isolated clean
    noise = got[1] - got[2]
    assert abs(noise.std() / 0.02 - 1) < 0.01


def test_seeds_give_their_own_inputs():
    a = generators.simulate_batch(generators.make_generator(2**31 + 5, 0, "cpu"), 4)[0]
    b = generators.simulate_batch(generators.make_generator(2**31 + 5, 0, "cpu"), 4)[0]
    c = generators.simulate_batch(generators.make_generator(2**31 + 6, 0, "cpu"), 4)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def _chip_smoke_make_field():
    import importlib.util

    from portbench.harness import REPO

    spec = importlib.util.spec_from_file_location("chip_smoke_generators", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.make_field


def test_make_field_matches_chip_smoke_statistics():
    size, n_gal = 768, 1200
    want = _chip_smoke_make_field()(size, n_gal, seed=4)[0]
    got = generators.make_field(generators.make_generator(4, 0, "cpu"), size, n_gal)[0][0].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    # light per galaxy and band: E[flux] = 27.5 for both, to the sampling spread of 1,200 draws
    for a in (got, want):
        assert abs(a.sum() / (n_gal * 6) / 27.5 - 1) < 0.05
    # the 15-pixel border holds noise alone (galaxies sit 40 px in, their stamps reach 20 px)
    for a in (got, want):
        assert abs(a[:15].std() / 0.02 - 1) < 0.02
    assert abs(np.percentile(got, 99.9) / np.percentile(want, 99.9) - 1) < 0.1


def test_make_field_is_the_same_for_a_seed():
    a, ca = generators.make_field(generators.make_generator(2**31 + 9, 0, "cpu"), 256, 40)
    b, cb = generators.make_field(generators.make_generator(2**31 + 9, 0, "cpu"), 256, 40)
    assert torch.equal(a, b) and torch.equal(ca, cb)


def test_make_field_truth_is_where_the_light_is():
    field, centres = generators.make_field(generators.make_generator(2**31 + 13, 0, "cpu"), 256, 12, noise=0.0)
    assert centres.shape == (12, 2) and centres.dtype == torch.float64
    for y, x in torch.round(centres).to(torch.int64).tolist():
        # the profile's peak lies within a pixel of its centre
        window = field[0, y - 3: y + 4, x - 3: x + 4].sum(-1)
        peak = divmod(int(torch.argmax(window)), 7)
        assert abs(peak[0] - 3) <= 1 and abs(peak[1] - 3) <= 1
