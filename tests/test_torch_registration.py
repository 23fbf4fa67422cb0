"""The PyTorch port's position registration held against the JAX package on
the CPU: ``registration_window``, the windowed Gauss-Newton fit
(``position_optimization_batch_windowed``) and its full-field branch
(``position_optimization_batch``), the 2x2 solve, the written-out
Jacobians against ``torch.func.jacfwd``, and ``optimise_positions=True`` on
both DeblendField routes with the sim_demo weights.

Tolerances: one Gauss-Newton step on arbitrary inputs within 1e-5 px of
JAX; 20 steps on well-posed inputs (the field is the shifted prediction
plus small noise) within 1e-4 px.  The sums of J^T J and J^T r add in
another order on the two sides, which is all that differs.  On ill-posed
inputs (noise fields, 20 steps) the fit wanders and the largest
difference found is printed, not held.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import debvader_tpu as dt
import debvader_tpu_torch as dtt
from debvader_tpu.config import PipelineConfig as JaxPipelineConfig
from debvader_tpu.ops import registration as jreg
from debvader_tpu_torch.kernels import registration as kreg
from debvader_tpu_torch.kernels.render import subpixel_shift
from debvader_tpu_torch.ops import registration as treg
from debvader_tpu_torch.ops.shift import render_field

torch.set_num_threads(1)

S, F = 15, 64


def _stamps(rng, n, s=S, sigma=(1.8, 3.0)):
    """Smooth single-band galaxy stamps: elliptical Gaussians near the
    stamp centre."""
    yy, xx = np.mgrid[:s, :s]
    out = []
    for _ in range(n):
        cy, cx = (s - 1) / 2 + rng.uniform(-1, 1, 2)
        sy, sx = rng.uniform(*sigma, 2)
        out.append(rng.uniform(0.5, 2.0) * np.exp(-((yy - cy) ** 2) / (2 * sy * sy) - (xx - cx) ** 2 / (2 * sx * sx)))
    return np.asarray(out, np.float32)


# offsets from the field centre: windows flush against all four borders,
# and stamps hanging over the field's edge
_BORDERS = np.array(
    [[-20.3, 0.4], [21.6, 3.2], [0.7, -22.8], [-4.1, 24.2], [-26.5, -26.5], [27.4, 27.1], [-25.0, 26.0]],
    np.float32,
)
_INTERIOR = np.array([[0.0, 0.0], [3.3, -12.6], [-12.4, 11.9], [12.75, 10.25], [-9.5, -13.0]], np.float32)


def _case(name, rng, well_posed):
    """(field band, stamps, offsets, bound).  Well-posed: the field is each
    stamp rendered at its offset plus a shift within the bound, plus noise
    of 1e-3; else noise of 0.05 under stamps at other, random positions."""
    bound = 3.0
    offsets = _BORDERS if name == "borders" else _INTERIOR
    n = len(offsets)
    preds = _stamps(rng, n)
    truth = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    if name == "clip":
        bound = 0.5
        truth = np.sign(rng.uniform(-1, 1, (n, 2))).astype(np.float32) * 1.7
    if not well_posed:
        truth = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
        preds_field = _stamps(rng, n)
    else:
        preds_field = preds
    field = render_field(torch.from_numpy(preds_field[..., None]), torch.from_numpy(offsets + truth), F)[..., 0]
    field = field.numpy() + (1e-3 if well_posed else 0.05) * rng.normal(size=(F, F)).astype(np.float32)
    if name == "nan":
        field[F // 2, F // 2 + 1] = np.nan
        field[F // 2 + 3, F // 2 - 2] = np.inf
    return field.astype(np.float32), preds, offsets, bound, truth


def _both(field, preds, offsets, bound, iterations, **kw):
    want = np.asarray(
        jreg.position_optimization_batch_windowed(
            jnp.asarray(field), jnp.asarray(preds), jnp.asarray(offsets), bound=bound, iterations=iterations, **kw
        )
    )
    got = treg.position_optimization_batch_windowed(
        torch.from_numpy(field), torch.from_numpy(preds), torch.from_numpy(offsets), bound=bound,
        iterations=iterations, **kw,
    ).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    return got, want


@pytest.mark.parametrize("stamp, bound", [(59, 3.0), (15, 3.0), (15, 1.5), (21, 0.4), (9, 7.0)])
def test_registration_window_matches_jax(stamp, bound):
    assert treg.registration_window(stamp, bound) == jreg.registration_window(stamp, bound)


@pytest.mark.parametrize("name", ["interior", "borders", "nan", "clip"])
def test_one_step_matches_jax_on_arbitrary_inputs(name):
    """One Gauss-Newton step from x = 0, where the knot convention picks
    the first step, on noise fields under stamps elsewhere."""
    field, preds, offsets, bound, _ = _case(name, np.random.default_rng(1), well_posed=False)
    got, want = _both(field, preds, offsets, bound, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.isfinite(got).all() and (np.abs(got) <= bound).all()


@pytest.mark.parametrize("name", ["interior", "borders", "nan", "clip"])
def test_twenty_steps_match_jax_on_well_posed_inputs(name):
    field, preds, offsets, bound, truth = _case(name, np.random.default_rng(2), well_posed=True)
    got, want = _both(field, preds, offsets, bound, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (np.abs(got) <= bound).all()
    if name == "clip":
        # every true shift lies beyond the bound: the fit ends on the clip
        np.testing.assert_array_equal(np.abs(got), np.full_like(got, bound))
    elif name == "interior":
        np.testing.assert_allclose(got, truth, atol=0.05)


def test_twenty_steps_on_ill_posed_inputs_report_the_difference():
    """Noise fields: the fit may wander or bounce off the clip, and the two
    sides' rounding grows; the largest difference is reported, not held."""
    worst = 0.0
    for name in ("interior", "borders", "nan", "clip"):
        field, preds, offsets, bound, _ = _case(name, np.random.default_rng(3), well_posed=False)
        got, want = _both(field, preds, offsets, bound, 20)
        assert np.isfinite(got).all() and (np.abs(got) <= bound).all()
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"ill-posed 20-step fits: largest difference from JAX {worst} px")


@pytest.mark.parametrize("iterations", [1, 20])
def test_rectangular_band_with_row_bounds_matches_jax(iterations):
    """A (48, 64) band, windows kept inside rows [4, 44): the sharded
    serving path's band form, which the port takes."""
    rng = np.random.default_rng(4)
    preds = _stamps(rng, 4)
    offsets = np.array([[-14.2, 3.5], [15.6, -20.1], [0.5, 25.0], [-3.0, -3.0]], np.float32)
    band = np.zeros((48, 64), np.float32)
    band += render_field(torch.from_numpy(preds[..., None]), torch.from_numpy(offsets + 0.6), 64)[8:56, :, 0].numpy()
    band += 1e-3 * rng.normal(size=band.shape).astype(np.float32)
    got, want = _both(band, preds, offsets, 3.0, iterations, row_bounds=(4, 44))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if iterations == 1 else 1e-4)


@pytest.mark.parametrize("shape, row_bounds", [((24, 24), (0, 24)), ((20, 24), None)])
def test_small_band_with_row_bounds_or_rectangular_raises_as_jax(shape, row_bounds):
    band = np.zeros(shape, np.float32)
    preds = _stamps(np.random.default_rng(5), 2)
    offsets = np.zeros((2, 2), np.float32)
    match = "smaller than the 27px registration window"
    with pytest.raises(ValueError, match=match):
        jreg.position_optimization_batch_windowed(
            jnp.asarray(band), jnp.asarray(preds), jnp.asarray(offsets), row_bounds=row_bounds
        )
    with pytest.raises(ValueError, match=match):
        treg.position_optimization_batch_windowed(
            torch.from_numpy(band), torch.from_numpy(preds), torch.from_numpy(offsets), row_bounds=row_bounds
        )


@pytest.mark.parametrize("iterations", [1, 20])
def test_full_field_branch_matches_jax(iterations):
    """A field smaller than the window takes the full-field fit (the
    generic shift's floor convention), directly and through the windowed
    entry."""
    rng = np.random.default_rng(6)
    f = 24
    preds = _stamps(rng, 4)
    offsets = np.array([[0.0, 0.0], [1.3, -0.6], [-2.4, 1.9], [3.5, -3.25]], np.float32)
    truth = rng.uniform(-1, 1, (4, 2)).astype(np.float32)
    field = np.zeros((f, f), np.float32)
    field += render_field(torch.from_numpy(preds[1:2, ..., None]), torch.from_numpy(offsets[1:2] + truth[1:2]), f)[
        ..., 0
    ].numpy()
    field += 1e-3 * rng.normal(size=(f, f)).astype(np.float32)
    field[3, 5] = np.nan
    want = np.asarray(
        jreg.position_optimization_batch(jnp.asarray(field), jnp.asarray(preds), jnp.asarray(offsets), iterations=iterations)
    )
    got = treg.position_optimization_batch(
        torch.from_numpy(field), torch.from_numpy(preds), torch.from_numpy(offsets), iterations=iterations
    ).numpy()
    via_window, _ = _both(field, preds, offsets, 3.0, iterations)
    np.testing.assert_array_equal(via_window, got)
    if iterations == 1:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        # only source 1 is in the field: the others fit noise
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
        print(f"full-field ill-posed rows: largest difference from JAX {float(np.abs(got - want).max())} px")


@pytest.mark.parametrize("detected", [[0.0, 0.0], [7.0, -9.0]])
def test_known_offset_is_recovered(detected):
    """A stamp placed 0.37 px down and 0.62 px left of an integer detection
    in a zero field: both packages recover the offset within 0.01 px."""
    rng = np.random.default_rng(7)
    preds = _stamps(rng, 1, sigma=(2.2, 2.6))
    det = np.asarray([detected], np.float32)
    truth = np.array([[0.37, -0.62]], np.float32)
    field = render_field(torch.from_numpy(preds[..., None]), torch.from_numpy(det + truth), F)[..., 0].numpy()
    got, want = _both(field, preds, det, 3.0, 20)
    np.testing.assert_allclose(got, truth, atol=0.01)
    np.testing.assert_allclose(want, truth, atol=0.01)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("x", [[0.0, 0.0], [1.0, -2.0], [0.37, -0.62], [-2.9, 2.45]])
def test_window_jacobian_matches_jacfwd(x):
    """The written-out Jacobian of the windowed shift against forward-mode
    autodiff of the plain blend, at the knot (integer x, where x0 = 0
    starts) and off it.  ix = ceil(x) - 1 is held fixed, as its derivative
    is zero."""
    rng = np.random.default_rng(8)
    preds = torch.from_numpy(_stamps(rng, 2))
    band = torch.from_numpy(rng.normal(size=(F, F)).astype(np.float32))
    offsets = torch.tensor([[2.3, -4.6], [-7.0, 3.0]])
    _, base_p, bp = kreg.windowed_setup(band, preds, offsets, 3.0, 0, F)
    xs = torch.tensor([x, x[::-1]], dtype=torch.float32)
    _, d0, d1 = kreg.shift_window(base_p, xs, bp, with_jacobian=True)
    win = base_p.shape[1] - 2 * bp
    for i in range(2):
        ix = torch.ceil(xs[i]) - 1

        def blend(xx, i=i, ix=ix):
            f2 = xx - ix
            start = (bp - ix.to(torch.int64) - 1).tolist()
            e = base_p[i, start[0] : start[0] + win + 1, start[1] : start[1] + win + 1]
            tmp = f2[0] * e[:win] + (1.0 - f2[0]) * e[1:]
            out = f2[1] * tmp[:, :win] + (1.0 - f2[1]) * tmp[:, 1:]
            it = torch.arange(win, dtype=torch.float32)
            inside = ((it[:, None] >= xs[i, 0]) & (it[:, None] <= win - 1 + xs[i, 0])) & (
                (it[None, :] >= xs[i, 1]) & (it[None, :] <= win - 1 + xs[i, 1])
            )
            return torch.where(inside, out, torch.zeros(()))

        jac = torch.func.jacfwd(blend)(xs[i])  # (win, win, 2)
        np.testing.assert_allclose(d0[i].numpy(), jac[..., 0].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(d1[i].numpy(), jac[..., 1].numpy(), rtol=0, atol=1e-6)
        assert float(jac.abs().max()) > 0.1


@pytest.mark.parametrize("shift", [[0.0, 0.0], [1.25, -0.5], [-3.0, 2.0]])
def test_full_shift_jacobian_matches_jacfwd(shift):
    """The generic shift's Jacobian (the full-field fit's) against
    forward-mode autodiff of the same shift; floor's derivative is zero."""
    img = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 20, 20)).astype(np.float32))
    s = torch.tensor([shift], dtype=torch.float32)
    _, ddy, ddx = subpixel_shift(img, s, with_jacobian=True)
    jac = torch.func.jacfwd(lambda v: subpixel_shift(img, v[None])[0])(s[0])
    np.testing.assert_allclose(ddy[0].numpy(), jac[..., 0].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ddx[0].numpy(), jac[..., 1].numpy(), rtol=0, atol=1e-6)


def test_generic_shift_matches_jax():
    from debvader_tpu.ops.shift import subpixel_shift as jshift

    img = np.random.default_rng(10).normal(size=(3, 17, 21)).astype(np.float32)
    shifts = np.array([[0.0, 0.0], [2.3, -1.7], [-5.5, 30.0]], np.float32)
    got = subpixel_shift(torch.from_numpy(img), torch.from_numpy(shifts)).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], np.asarray(jshift(jnp.asarray(img[i]), jnp.asarray(shifts[i]))), atol=1e-6)


def test_lu_solve_rounds_as_jnp_linalg_solve():
    """The 2x2 solve bit for bit against jnp.linalg.solve (LAPACK on the
    CPU) on J^T J + 1e-6 I systems over six decades of scale."""
    import jax

    rng = np.random.default_rng(11)
    jac = (rng.normal(size=(4000, 40, 2)) * rng.uniform(1e-3, 1e3, (4000, 1, 2))).astype(np.float32)
    r = rng.normal(size=(4000, 40)).astype(np.float32)

    def one(j, rr):
        a = j.T @ j + 1e-6 * jnp.eye(2)
        y = j.T @ rr
        return a, y, jnp.linalg.solve(a, y)

    a, y, want = (np.array(v) for v in jax.vmap(one)(jnp.asarray(jac), jnp.asarray(r)))
    at, yt = torch.from_numpy(a), torch.from_numpy(y)
    x0, x1 = kreg.lu_solve2(at[:, 0, 0], at[:, 0, 1], at[:, 1, 0], at[:, 1, 1], yt[:, 0], yt[:, 1])
    np.testing.assert_array_equal(torch.stack([x0, x1], -1).numpy(), want)


def test_pipeline_config_registration_defaults_match_jax():
    for name in ("position_bounds", "gn_iterations"):
        assert getattr(dtt.PipelineConfig(), name) == getattr(JaxPipelineConfig(), name)


# ------------------------------------------------------------ DeblendField


def _blob_field(size=160, bands=6, seed=0):
    """A seeded field of Gaussian galaxies with a band SED; each lies a
    fraction of a pixel from the offset given for it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    field = 0.02 * rng.normal(size=(size, size, bands))
    centers = np.array([[-30.0, -25.0], [0.0, 3.0], [20.0, -11.0], [35.0, 40.0], [-6.0, 30.0]])
    for cy, cx in centers + rng.uniform(-0.8, 0.8, centers.shape):
        s = rng.uniform(1.5, 3.0)
        sed = np.exp(rng.uniform(-0.15, 0.15) * np.arange(bands))
        prof = np.exp(-((yy - size // 2 - cy) ** 2 + (xx - size // 2 - cx) ** 2) / (2 * s * s))
        field += rng.uniform(0.5, 2.0) * prof[..., None] * sed
    return field[None].astype(np.float32), centers.astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    return dt.load_deblender("sim_demo"), dtt.load_deblender("sim_demo", device="cpu")


# Shifts through the sim_demo model, whose float32 means differ from JAX's
# by up to 2e-5 of their scale: held to the well-posed bound (3.2e-6 px
# found on this field).
_SHIFT_TOL = 1e-4


def test_deblend_field_optimise_positions_matches_jax(nets):
    """The record-array route (the JAX behaviour in
    tests/test_pipeline.py:157): shifts within the bound and near JAX's,
    and the residual rendered at offset + shift."""
    jnet, tnet = nets
    field, centers = _blob_field()
    jdf = dt.DeblendField(jnet, field, z_mode="mean")
    tdf = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu")
    want = jdf.deblend_field(centers, optimise_positions=True)
    got = tdf.deblend_field(centers, optimise_positions=True)
    assert got.dtype == want.dtype
    gs, ws = np.stack(list(got.shifts)), np.stack(list(want.shifts))
    assert gs.shape == (5, 2) and gs.dtype == np.float32
    assert (np.abs(gs) <= 3.0).all() and np.abs(gs).max() > 0.05
    np.testing.assert_allclose(gs, ws, rtol=0, atol=_SHIFT_TOL)
    scale = float(np.abs(field).max())
    np.testing.assert_allclose(tdf.get_residual_field(), jdf.get_residual_field(), rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("order", [1, 3])
def test_stream_optimise_positions_matches_jax_and_the_record_array_route(nets, order):
    """deblend_and_render(optimise_positions=True) in chunks of 2 against
    JAX's stream, and against the port's own record-array route with the
    same shifts."""
    jnet, tnet = nets
    field, centers = _blob_field(seed=1)
    cfg = dict(interp_order=order, source_chunk=2)
    jdf = dt.DeblendField(jnet, field, z_mode="mean", cfg=JaxPipelineConfig(**cfg))
    tdf = dtt.DeblendField(tnet, field, z_mode="mean", device="cpu", cfg=dtt.PipelineConfig(**cfg))
    jcat, jres = jdf.deblend_and_render(centers, optimise_positions=True)
    tcat, tres = tdf.deblend_and_render(centers, optimise_positions=True)
    np.testing.assert_allclose(np.stack(list(tcat.shifts)), np.stack(list(jcat.shifts)), rtol=0, atol=_SHIFT_TOL)
    scale = float(np.abs(field).max())
    np.testing.assert_allclose(tres, jres, rtol=0, atol=2e-4 * scale)
    rec = tdf.deblend_field(centers, optimise_positions=True)
    np.testing.assert_array_equal(np.stack(list(rec.shifts)), np.stack(list(tcat.shifts)))
    np.testing.assert_allclose(tdf.get_residual_field(), tres, rtol=0, atol=1e-5 * scale)
    _, fields = tdf.deblend_and_predict(centers, optimise_positions=True)
    np.testing.assert_allclose(fields["residual_field"], tres, rtol=0, atol=1e-5 * scale)
