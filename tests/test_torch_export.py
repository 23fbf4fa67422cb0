"""Export of the port's deblender through ``torch.export``
(debvader_tpu_torch/utils/export.py) and ``DeblendField(artifact=)``, on
the CPU: the nine tests of the JAX package's tests/test_export.py, each on
the port's artifact, and the port's own checks (a graph of ATen operations
only, the bfloat16 and fidelity models, the mean mode, devices).

The artifact runs the same ATen operations as the live model, so its
outputs are held bit for bit; the JAX package's tolerances (rtol 1e-5)
are what it needed between a jitted and an exported program.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import debvader_tpu_torch as dtt
from debvader_tpu_torch.config import ModelConfig, PipelineConfig
from debvader_tpu_torch.models.distributions import PixelNormal
from debvader_tpu_torch.utils import export as ex
from debvader_tpu_torch.utils.flux_cal import attach_flux_calibration

torch.set_num_threads(1)

TINY = ModelConfig(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))


def _model(cfg=TINY, seed=0):
    return dtt.init_vae(dtt.DeblenderVAE(cfg), seed).eval()


def _x(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(n, 23, 23, 3)).astype(np.float32))


def _live(model, x, generator):
    with torch.no_grad():
        return dtt.api.deblend_tensor(model, x, generator=generator)


def test_export_roundtrip_parity():
    assert ex.roundtrip_check(_model(), _x(4))


def test_export_to_file_and_reload(tmp_path):
    p = tmp_path / "deblender.pt2"
    ex.export_deblender(_model(), batch_size=2, path=p)
    assert p.stat().st_size > 1000
    call = ex.load_exported(p)
    with torch.no_grad():
        mean, std = call(torch.zeros(2, 23, 23, 3), torch.zeros(2, 4))
    assert mean.shape == (2, 23, 23, 3)
    assert float(std.min()) >= 1e-4 - 1e-9


def test_exported_sampling_is_driven_by_eps():
    """The artifact's latent is loc + L eps: other eps, other means; the
    same eps, the same means; artifact_forward's draws follow the
    generator."""
    call = ex.load_exported(ex.export_deblender(_model(), batch_size=2))
    x = _x(2, seed=1)
    e1, e2 = torch.randn(2, 4, generator=torch.Generator().manual_seed(1)), torch.randn(
        2, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        m1, m2, m1b = call(x, e1)[0], call(x, e2)[0], call(x, e1.clone())[0]
    assert not torch.allclose(m1, m2)
    assert torch.equal(m1, m1b)
    fwd = ex.artifact_forward(ex.export_deblender(_model()), device="cpu")
    a = fwd(x, torch.Generator().manual_seed(5))[0]
    b = fwd(x, torch.Generator().manual_seed(5))[0]
    c = fwd(x, torch.Generator().manual_seed(6))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_polymorphic_export_serves_any_batch():
    call = ex.load_exported(ex.export_deblender(_model()))
    for n in (1, 3, 8):
        with torch.no_grad():
            mean, _ = call(torch.zeros(n, 23, 23, 3), torch.zeros(n, 4))
        assert mean.shape == (n, 23, 23, 3)


def test_artifact_forward_matches_live_model():
    """The serving closure (finite guard, eps drawn as the live model draws
    it) reproduces the live sampled forward bit for bit; with
    normalise=True the bracket too."""
    model = _model()
    x = _x(5, seed=2)
    x[0, 3, 3, 0] = float("nan")
    blob = ex.export_deblender(model)
    for normalise in (False, True):
        want = dtt.api.deblend_tensor(model, x, normalise, torch.Generator().manual_seed(9))
        got = ex.artifact_forward(blob, normalise=normalise, device="cpu")(x, torch.Generator().manual_seed(9))
        torch.testing.assert_close(got[0], want.loc, rtol=0, atol=0)
        torch.testing.assert_close(got[1], want.scale, rtol=0, atol=0)


def test_export_bakes_flux_calibration():
    """A model that carries a flux calibration exports it: the artifact
    equals the calibrated live forward and differs from the raw one."""
    model = _model()
    raw = ex.export_deblender(model)
    attach_flux_calibration(model, [1.01, 0.99, 1.02])
    blob = ex.export_deblender(model)
    x = _x(3, seed=4)
    want = _live(model, x, torch.Generator().manual_seed(7))
    got = ex.artifact_forward(blob, device="cpu")(x, torch.Generator().manual_seed(7))
    torch.testing.assert_close(got[0], want.loc, rtol=0, atol=0)
    uncal = ex.artifact_forward(raw, device="cpu")(x, torch.Generator().manual_seed(7))
    assert not torch.allclose(uncal[0], got[0], rtol=1e-4)


def _scene(seed=5):
    rng = np.random.default_rng(seed)
    field = 0.01 * rng.normal(size=(1, 61, 61, 3)).astype(np.float32)
    yy, xx = np.mgrid[:61, :61]
    centers = []
    for _ in range(3):
        cy, cx = rng.integers(15, 46, size=2)
        field[0] += (rng.uniform(1, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0))[:, :, None]
        centers.append((cy - 30, cx - 30))
    return field.astype(np.float32), np.asarray(centers, np.float32)


@pytest.mark.parametrize("form", ["path", "bytes", "callable"])
def test_deblend_field_artifact_matches_live(tmp_path, form):
    """DeblendField(artifact=) serves the exported program through both
    routes with the live route's products, bit for bit."""
    model = _model()
    field, centers = _scene()
    p = tmp_path / "m.pt2"
    blob = ex.export_deblender(model, path=p)
    artifact = {"path": str(p), "bytes": blob, "callable": ex.artifact_forward(blob, device="cpu")}[form]
    kw = dict(cutout_size=23, nb_of_bands=3, cfg=PipelineConfig(cutout_size=23, nb_of_bands=3), device="cpu")

    def serve(**more):
        df = dtt.DeblendField(model, field, generator=torch.Generator().manual_seed(3), **kw, **more)
        cat, resid = df.deblend_and_render(centers)
        df2 = dtt.DeblendField(model, field, generator=torch.Generator().manual_seed(3), **kw, **more)
        res = df2.deblend_field(centers)
        return cat, resid, res, df2.get_residual_field()

    cat_ref, resid_ref, res_ref, rec_ref = serve()
    cat_art, resid_art, res_art, rec_art = serve(artifact=artifact)
    np.testing.assert_array_equal(resid_art, resid_ref)
    np.testing.assert_array_equal(cat_art["list_idx"], cat_ref["list_idx"])
    np.testing.assert_array_equal(rec_art, rec_ref)
    np.testing.assert_array_equal(np.stack(res_art["output_images_mean"]), np.stack(res_ref["output_images_mean"]))


def test_artifact_mutually_exclusive_with_mesh_and_quantized():
    model = _model()
    field = np.zeros((1, 61, 61, 3), np.float32)
    blob = ex.export_deblender(model)
    for other in ({"mesh": object()}, {"quantized": object()}):
        with pytest.raises(ValueError, match="mutually exclusive"):
            dtt.DeblendField(model, field, cutout_size=23, nb_of_bands=3, artifact=blob, device="cpu", **other)


def test_loading_imports_no_module_of_the_package(tmp_path):
    """An artifact loads and runs with torch alone: no module of
    debvader_tpu_torch (or of the JAX package) is imported, and the
    outputs equal the port's loader's."""
    model = _model()
    p = tmp_path / "m.pt2"
    ex.export_deblender(model, path=p)
    x, eps = _x(3, seed=6), torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    torch.save({"x": x, "eps": eps}, tmp_path / "in.pt")
    with torch.no_grad():
        want = ex.load_exported(p)(x, eps)[0]
    code = textwrap.dedent(
        f"""
        import sys, torch
        inp = torch.load({str(tmp_path / "in.pt")!r})
        call = torch.export.load({str(p)!r}).module()
        with torch.no_grad():
            loc, scale = call(inp["x"], inp["eps"])
        torch.save(loc, {str(tmp_path / "out.pt")!r})
        print(sorted(m for m in sys.modules if m.split(".")[0] in ("debvader_tpu_torch", "debvader_tpu", "jax")))
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert torch.equal(torch.load(tmp_path / "out.pt"), want)


def test_graph_holds_aten_ops_only():
    program = torch.export.load(__import__("io").BytesIO(ex.export_deblender(_model())))
    targets = {n.target for n in program.graph.nodes if n.op == "call_function"}
    assert targets
    for t in targets:
        assert isinstance(t, torch._ops.OpOverload) and t.namespace == "aten", t


@pytest.mark.parametrize(
    "extra",
    [dict(dtype="bfloat16"), dict(matmul_precision="high", limb_emulation=True), dict(decoder_subpixel=True)],
    ids=["bfloat16", "fidelity", "subpixel"],
)
def test_model_options_export(extra):
    """The bfloat16 model, the fidelity model (limb schemes plus its flux
    calibration) and the sub-pixel model export and equal the live
    forward bit for bit."""
    model = _model(ModelConfig(**{**TINY.__dict__, **extra}))
    if extra.get("limb_emulation"):
        attach_flux_calibration(model, n=4)
    x = _x(4, seed=7)
    got = ex.artifact_forward(ex.export_deblender(model), device="cpu")(x, torch.Generator().manual_seed(1))
    want = _live(model, x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(got[0], want.loc, rtol=0, atol=0)
    torch.testing.assert_close(got[1], want.scale, rtol=0, atol=0)


def test_mean_mode_takes_and_ignores_eps():
    model = _model()
    call = ex.load_exported(ex.export_deblender(model, z_mode="mean"))
    x = _x(3, seed=8)
    with torch.no_grad():
        a, b = call(x, torch.randn(3, 4))[0], call(x, torch.zeros(3, 4))[0]
        want = model(x, z_mode="mean")[0].loc
    assert torch.equal(a, b) and torch.equal(a, want)
    with pytest.raises(ValueError, match="z_mode"):
        ex.export_deblender(model, z_mode="median")


def test_artifact_served_on_another_device_raises(monkeypatch):
    """An artifact whose weights lie on another device than the one it is
    served on raises, and names the explicit move; moved by
    move_to_device_pass, it serves."""
    blob = ex.export_deblender(_model())
    program = torch.export.load(__import__("io").BytesIO(blob))
    assert ex._program_device(program).type == "cpu"
    monkeypatch.setattr(ex, "_program_device", lambda program: torch.device("meta"))
    with pytest.raises(ValueError, match="move_to_device_pass"):
        ex.artifact_forward(blob, device="cpu")
    monkeypatch.undo()
    from torch.export.passes import move_to_device_pass

    moved = move_to_device_pass(program, "cpu")
    with torch.no_grad():
        loc, _ = moved.module()(_x(2), torch.zeros(2, 4))
    assert loc.device.type == "cpu" and torch.isfinite(loc).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ex.artifact_forward(blob)


def test_pixel_normal_of_an_artifact():
    """The pipeline wraps an artifact's (loc, scale) as a PixelNormal."""
    loc, scale = ex.artifact_forward(ex.export_deblender(_model()), device="cpu")(_x(2), torch.Generator())
    dist = PixelNormal(loc, scale)
    assert torch.equal(dist.mean(), loc) and torch.equal(dist.stddev(), scale)
