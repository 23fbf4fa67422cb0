"""The port's command line (python -m debvader_tpu_torch), in process with
``--device cpu`` at the JAX package's ``TINY`` size, as tests/test_cli.py
drives the JAX CLI: train -> deblend -> detect -> serve -> export ->
deblend/serve --artifact, quantize -> serve --quantized, the iterative
route, the model flags, train --mesh, and what still raises.  ``detect`` is held bit for
bit against the JAX CLI's, ``deblend`` against the port's ``api.deblend``
with the same seed, ``--artifact`` against the live weights.
"""

import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from debvader_tpu_torch.cli import main

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TINY = ["--stamp-size", "23", "--bands", "3", "--latent", "4", "--filters", "4", "8", "--device", "cpu"]


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 23, 23, 3)).astype(np.float32)
    np.save(root / "x.npy", x)
    np.save(root / "y.npy", x)
    out = root / "weights"
    rc = main(["train", *TINY, "--blended", str(root / "x.npy"), "--isolated", str(root / "y.npy"),
               "--out", str(out), "--epochs", "1", "--batch-size", "4",
               "--metrics-log", str(root / "metrics.jsonl")])
    assert rc == 0
    assert (root / "metrics.jsonl").exists()
    assert (root / "weights.npz").exists()
    return root, out


def _field(root):
    rng = np.random.default_rng(2)
    f = 128
    img = (0.01 * rng.normal(size=(f, f))).astype(np.float32)
    yy, xx = np.mgrid[:f, :f]
    for cy, cx in ((40, 50), (90, 80)):
        img += 3 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.6**2))
    field = np.repeat(img[None, :, :, None], 3, axis=-1).astype(np.float32)
    path = root / "field.npy"
    np.save(path, field)
    return path


def _net(weights):
    import debvader_tpu_torch as dtt
    from debvader_tpu_torch.weights import load_flax_npz, state_dict_from_flax

    cfg = dtt.ModelConfig(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))
    net = dtt.DeblenderVAE(cfg)
    net.load_state_dict(state_dict_from_flax(load_flax_npz(str(weights) + ".npz"), cfg))
    return net.eval()


def test_cli_deblend_equals_api(weights_dir):
    import debvader_tpu_torch as dtt

    root, weights = weights_dir
    stamps = np.random.default_rng(1).normal(size=(4, 23, 23, 3)).astype(np.float32)
    np.save(root / "stamps.npy", stamps)
    rc = main(["deblend", *TINY, "--weights", str(weights), "--stamps", str(root / "stamps.npy"),
               "--out", str(root / "means.npy"), "--std", str(root / "std.npy")])
    assert rc == 0
    means = np.load(root / "means.npy")
    assert means.shape == stamps.shape and np.isfinite(means).all()
    want, dist = dtt.deblend(_net(weights), stamps, generator=torch.Generator().manual_seed(0), device="cpu")
    np.testing.assert_array_equal(means, want)
    np.testing.assert_array_equal(np.load(root / "std.npy"), dist.stddev().numpy())


def test_cli_detect_equals_jax_and_serve(weights_dir):
    from debvader_tpu.cli import main as jax_main

    root, weights = weights_dir
    field = _field(root)
    args = ["--field", str(field), "--tile", "64", "--overlap", "16", "--thresh", "25.0", "--detection-band", "0"]
    assert main(["detect", *args, "--out", str(root / "centers.npy"), "--device", "cpu"]) == 0
    assert jax_main(["detect", *args, "--out", str(root / "centers_jax.npy")]) == 0
    centers = np.load(root / "centers.npy")
    assert len(centers) == 2
    np.testing.assert_array_equal(centers, np.load(root / "centers_jax.npy"))

    rc = main(["serve", *TINY, "--weights", str(weights), "--field", str(field),
               "--centers", str(root / "centers.npy"), "--out-prefix", str(root / "out"),
               "--optimise-positions", "--measure"])
    assert rc == 0
    residual = np.load(str(root / "out_residual.npy"))
    assert residual.shape == (1, 128, 128, 3)
    lines = (root / "out_catalog.csv").read_text().splitlines()
    header = lines[0].split(",")
    assert len(lines) == 3
    for col in ("mse_center", "shifts_0", "flux_0", "passed_cuts"):
        assert col in header


def test_cli_serve_equals_in_process_route(weights_dir):
    """serve --centers writes the residual and the catalog of
    DeblendField.deblend_and_render with the same seed."""
    import debvader_tpu_torch as dtt

    root, weights = weights_dir
    field = _field(root)
    centers = np.asarray([[-24.0, -14.0], [26.0, 16.0]], np.float32)
    np.save(root / "centers_fixed.npy", centers)
    assert main(["serve", *TINY, "--weights", str(weights), "--field", str(field),
                 "--centers", str(root / "centers_fixed.npy"), "--out-prefix", str(root / "inproc")]) == 0
    cfg = dtt.PipelineConfig(cutout_size=23, nb_of_bands=3)
    df = dtt.DeblendField(_net(weights), np.load(field), cutout_size=23, nb_of_bands=3, cfg=cfg, device="cpu")
    cat, residual = df.deblend_and_render(centers)
    np.testing.assert_array_equal(np.load(root / "inproc_residual.npy"), residual)
    with open(root / "inproc_catalog.csv") as f:
        rows = list(csv.DictReader(f))
    for col in ("mse_center", "galaxy_distances_to_center_x", "epistemic_norm"):
        got = np.asarray([float(r[col]) for r in rows], np.float32)
        np.testing.assert_array_equal(got, np.asarray(cat[col], np.float32), err_msg=col)


def test_cli_export_and_artifact(weights_dir):
    root, weights = weights_dir
    field = _field(root)
    centers = np.asarray([[-24.0, -14.0], [26.0, 16.0]], np.float32)
    np.save(root / "centers_art.npy", centers)
    assert main(["export", *TINY, "--weights", str(weights), "--out", str(root / "fwd.pt2")]) == 0
    assert (root / "fwd.pt2").stat().st_size > 1000
    assert main(["export", *TINY, "--weights", str(weights), "--out", str(root / "fwd2.pt2"), "--batch", "2"]) == 0
    stamps = np.random.default_rng(1).normal(size=(4, 23, 23, 3)).astype(np.float32)
    np.save(root / "stamps_art.npy", stamps)
    for extra, tag in (([], "live"), (["--artifact", str(root / "fwd.pt2")], "art")):
        assert main(["deblend", *TINY, "--weights", str(weights), *extra, "--stamps", str(root / "stamps_art.npy"),
                     "--out", str(root / f"means_{tag}.npy")]) == 0
        assert main(["serve", *TINY, "--weights", str(weights), *extra, "--field", str(field),
                     "--centers", str(root / "centers_art.npy"), "--out-prefix", str(root / f"serve_{tag}")]) == 0
    np.testing.assert_array_equal(np.load(root / "means_art.npy"), np.load(root / "means_live.npy"))
    np.testing.assert_array_equal(np.load(root / "serve_art_residual.npy"), np.load(root / "serve_live_residual.npy"))


def test_cli_version_and_help():
    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0
    out = subprocess.run([sys.executable, "-m", "debvader_tpu_torch", "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "import-weights" in out.stdout
    out = subprocess.run([sys.executable, "-m", "debvader_tpu_torch", "quantize", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "PRNGKey(11)" in " ".join(out.stdout.split())


def test_cli_deblend_model_flags(weights_dir):
    """--dtype bfloat16 --f32-stages 1 reach the model's config."""
    import debvader_tpu_torch as dtt

    root, weights = weights_dir
    stamps = np.random.default_rng(3).normal(size=(4, 23, 23, 3)).astype(np.float32)
    np.save(root / "stamps_mp.npy", stamps)
    rc = main(["deblend", *TINY, "--weights", str(weights), "--stamps", str(root / "stamps_mp.npy"),
               "--out", str(root / "means_mp.npy"), "--dtype", "bfloat16", "--f32-stages", "1"])
    assert rc == 0
    means = np.load(root / "means_mp.npy")
    net = _net(weights)
    bf = dtt.DeblenderVAE(dtt.ModelConfig(**{**net.cfg.__dict__, "dtype": "bfloat16", "decoder_f32_stages": 1}))
    bf.load_state_dict(net.state_dict())
    want, _ = dtt.deblend(bf.eval(), stamps, device="cpu")
    np.testing.assert_array_equal(means, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_quantize_and_serve(weights_dir, dtype):
    """quantize (with QAT) then serve --quantized; ``--dtype bfloat16``
    writes a bfloat16 bundle, which serves the same field as the bundle's
    own DeblendField(quantized=) does, bit for bit."""
    import debvader_tpu_torch as dtt
    from debvader_tpu_torch.models.quantized import load_quantized

    root, weights = weights_dir
    field = _field(root)
    np.save(root / "centers_q.npy", np.asarray([[-24.0, -14.0], [26.0, 16.0]], np.float32))
    bundle = root / f"int8_bundle_{dtype}"
    rc = main(["quantize", *TINY, "--dtype", dtype, "--weights", str(weights), "--out", str(bundle), "--calib-n",
               "8", "--qat-steps", "2", "--qat-batch", "4"])
    assert rc == 0
    assert json.loads((root / f"int8_bundle_{dtype}.json").read_text())["model_cfg"]["dtype"] == dtype
    rc = main(["serve", *TINY, "--weights", str(weights), "--field", str(field),
               "--centers", str(root / "centers_q.npy"), "--out-prefix", str(root / f"q8_{dtype}"),
               "--quantized", str(bundle)])
    assert rc == 0
    residual = np.load(str(root / f"q8_{dtype}_residual.npy"))
    assert np.isfinite(residual).all()
    if dtype == "bfloat16":
        qv = load_quantized(bundle, device="cpu")
        assert qv.cfg.dtype == "bfloat16"
        cfg = dtt.PipelineConfig(cutout_size=23, nb_of_bands=3)
        _, want = dtt.DeblendField(_net(weights), np.load(field), cutout_size=23, nb_of_bands=3,
                                   quantized=qv, cfg=cfg, device="cpu").deblend_and_render(
            np.load(root / "centers_q.npy"))
        np.testing.assert_array_equal(residual, want)


def test_cli_iterative_serve(weights_dir):
    root, weights = weights_dir
    field = _field(root)
    rc = main(["serve", *TINY, "--weights", str(weights), "--field", str(field), "--out-prefix", str(root / "it"),
               "--iterative", "--tile", "64", "--overlap", "16", "--thresh", "25", "--detection-band", "0"])
    assert rc == 0
    assert np.load(str(root / "it_residual.npy")).shape == (1, 128, 128, 3)


def test_cli_detect_lutz(weights_dir):
    root, _ = weights_dir
    path = _field(root)
    rc = main(["detect", "--field", str(path), "--out", str(root / "centers_lutz.npy"), "--tile", "64",
               "--overlap", "16", "--thresh", "25.0", "--detection-band", "0", "--deblend-algo", "lutz",
               "--device", "cpu"])
    assert rc == 0
    assert len(np.load(root / "centers_lutz.npy")) >= 2


def test_cli_train_on_a_mesh(weights_dir, tmp_path):
    """train --mesh 4 (the CPU four times under --device cpu): the
    single-device run's epoch metrics within rtol 1e-4 (the mesh
    histories' tolerance, tests/test_torch_mesh_training.py) and its
    weights within 5e-3; --mesh 4 without four cards raises."""
    root, out = weights_dir
    rc = main(["train", *TINY, "--blended", str(root / "x.npy"), "--isolated", str(root / "y.npy"),
               "--out", str(tmp_path / "w"), "--epochs", "1", "--batch-size", "4", "--mesh", "4",
               "--metrics-log", str(tmp_path / "metrics.jsonl")])
    assert rc == 0
    want = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    got = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    a, b = np.load(str(tmp_path / "w.npz")), np.load(str(out) + ".npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=5e-3, err_msg=k)
    if torch.cuda.device_count() < 4:
        with pytest.raises((ValueError, RuntimeError)):
            main(["train", *[a for a in TINY if a not in ("--device", "cpu")], "--blended", str(root / "x.npy"),
                  "--isolated", str(root / "y.npy"), "--out", str(tmp_path / "w4"), "--mesh", "4"])


def test_cli_what_still_raises(weights_dir, tmp_path):
    """Nothing raises NotImplementedError any more: import-weights, the
    last command that did, reads a TensorBundle (the packaged sim_demo
    weights written as one) into a weights file equal to those weights,
    and a checkpoint that is not there raises FileNotFoundError."""
    from debvader_tpu_torch.utils.tf_checkpoint import write_bundle
    from debvader_tpu_torch.utils.weight_import import export_to_tensors
    from debvader_tpu_torch.weights import load_flax_npz, weights_file

    with pytest.raises(FileNotFoundError):
        main(["import-weights", "--ckpt", str(tmp_path / "model"), "--out", str(tmp_path / "w")])
    shipped = load_flax_npz(weights_file("sim_demo"))
    write_bundle(tmp_path / "ckpt" / "sim_demo.ckpt", export_to_tensors(shipped), shards=2)
    assert main(["import-weights", "--ckpt", str(tmp_path / "ckpt" / "sim_demo.ckpt"), "--out",
                 str(tmp_path / "w")]) == 0
    got = load_flax_npz(tmp_path / "w.npz")
    assert got.keys() == shipped.keys()
    for k, v in shipped.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_cli_without_device_raises_without_cuda(weights_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, weights = weights_dir
    field = _field(root)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["detect", "--field", str(field), "--out", str(root / "c.npy")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["deblend", "--stamp-size", "23", "--bands", "3", "--latent", "4", "--filters", "4", "8",
              "--weights", str(weights), "--stamps", str(root / "x.npy"), "--out", str(root / "m.npy")])
