"""The PyTorch port's model, weights and stamp API held against the JAX
package on the CPU, plus the port's import hygiene.

Both frameworks get the same numpy inputs.  Float tolerances: both sides
run float32 on the CPU, so outputs differ only by the order in which the
convolution and matmul libraries sum (a few float32 ulps of the largest
partial sums); 2e-5 relative to the output's scale is the bound the repo
already holds single TF-SAME conv layers to (tests/test_torch_parity.py).
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import debvader_tpu_torch as dtt
from debvader_tpu_torch.models.quantized import load_quantized
from debvader_tpu.config import ModelConfig as JaxModelConfig
from debvader_tpu.models.vae import create_model_vae, init_vae
from debvader_tpu_torch.models.distributions import fill_triangular
from debvader_tpu_torch.weights import (
    default_weights_dir,
    flatten_flax,
    load_flax_npz,
    state_dict_from_flax,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
N_PARAMS = 8_318_452


def _close(got, want, rel=2e-5):
    """|got - want| <= rel * max|want| elementwise (float32 sum order)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def sim_demo():
    import debvader_tpu as dt

    model, variables = dt.load_deblender("sim_demo")
    return model, variables, dtt.load_deblender("sim_demo", device="cpu")


def _stamps(n, size=59, bands=6, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] - (size - 1) / 2
    prof = np.exp(-(yy**2 + xx**2) / (2 * 3.0**2))
    amp = rng.uniform(0.1, 1.0, (n, 1, 1, bands))
    return (amp * prof[None, :, :, None] + 0.02 * rng.normal(size=(n, size, size, bands))).astype(np.float32)


def _perturbed(variables, seed):
    """Random non-trivial weights: init values plus noise, positive BN var
    (init leaves PReLU alphas at 0 and BN stats at 0/1)."""
    rng = np.random.default_rng(seed)
    flat = flatten_flax(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k, v in flat.items():
        noise = 0.05 * rng.normal(size=v.shape).astype(np.float32)
        out[k] = (np.abs(v) + 0.5 + noise if k.endswith("/var") else v + noise).astype(np.float32)
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def test_fill_triangular_tfp_order():
    got = fill_triangular(torch.arange(1.0, 7.0))
    np.testing.assert_array_equal(got.numpy(), [[4, 0, 0], [6, 5, 0], [3, 2, 1]])


def test_narrow_random_model_matches_jax():
    kw = dict(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(8, 16), kernels=(3, 3))
    jmodel = create_model_vae(JaxModelConfig(**kw))
    flat = _perturbed(init_vae(jmodel, jax.random.PRNGKey(3)), seed=3)
    net = dtt.DeblenderVAE(dtt.ModelConfig(**kw))
    net.load_state_dict(state_dict_from_flax(flat, net.cfg))
    x = _stamps(3, size=23, bands=3, seed=1)
    dist, post = jmodel.apply(_unflatten(flat), jnp.asarray(x), z_mode="mean")
    with torch.no_grad():
        tdist, tpost = net(torch.from_numpy(x), z_mode="mean")
    _close(tdist.loc.numpy(), dist.loc)
    _close(tdist.scale.numpy(), dist.scale)
    _close(tpost.loc.numpy(), post.loc)
    _close(tpost.scale_tril.numpy(), post.scale_tril)


def test_sim_demo_full_width_matches_jax(sim_demo):
    model, variables, net = sim_demo
    assert sum(v.numel() for v in net.state_dict().values()) == N_PARAMS
    x = _stamps(2, seed=2)
    dist, post = model.apply(variables, jnp.asarray(x), z_mode="mean")
    with torch.no_grad():
        tdist, tpost = net(torch.from_numpy(x), z_mode="mean")
    _close(tdist.loc.numpy(), dist.loc)
    _close(tdist.scale.numpy(), dist.scale)
    _close(tpost.loc.numpy(), post.loc)


def test_sample_with_eps_is_loc_plus_tril_eps(sim_demo):
    """Sampled latents use injected noise: JAX and torch generators never
    share a stream.  Tolerance: the posterior's own 2e-5 plus one 32-term
    float32 dot product."""
    model, variables, net = sim_demo
    x = _stamps(2, seed=4)
    eps = np.random.default_rng(5).normal(size=(2, 32)).astype(np.float32)
    _, post = model.apply(variables, jnp.asarray(x), z_mode="mean")
    want = np.asarray(post.loc, np.float64) + np.einsum(
        "nij,nj->ni", np.asarray(post.scale_tril, np.float64), eps
    )
    with torch.no_grad():
        tpost = net.encode(torch.from_numpy(x))
        z = tpost.sample(eps=torch.from_numpy(eps))
        tdist, _ = net(torch.from_numpy(x), z_mode="sample", eps=torch.from_numpy(eps))
    _close(z.numpy(), want)
    jdec = model.apply(variables, jnp.asarray(z.numpy()), method=lambda m, v: m.decode(v))
    _close(tdist.loc.numpy(), jdec.loc)


def test_packaged_npz_equals_orbax_checkpoint(sim_demo):
    _, variables, _ = sim_demo
    want = flatten_flax(jax.tree_util.tree_map(np.asarray, variables))
    got = load_flax_npz(default_weights_dir() / "sim_demo.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    assert sum(v.size for v in got.values()) == N_PARAMS


@pytest.mark.parametrize("normalise", [False, True])
def test_deblend_api_matches_jax(sim_demo, normalise):
    """Finite guard and the normalise bracket (delta-method stddev)."""
    import debvader_tpu as dt

    model, variables, net = sim_demo
    x = _stamps(3, seed=6)
    x[0, 10, 10, 2] = np.nan
    x[1, 0, 0, 0] = np.inf
    jmean, jdist = dt.deblend((model, variables), x, normalise=normalise, z_mode="mean")
    tmean, tdist = dtt.deblend(net, x, normalise=normalise, z_mode="mean", device="cpu")
    _close(tmean, jmean)
    _close(tdist.stddev().numpy(), jdist.stddev())


def test_import_pulls_in_no_jax_or_reference_package():
    code = textwrap.dedent(
        """
        import sys, numpy as np, torch
        import debvader_tpu_torch as dtt
        from debvader_tpu_torch.kernels import clipped_stats, detect_fused, label_select
        from debvader_tpu_torch.kernels import decoder_tail, matched_filter, render, tail_fused
        from debvader_tpu_torch.models import precision
        from debvader_tpu_torch.data import simulate
        from debvader_tpu_torch.ops import measure
        from debvader_tpu_torch.utils import flux_cal, profiling
        from debvader_tpu_torch.training import checkpoint, losses, train, transfer
        from debvader_tpu_torch.runtime import loader
        net = dtt.DeblenderVAE(dtt.ModelConfig(stamp_size=23, nb_of_bands=3, latent_dim=4,
                                               filters=(8, 16), kernels=(3, 3)))
        dtt.deblend(net, np.zeros((1, 23, 23, 3), np.float32), z_mode="mean", device="cpu")
        dtt.detect_objects(np.zeros((64, 64), np.float32), device="cpu")
        dtt.detect_objects(np.zeros((64, 64), np.float32),
                           dtt.DetectionConfig(use_pallas_filter=True), device="cpu")
        field = np.zeros((1, 64, 64, 3), np.float32)
        df = dtt.DeblendField(net, field, cutout_size=23, nb_of_bands=3, z_mode="mean",
                              cfg=dtt.PipelineConfig(cutout_size=23, nb_of_bands=3, interp_order=1),
                              device="cpu")
        df.deblend_and_render(np.zeros((1, 2), np.float32), measure=True)
        emu = dtt.DeblenderVAE(dtt.ModelConfig(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(8, 16),
                                               kernels=(3, 3), matmul_precision="high", limb_emulation=True))
        flux_cal.attach_flux_calibration(emu, n=2)
        dtt.deblend_sample_stats(emu, np.zeros((2, 23, 23, 3), np.float32), 3, device="cpu")
        edf = dtt.DeblendField(emu, field, cutout_size=23, nb_of_bands=3, epistemic_uncertainty_estimation=True,
                               cfg=dtt.PipelineConfig(cutout_size=23, nb_of_bands=3, interp_order=1,
                                                      epistemic_samples=2), device="cpu")
        edf.deblend_and_predict(np.zeros((1, 2), np.float32))
        tiny = dtt.ModelConfig(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))
        state = train.create_train_state(dtt.DeblenderVAE(tiny), dtt.TrainConfig(batch_size=2), device="cpu")
        x = np.zeros((2, 23, 23, 3), np.float32)
        train.train_network(dtt.DeblenderVAE(tiny), state, 1, (x, x), (x, x), 2, verbose=0,
                            metrics_log=profiling.MetricsLog())
        transfer.transfer_band_count(state.variables(), tiny)
        from debvader_tpu_torch.kernels import int8_conv
        from debvader_tpu_torch.models import quantized
        qv = quantized.quantize_vae(net, np.ones((2, 23, 23, 3), np.float32), act_granularity="per_channel")
        quantized.quantized_forward(qv, np.ones((1, 23, 23, 3), np.float32), z_mode="mean")
        qdf = dtt.DeblendField(net, field, cutout_size=23, nb_of_bands=3, z_mode="mean", quantized=qv,
                               cfg=dtt.PipelineConfig(cutout_size=23, nb_of_bands=3, interp_order=1),
                               device="cpu")
        qdf.deblend_and_render(np.zeros((1, 2), np.float32))
        quantized.load_quantized("sim_demo_int8", device="cpu")
        bfq = quantized.quantize_vae(dtt.DeblenderVAE(dtt.ModelConfig(stamp_size=23, nb_of_bands=3, latent_dim=4,
                                                                      filters=(8, 16), kernels=(3, 3),
                                                                      dtype="bfloat16")),
                                     np.ones((2, 23, 23, 3), np.float32))
        quantized.quantized_forward(bfq, np.ones((1, 23, 23, 3), np.float32), z_mode="mean")
        import tempfile
        from debvader_tpu_torch import weights
        from debvader_tpu_torch.utils import parity, tf_checkpoint, weight_import
        with tempfile.TemporaryDirectory() as tmp:
            tf_checkpoint.write_bundle(tmp + "/w.ckpt", weight_import.export_to_tensors(
                weights.flax_from_state_dict(net.state_dict(), net.cfg), net.cfg), shards=2)
            weight_import.import_reference_checkpoint(tmp + "/w.ckpt", net.cfg)
        from debvader_tpu_torch import cli, compat
        from debvader_tpu_torch.utils import export, flops
        flops.forward_macs(tiny)
        bf = dtt.DeblenderVAE(dtt.ModelConfig(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8),
                                              kernels=(3, 3), dtype="bfloat16", decoder_subpixel=True))
        export.artifact_forward(export.export_deblender(bf), device="cpu")(np.zeros((2, 23, 23, 3), np.float32))
        compat.extract_cutouts(field, 64, np.zeros((1, 2), np.float32), 23, 3)
        cli.build_parser().parse_args(["detect", "--field", "f.npy", "--out", "c.npy"])
        from debvader_tpu_torch import parallel
        from debvader_tpu_torch.pipeline.sharded_field import ShardedFieldDeblender
        mesh = parallel.make_mesh(2, devices=["cpu"] * 2)
        big = np.zeros((1, 160, 160, 3), np.float32)
        ShardedFieldDeblender(net, big, mesh, cutout_size=23, nb_of_bands=3, z_mode="mean",
                              cfg=dtt.PipelineConfig(cutout_size=23, nb_of_bands=3, interp_order=1)
                              ).deblend_and_render(np.zeros((1, 2), np.float32))
        dtt.DeblendField(net, field, cutout_size=23, nb_of_bands=3, mesh=mesh, device="cpu",
                         cfg=dtt.PipelineConfig(cutout_size=23, nb_of_bands=3, interp_order=1)
                         ).deblend_and_render(np.zeros((1, 2), np.float32))
        train.train_network(dtt.DeblenderVAE(tiny), state, 1, (x, x), (x, x), 2, verbose=0, mesh=mesh)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "pandas")
               or m == "debvader_tpu" or m.startswith("debvader_tpu.")]
        print(bad)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_module_of_the_port_imports_jax():
    for path in (REPO / "debvader_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for needle in ("import jax", "from jax", "import debvader_tpu ", "import debvader_tpu.",
                       "from debvader_tpu.", "from debvader_tpu "):
            assert needle not in text, f"{path} contains {needle!r}"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    field = np.zeros((1, 64, 64, 6), np.float32)
    net = dtt.DeblenderVAE()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dtt.load_deblender("sim_demo")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_quantized("sim_demo_int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dtt.deblend(net, field[0, :59, :59], z_mode="mean")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dtt.detect_objects(field)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dtt.DeblendField(net, field)


@pytest.mark.parametrize("caller_tf32", [False, True])
def test_fp32_math_is_scoped_to_the_port(monkeypatch, caller_tf32):
    """TF32 is off inside the port's forward and background matmuls, and
    the caller's flags are as they were after an entry point returns."""
    from debvader_tpu_torch.device import fp32_math

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", caller_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", caller_tf32)
    with fp32_math():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    net = dtt.DeblenderVAE(dtt.ModelConfig(stamp_size=23, nb_of_bands=3, latent_dim=4,
                                           filters=(8, 16), kernels=(3, 3)))
    dtt.deblend(net, np.zeros((1, 23, 23, 3), np.float32), z_mode="mean", device="cpu")
    dtt.detect_objects(np.zeros((64, 64), np.float32), device="cpu")
    assert torch.backends.cudnn.allow_tf32 is caller_tf32
    assert torch.backends.cuda.matmul.allow_tf32 is caller_tf32


def test_cpu_tensors_take_the_plain_versions_and_never_build(monkeypatch):
    """The kernel modules import without nvcc; CPU tensors never reach
    kernels/_build.py or a launch counter."""
    from debvader_tpu_torch.kernels import (
        _build,
        bias_prelu,
        clipped_stats,
        decoder_tail,
        detect_fused,
        int8_conv,
        label_select,
        matched_filter,
        parent_race,
        registration,
        render,
        tail_fused,
    )

    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == [
        "bias_prelu", "clipped_stats", "decoder_tail", "detect_fused", "int8_conv", "int8_conv_bf16", "label_select",
        "matched_filter", "parent_race", "registration", "render", "tail_fused",
    ]

    def no_build(name):
        raise AssertionError(f"the CPU path tried to build {name}")

    monkeypatch.setattr(_build, "load", no_build)
    counters = (
        bias_prelu.bias_prelu,
        clipped_stats.sigma_clipped_stats,
        detect_fused.matched_filter_parents,
        label_select.label_fixpoint,
        matched_filter.matched_filter_threshold,
        parent_race.parent_race_kernel,
        render.render_field_kernel,
        render.place_patches,
        decoder_tail.fused_decoder_tail,
        tail_fused.fused_tail_pair,
        registration.register_windowed,
        registration.register_full,
        int8_conv.quant_act,
        int8_conv.bn_quant,
        int8_conv.bias_prelu_quant,
        int8_conv.conv_s8,
        int8_conv.conv_fused,
    )
    bf16_counters = (render.render_field_kernel, render.place_patches, int8_conv.bn_quant, int8_conv.bias_prelu_quant,
                     bias_prelu.bias_prelu)
    bf16_fused = ("launches_bf16_conv", "launches_bf16_convT", "launches_bf16_dense")

    def count():
        return ([fn.launches for fn in counters] + [fn.launches_bf16 for fn in bf16_counters]
                + [getattr(int8_conv.conv_fused, k) for k in bf16_fused])

    before = count()
    img = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    dtt.detect_objects(img, device="cpu")
    dtt.detect_objects(img, dtt.DetectionConfig(use_pallas_filter=True), device="cpu")
    dtt.render_field(torch.ones(2, 9, 9, 2), torch.tensor([[0.5, -3.25], [4.0, 7.5]]), 40, order=1)
    dtt.render_field(torch.ones(2, 9, 9, 2), torch.tensor([[0.5, -3.25], [4.0, 7.5]]), 40, order=3)
    for order in (1, 3):
        dtt.render_field(
            torch.ones(2, 9, 9, 2, dtype=torch.bfloat16), torch.tensor([[0.5, -3.25], [4.0, 7.5]]), 40, order=order
        )
    registration.register_windowed(torch.ones(40, 40), torch.ones(2, 9, 9), torch.zeros(2, 2), iterations=2)
    registration.register_full(torch.ones(12, 12), torch.ones(2, 9, 9), torch.zeros(2, 2), iterations=2)
    dtt.fused_decoder_tail(
        torch.ones(1, 8, 8, 4), torch.ones(3, 3, 4, 4), torch.ones(4), torch.ones(8, 8, 4),
        torch.ones(3, 3, 4, 2), torch.ones(2),
    )
    dtt.fused_tail_pair(
        torch.ones(1, 8, 8, 4), torch.ones(3, 3, 4, 4), torch.ones(4), torch.ones(8, 8, 4),
        torch.ones(3, 3, 4, 2), torch.ones(2),
    )
    layer = int8_conv.make_layer(
        "conv", torch.ones(4, 3, 3, 3, dtype=torch.int8), torch.ones(4), torch.tensor(0.5), torch.zeros(4), 2
    )
    q = int8_conv.quant_act(torch.ones(1, 3, 7, 7), torch.tensor(0.5))
    int8_conv.conv_s8(q, layer)
    int8_conv.conv_fused(q, layer, torch.ones(4, 4, 4), None, torch.tensor(0.25))
    int8_conv.bn_quant(torch.ones(1, 7, 7, 3), dtt.models.layers.BatchNorm(3), torch.tensor(0.5))
    int8_conv.bias_prelu_quant(torch.ones(2, 5), torch.zeros(5), torch.ones(5), torch.tensor(0.5))
    for dtype in (torch.float32, torch.bfloat16):
        bias_prelu.bias_prelu(torch.ones(2, 3, 4, 4, dtype=dtype), torch.zeros(3), torch.ones(3, 4, 4))
    # the bfloat16 epilogues and points
    bf = dataclasses.replace(layer, dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    int8_conv.conv_fused(q, bf, torch.ones(4, 4, 4), None, torch.tensor(0.25))
    int8_conv.conv_fused(q, bf, torch.ones(4, 4, 4))
    int8_conv.bn_quant(torch.ones(1, 7, 7, 3), dtt.models.layers.BatchNorm(3, dtype=torch.bfloat16), torch.tensor(0.5))
    int8_conv.bias_prelu_quant(torch.ones(2, 5, dtype=torch.bfloat16), torch.zeros(5), torch.ones(5), torch.tensor(0.5))
    assert count() == before
