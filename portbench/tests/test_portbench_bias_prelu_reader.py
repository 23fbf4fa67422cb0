"""The reader of the one-pass bias and PReLU's roofline share: listed for
the two stamp cells only, reading the kernel's device time in a trace
against the bytes counted from the configuration's shapes, and nothing
where the trace holds no such kernel (a program without it, or the CPU)."""

import types

import pytest
from bench_cells import SEED, cells, tiny

from portbench.harness import load_cell, load_manifest, load_module, per_layer_names, run_cell
from portbench.work import HBM_BYTES_PER_S
from portbench.work_bias_prelu import bias_prelu_bytes, bias_prelu_layers

NAME = "bias_prelu_roofline.stamps"
STAMPS = ["f32-stamps-b4096", "bf16-stamps-b4096"]
KERNEL = "void (anonymous namespace)::bias_prelu_kernel<float, 4, true>(float const*, float*, float const*, " \
         "float const*, int, int, int, int, int, int, int)"


def _ctx(workload, ops):
    cell = load_cell(load_manifest(), workload)
    trace = {"steps": 4, "device_op_s": ops, "kernels": 10}
    return types.SimpleNamespace(stats={}, trace=trace, config=cell["config_data"], mix=cell["mix_data"], cell=cell)


@pytest.mark.parametrize("workload", cells())
def test_listed_for_the_stamp_cells_only(workload):
    assert (NAME in per_layer_names(load_manifest(), workload)) == (workload in STAMPS)


def test_the_activations_counted_are_the_models():
    """761,184 conv elements a stamp (269,664 in the encoder, 491,520 in
    the decoder) and the two dense layers' 560 and 4,096."""
    model = load_cell(load_manifest(), STAMPS[0])["config_data"]["model"]
    layers = bias_prelu_layers(model)
    assert len(layers) == 18
    assert sum(e for _, e, _ in layers[:8]) == 269_664 and sum(e for _, e, _ in layers[10:]) == 491_520
    assert [e for _, e, _ in layers[8:10]] == [560, 4096]
    f32 = bias_prelu_bytes(model, 4096, 4)
    assert f32 == 8 * 4096 * (761_184 + 560 + 4096) + 4 * (761_184 + 560 + 4096) + 4 * sum(c for c, _, _ in layers)


@pytest.mark.parametrize("workload", STAMPS)
def test_reads_the_kernel_time_against_the_bytes(workload):
    ctx = _ctx(workload, {KERNEL: 0.02, "elementwise_kernel": 0.5, "cudnn_fprop": 0.1})
    model = ctx.config["model"]
    itemsize = 2 if model["dtype"] == "bfloat16" else 4
    want = 100.0 * 4 * bias_prelu_bytes(model, 4096, itemsize) / HBM_BYTES_PER_S / 0.02
    assert load_module("metrics", NAME).read(ctx) == pytest.approx(want, rel=1e-12)
    # bfloat16 moves half the bytes of the conv layers (dec/Dense_1 stays float32)
    if itemsize == 2:
        assert bias_prelu_bytes(model, 4096, 2) < 0.52 * bias_prelu_bytes(model, 4096, 4)


@pytest.mark.parametrize("workload", STAMPS)
def test_finds_nothing_without_the_kernel(workload):
    reader = load_module("metrics", NAME)
    assert reader.read(_ctx(workload, {"elementwise_kernel_128": 0.3, "cudnn_fprop": 0.1})) is None
    assert reader.read(types.SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("workload", STAMPS)
def test_a_traced_cpu_run_leaves_it_out(workload):
    manifest, cell, overrides = tiny(workload)
    line = run_cell(manifest, cell, SEED, 0.3, True, device="cpu", mix_overrides=overrides)
    assert NAME not in line["metrics"] and "launches_per_batch.stamps" not in line["metrics"]
