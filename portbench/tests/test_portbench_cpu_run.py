"""A whole run of each cell at a tiny size on the CPU, with the kernels'
plain versions: the result line and the checks beside their limits."""

import json

import pytest
from bench_cells import SEED, cells, tiny

from portbench.harness import emit, end_to_end_names, per_layer_names, run_cell


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", cells())
def test_run_prints_the_result_line(workload, trace, capsys):
    manifest, cell, overrides = tiny(workload)
    result = run_cell(manifest, cell, SEED, 0.5, bool(trace), device="cpu", mix_overrides=overrides)
    assert emit(result) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, check in line["checks"].items():
        assert f"check {name} " in err and check["value"] <= check["limit"]
    assert err.strip().splitlines()[-1] == "correct True"
    if trace:
        assert set(line["metrics"]) <= set(per_layer_names(manifest, workload))
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        # the host-clock readers read on the CPU too; the device-trace ones find nothing there
        host = {m["name"] for m in manifest["per_layer"] if m["source"] == "host_clock"}
        assert set(per_layer_names(manifest, workload)) & host <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == set(end_to_end_names(manifest, workload))
        assert all(m["value"] > 0 for m in line["metrics"].values())
