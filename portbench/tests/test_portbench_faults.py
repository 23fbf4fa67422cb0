"""The comparison fails what it must: a whole run of each cell at a tiny
size on the CPU, past the harness's look for a chip, with the timed path
broken underneath (each fault the cell can have) or with the control (the
reference one precision below the configuration's in the program's
place), comes out not correct under the cell's limits."""

import pytest
from bench_cells import SEED, cells, tiny

from portbench.harness import load_module, run_cell


def _run(workload, program):
    manifest, cell, overrides = tiny(workload)
    return run_cell(manifest, cell, SEED, 0.3, False, device="cpu", program=program, mix_overrides=overrides)


def _driver(workload):
    _, cell, _ = tiny(workload)
    return load_module("drivers", cell["mix_data"]["driver"]), cell


@pytest.mark.parametrize("workload", cells())
def test_the_control_is_not_correct(workload):
    driver, cell = _driver(workload)
    result = _run(workload, driver.control(cell["config_data"]))
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("workload", cells())
def test_a_fault_is_not_correct(workload, fault):
    driver, _ = _driver(workload)
    if fault not in driver.FAULTS:
        pytest.skip(f"{workload} cannot have the fault {fault}")
    result = _run(workload, driver.FAULTS[fault])
    assert result["correct"] is False, result["checks"]
