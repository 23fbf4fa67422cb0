"""On the card, at each cell's own size: the program comes out correct
and the control does not.  Skips, with its reason, where there is no card
(decided inside the test)."""

import pytest
import torch
from bench_cells import SEED, cells

from portbench.harness import load_cell, load_manifest, load_module, run_cell


@pytest.mark.card
@pytest.mark.parametrize("workload", cells())
def test_program_correct_and_control_not_at_full_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' sizes and the card's kernels")
    manifest = load_manifest()
    cell = load_cell(manifest, workload)
    driver = load_module("drivers", cell["mix_data"]["driver"])
    assert run_cell(manifest, cell, SEED, 2.0, False, device="cuda")["correct"] is True
    control = driver.control(cell["config_data"])
    assert run_cell(manifest, cell, SEED + 1, 2.0, False, device="cuda", program=control)["correct"] is False
