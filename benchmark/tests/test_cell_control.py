"""The control, at a size a test run holds: the nearest precision below each
configuration's, in the program's place, comes out not correct under the
cell's own limits, where the program as configured comes out correct. (On the
card at the cells' sizes: ``python3 -m benchmark.control``.)"""

from __future__ import annotations

import pytest
import torch

from benchmark.cells import load_driver, load_limits
from benchmark.run import judge
from benchmark.tests.tiny import tiny_cell

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload,config,mode", [
    ("vitb16-clips-fp32", "ucfcrime-vitb16", "tf32"),
    ("vitb16-clips-bf16", "ucfcrime-vitb16-bf16", "fp8"),
    ("vitl14-336-clips-bf16", "ucfcrime-vitl14-336", "fp8"),
])
def test_scoring_control_fails(workload, config, mode, seed):
    cell = tiny_cell("clips", config=config)
    driver = load_driver("clips")
    limits = load_limits(workload)
    assert driver.controls(cell) == [mode]
    assert judge(driver.reading(cell, seed, CPU, "program")["numbers"], limits)[0]
    assert not judge(driver.reading(cell, seed, CPU, mode)["numbers"], limits)[0]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", ["tf32", "half_batch"])
def test_training_control_and_fault_fail(mode, seed):
    cell = tiny_cell("train")
    driver = load_driver("train")
    limits = load_limits("vitb16-train-fp32")
    assert mode in driver.controls(cell)
    assert judge(driver.reading(cell, seed, CPU, "program")["numbers"], limits)[0]
    assert not judge(driver.reading(cell, seed, CPU, mode)["numbers"], limits)[0]
