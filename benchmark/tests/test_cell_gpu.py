"""On the card only: a tiny cell of each kind through a traced run, its
per-layer metrics read from a real device trace (run with
``python -m pytest benchmark/tests -m gpu``)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.cells import load_benchmark, load_metric
from benchmark.run import execute, judge
from benchmark.tests.tiny import tiny_cell


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["clips", "train"])
def test_tiny_traced_run_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny_cell(kind)
    start = time.perf_counter()
    out = execute(cell, 2**31 + 99, 2.0, True, torch.device("cuda", 0), lambda: time.perf_counter() - start)
    assert judge(out["numbers"], cell.limits)[0], out["numbers"]
    reading = out["reading"]
    assert reading.kernels and 0 < reading.busy_s <= reading.window_s * 1.01
    moves = "frames_per_s" if kind == "clips" else "train_step_ms"
    for metric in load_benchmark()["per_layer"]:
        if metric["moves"] != moves:
            continue
        value = load_metric(metric["name"])(reading)
        assert value is not None and value >= 0, metric["name"]
        if metric["unit"] == "%":
            assert value <= 105, (metric["name"], value)
