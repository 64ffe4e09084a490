"""The benchmark of the PyTorch and CUDA port (``anomalyclip_tpu_torch``):

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It finds the cell in ``BENCHMARK.json`` and hands it to the driver of its mix's
kind (``benchmark/drivers/<kind>.py``), which makes its weights and traffic
from the seed, warms up, measures for ``--seconds`` and checks what the timed
path produced against the plain reference (``benchmark/reference``). The last line
of standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, ``breakdown`` with ``--trace 1``, and ``checks`` last: each
number compared beside its limit, which the last lines of standard error give
too. It exits non-zero, printing no result, without a CUDA device or with fewer
than the cell asks for, and when ``jax``, ``jaxlib``, ``flax``, ``optax``,
``orbax`` or the JAX package ``anomalyclip_tpu`` is loaded once the window has
closed and the per-layer metrics' readers have run.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

from benchmark.session import process_clock

# what no process of the benchmark may load, compared by whole top-level names
# (anomalyclip_tpu_torch begins with anomalyclip_tpu and is allowed)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "anomalyclip_tpu"})
CHECKOUT = Path(__file__).resolve().parents[1]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; no library loads Flax."""
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell, seed: int, seconds: float, trace: bool, device, setup_clock) -> dict:
    """Run ``cell`` on ``device`` (the card, or the CPU in the tests) by the
    driver of its mix's kind -> its outcome."""
    from benchmark.cells import load_driver

    return load_driver(cell.mix["kind"]).run(cell, seed, seconds, trace, device, setup_clock)


def judge(numbers: dict, limits: dict) -> tuple:
    """-> (correct, [[name, number, limit], ...]) over the numbers the cell's
    limits name; a limit without its number is a fault of the harness."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no number for the limits {sorted(missing)}")
    checks = [[k, numbers[k], limits[k]] for k in sorted(limits)]
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks), checks


def result(cell, outcome: dict, trace: bool, bench: dict, device_info: dict) -> dict:
    from benchmark.cells import load_metric

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    correct, checks = judge(outcome["numbers"], cell.limits)
    device = dict(device_info, memory_peak_bytes=int(outcome["memory_peak_bytes"]))
    metrics, breakdown = {}, None
    if trace:
        reading = outcome["reading"]
        for name in cell.per_layer:
            value = load_metric(name)(reading)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        device.update(busy_s=reading.busy_s, window_s=reading.window_s)
        breakdown = {"device_ops": reading.device_ops(), "idle_gaps": reading.idle_gaps()}
    else:
        for name in cell.end_to_end:
            metrics[name] = {"value": outcome["end_to_end"][name], "unit": units[name]}
    line = {"correct": correct, "attempted": outcome["attempted"], "failed": outcome["failed"],
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["notes"] = outcome["notes"]
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line


def main(argv=None) -> int:
    setup_clock = process_clock()
    args = parse(argv)
    pin_caches()
    import torch

    from benchmark.cells import find_cell, load_benchmark

    bench = load_benchmark()
    cell = find_cell(args.workload, bench)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips}
    outcome = execute(cell, args.seed, args.seconds, bool(args.trace), device, setup_clock)
    line = result(cell, outcome, bool(args.trace), bench, device_info)
    found = forbidden_modules()  # after the metric readers have loaded too
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
