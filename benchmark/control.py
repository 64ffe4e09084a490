"""The readings that the correctness limits are set from, at a cell's own size:

    python3 -m benchmark.control --workload <name> [--seeds 1,2,...] [--control-seeds 7,8,9] [--controls fp8]

For each of ``--seeds`` the program's gaps to the plain reference on the
sample a run compares (the sound readings: their largest is the lower
reading). For each of ``--control-seeds`` each reading the driver of the
cell's mix names (``controls``): the nearest precision below the
configuration's in the program's place (for a bf16 configuration the
reference with its products in fp8; for an fp32 one the reference with its
products in TF32), and the faults a cell of that kind can have, planted in
the program. ``--controls`` keeps only the named ones. One JSON line per
reading, then a summary line. No window is timed: each driver's ``reading``
says what it compares.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.cells import find_cell, load_driver
from benchmark.run import pin_caches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--controls", default="", help="the control readings to take, by name; all of them by default")
    args = p.parse_args(argv)
    pin_caches()
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = find_cell(args.workload)
    driver = load_driver(cell.mix["kind"])
    split = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    lows = driver.controls(cell)
    if args.controls:
        lows = [m for m in lows if m in set(args.controls.split(","))]
    modes = [("program", split(args.seeds))] + [(m, split(args.control_seeds)) for m in lows]
    summary = {}
    for mode, seeds in modes:
        for seed in seeds:
            start = time.perf_counter()
            reading = driver.reading(cell, seed, device, mode)
            reading.update(mode=mode, seed=seed, seconds=time.perf_counter() - start)
            print(json.dumps(reading), flush=True)
            for k, v in reading["numbers"].items():
                summary.setdefault(mode, {}).setdefault(k, []).append(v)
    print(json.dumps({"workload": cell.name, "device": torch.cuda.get_device_name(device),
                      "summary": {m: {k: {"min": min(v), "max": max(v)} for k, v in d.items()}
                                  for m, d in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
