"""What the measurement scripts share: the clock and the device line.

The JAX package's scripts chain each call to the one before it
(scripts/_bench_util.py: ``carry_bench``) because waiting on a result is
unreliable over a remote TPU. On the card CUDA events are the clock: a warm
call, then the median of ``reps`` calls, each between two events on the current
stream.
"""

from __future__ import annotations

import statistics
import subprocess

import torch


def median_ms(fn, reps: int = 30) -> float:
    """Median time of ``fn`` on the current CUDA device over ``reps`` calls, by
    CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def announce_device(script: str, device: str, on_cpu: str) -> bool:
    """Print the ``# device:`` line of a script run on ``device`` -> whether that
    is the card. ``--device cuda`` without a card exits, naming ``--device cpu``;
    ``on_cpu`` says what a CPU run does instead."""
    if device != "cuda":
        print(f"# device: cpu ({on_cpu})", flush=True)
        return False
    if not torch.cuda.is_available():
        raise SystemExit(f"{script}: no CUDA device (--device cpu: {on_cpu})")
    print(f"# device: {device_line()}", flush=True)
    return True
