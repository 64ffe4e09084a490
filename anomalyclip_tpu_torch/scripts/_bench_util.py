"""What the measurement scripts share: the clock and the device line.

The JAX package's scripts chain each call to the one before it
(scripts/_bench_util.py: ``carry_bench``) because waiting on a result is
unreliable over a remote TPU. On the card CUDA events are the clock: a warm
call, then the median of ``reps`` calls, each between two events on the current
stream (``median_ms``). A call shorter than its own enqueue is timed by that
clock at the host's pace, so two more clocks stand beside it: the device time of
the kernels a call launches, under torch.profiler (``device_ms``), and the host
time of one enqueue (``host_ms``).
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Optional

import torch

# readings of ``device_ms`` in this process, by outcome: a reader of the
# printed times counts from here how many came back not measured
device_readings = {"measured": 0, "not_measured": 0}


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


def device_ms(fn, calls: int = 30, sessions: int = 3) -> Optional[float]:
    """Device time of one call of ``fn``: the durations of every kernel and copy
    that ``calls`` calls put on the card under torch.profiler, summed, over
    ``calls``, after one warm call. Now and then a profiler session hands back
    no device activity at all (seen on the H100's machine in the middle of
    runs whose other sessions recorded theirs, once in three sessions in a
    row): such a session is run again, up to ``sessions`` in all; if none
    records any, the device time is not measured and this returns None (the
    callers print the CUDA-event time beside it, which is measured). Each
    reading is counted in ``device_readings``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == cuda)
        if total_us > 0:
            device_readings["measured"] += 1
            return total_us / 1e3 / calls
    device_readings["not_measured"] += 1
    return None


def format_ms(ms: Optional[float]) -> str:
    """A time of ``device_ms`` for a line: "not measured" where it is None."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def versus(ms: Optional[float], base_ms: Optional[float]) -> str:
    """Two times of ``device_ms`` as the first's ratio to the second, or "not
    measured" where either is None."""
    return "not measured" if ms is None or base_ms is None else f"{ms / base_ms:.3f}x"


def both_clocks(fn, iters: int) -> tuple:
    """(``median_ms``, ``device_ms``) of ``fn`` over ``iters`` calls each: 2
    (iters + 1) calls."""
    return median_ms(fn, iters), device_ms(fn, iters)


def host_ms(fn, calls: int = 200) -> float:
    """Host time of one enqueue of ``fn``: ``calls`` calls on the host clock with
    no synchronisation between them, over ``calls``, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed * 1e3 / calls


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
