"""What every driver's run shares: the process's clock, set-up's phases, the
peak memory, and handing the program's memory back before the reference runs."""

from __future__ import annotations

import gc
import os
import time
from typing import Callable

import torch


def process_clock() -> Callable[[], float]:
    """-> a clock of seconds since this process started (the kernel's start
    time, to its 10 ms tick), read on the host's monotonic clock."""
    with open("/proc/self/stat") as f:
        started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        age = float(f.read().split()[0]) - started
    origin = time.perf_counter() - age
    return lambda: time.perf_counter() - origin


class Phases:
    """Set-up's seconds by phase, each from the end of the one before: the
    first from the process's start (library loads, the device's context)."""

    def __init__(self, clock: Callable[[], float]):
        self.clock, self.last, self.times = clock, 0.0, {}

    def mark(self, name: str, device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = self.clock()
        self.times[name] = now - self.last
        self.last = now


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free() -> None:
    """Hand what the program no longer holds back to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
