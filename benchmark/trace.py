"""The traced run: a ``torch.profiler`` session over part of the window, and
what the per-layer metrics read from it.

``traced(fn)`` runs ``fn`` with the profiler on and returns a ``Reading``: the
device's kernels (each classed by ``kernel_classes.json``), its copies and
sets, the host's operators, the window's length on the host clock, and the
counters and work the cell adds. A session that records no device activity at
all is run again (seen now and then on the H100's machine); if the second
records none either, the run fails: no metric is ever read from the host
alone.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

CLASSES = [(c, re.compile(p)) for c, p in
           json.loads((Path(__file__).resolve().parent / "kernel_classes.json").read_text())["classes"]]
WINDOW_SPAN = "benchmark.window"
HOST_ONLY = "host outside torch operators"  # an idle gap no traced host operator covers
PROFILER_OWN = ("Activity Buffer Request",)  # the profiler's own host events
SESSIONS = 2
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length


def kernel_class(name: str) -> str:
    for cls, pattern in CLASSES:
        if pattern.search(name):
            return cls
    return "elementwise"


@dataclasses.dataclass
class Reading:
    kernels: List[Tuple[str, str, float, float]]  # (name, class, start us, duration us)
    copies: List[Tuple[str, float, float]]  # (name, start us, duration us): memcpy, memset
    host: List[Tuple[str, float, float]]  # (name, start us, end us) of the host's operators
    window: Tuple[float, float]  # (start us, end us) of the traced window, the device's clock base
    window_s: float  # its length on the host clock
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: Dict[str, float] = dataclasses.field(default_factory=dict)

    def device_s(self, cls: str) -> float:
        return sum(d for _, c, _, d in self.kernels if c == cls) / 1e6

    def copy_s(self, pattern: str) -> float:
        return sum(d for name, _, d in self.copies if re.search(pattern, name)) / 1e6

    def intervals(self) -> List[Tuple[float, float]]:
        """The device's busy intervals (kernels, copies, sets), merged, in us."""
        spans = sorted([(s, s + d) for _, _, s, d in self.kernels] + [(s, s + d) for _, s, d in self.copies])
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        lo, hi = self.window
        return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in self.intervals()) / 1e6

    def idle_gaps(self, count: int = 10) -> List[List]:
        """The longest stretches of the window with nothing on the device, each
        named by the innermost host operator running at its middle."""
        lo, hi = self.window
        gaps, edge = [], lo
        for s, e in self.intervals() + [(hi, hi)]:
            if s > edge:
                gaps.append((edge, min(s, hi)))
            edge = max(edge, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:count]
        out = []
        for s, e in gaps:
            mid = (s + e) / 2
            around = [(he - hs, name) for name, hs, he in self.host if hs <= mid <= he]
            out.append([min(around)[1] if around else HOST_ONLY, (e - s) / 1e6])
        return out

    def device_ops(self, count: int = 10) -> List[List]:
        totals: Dict[str, float] = {}
        for name, _, _, d in self.kernels:
            totals[name[:NAME_CHARS]] = totals.get(name[:NAME_CHARS], 0.0) + d / 1e6
        for name, _, d in self.copies:
            totals[name[:NAME_CHARS]] = totals.get(name[:NAME_CHARS], 0.0) + d / 1e6
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:count]]


def _read(prof, window_s: float) -> Reading:
    cuda = torch.autograd.DeviceType.CUDA
    kernels, copies, host, window = [], [], [], None
    for e in prof.events():
        start, dur = e.time_range.start, e.time_range.elapsed_us()
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) or e.name == WINDOW_SPAN:
                continue  # a host span mirrored on the device's timeline, not device work
            if re.match(r"(?i)mem(cpy|set)", e.name):
                copies.append((e.name, start, dur))
            else:
                kernels.append((e.name, kernel_class(e.name), start, dur))
        elif e.name == WINDOW_SPAN:
            window = (start, e.time_range.end)
        elif not e.name.startswith(PROFILER_OWN):
            host.append((e.name, start, e.time_range.end))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    return Reading(kernels, copies, host, window, window_s)


def traced(fn: Callable[[], None], device: torch.device) -> Reading:
    """Run ``fn`` under ``torch.profiler`` -> its Reading. Raises if no session
    of ``SESSIONS`` records device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            with record_function(WINDOW_SPAN):
                fn()
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - start
        reading = _read(prof, window_s)
        if reading.kernels:
            return reading
    raise RuntimeError(f"torch.profiler recorded no device activity in {SESSIONS} sessions")
