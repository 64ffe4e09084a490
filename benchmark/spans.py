"""The port's own spans in a traced window, and the device's idle time put down
to the layer the host was in.

The port marks its layers with ``torch.profiler.record_function`` spans named
``anomalyclip.<layer>.<what>`` while a profiler session records
(``anomalyclip_tpu_torch/utils/trace.py``). They reach a ``trace.Reading`` among
its host events, on the device's time base. This module imports nothing of the
port: a program without such spans gives readings with none, and every reader
then returns None. ``split`` gives a traced run's reading (``run.execute(...)
["reading"]``) per span: each span's count and host seconds, and the device's
idle seconds under each span and each layer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

PREFIX = "anomalyclip."
UNTRACED = "untraced"  # idle with no anomalyclip. span open


def spans(r, name: Optional[str] = None) -> List[Tuple[str, float, float]]:
    """The port's spans of ``r`` (all, or those named ``name``), clipped to the
    window -> [(name, start us, end us)], the empty ones left out."""
    lo, hi = r.window
    out = []
    for n, s, e in r.host:
        if n.startswith(PREFIX) and (name is None or n == name):
            s, e = max(s, lo), min(e, hi)
            if e > s:
                out.append((n, s, e))
    return out


def layer(name: str) -> str:
    """``anomalyclip.<layer>.<what>`` -> ``<layer>``."""
    return name[len(PREFIX):].split(".", 1)[0]


def span_s(r, name: str) -> float:
    """The summed host seconds of the spans named ``name``."""
    return sum(e - s for _, s, e in spans(r, name)) / 1e6


def _idle(r) -> List[Tuple[float, float]]:
    """The window's stretches with nothing on the device, in us."""
    lo, hi = r.window
    gaps, edge = [], lo
    for s, e in r.intervals() + [(hi, hi)]:
        s = min(s, hi)
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    return gaps


def idle_by_span(r) -> Dict[str, float]:
    """The device's idle seconds inside the window, by the innermost open
    ``anomalyclip.`` span (the latest started); ``untraced`` where none is open."""
    own = spans(r)
    starts = sorted(range(len(own)), key=lambda i: own[i][1])
    ends = sorted(range(len(own)), key=lambda i: own[i][2])
    gaps = _idle(r)
    points = sorted({p for _, s, e in own for p in (s, e)} | {p for g in gaps for p in g})
    out: Dict[str, float] = {}
    open_, si, ei, gi = set(), 0, 0, 0
    for a, b in zip(points, points[1:]):
        while si < len(starts) and own[starts[si]][1] <= a:
            open_.add(starts[si])
            si += 1
        while ei < len(ends) and own[ends[ei]][2] <= a:
            open_.discard(ends[ei])
            ei += 1
        while gi < len(gaps) and gaps[gi][1] <= a:
            gi += 1
        if gi < len(gaps) and gaps[gi][0] <= a:  # the points hold every gap's edges: [a, b] is idle whole
            key = own[max(open_, key=lambda i: (own[i][1], -own[i][2]))][0] if open_ else UNTRACED
            out[key] = out.get(key, 0.0) + (b - a) / 1e6
    return out


def idle_by_layer(r) -> Dict[str, float]:
    """``idle_by_span`` summed by the spans' layer; ``untraced`` as it is."""
    out: Dict[str, float] = {}
    for name, seconds in idle_by_span(r).items():
        key = UNTRACED if name == UNTRACED else layer(name)
        out[key] = out.get(key, 0.0) + seconds
    return out


def idle_pct(r, key: str) -> Optional[float]:
    """The device's idle time under layer ``key`` (or ``untraced``) as a share of
    the traced window; None where the window holds no kernel, no span of the
    port, or (for a layer) no span of that layer."""
    own = spans(r)
    if r.window_s <= 0 or not r.kernels or not own:
        return None
    if key != UNTRACED and not any(layer(n) == key for n, _, _ in own):
        return None
    return 100.0 * idle_by_layer(r).get(key, 0.0) / r.window_s


def per_count_ms(r, name: str, counter: str) -> Optional[float]:
    """The host milliseconds of the spans named ``name`` per ``counters[counter]``."""
    count = r.counters.get(counter)
    return 1e3 * span_s(r, name) / count if count and spans(r, name) else None


def split(r) -> dict:
    """Each span's count and host seconds, and the idle seconds by span and by layer."""
    own = spans(r)
    names = sorted({n for n, _, _ in own})
    return {"window_s": r.window_s, "busy_s": r.busy_s,
            "spans": {n: {"count": sum(1 for m, _, _ in own if m == n), "host_s": span_s(r, n)} for n in names},
            "idle_s_by_span": idle_by_span(r), "idle_s_by_layer": idle_by_layer(r)}
