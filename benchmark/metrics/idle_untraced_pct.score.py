"""The device's idle time while no span of the port (``anomalyclip.``) was
open, as a share of the traced window (``spans.py``): the harness's own work
and whatever the port's spans leave out."""

from benchmark.spans import UNTRACED, idle_pct


def read(r):
    return idle_pct(r, UNTRACED)
