"""The device's idle time while the innermost open span of the port
(``anomalyclip.<layer>.<what>``) was of the model layer
(``models/anomaly_clip.py``: the forward and the loss, the backward), as a share
of the traced window (``spans.py``)."""

from benchmark.spans import idle_pct


def read(r):
    return idle_pct(r, "model")
