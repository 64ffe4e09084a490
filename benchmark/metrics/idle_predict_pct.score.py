"""The device's idle time while the innermost open span of the port
(``anomalyclip.<layer>.<what>``) was of the predict layer (``predict.py``: the
video, the grid cover), as a share of the traced window (``spans.py``)."""

from benchmark.spans import idle_pct


def read(r):
    return idle_pct(r, "predict")
