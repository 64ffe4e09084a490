"""The device's idle time while the innermost open span of the port
(``anomalyclip.<layer>.<what>``) was of the evaluator layer
(``eval/evaluator.py``, ``eval/grids.py``: each chunk's staging, upload and
fetch, the grid scoring's host half), as a share of the traced window
(``spans.py``)."""

from benchmark.spans import idle_pct


def read(r):
    return idle_pct(r, "evaluator")
