"""The device's idle time while the innermost open span of the port
(``anomalyclip.<layer>.<what>``) was of the trainer layer (``train/module.py``:
the step, its batch's draw and upload, AdamW, the epoch's end), as a share of
the traced window (``spans.py``)."""

from benchmark.spans import idle_pct


def read(r):
    return idle_pct(r, "trainer")
