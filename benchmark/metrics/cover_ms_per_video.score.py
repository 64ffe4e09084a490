"""Host milliseconds of the grid cover a video (``anomalyclip.predict.cover``:
the covering grids' start indices and the gather ``raw[:, indices]``)."""

from benchmark.spans import per_count_ms


def read(r):
    return per_count_ms(r, "anomalyclip.predict.cover", "videos")
