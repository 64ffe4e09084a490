"""Host milliseconds of a step's batch preparation (``anomalyclip.trainer.prepare``:
``prepare_batch``'s upload from pageable host memory) per step."""

from benchmark.spans import per_count_ms


def read(r):
    return per_count_ms(r, "anomalyclip.trainer.prepare", "steps")
