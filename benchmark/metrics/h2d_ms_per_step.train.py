"""Device time of host-to-device copies per training step: the batch's upload
(``prepare_batch``)."""


def read(r):
    steps = r.counters.get("steps")
    return r.copy_s("HtoD") * 1e3 / steps if steps else None
