"""Device time of the convolutions (the temporal model's 3x3 feed-forwards,
forward and backward, with cuDNN's layout transforms) per training step."""


def read(r):
    steps = r.counters.get("steps")
    return r.device_s("conv") * 1e3 / steps if steps else None
