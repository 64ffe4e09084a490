"""The share of the traced window in which no kernel, copy or set ran on the device."""


def read(r):
    return 100.0 * (1.0 - r.busy_s / r.window_s) if r.window_s > 0 and r.kernels else None
