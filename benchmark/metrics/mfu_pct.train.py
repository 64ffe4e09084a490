"""Forward-plus-backward model FLOPs of the steps taken (``work.py``) over the
traced window, as a share of the card's fp32 peak (split-TF32, 165 TFLOP/s)."""


def read(r):
    flops, peak = r.work.get("flops"), r.work.get("peak_flops")
    return 100.0 * flops / r.window_s / peak if flops and peak and r.window_s > 0 else None
