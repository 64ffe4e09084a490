"""Model FLOPs of the clips scored (the tower over their real frames, the head
over their covering grids: ``work.py``) over the traced window, as a share of
the card's peak for the compute type."""


def read(r):
    flops, peak = r.work.get("flops"), r.work.get("peak_flops")
    return 100.0 * flops / r.window_s / peak if flops and peak and r.window_s > 0 else None
