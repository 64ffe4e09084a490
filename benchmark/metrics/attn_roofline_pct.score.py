"""The least time of the attention the clips need (the image tower's over
their real frames, the temporal model's over their covering grids, from shapes:
``work.py``) over the device time of the attention kernels, in percent."""


def read(r):
    spent, bound = r.device_s("attention"), r.work.get("attention_bound_s")
    return 100.0 * bound / spent if spent > 0 and bound else None
