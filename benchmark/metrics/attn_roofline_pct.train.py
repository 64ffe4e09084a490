"""The least time of a step's attention (the text tower's causal forward and
backward, the temporal model's forward and backward, from shapes: ``work.py``)
over the device time of the attention kernels, in percent."""


def read(r):
    spent, bound = r.device_s("attention"), r.work.get("attention_bound_s")
    return 100.0 * bound / spent if spent > 0 and bound else None
