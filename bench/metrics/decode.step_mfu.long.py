"""The step's share of the card's dense bf16 peak (%): the model FLOPs of
a step (``bench/lm_counts.py``: projections, feed-forward, head, and
attention over the rows the checked steps attended) over the window's
seconds a step before the traced segment times the peak."""


def read(rec):
    seg = rec["segment"]
    if not seg or not rec.get("flops_per_s"):
        return None
    wall_s, steps = seg["before"]
    if steps <= 0 or wall_s <= 0:
        return None
    return 100.0 * rec["flops_per_step"] / (wall_s / steps) \
        / rec["flops_per_s"]
