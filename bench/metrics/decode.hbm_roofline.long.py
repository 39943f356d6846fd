"""The step's share of its memory roofline (%): the bytes a step must move
(``bench/lm_counts.py``: every weight once, every page summary
``page_scores`` reads, the attended K/V rows, the fetched pages read and
written) at the card's HBM rate, over the window's seconds a step before
the traced segment."""


def read(rec):
    seg = rec["segment"]
    if not seg or not rec.get("hbm_bytes_per_s"):
        return None
    wall_s, steps = seg["before"]
    if steps <= 0 or wall_s <= 0:
        return None
    return 100.0 * rec["bytes_per_step"] / rec["hbm_bytes_per_s"] \
        / (wall_s / steps)
