"""The row-copy kernels' share of their roofline (%) in the traced
segment.  Numerator: the bytes the segment's work needs, each read once
and written once (a served row, an object fetch and an object that
evacuation moved: a row each; a page-in: a page), at the card's HBM rate.
Denominator: the summed device time of ``gather_rows``,
``gather_rows_into`` and ``compact_pages`` (every ``row_copy``
instantiation)."""


def needed_bytes(stats, served, row_bytes, page_bytes):
    rows = served + stats["obj_ins"] + stats["evac_moved"]
    return 2 * (rows * row_bytes + stats["page_ins"] * page_bytes)


def read(rec):
    seg = rec["segment"]
    if not seg or not seg["trace"] or not rec.get("hbm_bytes_per_s"):
        return None
    t = sum(d for n, _, d in seg["trace"]["device_ops"]
            if "row_copy" in n) * 1e-6
    if t <= 0:
        return None
    b = needed_bytes(seg["stats"], seg["keys"], rec["row_bytes"],
                     rec["page_bytes"])
    return 100.0 * b / rec["hbm_bytes_per_s"] / t
