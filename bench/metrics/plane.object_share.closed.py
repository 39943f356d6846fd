"""``obj_ins / (obj_ins + page_ins)`` (%) over the window: which ingress
path did the work."""


def read(rec):
    s = rec["window_stats"]
    n = s["obj_ins"] + s["page_ins"]
    return 100.0 * s["obj_ins"] / n if n else None
