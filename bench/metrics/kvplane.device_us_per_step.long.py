"""Device time a step (us) of the KV plane's own CUDA kernels in the
traced segment: ``page_scores`` (the page summaries scored) and
``gather_rows`` (the page fetch), summed by name from the profiler."""
KERNELS = ("page_scores_kernel", "tag::gather_rows")


def read(rec):
    seg = rec["segment"]
    if not seg or not seg["trace"] or not seg["steps"]:
        return None
    t = sum(d for n, _, d in seg["trace"]["device_ops"]
            if any(k in n for k in KERNELS))
    return t / seg["steps"] if t else None
