"""Device time per tick (us) of the port's own CUDA kernels in the traced
segment, summed by name from the profiler."""
PORT_KERNELS = ("row_copy", "cat_decay_kernel", "cat_update_kernel",
                "page_scores_kernel", "paged_attention", "combine_kernel")


def read(rec):
    seg = rec["segment"]
    if not seg or not seg["trace"] or not seg["ticks"]:
        return None
    t = sum(d for n, _, d in seg["trace"]["device_ops"]
            if any(k in n for k in PORT_KERNELS))
    return t / seg["ticks"] if t else None
