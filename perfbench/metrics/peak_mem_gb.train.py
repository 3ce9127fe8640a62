"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start, in GB (1e9 bytes)."""


def read(rec):
    peak = rec.host.get("window_peak_bytes")
    return peak / 1e9 if peak else None
