"""The caching allocator's peak over the window
(``torch.cuda.max_memory_allocated``, reset when the window opens), on
the fullest chip, in GB (10^9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
