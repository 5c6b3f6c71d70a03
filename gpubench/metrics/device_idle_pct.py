"""The device's idle share of the traced stretch, in %: 100 x (1 - the
union of device intervals / the stretch), from ``torch.profiler``
(CUPTI); rank 0's on more than one chip."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
