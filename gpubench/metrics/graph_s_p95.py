"""The 95th percentile (nearest rank) of the time per graph, from the
call to ``api.plan`` to the synchronise after ``api.generate``, over
every graph completed in the window (host clock)."""
import math


def read(run):
    times = sorted(g.graph_s for g in run.done)
    if not times:
        return None
    return times[math.ceil(0.95 * len(times)) - 1]
